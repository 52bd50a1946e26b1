// Limb-form CMux steps (K4, K6) and external product (K5) for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of the JAX engine "pallas":
//   K4 rustfhe_tpu/engine/pallas_step.py:363  fused_cmux_step_merged (body _kernel_merged, :295)
//   K6 rustfhe_tpu/engine/pallas_step.py:267  fused_cmux_step (body _kernel_fused, :209)
//   K5 rustfhe_tpu/engine/pallas_step.py:158  fused_external_product (body _kernel, :117)
//
// Contract (the function, not the TPU's blocking), bit for bit:
//   K4, K6: out = acc + ExtProd(bk_i, Decompose(X^{a~} * acc - acc))
//   K5:     out = ExtProd(rows, digits)
// computed in limb form from the step's doubled int8 limb table (2L, 2, 4,
// 2N) (engine/plain.py prepare_trgsw_limbs): every key word split into
// four balanced signed 8-bit limbs, L_jct = [limbs(-q)[t], limbs(q)[t]] for
// row j, half c and limb t, and for each half c and limb t
//   P_ct[k] = sum_j sum_i d_j[i] * L_jct[k - i + N]      (int32, all 2L planes)
//   out[c]  = acc[c] + sum_t (uint32) P_ct << 8t          (wrapping mod 2^32)
// The plane sum is taken first and the limbs recombine once per (c, t),
// the limb-outer order of _kernel_merged.  |P_ct| stays below 2^31 for
// every shape taken (the wrappers check it).
//
// What bounds it.  The step needs at least the two-level Karatsuba count,
// 2 x 2 x 4 x 2L x 9 x (N/4)^2 int8 operations per sample (0.078 ms at
// FAST_PARAMS, B=4096, against the published 1,979 dense int8 TOP/s of the
// H100 SXM); the bytes (the accumulator in and out, the 64 KiB table) take
// 0.02 ms at 3.35 TB/s.  Only warpgroup MMA reaches the int8 rate, so K4
// and K6 are K1's step (cmux_k.cu) on the limb table: one int8 wgmma GEMM
// in three launches, from one call:
//   1. limb_panel_kernel: per plane j, half c and limb t, the K-major panel
//        Pt[x][r] = L_jct[x - r],  x in [x0, 2N), r in [0, 128),
//      zero for r >= N: K1's key panel (cmux_step.cuh), cut from the
//      table's bytes with no limb split (the table holds the limbs that
//      K1's panel kernel splits from the int32 key).  A byte gather from
//      the 64 KiB table (96 KiB at DEFAULT_PARAMS) into 7.5 MiB of panels
//      at FAST_PARAMS (11.25 MiB at DEFAULT_PARAMS), built anew each step;
//   2. step_digits_kernel (cmux_step.cuh): the digits as int8 (B, 2L,
//      Npad).  The TPU kernels keep the digits out of HBM; here a block
//      tile covers 64 or fewer coefficients of one limb, so each sample's
//      digits feed every coefficient tile, and writing them once (16 MiB
//      at FAST_PARAMS, B=4096) for TMA to read back from L2 costs less
//      than rebuilding them from the accumulator in every tile;
//   3. cmux_product_kernel (cmux_step.cuh), the TMA ring and wgmma
//      m64n256k32 .s32.s8.s8 mainloop with the limb recombination and the
//      add of acc in the epilogue, in two tile layouts:
//        K6 (c-split) <true, 1>: K1's tile, 128 samples x (one half c, 4
//          limbs x 64 coefficients);
//        K4 (merged) <true, 2>: 128 samples x (2 halves x 4 limbs x 32
//          coefficients), eight 32-row panel boxes a stage, so each digit
//          stage taken from the ring feeds both output halves, as
//          _kernel_merged feeds both halves from one batch tile.
// 197,696 bytes of shared memory at any shape: N a power of two in [8,
// 2048] with any l whose sums stay exact (PBS_PARAMS, N=2048 and l=4,
// included).  The digit and panel buffers are the wrapper's
// (engine/limb_step.py keeps them per thread, device and stream, as K1's),
// and their TMA maps are cached in this library by address.
//
// K5 keeps its first form: the limb table of one output half in shared
// memory, byte-reversed, and __dp4a on the CUDA cores, TB=8 samples a
// block (limb_common.cuh, shared with the probes P5/P6 of limb_probe.cu).
// Its shared memory grows with N and l: it refuses PBS_PARAMS.

#include <cstdint>
#include <cuda_runtime.h>

#include "cmux_step.cuh"
#include "limb_common.cuh"

namespace {

using namespace rustfhe::cmux;

// 1. table: (2L, 2, LIMBS, 2N) int8, read as words (4-byte aligned);
// panel: (2L, 2, LIMBS, rows, DEPTH) int8 with panel[p, x - x0, r] =
// table[p, x - r] (r < N, x < 2N) for p = (j * 2 + c) * LIMBS + t, and zeros
// elsewhere.  Thread: CHUNK bytes of one row x of one panel p: the table's
// bytes x - r0 - 15 .. x - r0, reversed.
__global__ void __launch_bounds__(THREADS)
limb_panel_kernel(const uint32_t* __restrict__ table, int8_t* __restrict__ panel, int N,
                  int two_l) {
  const Geometry g(N);
  constexpr int chunks = DEPTH / CHUNK;
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= two_l * 2 * LIMBS * g.rows * chunks) return;
  const int r0 = idx % chunks * CHUNK;
  const int xl = idx / chunks % g.rows;
  const int p = idx / (chunks * g.rows);
  const int x = g.x0 + xl;
  const uint32_t* T = table + (size_t)p * (N / 2);  // a plane: 2N bytes
  uint32_t v[CHUNK / 4];
  if (r0 + CHUNK <= N && x < 2 * N) {
    // Every byte live: s = x - r0 - 15 >= x0 - N + 1 >= 1 and s + 15 < 2N.
    // W[i], the word at byte s + 4i, from the aligned words a[] (the fifth
    // only when s is not aligned: it then holds byte s + 15); panel word k
    // is W[3 - k] byte-reversed.
    const int s = x - r0 - (CHUNK - 1);
    const int w = s >> 2, sh = 8 * (s & 3);
    uint32_t a[5];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = T[w + i];
    a[4] = sh ? T[w + 4] : 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = __byte_perm(__funnelshift_r(a[3 - k], a[4 - k], sh), 0u, 0x0123);
  } else {
    // The edges (N < 128, rows past 2N): byte by byte, zeros where r >= N
    // or x >= 2N (x - r >= 1 wherever both hold).
    const uint8_t* Tb = reinterpret_cast<const uint8_t*>(T);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t word = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = r0 + 4 * k + b;
        if (r < N && x < 2 * N) word |= (uint32_t)Tb[x - r] << (8 * b);
      }
      v[k] = word;
    }
  }
  *reinterpret_cast<uint4*>(panel + ((size_t)p * g.rows + xl) * DEPTH + r0) =
      make_uint4(v[0], v[1], v[2], v[3]);
}

cudaError_t launch_limb_panel(const void* table, void* panel, int N, int two_l,
                              cudaStream_t stream) {
  if ((uintptr_t)table % 4 || (uintptr_t)panel % 16) return cudaErrorMisalignedAddress;
  const int threads = two_l * 2 * LIMBS * Geometry(N).rows * (DEPTH / CHUNK);
  limb_panel_kernel<<<blocks(threads), THREADS, 0, stream>>>((const uint32_t*)table,
                                                             (int8_t*)panel, N, two_l);
  return cudaGetLastError();
}

// K4 (HALVES 2) and K6 (HALVES 1): the three launches of one step, into the
// caller's digit and panel buffers.
template <int HALVES>
int step(const void* acc, const void* a_tilde, const void* table, void* out, void* digits,
         void* panel, int B, int N, int l, int bgbit, unsigned int mask, void* stream) {
  if (!shape_ok(B, N, 2 * l)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = launch_limb_panel(table, panel, N, 2 * l, st);
  if (e == cudaSuccess) e = launch_digits(acc, a_tilde, digits, B, N, l, bgbit, mask, st);
  if (e == cudaSuccess) e = launch_product<true, HALVES>(digits, panel, acc, out, B, N, 2 * l, st);
  return (int)e;
}

// K5: the product of the caller's digits, one output half per block.
using rustfhe::KPT;
using namespace rustfhe::limb;

__global__ void __launch_bounds__(MAX_THREADS)
limb_kernel(const int8_t* __restrict__ digits, const uint32_t* __restrict__ table,
            int32_t* __restrict__ out, int B, int N, int two_l) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.y;
  const int b0 = blockIdx.x * TB;
  uint32_t* tab_s = reinterpret_cast<uint32_t*>(smem);
  int8_t* dig_s = reinterpret_cast<int8_t*>(smem + table_bytes(N, two_l, 1));

  load_table(tab_s, table, c, 1, two_l, N);
  const int per_sample = two_l * N;
  for (int idx = threadIdx.x; idx < TB * per_sample; idx += blockDim.x) {
    const int s = idx / per_sample;
    const int ji = idx - s * per_sample;  // j*N + i
    const int j = ji / N;
    const int b = b0 + s;
    dig_s[digit_byte(j, ji - j * N, s, N)] =
        b < B ? digits[(size_t)b * per_sample + ji] : (int8_t)0;
  }
  __syncthreads();

  const int k0 = threadIdx.x * KPT;
  const uint32_t* dig_w = reinterpret_cast<const uint32_t*>(dig_s);
  const int plane_words = two_l * (N / 2);
  uint32_t res[TB][KPT];
#pragma unroll
  for (int s = 0; s < TB; ++s)
#pragma unroll
    for (int t = 0; t < KPT; ++t) res[s][t] = 0u;
  for (int k = 0; k < NUM_LIMBS; ++k) {
    int32_t part[TB][KPT];
#pragma unroll
    for (int s = 0; s < TB; ++s)
#pragma unroll
      for (int t = 0; t < KPT; ++t) part[s][t] = 0;
    limb_products(tab_s + (size_t)k * plane_words, dig_w, two_l, N, k0, part);
#pragma unroll
    for (int s = 0; s < TB; ++s)
#pragma unroll
      for (int t = 0; t < KPT; ++t) res[s][t] += (uint32_t)part[s][t] << (LIMB_BITS * k);
  }
#pragma unroll
  for (int s = 0; s < TB; ++s) {
    const int b = b0 + s;
    if (b < B) {
      const size_t base = ((size_t)b * 2 + c) * N + k0;
#pragma unroll
      for (int t = 0; t < KPT; ++t) out[base + t] = (int32_t)res[s][t];
    }
  }
}

size_t extprod_granted[rustfhe::limb::MAX_DEVICES];

}  // namespace

extern "C" {

// Every entry returns the cudaError_t of its launches (0 = launched); a
// shape the kernels do not take launches nothing and returns
// cudaErrorInvalidValue.  Buffers: acc, out (B, 2, N) words; a_tilde (B,);
// table (2L, 2, 4, 2N) int8, 4-byte aligned; digits (B, 2L, npad) int8 and
// panel (2L, 2, 4, rows, 128) int8, 16-byte aligned.

// K4: the limb panel, digits and merged product of one step.
int rustfhe_limb_cmux_step_merged(const void* acc, const void* a_tilde, const void* table,
                                  void* out, void* digits, void* panel, int B, int N, int l,
                                  int bgbit, unsigned int mask, void* stream) {
  return step<2>(acc, a_tilde, table, out, digits, panel, B, N, l, bgbit, mask, stream);
}

// K6: the same launches with the c-split product.
int rustfhe_limb_cmux_step_split(const void* acc, const void* a_tilde, const void* table,
                                 void* out, void* digits, void* panel, int B, int N, int l,
                                 int bgbit, unsigned int mask, void* stream) {
  return step<1>(acc, a_tilde, table, out, digits, panel, B, N, l, bgbit, mask, stream);
}

// The pieces that are not K1's, alone, for their checks: the limb panel,
// and K4's merged product with the add (K6's product is K1's).
int rustfhe_limb_panel(const void* table, void* panel, int N, int two_l, void* stream) {
  if (!shape_ok(1, N, two_l)) return (int)cudaErrorInvalidValue;
  return (int)launch_limb_panel(table, panel, N, two_l, (cudaStream_t)stream);
}

int rustfhe_limb_merged_product(const void* digits, const void* panel, const void* acc, void* out,
                                int B, int N, int two_l, void* stream) {
  if (!shape_ok(B, N, two_l)) return (int)cudaErrorInvalidValue;
  return (int)launch_product<true, 2>(digits, panel, acc, out, B, N, two_l,
                                      (cudaStream_t)stream);
}

// K5: digits (B, 2L, N) int8; table (2L, 2, 4, 2N) int8; out (B, 2, N) words.
int rustfhe_limb_external_product(const void* digits, const void* table, void* out, int B,
                                  int N, int l, void* stream) {
  const int two_l = 2 * l;
  const size_t smem = rustfhe::limb::smem_bytes(N, two_l, 1);
  const cudaError_t e = rustfhe::limb::prepare((const void*)limb_kernel, B, N, two_l, smem,
                                               extprod_granted);
  if (e != cudaSuccess) return (int)e;
  limb_kernel<<<dim3((B + rustfhe::limb::TB - 1) / rustfhe::limb::TB, 2), N / KPT, smem,
                (cudaStream_t)stream>>>((const int8_t*)digits, (const uint32_t*)table,
                                        (int32_t*)out, B, N, two_l);
  return (int)cudaGetLastError();
}

// The current device's opt-in limit of shared memory per block, in bytes.
int rustfhe_limb_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // extern "C"
