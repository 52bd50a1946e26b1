// Blind-rotate CMux step (K1) and external product (K2) for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels on the gate-bootstrap path:
//   K1 rustfhe_tpu/engine/pallas_k.py:295  fused_cmux_step_k (body _kernel_step_k, :207)
//   K2 rustfhe_tpu/engine/pallas_k.py:506  fused_external_product_k (body _kernel_extprod_k, :459)
//
// Contract (the function, not the TPU's blocking):
//   K1: out = acc + ExtProd(bk_i, Decompose(X^{a~} * acc - acc))   bit for bit
//   K2: out = ExtProd(rows, digits)                                 bit for bit
// in the standard (B, 2, N) layout, all torus arithmetic in uint32_t
// (wrapping mod 2^32).  The key is the prepared TRGSW table of the step
// (engine/plain.py prepare_trgsw): per row j and output half c the doubled
// polynomial T = [-q, q] of 2N words, so that the negacyclic product is
//   out[c][k] = sum_j sum_i d_j[i] * T_jc[k - i + N].
//
// The step as one int8 GEMM.  With limb_t the balanced signed 8-bit limbs
// of a word (poly.to_signed_limbs; sum_t limb_t(w) << 8t = w mod 2^32):
//   P[b][(c, t, k)] = sum_j sum_i d[b][j][i] * limb_t(T_jc[k - i + N])
//   out[b][c][k]    = acc[b][c][k] + sum_t P[b][(c, t, k)] << 8t
// P is exact in int32: |P| <= 2L * Npad * 128 * 128 (2^26.6 at N=1024,
// l=3 with any int8 digits; the wrappers check the bound).
//
// What bounds it.  The step needs at least the two-level Karatsuba count,
// 2 x 2 x 4 x 2L x 9 x (N/4)^2 int8 operations per sample (0.117 ms at
// DEFAULT_PARAMS, B=4096, against the published 1,979 dense int8 TOP/s of
// the H100 SXM); the GEMM below executes the schoolbook count, 16/9 of it.
// The bytes (the accumulator in and out, the digits and the key panels,
// ~100 MB at B=4096) take 0.03 ms at 3.35 TB/s.  Only warpgroup MMA
// reaches the int8 rate, so a step is three launches:
//   1. key_panel_kernel: per plane j, half c and limb t, the K-major panel
//        Pt[x][r] = limb_t(T_jc[x - r]),  x in [x0, 2N), r in [0, 128),
//      zero for r >= N.  Row (c, t, k) of the GEMM's second operand over
//      the 128-byte K slice kb is panel row k + N - 128 kb: the circulant
//      is a sliding window of rows, and a TMA box of 64 rows at that row is
//      the key tile of 64 output coefficients (wgmma's core matrices and a
//      TMA map both need 16-byte rows, so the one-byte shift between rows
//      has to be written out).  11.25 MiB a step at DEFAULT_PARAMS, built
//      anew each step (all 635 steps' panels would take ~7 GiB);
//   2. step_digits_kernel: the digits of X^{a~} * acc - acc as int8
//      (B, 2L, Npad), Npad = N rounded up to 128, zeros past N
//      (cmux_common.cuh's rotated_coeff, rounded_diff and digit);
//   3. cmux_product_kernel: the GEMM on int8_gemm.cu's warp-specialised
//      mainloop (hopper_common.cuh): a producer warpgroup keeps a 4-stage
//      TMA ring full (one 128 x 128 B digit box and four 64 x 128 B panel
//      boxes, one per limb, a stage), two consumer warpgroups run wgmma
//      m64n256k32 .s32.s8.s8, a persistent grid walks the block tiles of
//      128 samples x (one half c, 4 limbs x 64 coefficients).  The
//      epilogue recombines the four limbs of each (b, k) in registers (the
//      fragment holds them at column blocks j, j+8, j+16, j+24), adds acc
//      and stores one word: 32 MiB out at B=4096, not 128 MiB of partials.
// K2 is the panel and the product without the add, on the caller's digits.
// The digit and panel buffers are the wrapper's (engine/cmux_k.py keeps
// them per thread across the steps of a rotation) and their TMA maps are
// cached here by address.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "cmux_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace rustfhe::hopper;

constexpr int LIMBS = 4;            // balanced signed 8-bit limbs of a key word
constexpr int COEFFS = 64;          // output coefficients of one limb in a block tile
constexpr int BM = 128;             // samples of a block tile: two consumer warpgroups
constexpr int BN = LIMBS * COEFFS;  // columns of a block tile, limb-major
constexpr int CONSUMERS = 2;
constexpr int A_STAGE = BM * DEPTH;
constexpr int B_STAGE = BN * DEPTH;
constexpr int SMEM = ALIGN + STAGES * (A_STAGE + B_STAGE) + 2 * STAGES * 8;
constexpr int MIN_N = 8, MAX_N = 2048;
constexpr int CHUNK = 16;  // panel bytes (one row, consecutive r) per thread
constexpr int THREADS = 256;  // of the panel and digit kernels

// The shapes of one step at N and 2L planes.
struct Geometry {
  int npad;    // bytes of digits of a plane: N rounded up to DEPTH
  int slices;  // DEPTH-byte K slices of a plane
  int x0;      // key offset of a panel's first row
  int rows;    // rows of one panel: [x0, 2N), at least one box of COEFFS
  __host__ __device__ explicit Geometry(int N) {
    npad = N < DEPTH ? DEPTH : N;
    slices = npad / DEPTH;
    x0 = N + DEPTH - npad;
    rows = 2 * N - x0 < COEFFS ? COEFFS : 2 * N - x0;
  }
};

// The four balanced limbs of w, limb t in byte t: adding 0x80 to every byte
// with carries and flipping the bytes' top bits gives b - 128 in each, the
// unique representation with digits in [-128, 128).
__device__ __forceinline__ uint32_t limbs_of(uint32_t w) {
  return (w + 0x80808080u) ^ 0x80808080u;
}

__device__ __forceinline__ uint32_t pack4(const uint32_t* L, int t) {
  const int sh = 8 * t;
  return ((L[0] >> sh) & 0xFFu) | (((L[1] >> sh) & 0xFFu) << 8) | (((L[2] >> sh) & 0xFFu) << 16) |
         (((L[3] >> sh) & 0xFFu) << 24);
}

// 1. key: (2L, 2, 2N) words; panel: (2L, 2, LIMBS, rows, DEPTH) int8.
// Thread: CHUNK bytes of one row x of the four limb panels of one (j, c).
__global__ void __launch_bounds__(THREADS)
key_panel_kernel(const int32_t* __restrict__ key, int8_t* __restrict__ panel, int N, int two_l) {
  const Geometry g(N);
  constexpr int chunks = DEPTH / CHUNK;
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= two_l * 2 * g.rows * chunks) return;
  const int r0 = idx % chunks * CHUNK;
  const int xl = idx / chunks % g.rows;
  const int jc = idx / (chunks * g.rows);  // j * 2 + c
  const int x = g.x0 + xl;
  const int32_t* T = key + (size_t)jc * 2 * N;
  uint32_t L[CHUNK];
#pragma unroll
  for (int m = 0; m < CHUNK; ++m) {
    const int r = r0 + m;
    L[m] = r < N && x < 2 * N ? limbs_of((uint32_t)T[x - r]) : 0u;  // x - r >= 1 here
  }
#pragma unroll
  for (int t = 0; t < LIMBS; ++t) {
    const uint4 v = make_uint4(pack4(L, t), pack4(L + 4, t), pack4(L + 8, t), pack4(L + 12, t));
    *reinterpret_cast<uint4*>(panel + ((size_t)(jc * LIMBS + t) * g.rows + xl) * DEPTH + r0) = v;
  }
}

// 2. acc: (B, 2, N) words; a_tilde: (B,) (reduced mod 2N here); digits:
// (B, 2L, npad) int8, plane p * l + lv.  Thread: four coefficients of one
// half of one sample, all l levels.
__global__ void __launch_bounds__(THREADS)
step_digits_kernel(const int32_t* __restrict__ acc, const int32_t* __restrict__ a_tilde,
                   int8_t* __restrict__ digits, int B, int N, int l, int bgbit, uint32_t mask) {
  const Geometry g(N);
  const int quads = g.npad / 4;
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= B * 2 * quads) return;
  const int q = idx % quads;
  const int p = idx / quads % 2;
  const int b = idx / (2 * quads);
  const int tn = 2 * N;
  int a = a_tilde[b] % tn;
  if (a < 0) a += tn;
  const int32_t* poly = acc + ((size_t)b * 2 + p) * N;
  const auto at = [poly](int x) { return (uint32_t)poly[x]; };
  uint32_t u[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = 4 * q + m;
    u[m] = i < N ? rustfhe::rounded_diff(rustfhe::rotated_coeff(at, i, a, N), at(i), mask) : 0u;
  }
  for (int lv = 0; lv < l; ++lv) {
    uint32_t word = 0u;
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (4 * q + m < N) word |= (uint32_t)(uint8_t)rustfhe::digit(u[m], lv, bgbit) << (8 * m);
    *reinterpret_cast<uint32_t*>(digits + ((size_t)b * 2 * l + p * l + lv) * g.npad + 4 * q) = word;
  }
}

// 3. tma_d: digits (B rows, 2L * npad bytes), boxes of (BM, DEPTH); tma_p:
// panels (2L * 2 * LIMBS * rows, DEPTH), boxes of (COEFFS, DEPTH).
// out = [acc_in +] the recombined product, (B, 2, N) words.
template <bool ADD>
__global__ void __launch_bounds__(Shape<CONSUMERS>::THREADS, 1)
cmux_product_kernel(const __grid_constant__ CUtensorMap tma_d,
                    const __grid_constant__ CUtensorMap tma_p, const int32_t* __restrict__ acc_in,
                    int32_t* __restrict__ out, int B, int N, int two_l) {
  using S = Shape<CONSUMERS>;
  const Geometry g(N);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  const uint32_t a_ring = base;
  const uint32_t b_ring = base + STAGES * A_STAGE;
  const uint32_t full = b_ring + STAGES * B_STAGE;  // STAGES barriers of 8 bytes
  const uint32_t empty = full + STAGES * 8;

  const int wg = threadIdx.x / WG;
  const int KT = two_l * g.slices;  // K slices of a tile: plane j, slice kb = ks / slices, % slices
  const int ctiles = (N + COEFFS - 1) / COEFFS;  // coefficient tiles of one half
  const int tiles_m = (B + BM - 1) / BM, tiles_n = 2 * ctiles;
  const int tiles = tiles_m * tiles_n;

  if (threadIdx.x == 0) ring_init(full, empty, CONSUMERS * WG / 32);
  __syncthreads();

  // The block walks the tiles blockIdx.x, + gridDim.x, ...; `it` counts the
  // stages it has passed through the ring over all its tiles (stage
  // it % STAGES in round it / STAGES), so a tile may start mid-round.
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      prefetch_map(&tma_d);
      prefetch_map(&tma_p);
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int tm, tn;
        tile_coords(tile, tiles_m, tiles_n, tm, tn);
        const int m0 = tm * BM, c = tn / ctiles, k0 = tn % ctiles * COEFFS;
        for (int ks = 0; ks < KT; ++ks, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, A_STAGE + B_STAGE);
          tma_load(a_ring + s * A_STAGE, &tma_d, full + 8 * s, ks * DEPTH, m0);
          const int j = ks / g.slices, kb = ks - j * g.slices;
          const int y = (j * 2 + c) * LIMBS * g.rows + k0 + N - kb * DEPTH - g.x0;
#pragma unroll
          for (int t = 0; t < LIMBS; ++t)
            tma_load(b_ring + s * B_STAGE + t * COEFFS * DEPTH, &tma_p, full + 8 * s, 0,
                     y + t * g.rows);
        }
      }
    }
  } else {
    // Consumers: warpgroup cw computes samples 64cw..64cw+63 of each tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::CONSUMER_REGS));
    const int cw = wg - 1;
    const int t = threadIdx.x % WG;
    const int w = t / 32, ln = t % 32;
    int32_t acc[BN / 2];  // set by each tile's first wgmma (scale 0)
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int tm, tn;
      tile_coords(tile, tiles_m, tiles_n, tm, tn);
      const int m0 = tm * BM, c = tn / ctiles, k0 = tn % ctiles * COEFFS;
      for (int ks = 0; ks < KT; ++ks, ++it) {
        const int s = it % STAGES;
        mbar_wait(full + 8 * s, (it / STAGES) & 1);
        __syncwarp();  // the warp converges before the .aligned wgmma instructions
        const uint32_t a_s = a_ring + s * A_STAGE + cw * 64 * DEPTH;
        const uint32_t b_s = b_ring + s * B_STAGE;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DEPTH / KSTEP; ++kk)
          Wgmma<BN>::mma(acc, smem_desc(a_s + kk * KSTEP), smem_desc(b_s + kk * KSTEP),
                         (ks | kk) != 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products have retired
        fence_acc(acc);
        if (ks > 0 && ln == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (ln == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));

      // Column block j + 8t of the fragment is limb t of coefficients
      // k0 + 8j + 2(ln % 4), +1: acc[4j + e + 32t] (e: 0, 1 at row r, 2, 3
      // at row r + 8).  Recombine, add, store one int2 per (row, j).
      const int kq = k0 + 2 * (ln % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = m0 + cw * 64 + w * 16 + ln / 4 + 8 * h;
        if (b >= B) continue;
        const size_t row = ((size_t)b * 2 + c) * N + kq;
#pragma unroll
        for (int j = 0; j < COEFFS / 8; ++j) {
          if (kq + 8 * j >= N) continue;
          const int e = 4 * j + 2 * h;
          uint32_t v0 = 0u, v1 = 0u;
#pragma unroll
          for (int lt = 0; lt < LIMBS; ++lt) {
            v0 += (uint32_t)acc[e + 32 * lt] << (8 * lt);
            v1 += (uint32_t)acc[e + 1 + 32 * lt] << (8 * lt);
          }
          if (ADD) {
            const int2 a = *reinterpret_cast<const int2*>(acc_in + row + 8 * j);
            v0 += (uint32_t)a.x;
            v1 += (uint32_t)a.y;
          }
          *reinterpret_cast<int2*>(out + row + 8 * j) = make_int2((int32_t)v0, (int32_t)v1);
        }
      }
    }
  }
}

// Shapes the kernels take: B >= 1; N a power of two in [MIN_N, MAX_N]; the
// int32 sums exact for any int8 digits.
bool shape_ok(int B, int N, int two_l) {
  if (B < 1 || N < MIN_N || N > MAX_N || (N & (N - 1)) || two_l < 1) return false;
  return (long long)two_l * Geometry(N).npad * 128 * 128 < (1ll << 31);
}

cudaError_t launch_panel(const void* key, void* panel, int N, int two_l, cudaStream_t stream) {
  if ((uintptr_t)panel % 16) return cudaErrorMisalignedAddress;
  const int threads = two_l * 2 * Geometry(N).rows * (DEPTH / CHUNK);
  key_panel_kernel<<<(threads + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      (const int32_t*)key, (int8_t*)panel, N, two_l);
  return cudaGetLastError();
}

cudaError_t launch_digits(const void* acc, const void* a_tilde, void* digits, int B, int N, int l,
                          int bgbit, unsigned int mask, cudaStream_t stream) {
  if ((uintptr_t)digits % 16) return cudaErrorMisalignedAddress;
  const int threads = B * 2 * (Geometry(N).npad / 4);
  step_digits_kernel<<<(threads + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      (const int32_t*)acc, (const int32_t*)a_tilde, (int8_t*)digits, B, N, l, bgbit,
      (uint32_t)mask);
  return cudaGetLastError();
}

MapCache maps;  // the TMA maps of the digit and panel buffers

template <bool ADD>
cudaError_t launch_product(const void* digits, const void* panel, const void* acc_in, void* out,
                           int B, int N, int two_l, cudaStream_t stream) {
  static bool ready[MAX_DEVICES];
  if ((uintptr_t)digits % 16 || (uintptr_t)panel % 16 || (uintptr_t)acc_in % 8 ||
      (uintptr_t)out % 8)
    return cudaErrorMisalignedAddress;
  const auto kernel = cmux_product_kernel<ADD>;
  int sms = 0;
  cudaError_t e = prepare_kernel((const void*)kernel, SMEM, Shape<CONSUMERS>::LAUNCH_REGS, ready,
                                 &sms);
  if (e != cudaSuccess) return e;
  const Geometry g(N);
  CUtensorMap map_d, map_p;
  if (!maps.get(&map_d, digits, B, two_l * g.npad, BM) ||
      !maps.get(&map_p, panel, two_l * 2 * LIMBS * g.rows, DEPTH, COEFFS))
    return cudaErrorInvalidValue;
  const int tiles = (B + BM - 1) / BM * 2 * ((N + COEFFS - 1) / COEFFS);
  kernel<<<tiles < sms ? tiles : sms, Shape<CONSUMERS>::THREADS, SMEM, stream>>>(
      map_d, map_p, (const int32_t*)acc_in, (int32_t*)out, B, N, two_l);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry returns the cudaError_t of its launches (0 = launched); a
// shape the kernels do not take launches nothing and returns
// cudaErrorInvalidValue.  Buffers: key (2L, 2, 2N) words; panel (2L, 2, 4,
// rows, 128) int8; digits (B, 2L, npad) int8; acc, out (B, 2, N) words; all
// 16-byte aligned where a kernel reads them by TMA or writes them by vector.

// K1: the three launches of one step, into the caller's digit and panel buffers.
int rustfhe_cmux_step_k(const void* acc, const void* a_tilde, const void* key, void* out,
                        void* digits, void* panel, int B, int N, int l, int bgbit,
                        unsigned int mask, void* stream) {
  if (!shape_ok(B, N, 2 * l)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = launch_panel(key, panel, N, 2 * l, st);
  if (e == cudaSuccess) e = launch_digits(acc, a_tilde, digits, B, N, l, bgbit, mask, st);
  if (e == cudaSuccess) e = launch_product<true>(digits, panel, acc, out, B, N, 2 * l, st);
  return (int)e;
}

// K2: the panel, then the product of the caller's digits without the add.
int rustfhe_external_product_k(const void* digits, const void* key, void* out, void* panel, int B,
                               int N, int two_l, void* stream) {
  if (!shape_ok(B, N, two_l)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = launch_panel(key, panel, N, two_l, st);
  if (e == cudaSuccess) e = launch_product<false>(digits, panel, nullptr, out, B, N, two_l, st);
  return (int)e;
}

// The pieces alone, for their checks and times.
int rustfhe_key_panel(const void* key, void* panel, int N, int two_l, void* stream) {
  if (!shape_ok(1, N, two_l)) return (int)cudaErrorInvalidValue;
  return (int)launch_panel(key, panel, N, two_l, (cudaStream_t)stream);
}

int rustfhe_step_digits(const void* acc, const void* a_tilde, void* digits, int B, int N, int l,
                        int bgbit, unsigned int mask, void* stream) {
  if (!shape_ok(B, N, 2 * l)) return (int)cudaErrorInvalidValue;
  return (int)launch_digits(acc, a_tilde, digits, B, N, l, bgbit, mask, (cudaStream_t)stream);
}

int rustfhe_panel_product(const void* digits, const void* panel, const void* acc, void* out, int B,
                          int N, int two_l, void* stream) {
  if (!shape_ok(B, N, two_l)) return (int)cudaErrorInvalidValue;
  return (int)launch_product<true>(digits, panel, acc, out, B, N, two_l, (cudaStream_t)stream);
}

const char* rustfhe_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
