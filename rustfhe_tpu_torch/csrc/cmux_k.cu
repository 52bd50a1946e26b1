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
//      (B, 2L, Npad), Npad = N rounded up to 128, zeros past N;
//   3. cmux_product_kernel<true, 1>: the GEMM on int8_gemm.cu's
//      warp-specialised mainloop (hopper_common.cuh): a producer warpgroup
//      keeps a 4-stage TMA ring full (one 128 x 128 B digit box and four
//      64 x 128 B panel boxes, one per limb, a stage), two consumer
//      warpgroups run wgmma m64n256k32 .s32.s8.s8, a persistent grid walks
//      the block tiles of 128 samples x (one half c, 4 limbs x 64
//      coefficients).  The epilogue recombines the four limbs of each (b,
//      k) in registers (the fragment holds them at column blocks j, j+8,
//      j+16, j+24), adds acc and stores one word: 32 MiB out at B=4096,
//      not 128 MiB of partials.
// The digit and product kernels are cmux_step.cuh's, shared with the limb
// engine's steps K4/K6 (limb_step.cu), which cut the same panels from the
// int8 limb table.
// K2 is the panel and the product without the add, on the caller's digits.
// The digit and panel buffers are the wrapper's (engine/cmux_k.py keeps
// them per thread across the steps of a rotation) and their TMA maps are
// cached here by address.  rustfhe_cmux_rotate_k issues a whole rotation's
// steps from one host call, the three launches a step in a C loop; a single
// step is a rotation of one.
//
// Wide batches take the same step on the two-level Karatsuba product
// (karatsuba_step.cuh: 9/16 of the multiply-adds in nine leaf GEMMs on
// K1's tile, the leaves written out and combined by a fourth launch), word
// for word the step above: rustfhe_cmux_rotate_karatsuba issues its
// rotation the same way, each step's leaf panels cut from the key's leaf
// table (engine/cmux_k.py leaf_table, prepared once).

#include <cstdint>
#include <cuda_runtime.h>

#include "cmux_step.cuh"
#include "error_string.cuh"
#include "karatsuba_step.cuh"

namespace {

using namespace rustfhe::cmux;

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

cudaError_t launch_panel(const void* key, void* panel, int N, int two_l, cudaStream_t stream) {
  if ((uintptr_t)panel % 16) return cudaErrorMisalignedAddress;
  const int threads = two_l * 2 * Geometry(N).rows * (DEPTH / CHUNK);
  key_panel_kernel<<<blocks(threads), THREADS, 0, stream>>>((const int32_t*)key, (int8_t*)panel,
                                                            N, two_l);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry returns the cudaError_t of its launches (0 = launched); a
// shape the kernels do not take launches nothing and returns
// cudaErrorInvalidValue.  Buffers: key (2L, 2, 2N) words; panel (2L, 2, 4,
// rows, 128) int8; digits (B, 2L, npad) int8; acc, out (B, 2, N) words; all
// 16-byte aligned where a kernel reads them by TMA or writes them by vector.

// K1: a whole rotation of n steps, each the three launches above (key_panel_kernel,
// step_digits_kernel, cmux_product_kernel<true, 1>) on `stream`, from one host call; a single
// step is a rotation of one.  a_steps (n, B) int32, row i the rotations of step i; key (n, 2L,
// 2, 2N) words, step i at i 2L 2 2N.  Step i reads accumulator i % 2 and writes the other, acc
// being 0 and acc2 1 (same shape), so acc2 is written and, from n = 2 on, acc too; *result says
// which holds the rotation's output (n % 2).  The product's TMA maps and grid are fetched once,
// the digit and panel buffers being the same for every step.  On an error *failed_step is the
// step whose launch failed (-1: none launched, the shape or the plan), and the steps after it
// are not launched.
int rustfhe_cmux_rotate_k(void* acc, const void* a_steps, const void* key, void* acc2,
                          void* digits, void* panel, int n, int B, int N, int l, int bgbit,
                          unsigned int mask, int* failed_step, int* result, void* stream) {
  *failed_step = -1;
  *result = n % 2;
  if (n < 1 || !shape_ok(B, N, 2 * l)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  ProductPlan plan;
  cudaError_t e = plan_product<true, 1>(&plan, digits, panel, B, N, 2 * l);
  if (e != cudaSuccess) return (int)e;
  void* bufs[2] = {acc, acc2};
  const size_t key_words = (size_t)2 * l * 2 * 2 * N;
  for (int i = 0; i < n; ++i) {
    const void* in = bufs[i % 2];
    const int32_t* a_i = (const int32_t*)a_steps + (size_t)i * B;
    e = launch_panel((const int32_t*)key + i * key_words, panel, N, 2 * l, st);
    if (e == cudaSuccess) e = launch_digits(in, a_i, digits, B, N, l, bgbit, mask, st);
    if (e == cudaSuccess)
      e = launch_planned<true, 1>(plan, digits, in, bufs[(i + 1) % 2], B, N, 2 * l, st);
    if (e != cudaSuccess) {
      *failed_step = i;
      return (int)e;
    }
  }
  return (int)cudaSuccess;
}

// K1 on the Karatsuba product: a whole rotation of n steps, each karatsuba_step.cuh's four
// launches on `stream`, from one host call, as rustfhe_cmux_rotate_k issues them.  table (n, 2,
// 9, 4, 2L, N/2) int8, step i's leaf table at i 72 l N bytes; digits (B, 9, 2L, npad) int8,
// panel (9, 2L, 2, 4, rows, 128) int8, npad and rows those of ns = N/4, and leaves (B, 9, 2,
// N/4) words.  acc, acc2, a_steps, failed_step and result as rustfhe_cmux_rotate_k has them.
int rustfhe_cmux_rotate_karatsuba(void* acc, const void* a_steps, const void* table, void* acc2,
                                  void* digits, void* panel, void* leaves, int n, int B, int N,
                                  int l, int bgbit, unsigned int mask, int* failed_step,
                                  int* result, void* stream) {
  namespace kara = rustfhe::karatsuba;
  *failed_step = -1;
  *result = n % 2;
  if (n < 1 || !kara::step_shape_ok(B, N, l, bgbit)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  ProductPlan plan;
  cudaError_t e = kara::plan_product(&plan, digits, panel, B, N, l);
  if (e != cudaSuccess) return (int)e;
  void* bufs[2] = {acc, acc2};
  for (int i = 0; i < n; ++i) {
    e = kara::launch_step(plan, bufs[i % 2], (const int32_t*)a_steps + (size_t)i * B,
                          (const int8_t*)table + i * kara::table_bytes(N, l), bufs[(i + 1) % 2],
                          digits, panel, leaves, B, N, l, bgbit, mask, st);
    if (e != cudaSuccess) {
      *failed_step = i;
      return (int)e;
    }
  }
  return (int)cudaSuccess;
}

// K1 on the caller's prebuilt panel (a hybrid key's step, keys.cloud_key_hybrid): the digits
// and the product, without key_panel_kernel.  The JAX package fuses a hybrid key's pair of steps
// into one launch (cmux_step_pair, pallas_k.py:721); here the odd step's digits read the whole
// accumulator that the even step's product tiles write across blocks, so fusing would need a
// grid-wide barrier to save one accumulator round trip, and a pair stays two calls.
int rustfhe_cmux_step_panel(const void* acc, const void* a_tilde, const void* panel, void* out,
                            void* digits, int B, int N, int l, int bgbit, unsigned int mask,
                            void* stream) {
  if (!shape_ok(B, N, 2 * l)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = launch_digits(acc, a_tilde, digits, B, N, l, bgbit, mask, st);
  if (e == cudaSuccess) e = launch_product<true, 1>(digits, panel, acc, out, B, N, 2 * l, st);
  return (int)e;
}

// K2: the panel, then the product of the caller's digits without the add.
int rustfhe_external_product_k(const void* digits, const void* key, void* out, void* panel, int B,
                               int N, int two_l, void* stream) {
  if (!shape_ok(B, N, two_l)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = launch_panel(key, panel, N, two_l, st);
  if (e == cudaSuccess) e = launch_product<false, 1>(digits, panel, nullptr, out, B, N, two_l, st);
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
  return (int)launch_product<true, 1>(digits, panel, acc, out, B, N, two_l, (cudaStream_t)stream);
}

// The Karatsuba step's combine: out = acc + the tree combine of leaves (B, 9, 2, N/4) words.
int rustfhe_leaf_combine(const void* acc, const void* leaves, void* out, int B, int N, int l,
                         int bgbit, void* stream) {
  namespace kara = rustfhe::karatsuba;
  if (!kara::step_shape_ok(B, N, l, bgbit)) return (int)cudaErrorInvalidValue;
  return (int)kara::launch_leaf_combine(acc, leaves, out, B, N, (cudaStream_t)stream);
}

}  // extern "C"
