// Measurement variants of the limb CMux step for Hopper (sm_90a): K4's and
// K6's tensor-core step with one part changed.
//
// Replaces the two Pallas TPU probe kernels that ablate the limb step:
//   P6 benches/step_breakdown_probe.py:134  make_variant.step (body variant_kernel, :80)
//   P5 benches/limb_order_probe.py:85       make_step.step (body kernel, :33)
//
// A limb step is K4's or K6's three launches (limb_step.cu): the limb panel
// (limb_panel_kernel<1>), the digits (step_digits_kernel<true>) and the
// int8 wgmma GEMM with the limb recombination and the add of acc in its
// epilogue (cmux_product_kernel, all in cmux_step.cuh).  Each variant
// changes one of them, so that the differences between their times split
// the step that the limb engine runs (ncu does not run where the card is).
// Contract, bit for bit:
//   P6 "full"   K6's kernels, the product <true, 1>:
//      acc + ExtProd(key, Decompose(X^{a~} * acc - acc));
//   P6 "norot"  step_digits_kernel<false>, the digits of acc itself (no
//      rotation, no difference), then K6's product:
//      acc + ExtProd(key, Decompose(acc));
//   P6 "nodots" the product replaced by nodots_kernel: for every plane j
//      and limb k the part sum_mb d_j[mb * tm], one digit per block of tm
//      coefficients, the same for all N outputs (the TPU probe's broadcast
//      add, tm = its panel depth), recombined: out[c] = acc[c] + sum_j
//      sum_k (uint32) part << 8k;
//   P5 "limb-outer"  K4's kernels, the product <true, 2>: the fragment sums
//      all 2L planes per (half, limb) and the limbs recombine once;
//   P5 "j-outer"     K4's kernels with the product <true, 2, Drain>: the
//      fragment drains into the uint32 recombination after each plane's K
//      slices, 2L drains in place of one.  Both equal K4.
//
// What bounds them: K4's and K6's step, the int8 operations of its GEMM
// (the schoolbook count, 2 x 2 x 4 x 2L x N^2 a sample) on the tensor
// cores, minus what a variant drops; the bytes of nodots (the accumulator
// in and out, the digits) bound it.  The design adds nothing of its own:
// each variant reuses the step's kernels, and its extra code (the norot
// digits, the drain, nodots_kernel) is the part it measures.

#include <cstdint>
#include <cuda_runtime.h>

#include "cmux_step.cuh"
#include "error_string.cuh"

namespace {

using namespace rustfhe::cmux;

// P6 nodots: out (B, 2, N) = acc + S_b * 0x01010101 (mod 2^32), S_b =
// sum_j sum_mb digits[b, j, mb tm] over the digits (B, 2L, npad).  Block:
// sample b.  Its threads sum the 2L N / tm digits into shared memory, then
// add S_b to the sample's 2N words, four a thread at a time.
__global__ void __launch_bounds__(THREADS)
nodots_kernel(const int32_t* __restrict__ acc, const int8_t* __restrict__ digits,
              int32_t* __restrict__ out, int N, int two_l, int tm) {
  __shared__ int32_t sum;
  const int b = blockIdx.x;
  const int npad = Geometry(N).npad, per_plane = N / tm;
  if (threadIdx.x == 0) sum = 0;
  __syncthreads();
  int32_t s = 0;
  for (int i = threadIdx.x; i < two_l * per_plane; i += THREADS)
    s += digits[((size_t)b * two_l + i / per_plane) * npad + i % per_plane * tm];
  if (s != 0) atomicAdd(&sum, s);
  __syncthreads();
  const uint32_t add = (uint32_t)sum * 0x01010101u;
  const int4* in = reinterpret_cast<const int4*>(acc + (size_t)b * 2 * N);
  int4* dst = reinterpret_cast<int4*>(out + (size_t)b * 2 * N);
  for (int q = threadIdx.x; q < 2 * N / 4; q += THREADS) {
    const int4 v = in[q];
    dst[q] = make_int4((int32_t)((uint32_t)v.x + add), (int32_t)((uint32_t)v.y + add),
                       (int32_t)((uint32_t)v.z + add), (int32_t)((uint32_t)v.w + add));
  }
}

cudaError_t launch_nodots(const void* acc, const void* digits, void* out, int B, int N,
                          int two_l, int tm, cudaStream_t stream) {
  if (tm < 1 || N % tm != 0) return cudaErrorInvalidValue;
  if ((uintptr_t)acc % 16 || (uintptr_t)out % 16) return cudaErrorMisalignedAddress;
  nodots_kernel<<<B, THREADS, 0, stream>>>((const int32_t*)acc, (const int8_t*)digits,
                                           (int32_t*)out, N, two_l, tm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry returns the cudaError_t of its launches (0 = launched); a
// shape the kernels do not take launches nothing and returns
// cudaErrorInvalidValue.  Operands as K4/K6 (limb_step.cu): acc, out (B,
// 2, N) words; a_tilde (B,) in [0, 2N); table (2L, 2, 4, 2N) int8, 4-byte
// aligned; digits (B, 2L, npad) int8 and panel (2L, 2, 4, rows, 128) int8,
// 16-byte aligned, the caller's buffers.

// P6, K6's tile: (rotate, dots) = (1, 1) "full", (1, 0) "nodots" (tm: the
// coefficients per summed digit), (0, 1) "norot".
int rustfhe_limb_probe_variant(const void* acc, const void* a_tilde, const void* table,
                               void* out, void* digits, void* panel, int B, int N, int l,
                               int bgbit, unsigned int mask, int rotate, int dots, int tm,
                               void* stream) {
  if (!shape_ok(B, N, 2 * l) || !(rotate || dots)) return (int)cudaErrorInvalidValue;
  if (!dots && (tm < 1 || N % tm != 0)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = launch_limb_panel(table, panel, N, 2 * l, st);
  if (e == cudaSuccess)
    e = rotate ? launch_digits<true>(acc, a_tilde, digits, B, N, l, bgbit, mask, st)
               : launch_digits<false>(acc, a_tilde, digits, B, N, l, bgbit, mask, st);
  if (e == cudaSuccess)
    e = dots ? launch_product<true, 1>(digits, panel, acc, out, B, N, 2 * l, st)
             : launch_nodots(acc, digits, out, B, N, 2 * l, tm, st);
  return (int)e;
}

// P5, K4's tile: j_outer 0 (limb-outer, K4's product) or 1 (a drain per plane).
int rustfhe_limb_probe_order(const void* acc, const void* a_tilde, const void* table, void* out,
                             void* digits, void* panel, int B, int N, int l, int bgbit,
                             unsigned int mask, int j_outer, void* stream) {
  if (!shape_ok(B, N, 2 * l)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = launch_limb_panel(table, panel, N, 2 * l, st);
  if (e == cudaSuccess) e = launch_digits<true>(acc, a_tilde, digits, B, N, l, bgbit, mask, st);
  if (e == cudaSuccess)
    e = j_outer ? launch_product<true, 2, Drain>(digits, panel, acc, out, B, N, 2 * l, st)
                : launch_product<true, 2>(digits, panel, acc, out, B, N, 2 * l, st);
  return (int)e;
}

// The pieces that are the probes' own, alone, for their checks and times:
// the digits without rotation, P5's product with a drain per plane, and
// P6's nodots kernel.
int rustfhe_limb_probe_digits_norot(const void* acc, void* digits, int B, int N, int l, int bgbit,
                                    unsigned int mask, void* stream) {
  if (!shape_ok(B, N, 2 * l)) return (int)cudaErrorInvalidValue;
  return (int)launch_digits<false>(acc, acc, digits, B, N, l, bgbit, mask, (cudaStream_t)stream);
}

int rustfhe_limb_probe_drain_product(const void* digits, const void* panel, const void* acc,
                                     void* out, int B, int N, int two_l, void* stream) {
  if (!shape_ok(B, N, two_l)) return (int)cudaErrorInvalidValue;
  return (int)launch_product<true, 2, Drain>(digits, panel, acc, out, B, N, two_l,
                                             (cudaStream_t)stream);
}

int rustfhe_limb_probe_nodots(const void* acc, const void* digits, void* out, int B, int N,
                              int two_l, int tm, void* stream) {
  if (!shape_ok(B, N, two_l)) return (int)cudaErrorInvalidValue;
  return (int)launch_nodots(acc, digits, out, B, N, two_l, tm, (cudaStream_t)stream);
}

}  // extern "C"
