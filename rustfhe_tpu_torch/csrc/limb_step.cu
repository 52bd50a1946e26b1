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
//   1. limb_panel_kernel<1> (cmux_step.cuh): per plane j, half c and limb
//      t, the K-major panel
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
// K5 is to K4/K6 what K2 is to K1: the limb panel and the product
// without the add, on the caller's digits (B, 2L, N) int8, fed to TMA as
// they are (N a multiple of DEPTH; the wrapper pads smaller N).  No digit
// kernel.  Its tile is K1's and K6's (<false, 1>): K4's two-half tile
// timed the same within the spread at FAST_PARAMS, B=4096 (PERF.md).  It
// takes every shape K4/K6 take.

#include <cstdint>
#include <cuda_runtime.h>

#include "cmux_step.cuh"
#include "error_string.cuh"

namespace {

using namespace rustfhe::cmux;

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

// K5: the limb panel, then the product of the caller's digits without
// the add, in K1's tile.  digits (B, 2L, npad) int8; table (2L, 2, 4, 2N)
// int8; out (B, 2, N) words; panel as above.
int rustfhe_limb_external_product(const void* digits, const void* table, void* out, void* panel,
                                  int B, int N, int two_l, void* stream) {
  if (!shape_ok(B, N, two_l)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = launch_limb_panel(table, panel, N, two_l, st);
  if (e == cudaSuccess) e = launch_product<false, 1>(digits, panel, nullptr, out, B, N, two_l, st);
  return (int)e;
}

// The current device's opt-in limit of shared memory per block, in bytes.
int rustfhe_limb_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // extern "C"
