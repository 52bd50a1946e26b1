// Measurement variants of the limb CMux step for Hopper (sm_90a).
//
// Replaces the two Pallas TPU probe kernels that ablate the limb step:
//   P6 benches/step_breakdown_probe.py:134  make_variant.step (body variant_kernel, :80)
//   P5 benches/limb_order_probe.py:85       make_step.step (body kernel, :33)
//
// Both keep the __dp4a form of the limb step that K4/K6 had before they
// became an int8 wgmma GEMM (limb_step.cu): the limb table in shared
// memory, the digits built in the block, with one part changed, so that the
// step's time can be split by ablation (ncu does not run where the card
// is).  The probes are held to the wgmma K4/K6 word for word.  Contract,
// bit for bit:
//   P6 "full"   (ROTATE, DOTS):  acc + ExtProd(key, Decompose(X^{a~} * acc - acc)), = K6;
//   P6 "norot"  (!ROTATE, DOTS): acc + ExtProd(key, Decompose(acc)): the digits are
//      built from acc itself, the rotation and difference are skipped;
//   P6 "nodots" (ROTATE, !DOTS): no products.  For every plane j and limb k
//      the partial sum is part = sum_mb d_j[mb * tm], one digit per block of
//      tm coefficients, the same for all N outputs (the TPU probe's
//      broadcast add, tm = its panel depth), recombined as usual:
//      out[c] = acc[c] + sum_j sum_k (uint32) part << 8k;
//   P5 (HALVES = 2, = K4): J_OUTER false sums the products of all 2L planes
//      per (half, limb) and recombines once (K4's limb-outer order); J_OUTER
//      true recombines (uint32) part << 8k after each plane j.  Both equal K4.
// The shared code (table and digit layouts, digit build, product loop) is
// limb_common.cuh, which K4-K6 compiled in their __dp4a forms.
//
// What bounds it: the integer issue of __dp4a, minus what a variant drops.
// Its design does nothing of its own: each variant is the __dp4a step with
// one part removed or reordered, so the differences between their times
// are the parts' costs in that form.

#include <cstdint>
#include <cuda_runtime.h>

#include "limb_common.cuh"

namespace {

using rustfhe::KPT;
using namespace rustfhe::limb;

template <bool ROTATE, bool DOTS, bool J_OUTER, int HALVES>
__global__ void __launch_bounds__(MAX_THREADS)
probe_kernel(const int32_t* __restrict__ acc_in, const int32_t* __restrict__ a_tilde,
             const uint32_t* __restrict__ table, int32_t* __restrict__ out, int B, int N, int l,
             int bgbit, uint32_t mask, int tm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int two_l = 2 * l;
  const int c0 = HALVES == 2 ? 0 : (int)blockIdx.y;
  const int b0 = blockIdx.x * TB;
  uint32_t* tab_s = reinterpret_cast<uint32_t*>(smem);
  int8_t* dig_s = reinterpret_cast<int8_t*>(smem + table_bytes(N, two_l, HALVES));

  load_table(tab_s, table, c0, HALVES, two_l, N);
  build_step_digits<ROTATE>(dig_s, acc_in, a_tilde, B, b0, N, l, bgbit, mask);
  __syncthreads();

  const int k0 = threadIdx.x * KPT;
  const uint32_t* dig_w = reinterpret_cast<const uint32_t*>(dig_s);
  const int pw = N / 2;
  const int plane_words = two_l * pw;
  // nodots: per sample, the sum over planes j and blocks mb of d_j[mb * tm].
  int32_t flat[TB];
  if constexpr (!DOTS) {
#pragma unroll
    for (int s = 0; s < TB; ++s) {
      flat[s] = 0;
      for (int j = 0; j < two_l; ++j)
        for (int i = 0; i < N; i += tm) flat[s] += dig_s[digit_byte(j, i, s, N)];
    }
  }
  for (int h = 0; h < HALVES; ++h) {
    const int c = c0 + h;
    uint32_t res[TB][KPT];
#pragma unroll
    for (int s = 0; s < TB; ++s)
#pragma unroll
      for (int t = 0; t < KPT; ++t) res[s][t] = 0u;
    const int planes = (DOTS && J_OUTER) ? two_l : 1;
    for (int j = 0; j < planes; ++j) {
      for (int k = 0; k < NUM_LIMBS; ++k) {
        int32_t part[TB][KPT];
#pragma unroll
        for (int s = 0; s < TB; ++s)
#pragma unroll
          for (int t = 0; t < KPT; ++t) part[s][t] = DOTS ? 0 : flat[s];
        if constexpr (DOTS) {
          const uint32_t* tab_hk = tab_s + (size_t)(h * NUM_LIMBS + k) * plane_words;
          if constexpr (J_OUTER)  // plane j alone
            limb_products(tab_hk + (size_t)j * pw, dig_w + (size_t)j * (N / 4) * TB, 1, N, k0,
                          part);
          else  // all 2L planes, then one recombination
            limb_products(tab_hk, dig_w, two_l, N, k0, part);
        }
#pragma unroll
        for (int s = 0; s < TB; ++s)
#pragma unroll
          for (int t = 0; t < KPT; ++t) res[s][t] += (uint32_t)part[s][t] << (LIMB_BITS * k);
      }
    }
#pragma unroll
    for (int s = 0; s < TB; ++s) {
      const int b = b0 + s;
      if (b < B) {
        const size_t base = ((size_t)b * 2 + c) * N + k0;
#pragma unroll
        for (int t = 0; t < KPT; ++t)
          out[base + t] = (int32_t)((uint32_t)acc_in[base + t] + res[s][t]);
      }
    }
  }
}

template <bool ROTATE, bool DOTS, bool J_OUTER, int HALVES>
int launch(const void* acc, const void* a_tilde, const void* table, void* out, int B, int N,
           int l, int bgbit, unsigned int mask, int tm, void* stream) {
  static size_t granted[MAX_DEVICES];
  if (tm < 1 || N % tm != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(N, 2 * l, HALVES);
  const cudaError_t e = prepare((const void*)probe_kernel<ROTATE, DOTS, J_OUTER, HALVES>, B, N,
                                2 * l, smem, granted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + TB - 1) / TB, 2 / HALVES);
  probe_kernel<ROTATE, DOTS, J_OUTER, HALVES><<<grid, N / KPT, smem, (cudaStream_t)stream>>>(
      (const int32_t*)acc, (const int32_t*)a_tilde, (const uint32_t*)table, (int32_t*)out, B, N,
      l, bgbit, (uint32_t)mask, tm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry returns the cudaError_t of its launch (0 = launched).
// Operands as K4/K6: acc, out (B, 2, N) words; a_tilde (B,) in [0, 2N);
// table (2L, 2, 4, 2N) int8.

// P6, one output half per block as K6: (rotate, dots) = (1, 1) "full",
// (1, 0) "nodots" (tm: the coefficients per summed digit), (0, 1) "norot".
int rustfhe_limb_probe_variant(const void* acc, const void* a_tilde, const void* table,
                               void* out, int B, int N, int l, int bgbit, unsigned int mask,
                               int rotate, int dots, int tm, void* stream) {
  if (rotate && dots)
    return launch<true, true, false, 1>(acc, a_tilde, table, out, B, N, l, bgbit, mask, tm,
                                        stream);
  if (rotate)
    return launch<true, false, false, 1>(acc, a_tilde, table, out, B, N, l, bgbit, mask, tm,
                                         stream);
  if (dots)
    return launch<false, true, false, 1>(acc, a_tilde, table, out, B, N, l, bgbit, mask, tm,
                                         stream);
  return (int)cudaErrorInvalidValue;
}

// P5, both output halves per block as K4: j_outer 0 (limb-outer) or 1.
int rustfhe_limb_probe_order(const void* acc, const void* a_tilde, const void* table, void* out,
                             int B, int N, int l, int bgbit, unsigned int mask, int j_outer,
                             void* stream) {
  if (j_outer)
    return launch<true, true, true, 2>(acc, a_tilde, table, out, B, N, l, bgbit, mask, 1,
                                       stream);
  return launch<true, true, false, 2>(acc, a_tilde, table, out, B, N, l, bgbit, mask, 1, stream);
}

}  // extern "C"
