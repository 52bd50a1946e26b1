// Device code shared by the blind-rotation kernels: the digit build of one
// CMux step (the digit kernel of K1/K4/K6 and P5/P6 in cmux_step.cuh, K3 in
// rotate_all_k.cu, and the Karatsuba tree digits of karatsuba_probe.cu).
// All torus arithmetic is uint32_t (wrapping mod 2^32).

#pragma once

#include <cstdint>

namespace rustfhe {

// Coefficient i of X^a * poly (negacyclic, a in [0, 2N)), with the
// polynomial read through at(x) for x in [0, N).
template <class At>
__device__ __forceinline__ uint32_t rotated_coeff(At at, int i, int a, int N) {
  int k = i - a;
  if (k < 0) k += 2 * N;
  return k >= N ? 0u - at(k - N) : at(k);
}

// The rounded difference whose top l*bgbit bits are the l signed digits:
// u = ((X^a * acc - acc) + mask) ^ mask, with the reference's decomposition
// mask (params.decomp_mask).
__device__ __forceinline__ uint32_t rounded_diff(uint32_t rotated, uint32_t cur,
                                                 uint32_t mask) {
  return ((rotated - cur) + mask) ^ mask;
}

__device__ __forceinline__ int8_t digit(uint32_t u, int lv, int bgbit) {
  return (int8_t)((int32_t)(u << (bgbit * lv)) >> (32 - bgbit));
}

}  // namespace rustfhe
