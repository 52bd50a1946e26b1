// Device code shared by the blind-rotation kernels: the digit build of one
// CMux step (the digit kernel of K1/K4/K6 in cmux_step.cuh, K3 in
// rotate_all_k.cu, and the limb-form probes of limb_common.cuh) and K3's
// uint32 multiply-add of digits against a doubled key plane.
//
// Layouts of the multiply-add:
//   * a key plane is the doubled TRGSW row polynomial T = [-q, q] (2N words,
//     engine/plain.py prepare_trgsw), or a window of it, stored in shared
//     memory with one pad word after every eight (pad_idx) so that lanes
//     whose windows start eight words apart fall in different banks;
//   * digits are int8, dig[(j*N + i)*TB + s] for plane j = p*l + lv (input
//     half p, level lv), coefficient i and sample s of a tile of TB.
// All torus arithmetic is uint32_t (wrapping mod 2^32).

#pragma once

#include <cstdint>

namespace rustfhe {

constexpr int KPT = 8;  // consecutive output coefficients per thread

__device__ __forceinline__ int pad_idx(int y) { return y + (y >> 3); }

__host__ __device__ inline int padded_words(int w) { return w + w / 8; }

__device__ __forceinline__ int32_t sext8(uint32_t w, int byte) {
  return (int32_t)(w << (24 - 8 * byte)) >> 24;
}

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

// acc[s][t] += sum_i D[i][s] * T[k0 + t - i + N] over one plane, i in [0, N).
// T holds at least the words [k0, k0 + KPT - 1 + N] of the (local) plane.
template <int TB>
__device__ __forceinline__ void accumulate_plane(const uint32_t* T, const int8_t* D, int N,
                                                 int k0, uint32_t (&acc)[TB][KPT]) {
  // Sliding window: at digit index i, slot (t - i) & 7 holds T[k0 + t - i + N].
  uint32_t w[KPT];
#pragma unroll
  for (int t = 0; t < KPT; ++t) w[t] = T[pad_idx(k0 + t + N)];
  for (int i0 = 0; i0 < N; i0 += KPT) {
#pragma unroll
    for (int ii = 0; ii < KPT; ++ii) {
      const int i = i0 + ii;
      uint32_t d[TB];
      if constexpr (TB == 8) {
        const uint2 dd = *reinterpret_cast<const uint2*>(D + (size_t)i * TB);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          d[s] = (uint32_t)sext8(dd.x, s);
          d[s + 4] = (uint32_t)sext8(dd.y, s);
        }
      } else {
#pragma unroll
        for (int s = 0; s < TB; ++s) d[s] = (uint32_t)(int32_t)D[(size_t)i * TB + s];
      }
#pragma unroll
      for (int s = 0; s < TB; ++s) {
#pragma unroll
        for (int t = 0; t < KPT; ++t) acc[s][t] += d[s] * w[(t - ii) & (KPT - 1)];
      }
      // Next index i+1 needs T[k0 - i - 1 + N] for t = 0, in the slot that
      // held t = KPT-1 (no longer needed).  At i = N-1 this reads T[k0],
      // still inside the table, and is never used.
      w[(KPT - 1 - ii) & (KPT - 1)] = T[pad_idx(k0 - i - 1 + N)];
    }
  }
}

template <int TB>
__device__ __forceinline__ void zero(uint32_t (&acc)[TB][KPT]) {
#pragma unroll
  for (int s = 0; s < TB; ++s)
#pragma unroll
    for (int t = 0; t < KPT; ++t) acc[s][t] = 0u;
}

}  // namespace rustfhe
