// Device and host code shared by the limb-form __dp4a kernels: the limb
// step's measurement variants P5/P6 (limb_probe.cu) and, with N the leaf
// size, the Karatsuba step (karatsuba_probe.cu).
//
// Layouts:
//   * the step's limb table is (2L, 2, K, 2N) int8 in device memory
//     (engine/plain.py prepare_trgsw_limbs), read as words; a block copies
//     the planes of the output halves it computes into shared memory,
//     byte-reversed (load_table), so that the four key bytes a group of
//     four consecutive digits meets are four consecutive bytes;
//   * the tile's digits are int8 in shared memory, byte i % 4 of the word
//     dig[(j * N/4 + i/4) * TB + s] for plane j, coefficient i, sample s
//     (digit_byte), so one uint4 load gives four samples' digit words.
// All torus arithmetic is uint32_t (wrapping mod 2^32).

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "cmux_common.cuh"

namespace rustfhe {
namespace limb {

constexpr int TB = 8;  // samples per block
constexpr int NUM_LIMBS = 4;
constexpr int LIMB_BITS = 8;
constexpr int MAX_THREADS = 256;
static_assert(KPT == 8 && TB == 8, "the inner loop is written for 8 outputs x 8 samples");

// Shared memory of a block that holds `halves` output halves of the table.
__host__ __device__ inline size_t table_bytes(int N, int two_l, int halves) {
  return (size_t)halves * NUM_LIMBS * two_l * 2 * N;
}

__host__ inline size_t smem_bytes(int N, int two_l, int halves) {
  return table_bytes(N, two_l, halves) + (size_t)TB * two_l * N;
}

// Digit i of plane j for sample s, as a byte of the digit words
// dig[(j * N/4 + i/4) * TB + s] (byte i % 4 of the word).
__device__ __forceinline__ int digit_byte(int j, int i, int s, int N) {
  return ((j * (N / 4) + (i >> 2)) * TB + s) * 4 + (i & 3);
}

// Copy the limb planes of halves [c0, c0 + halves) into shared memory,
// byte-reversed: plane ((h * K + k) * 2L + j) holds R[y] = L_jck[2N-1-y].
// The table is (2L, 2, K, 2N) int8 in device memory, read as words.
__device__ __forceinline__ void load_table(uint32_t* tab_s, const uint32_t* __restrict__ tab,
                                           int c0, int halves, int two_l, int N) {
  const int pw = N / 2;  // words of one 2N-byte plane
  const int total = halves * NUM_LIMBS * two_l * pw;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int p = idx / pw;
    const int w = idx - p * pw;
    const int j = p % two_l;
    const int k = (p / two_l) % NUM_LIMBS;
    const int c = c0 + p / (two_l * NUM_LIMBS);
    const uint32_t v = tab[(((size_t)j * 2 + c) * NUM_LIMBS + k) * pw + (pw - 1 - w)];
    tab_s[idx] = __byte_perm(v, 0u, 0x0123);
  }
}

// The digits of a CMux step for the block's TB samples, both input halves
// p, plane j = p*l + lv: of u = ((X^a * acc - acc) + mask) ^ mask, or with
// ROTATE false (a measurement variant) of u = (acc + mask) ^ mask.
// Samples past B get zero digits.
template <bool ROTATE>
__device__ __forceinline__ void build_step_digits(int8_t* dig_s, const int32_t* __restrict__ acc_in,
                                                  const int32_t* __restrict__ a_tilde, int B,
                                                  int b0, int N, int l, int bgbit, uint32_t mask) {
  const int tn = 2 * N;
  for (int idx = threadIdx.x; idx < TB * tn; idx += blockDim.x) {
    const int s = idx / tn;
    const int rem = idx - s * tn;
    const int p = rem / N;
    const int i = rem - p * N;
    const int b = b0 + s;
    uint32_t u = 0u;
    const bool live = b < B;
    if (live) {
      const int32_t* poly = acc_in + ((size_t)b * 2 + p) * N;
      const auto at = [poly](int x) { return (uint32_t)poly[x]; };
      if constexpr (ROTATE) {
        int a = a_tilde[b] % tn;
        if (a < 0) a += tn;
        u = rounded_diff(rotated_coeff(at, i, a, N), at(i), mask);
      } else {
        u = rounded_diff(at(i), 0u, mask);
      }
    }
    for (int lv = 0; lv < l; ++lv)
      dig_s[digit_byte(p * l + lv, i, s, N)] = live ? digit(u, lv, bgbit) : 0;
  }
}

// part[s][t] += sum_j sum_i d_j[i][s0 + s] * L_j[k0 + t - i + N] for one
// (half, limb): `tab` points at its 2L reversed planes.  With base = N - k0 -
// 8 + 4g, output t and the digits 4g..4g+3 meet R[base + 7 - t .. base + 10 -
// t]: bytes 7 - t .. 10 - t of the three words at base, base + 4, base + 8.
// SUB samples from s0: the whole tile (8, s0 = 0) or half of it (4, s0 = 0 or 4).
template <int SUB = TB>
__device__ __forceinline__ void limb_products(const uint32_t* tab, const uint32_t* dig,
                                              int two_l, int N, int k0,
                                              int32_t (&part)[SUB][KPT], int s0 = 0) {
  static_assert(SUB == TB || SUB == TB / 2, "a tile or half a tile");
  const int pw = N / 2;
  const int groups = N / 4;
  const int w_first = (N - k0 - KPT) / 4;
  for (int j = 0; j < two_l; ++j) {
    const uint32_t* R = tab + (size_t)j * pw + w_first;
    const uint32_t* D = dig + (size_t)j * groups * TB;
    uint32_t w0 = R[0], w1 = R[1];
#pragma unroll 2
    for (int g = 0; g < groups; ++g) {
      // At the last group this reads word w_first + groups + 1 <= pw - 1.
      const uint32_t w2 = R[g + 2];
      int key[KPT];
      key[7] = (int)w0;
      key[6] = (int)__funnelshift_r(w0, w1, 8);
      key[5] = (int)__funnelshift_r(w0, w1, 16);
      key[4] = (int)__funnelshift_r(w0, w1, 24);
      key[3] = (int)w1;
      key[2] = (int)__funnelshift_r(w1, w2, 8);
      key[1] = (int)__funnelshift_r(w1, w2, 16);
      key[0] = (int)__funnelshift_r(w1, w2, 24);
      int d[SUB];
      const uint4 da = *reinterpret_cast<const uint4*>(D + (size_t)g * TB + s0);
      d[0] = (int)da.x;
      d[1] = (int)da.y;
      d[2] = (int)da.z;
      d[3] = (int)da.w;
      if constexpr (SUB == TB) {
        const uint4 db = *reinterpret_cast<const uint4*>(D + (size_t)g * TB + s0 + 4);
        d[4] = (int)db.x;
        d[5] = (int)db.y;
        d[6] = (int)db.z;
        d[7] = (int)db.w;
      }
#pragma unroll
      for (int s = 0; s < SUB; ++s)
#pragma unroll
        for (int t = 0; t < KPT; ++t) part[s][t] = __dp4a(d[s], key[t], part[s][t]);
      w0 = w1;
      w1 = w2;
    }
  }
}

constexpr int MAX_DEVICES = 64;

// Shapes the kernels take: N a multiple of KPT with N/KPT threads per
// block, and the shared-memory footprint within the card's per-block
// limit.  The opt-in to `smem` bytes of dynamic shared memory is made once
// per kernel and device (`granted` holds the largest size set so far).
inline cudaError_t prepare(const void* kernel, int B, int N, int two_l, size_t smem,
                           size_t (&granted)[MAX_DEVICES]) {
  if (B < 1 || N < KPT || N % KPT != 0 || N / KPT > MAX_THREADS || two_l < 1)
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem <= granted[dev]) return cudaSuccess;
  int limit = 0;
  e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (smem > (size_t)limit) return cudaErrorInvalidConfiguration;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) granted[dev] = smem;
  return e;
}

}  // namespace limb
}  // namespace rustfhe
