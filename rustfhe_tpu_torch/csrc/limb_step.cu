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
// computed in limb form: every key word is split into K=4 balanced signed
// 8-bit limbs (engine/plain.py prepare_trgsw_limbs), and for each output
// half c and limb k
//   P_ck[x] = sum_j sum_i d_j[i] * L_jck[x - i + N]      (int32, all 2L planes)
//   out[c]  = sum_k (uint32) P_ck << 8k                   (wrapping mod 2^32)
// with L_jck = [limbs(-q), limbs(q)] the doubled int8 table of row j, half c,
// limb k, read at a plain offset (no reduction, no sign in the inner loop).
// The plane sum is taken first and the limbs recombine once per (c, k), the
// limb-outer order of _kernel_merged.  |P_ck| <= 2L*N * 2^7 * 2^7 stays
// below 2^31 for every supported shape (the wrapper checks it), and the
// int32 sums wrap mod 2^32 in any case.
//
// The TPU kernels' panel tables and static slices exist because Mosaic
// cannot slice int8 lanes dynamically; here the block reads its shared copy
// of the limb table at any offset.
//
// What bounds it.  Per sample and step 2 * K * 2L * N * N int8 products
// (33.5 M at N=1024, L=2; 50.3 M at L=3), against 2 * 2L * K * 2N bytes of
// key: the card's integer issue rate bounds it, not memory.  The design:
//   * the limb table of the step is held in shared memory, byte-reversed
//     (R[y] = L[2N-1-y]) so that the four key bytes a group of four
//     consecutive digits meets are four consecutive bytes: one __dp4a
//     multiplies four digits by four limbs and adds them to an int32 sum;
//   * each thread owns KPT=8 consecutive outputs for all TB=8 samples of the
//     block (64 int32 sums per limb, 64 uint32 results). Per group of four
//     digits it reads the tile's 8 digit words (a broadcast), one new key
//     word, builds the 8 key windows with funnel shifts, and issues 64
//     __dp4a: 256 products, as many instructions as K1 spends on 64;
//   * K4 and K6 build the digits of the tile in shared memory (rotation,
//     difference, rounding and digits in the block, as K1 does), so they
//     never touch device memory, as the TPU kernels keep them out of HBM.
//     K4 keeps both output halves' tables (2 * 2L * 4 * 2N bytes: 64 KB at
//     L=2, 96 KB at L=3) and builds the digits once; K6 takes one half per
//     block and builds the digits again in each.
// int8 tensor cores (mma.sync / wgmma s8) are later work.  The table and
// digit layouts, the digit build and the product loop are in
// limb_common.cuh, shared with the measurement variants of limb_probe.cu.

#include <cstdint>
#include <cuda_runtime.h>

#include "limb_common.cuh"

namespace {

using rustfhe::KPT;
using namespace rustfhe::limb;

// STEP: K4/K6 (digits built from acc and a~, acc added to the result);
// otherwise K5 (digits read from device memory).  HALVES: 2 for K4 (both
// output halves per block), 1 for K6/K5 (half blockIdx.y).
template <bool STEP, int HALVES>
__global__ void __launch_bounds__(MAX_THREADS)
limb_kernel(const int32_t* __restrict__ acc_in, const int32_t* __restrict__ a_tilde,
            const int8_t* __restrict__ digits, const uint32_t* __restrict__ table,
            int32_t* __restrict__ out, int B, int N, int l, int bgbit, uint32_t mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int two_l = 2 * l;
  const int c0 = HALVES == 2 ? 0 : (int)blockIdx.y;
  const int b0 = blockIdx.x * TB;
  uint32_t* tab_s = reinterpret_cast<uint32_t*>(smem);
  int8_t* dig_s = reinterpret_cast<int8_t*>(smem + table_bytes(N, two_l, HALVES));

  load_table(tab_s, table, c0, HALVES, two_l, N);
  if constexpr (STEP) {
    // Digits of diff = X^a * acc - acc, both input halves p, plane j = p*l + lv.
    build_step_digits<true>(dig_s, acc_in, a_tilde, B, b0, N, l, bgbit, mask);
  } else {
    const int per_sample = two_l * N;
    for (int idx = threadIdx.x; idx < TB * per_sample; idx += blockDim.x) {
      const int s = idx / per_sample;
      const int ji = idx - s * per_sample;  // j*N + i
      const int j = ji / N;
      const int b = b0 + s;
      dig_s[digit_byte(j, ji - j * N, s, N)] =
          b < B ? digits[(size_t)b * per_sample + ji] : (int8_t)0;
    }
  }
  __syncthreads();

  const int k0 = threadIdx.x * KPT;
  const uint32_t* dig_w = reinterpret_cast<const uint32_t*>(dig_s);
  const int plane_words = two_l * (N / 2);
  for (int h = 0; h < HALVES; ++h) {
    const int c = c0 + h;
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
      limb_products(tab_s + (size_t)(h * NUM_LIMBS + k) * plane_words, dig_w, two_l, N, k0,
                    part);
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
        for (int t = 0; t < KPT; ++t) {
          const uint32_t add = STEP ? (uint32_t)acc_in[base + t] : 0u;
          out[base + t] = (int32_t)(add + res[s][t]);
        }
      }
    }
  }
}

size_t merged_granted[MAX_DEVICES];
size_t split_granted[MAX_DEVICES];
size_t extprod_granted[MAX_DEVICES];

template <bool STEP, int HALVES>
int launch(const void* acc, const void* a_tilde, const void* digits, const void* table,
           void* out, int B, int N, int l, int bgbit, unsigned int mask, void* stream,
           size_t (&granted)[MAX_DEVICES]) {
  const size_t smem = smem_bytes(N, 2 * l, HALVES);
  const cudaError_t e =
      prepare((const void*)limb_kernel<STEP, HALVES>, B, N, 2 * l, smem, granted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + TB - 1) / TB, 2 / HALVES);
  limb_kernel<STEP, HALVES><<<grid, N / KPT, smem, (cudaStream_t)stream>>>(
      (const int32_t*)acc, (const int32_t*)a_tilde, (const int8_t*)digits,
      (const uint32_t*)table, (int32_t*)out, B, N, l, bgbit, (uint32_t)mask);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry returns the cudaError_t of its launch (0 = launched).

// K4: acc, out (B, 2, N) words; a_tilde (B,) in [0, 2N); table (2L, 2, 4, 2N) int8.
int rustfhe_limb_cmux_step_merged(const void* acc, const void* a_tilde, const void* table,
                                  void* out, int B, int N, int l, int bgbit, unsigned int mask,
                                  void* stream) {
  return launch<true, 2>(acc, a_tilde, nullptr, table, out, B, N, l, bgbit, mask, stream,
                         merged_granted);
}

// K6: the same operands; one output half per block.
int rustfhe_limb_cmux_step_split(const void* acc, const void* a_tilde, const void* table,
                                 void* out, int B, int N, int l, int bgbit, unsigned int mask,
                                 void* stream) {
  return launch<true, 1>(acc, a_tilde, nullptr, table, out, B, N, l, bgbit, mask, stream,
                         split_granted);
}

// K5: digits (B, 2L, N) int8; table (2L, 2, 4, 2N) int8; out (B, 2, N) words.
int rustfhe_limb_external_product(const void* digits, const void* table, void* out, int B,
                                  int N, int l, void* stream) {
  return launch<false, 1>(nullptr, nullptr, digits, table, out, B, N, l, 0, 0u, stream,
                          extprod_granted);
}

// The current device's opt-in limit of shared memory per block, in bytes.
int rustfhe_limb_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // extern "C"
