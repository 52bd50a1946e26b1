// Blind-rotate CMux step (K1) and external product (K2) for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels on the gate-bootstrap path:
//   K1 rustfhe_tpu/engine/pallas_k.py:295  fused_cmux_step_k (body _kernel_step_k, :207)
//   K2 rustfhe_tpu/engine/pallas_k.py:506  fused_external_product_k (body _kernel_extprod_k, :459)
//
// Contract (the function, not the TPU's blocking):
//   K1: out = acc + ExtProd(bk_i, Decompose(X^{a~} * acc - acc))   bit for bit
//   K2: out = ExtProd(rows, digits)                                 bit for bit
// in the standard (B, 2, N) layout, all torus arithmetic in uint32_t (wrapping
// mod 2^32; signed overflow would be undefined).  The TPU kernels' residue
// layout, panel tables, int8 limbs and Karatsuba tree exist for Mosaic and the
// MXU; none of them is needed for this contract.
//
// Operands.  The key is the prepared TRGSW table (engine/plain.py
// prepare_trgsw): per row j and output half c the doubled polynomial
// T = [-q, q] of 2N words, so that the negacyclic product
//   out[c][k] = sum_j sum_i d_j[i] * T_jc[k - i + N]
// indexes T at a plain offset and never negates.
//
// What bounds it.  Per sample and step the product is 2 * N * 2L * N
// multiply-adds (12.6 M at N=1024, L=3), all 32-bit integer multiply-adds
// (IMAD), against 2 * 2L * 2N * 4 B = 96 KB of key and 16 KB of accumulator
// traffic: about 100 IMADs per byte, so the card's IMAD throughput bounds it,
// not HBM.  The design keeps every operand of the inner loop on chip:
//   * one block per (tile of TB=8 samples, output half c); its key half
//     (2L planes of 2N words, padded one word in nine against bank conflicts,
//     55 KB at DEFAULT_PARAMS) and the tile's digits (int8, 2L*N*TB = 48 KB)
//     sit in shared memory, above the 48 KB static limit;
//   * K1 computes the rotation, the difference, the rounding and the digits
//     in the block itself, so the digits never touch device memory (what the
//     TPU kernel also keeps out of HBM);
//   * each thread owns KPT=8 consecutive outputs for all TB samples: 64
//     register accumulators.  Per digit index i it reads one 8-byte digit
//     vector (a broadcast within the warp) and one key word (a sliding
//     window of 8 words held in registers), then issues 64 IMADs.
// int8 tensor cores (wgmma), TMA and the Karatsuba split are later work.
// The digit build and the multiply-add are in cmux_common.cuh, shared with
// the single-launch rotation K3 (rotate_all_k.cu).

#include <cstdint>
#include <cuda_runtime.h>

#include "cmux_common.cuh"

namespace {

using rustfhe::KPT;
using rustfhe::pad_idx;

constexpr int TB = 8;   // samples per block
constexpr int MAX_THREADS = 256;

__host__ __device__ inline size_t key_plane_words(int N) {
  return (size_t)rustfhe::padded_words(2 * N);
}

__host__ inline size_t smem_bytes(int N, int two_l) {
  return (size_t)two_l * key_plane_words(N) * 4 + (size_t)TB * two_l * N;
}

// Copy the 2L doubled planes of output half c into padded shared memory.
__device__ __forceinline__ void load_key(uint32_t* key_s, const int32_t* __restrict__ key,
                                         int c, int two_l, int N) {
  const int tn = 2 * N;
  const int pw = (int)key_plane_words(N);
  for (int idx = threadIdx.x; idx < two_l * tn; idx += blockDim.x) {
    const int j = idx / tn;
    const int y = idx - j * tn;
    key_s[j * pw + pad_idx(y)] = (uint32_t)key[(j * 2 + c) * tn + y];
  }
}

// acc[s][t] += sum_j sum_i dig[j][i][s] * T_j[k0 + t - i + N]
__device__ __forceinline__ void accumulate(const uint32_t* key_s, const int8_t* dig_s,
                                           int two_l, int N, int k0,
                                           uint32_t (&acc)[TB][KPT]) {
  const int pw = (int)key_plane_words(N);
  for (int j = 0; j < two_l; ++j)
    rustfhe::accumulate_plane<TB>(key_s + j * pw, dig_s + (size_t)j * N * TB, N, k0, acc);
}

// K1.  acc, out: (B, 2, N) words; a_tilde: (B,) in [0, 2N) (reduced here
// anyway); key: (2L, 2, 2N) doubled table of this step.
__global__ void __launch_bounds__(MAX_THREADS)
cmux_step_kernel(const int32_t* __restrict__ acc_in, const int32_t* __restrict__ a_tilde,
                 const int32_t* __restrict__ key, int32_t* __restrict__ out, int B, int N,
                 int l, int bgbit, uint32_t mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int two_l = 2 * l;
  const int tn = 2 * N;
  const int c = blockIdx.y;
  const int b0 = blockIdx.x * TB;
  uint32_t* key_s = reinterpret_cast<uint32_t*>(smem);
  int8_t* dig_s = reinterpret_cast<int8_t*>(smem + (size_t)two_l * key_plane_words(N) * 4);

  load_key(key_s, key, c, two_l, N);

  // Digits of diff = X^a * acc - acc, both halves p, plane j = p*l + lv,
  // stored as dig_s[(j*N + i)*TB + s].
  for (int idx = threadIdx.x; idx < TB * tn; idx += blockDim.x) {
    const int s = idx / tn;
    const int rem = idx - s * tn;
    const int p = rem / N;
    const int i = rem - p * N;
    const int b = b0 + s;
    uint32_t u = 0u;
    const bool live = b < B;
    if (live) {
      int a = a_tilde[b] % tn;
      if (a < 0) a += tn;
      const int32_t* poly = acc_in + ((size_t)b * 2 + p) * N;
      const auto at = [poly](int x) { return (uint32_t)poly[x]; };
      u = rustfhe::rounded_diff(rustfhe::rotated_coeff(at, i, a, N), at(i), mask);
    }
    for (int lv = 0; lv < l; ++lv)
      dig_s[((size_t)(p * l + lv) * N + i) * TB + s] = live ? rustfhe::digit(u, lv, bgbit) : 0;
  }
  __syncthreads();

  const int k0 = threadIdx.x * KPT;
  uint32_t acc[TB][KPT];
  rustfhe::zero<TB>(acc);
  accumulate(key_s, dig_s, two_l, N, k0, acc);

#pragma unroll
  for (int s = 0; s < TB; ++s) {
    const int b = b0 + s;
    if (b < B) {
      const size_t base = ((size_t)b * 2 + c) * N + k0;
#pragma unroll
      for (int t = 0; t < KPT; ++t)
        out[base + t] = (int32_t)((uint32_t)acc_in[base + t] + acc[s][t]);
    }
  }
}

// K2.  digits: (B, 2L, N) int8; key: (2L, 2, 2N); out: (B, 2, N) words.
__global__ void __launch_bounds__(MAX_THREADS)
external_product_kernel(const int8_t* __restrict__ digits, const int32_t* __restrict__ key,
                        int32_t* __restrict__ out, int B, int N, int two_l) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.y;
  const int b0 = blockIdx.x * TB;
  uint32_t* key_s = reinterpret_cast<uint32_t*>(smem);
  int8_t* dig_s = reinterpret_cast<int8_t*>(smem + (size_t)two_l * key_plane_words(N) * 4);

  load_key(key_s, key, c, two_l, N);
  const int per_sample = two_l * N;
  for (int idx = threadIdx.x; idx < TB * per_sample; idx += blockDim.x) {
    const int s = idx / per_sample;
    const int ji = idx - s * per_sample;  // j*N + i
    const int b = b0 + s;
    dig_s[(size_t)ji * TB + s] = b < B ? digits[(size_t)b * per_sample + ji] : (int8_t)0;
  }
  __syncthreads();

  const int k0 = threadIdx.x * KPT;
  uint32_t acc[TB][KPT];
  rustfhe::zero<TB>(acc);
  accumulate(key_s, dig_s, two_l, N, k0, acc);

#pragma unroll
  for (int s = 0; s < TB; ++s) {
    const int b = b0 + s;
    if (b < B) {
      const size_t base = ((size_t)b * 2 + c) * N + k0;
#pragma unroll
      for (int t = 0; t < KPT; ++t) out[base + t] = (int32_t)acc[s][t];
    }
  }
}

constexpr int MAX_DEVICES = 64;

// Shapes the kernels take: N a multiple of KPT with N/KPT threads per
// block, and the shared-memory footprint within the card's per-block limit.
// The opt-in to `smem` bytes of dynamic shared memory is made once per
// kernel and device (`granted` holds the largest size set so far), not at
// every launch: the blind rotation launches K1 n times per pass.
cudaError_t prepare(const void* kernel, int B, int N, int two_l, size_t smem,
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

size_t cmux_step_granted[MAX_DEVICES];
size_t external_product_granted[MAX_DEVICES];

}  // namespace

extern "C" {

// Every entry returns the cudaError_t of its launch (0 = launched).

int rustfhe_cmux_step_k(const void* acc, const void* a_tilde, const void* key, void* out,
                        int B, int N, int l, int bgbit, unsigned int mask, void* stream) {
  const size_t smem = smem_bytes(N, 2 * l);
  const cudaError_t e = prepare((const void*)cmux_step_kernel, B, N, 2 * l, smem,
                                cmux_step_granted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + TB - 1) / TB, 2);
  cmux_step_kernel<<<grid, N / KPT, smem, (cudaStream_t)stream>>>(
      (const int32_t*)acc, (const int32_t*)a_tilde, (const int32_t*)key, (int32_t*)out, B, N,
      l, bgbit, (uint32_t)mask);
  return (int)cudaGetLastError();
}

int rustfhe_external_product_k(const void* digits, const void* key, void* out, int B, int N,
                               int two_l, void* stream) {
  const size_t smem = smem_bytes(N, two_l);
  const cudaError_t e = prepare((const void*)external_product_kernel, B, N, two_l, smem,
                                external_product_granted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + TB - 1) / TB, 2);
  external_product_kernel<<<grid, N / KPT, smem, (cudaStream_t)stream>>>(
      (const int8_t*)digits, (const int32_t*)key, (int32_t*)out, B, N, two_l);
  return (int)cudaGetLastError();
}

const char* rustfhe_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
