// The Nussbaumer transform's two primitives on a tile of 32-bit words, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU probe kernel of benches/nussbaumer_primitives_probe.py
// (main, :57; body kernel, :43), which checks that the primitives of the
// transform-domain engine (rustfhe_tpu/engine/transform.py) run exactly in
// a kernel:
//   1. the in-block negacyclic roll: each block of BL = 64 lanes of a row is
//      multiplied by Z^S in Z[Z]/(Z^64 + 1): lane t takes lane t - S of the
//      same block, and the lanes t < S take the wrapped word negated;
//   2. the radix-2 butterfly of adjacent blocks (2i, 2i+1) = (a, b) ->
//      (a + b, a - b).
// All arithmetic is uint32_t, wrapping mod 2^32 (the TPU kernel's uint32).
// Contract: engine/nuss_primitives.py nuss_primitives_plain, and the JAX
// script's host reference (block_neg_roll_host, butterfly_host).
//
// What bounds it: one read and one write of every word, nothing else; at
// the transform's size, (24576, 2048) words (DEFAULT_PARAMS at B=4096 on
// the digit side), that is 402.7 MB, 0.120 ms at 3.35 TB/s.  The design
// serves the memory path:
//   - the tile is a flat run of block pairs (W is a multiple of 128, so a
//     pair never straddles a row): a warp owns whole pairs, and no thread
//     divides by the row width;
//   - a pair is 512 bytes, one 16-byte load per lane: lanes 0-15 hold block
//     a, lanes 16-31 block b, lane i words 4i..4i+3.  A warp loads
//     PAIRS_PER_WARP pairs before it computes, so that 64 bytes a lane are
//     in flight;
//   - the roll stays in registers: with S = 4q + R, output word 4i + j
//     comes from component (j - R) & 3 of lane i - q (- 1 when j < R) of
//     its own half, one __shfl_sync a word; R is a template argument, so
//     the component index is static;
//   - the butterfly takes the other half's rolled words with one
//     __shfl_xor_sync(16) a word; each lane writes its four outputs back to
//     the place it loaded them from, one 16-byte store.
// Loads and stores take the streaming cache path (the tile is read and
// written once).  The TPU kernel built the roll from two full-row lane
// rolls and a lane mask.

#include <cstdint>
#include <cuda_runtime.h>

#include "error_string.cuh"

namespace {

constexpr int BL = 64;                // lanes per block
constexpr int PAIR_VECS = 2 * BL / 4;  // 16-byte vectors per block pair: one per lane
constexpr int WARPS = 8;              // warps per thread block
constexpr int PAIRS_PER_WARP = 4;     // block pairs a warp loads before it computes
constexpr unsigned FULL = 0xffffffffu;

// Roll one pair by S = 4q + R and apply the butterfly: the lane's four
// words in, its four outputs back.  Every lane of the warp calls it.
template <int R>
__device__ __forceinline__ uint4 roll_butterfly(uint4 v, int lane, int q, int s) {
  const int half = lane & 16, i = lane & 15;
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t y[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int src = half | ((i - q - (j < R ? 1 : 0)) & 15);
    const uint32_t got = __shfl_sync(FULL, w[(j - R) & 3], src);
    y[j] = 4 * i + j < s ? 0u - got : got;
  }
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t other = __shfl_xor_sync(FULL, y[j], 16);
    o[j] = half ? other - y[j] : y[j] + other;  // block a: a + b; block b: a - b
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

template <int R>
__global__ void __launch_bounds__(WARPS * 32)
nuss_primitives_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, long long pairs,
                       int s) {
  const int lane = threadIdx.x & 31;
  const long long first = ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * PAIRS_PER_WARP;
  uint4 v[PAIRS_PER_WARP];
#pragma unroll
  for (int k = 0; k < PAIRS_PER_WARP; ++k)
    if (first + k < pairs) v[k] = __ldcs(x + (first + k) * PAIR_VECS + lane);
#pragma unroll
  for (int k = 0; k < PAIRS_PER_WARP; ++k)
    if (first + k < pairs)  // the same for every lane of the warp
      __stcs(out + (first + k) * PAIR_VECS + lane, roll_butterfly<R>(v[k], lane, s >> 2, s));
}

}  // namespace

extern "C" {

// x, out: (rows, width) uint32 words, 16-byte aligned, width a multiple of
// 2 * 64; the roll S in [0, 64).  Returns the cudaError_t of the launch
// (0 = launched).
int rustfhe_nuss_primitives(const void* x, void* out, int rows, int width, int s, void* stream) {
  if (rows < 1 || width < 2 * BL || width % (2 * BL) != 0 || s < 0 || s >= BL ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long pairs = (long long)rows * (width / (2 * BL));
  const long long per_block = (long long)WARPS * PAIRS_PER_WARP;
  const long long blocks = (pairs + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  const uint4* in = static_cast<const uint4*>(x);
  uint4* o = static_cast<uint4*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (s & 3) {
    case 0: nuss_primitives_kernel<0><<<grid, WARPS * 32, 0, st>>>(in, o, pairs, s); break;
    case 1: nuss_primitives_kernel<1><<<grid, WARPS * 32, 0, st>>>(in, o, pairs, s); break;
    case 2: nuss_primitives_kernel<2><<<grid, WARPS * 32, 0, st>>>(in, o, pairs, s); break;
    default: nuss_primitives_kernel<3><<<grid, WARPS * 32, 0, st>>>(in, o, pairs, s); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
