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
// What bounds it: one read and one write of every word; at the probe's
// (128, 2048) tile that is 2 MiB, ~0.6 us at 3.35 TB/s, below a launch's
// own cost.  The design is the simple one: one thread per output word,
// each reading the two rolled words its butterfly needs (both from the
// same row, so a warp's reads are two contiguous runs), with S a runtime
// argument.  The TPU kernel built the roll from two full-row lane rolls
// and a lane mask; a thread here computes its source index directly.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BL = 64;  // lanes per block

__device__ __forceinline__ uint32_t rolled(const uint32_t* row, int block, int t, int s) {
  return t >= s ? row[block * BL + t - s] : 0u - row[block * BL + t - s + BL];
}

__global__ void nuss_primitives_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                                       int rows, int width, int s) {
  const size_t words = (size_t)rows * width;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < words;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(idx / width);
    const int col = (int)(idx - (size_t)r * width);
    const int block = col / BL;
    const int t = col - block * BL;
    const uint32_t* row = x + (size_t)r * width;
    const int even = block & ~1;
    const uint32_t a = rolled(row, even, t, s);
    const uint32_t b = rolled(row, even + 1, t, s);
    out[idx] = (block & 1) ? a - b : a + b;
  }
}

}  // namespace

extern "C" {

// x, out: (rows, width) uint32 words, width a multiple of 2 * 64; the roll
// S in [0, 64).  Returns the cudaError_t of the launch (0 = launched).
int rustfhe_nuss_primitives(const void* x, void* out, int rows, int width, int s, void* stream) {
  if (rows < 1 || width < 2 * BL || width % (2 * BL) != 0 || s < 0 || s >= BL)
    return (int)cudaErrorInvalidValue;
  const size_t words = (size_t)rows * width;
  const size_t blocks = (words + 255) / 256;
  nuss_primitives_kernel<<<(unsigned)(blocks < 65535 ? blocks : 65535), 256, 0,
                           (cudaStream_t)stream>>>((const uint32_t*)x, (uint32_t*)out, rows,
                                                   width, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
