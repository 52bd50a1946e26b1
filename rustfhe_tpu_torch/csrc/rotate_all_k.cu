// The whole blind rotation in one launch (K3) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the latency path:
//   K3 rustfhe_tpu/engine/pallas_k.py:432  fused_rotate_all_k (body _kernel_rotate_all, :326)
//
// Contract: the K1 step (cmux_k.cu) applied n times,
//   acc_{i+1} = acc_i + ExtProd(bk_i, Decompose(X^{a[i]} * acc_i - acc_i)),
// bit for bit, in the standard (B, 2, N) layout, all torus arithmetic in
// uint32_t.  The key is the standard prepared table K1 reads, (n, 2L, 2, 2N)
// int32 (62 MB at DEFAULT_PARAMS).  The TPU kernel's panel tables (12.6 GiB),
// residue layout and Karatsuba tree exist for Mosaic and the MXU; none of
// them is needed here.
//
// What bounds it.  Per sample and step 2 * N * 2L * N = 12.6 M 32-bit
// multiply-adds (IMAD) against 96 KB of key, and the n steps are strictly
// sequential.  A kernel with one block per (tile, output half), as K1, puts
// a single sample on 2 of the 132 SMs; at interactive batches (1 to 32) the
// card is then idle and each step costs a full tile's IMAD time.
//
// Design.  Each sample (a tile of TB = 1) runs on a thread-block cluster of
// CS = 8 blocks, on 8 SMs; the card holds 30 such clusters at once.  (Tiles
// of 8 samples per cluster, measured on the H100, were slower than tiles of
// 1 at every batch from 1 to 512, so the kernel is built for TB = 1 only.)
//   * block r of the cluster owns a slice of S = 2N/CS consecutive output
//     words (of one output half c) of every sample in the tile, and keeps
//     that slice of the accumulator in its shared memory, double-buffered;
//   * per step it builds the tile's digits from the whole accumulator,
//     reading the peers' slices through distributed shared memory
//     (cluster.map_shared_rank), multiplies its output slice against its
//     window of the step's key (2L planes x (N + S) words), and writes the
//     new slice into the other buffer; one cluster barrier per step orders
//     the slices (arrive.release / wait.acquire): a slice is read only
//     after it was written, and overwritten only after every peer read it;
//   * the 2L planes run on 2L groups of S/KPT threads, whose partial sums
//     are added in shared memory (so a block has 2L warps of work at
//     N = 1024, not one);
//   * the key window of step i+1 is copied with cp.async while step i
//     computes, into the other of two key buffers.
// Shared memory at DEFAULT_PARAMS: key windows 2 x 34.6 KB, slices 2 KB,
// partial sums 6 KB, digits 6 KB: 83 KB of the card's 227 KB.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "cmux_common.cuh"

namespace cg = cooperative_groups;

namespace {

using rustfhe::KPT;
using rustfhe::pad_idx;

static_assert(KPT == 8, "the partial sums are stored as two uint4 per sample");

constexpr int CS = 8;  // blocks per cluster (the portable maximum)
constexpr int TB = 1;  // samples per cluster
constexpr int MAX_THREADS = 384;
constexpr int MAX_DEVICES = 64;

struct Shape {
  int S;        // output words per block
  int W;        // key window words per plane
  int pw;       // padded words per key plane
  int threads;  // (S / KPT) threads per plane, 2L planes
};

__host__ __device__ inline Shape shape_of(int N, int two_l) {
  Shape sh;
  sh.S = 2 * N / CS;
  sh.W = sh.S + N;
  sh.pw = rustfhe::padded_words(sh.W);
  sh.threads = sh.S / KPT * two_l;
  return sh;
}

__host__ inline size_t smem_bytes(int N, int two_l) {
  const Shape sh = shape_of(N, two_l);
  return (size_t)2 * two_l * sh.pw * 4    // key windows, double-buffered
         + (size_t)2 * TB * sh.S * 4      // accumulator slices, double-buffered
         + (size_t)two_l * TB * sh.S * 4  // partial sums, one per plane
         + (size_t)two_l * N * TB;        // digits
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying step st's key window (words [kb, kb + W) of the 2L planes
// of output half c) into the padded buffer key_s.
__device__ __forceinline__ void prefetch_key(uint32_t* key_s, const int32_t* __restrict__ bk,
                                             int st, int c, int kb, int two_l, int N,
                                             const Shape& sh) {
  const int tn = 2 * N;
  const int32_t* base = bk + (size_t)st * two_l * 2 * tn;
  for (int idx = threadIdx.x; idx < two_l * sh.W; idx += blockDim.x) {
    const int j = idx / sh.W;
    const int x = idx - j * sh.W;
    cp_async4(key_s + j * sh.pw + pad_idx(x), base + (size_t)(j * 2 + c) * tn + kb + x);
  }
  cp_async_commit();
}

// acc0, out: (B, 2, N); a_steps: (n, B) in [0, 2N) (reduced here anyway);
// bk: (n, 2L, 2, 2N).  Grid: CS blocks per tile of TB samples, clusters of CS.
__global__ void __launch_bounds__(MAX_THREADS)
rotate_all_kernel(const int32_t* __restrict__ acc0, const int32_t* __restrict__ a_steps,
                  const int32_t* __restrict__ bk, int32_t* __restrict__ out, int B, int n,
                  int N, int l, int bgbit, uint32_t mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int two_l = 2 * l;
  const int tn = 2 * N;
  const Shape sh = shape_of(N, two_l);
  const int S = sh.S;
  const int r = (int)cluster.block_rank();
  const int b0 = (int)(blockIdx.x / CS) * TB;
  const int y0 = r * S;  // this block's slice of the flattened (c, k) words
  const int c = y0 / N;
  const int kb = y0 - c * N;

  uint32_t* key_s = reinterpret_cast<uint32_t*>(smem);  // [2][2L][pw]
  uint32_t* slice = key_s + 2 * two_l * sh.pw;           // [2][TB][S]
  uint32_t* part = slice + 2 * TB * S;                   // [2L][TB][S]
  int8_t* dig = reinterpret_cast<int8_t*>(part + two_l * TB * S);  // [2L][N][TB]

  const int tpp = S / KPT;
  const int j = threadIdx.x / tpp;              // this thread's key plane
  const int k0 = (threadIdx.x - j * tpp) * KPT;  // its first local output word

  for (int idx = threadIdx.x; idx < TB * S; idx += blockDim.x) {
    const int s = idx / S;
    const int b = b0 + s;
    slice[idx] = b < B ? (uint32_t)acc0[(size_t)b * tn + y0 + (idx - s * S)] : 0u;
  }
  prefetch_key(key_s, bk, 0, c, kb, two_l, N, sh);
  cp_async_wait_all();
  cluster.sync();

  for (int st = 0; st < n; ++st) {
    const int cur = st & 1;
    const uint32_t* cur_slice = slice + cur * TB * S;
    uint32_t* nxt_slice = slice + (cur ^ 1) * TB * S;
    if (st + 1 < n)
      prefetch_key(key_s + (cur ^ 1) * two_l * sh.pw, bk, st + 1, c, kb, two_l, N, sh);

    // Digits of X^a * acc - acc over the whole accumulator of the tile.
    for (int idx = threadIdx.x; idx < TB * tn; idx += blockDim.x) {
      const int s = idx / tn;
      const int y = idx - s * tn;
      const int p = y / N;
      const int i = y - p * N;
      const int b = b0 + s;
      uint32_t u = 0u;
      const bool live = b < B;
      if (live) {
        int a = a_steps[(size_t)st * B + b] % tn;
        if (a < 0) a += tn;
        const auto at = [&](int x) {
          const int yy = p * N + x;
          const int owner = yy / S;
          const uint32_t* peer = cluster.map_shared_rank(cur_slice, owner);
          return peer[s * S + (yy - owner * S)];
        };
        u = rustfhe::rounded_diff(rustfhe::rotated_coeff(at, i, a, N), at(i), mask);
      }
      for (int lv = 0; lv < l; ++lv)
        dig[((size_t)(p * l + lv) * N + i) * TB + s] = live ? rustfhe::digit(u, lv, bgbit) : 0;
    }
    __syncthreads();

    uint32_t acc[TB][KPT];
    rustfhe::zero<TB>(acc);
    rustfhe::accumulate_plane<TB>(key_s + (cur * two_l + j) * sh.pw, dig + (size_t)j * N * TB,
                                  N, k0, acc);
#pragma unroll
    for (int s = 0; s < TB; ++s) {
      uint4* dst = reinterpret_cast<uint4*>(part + (j * TB + s) * S + k0);  // 32-byte aligned
      dst[0] = make_uint4(acc[s][0], acc[s][1], acc[s][2], acc[s][3]);
      dst[1] = make_uint4(acc[s][4], acc[s][5], acc[s][6], acc[s][7]);
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < TB * S; idx += blockDim.x) {
      uint32_t v = cur_slice[idx];
      for (int jj = 0; jj < two_l; ++jj) v += part[jj * TB * S + idx];
      nxt_slice[idx] = v;
    }
    cp_async_wait_all();
    cluster.sync();
  }

  const uint32_t* fin = slice + (n & 1) * TB * S;
  for (int idx = threadIdx.x; idx < TB * S; idx += blockDim.x) {
    const int s = idx / S;
    const int b = b0 + s;
    if (b < B) out[(size_t)b * tn + y0 + (idx - s * S)] = (int32_t)fin[idx];
  }
}

// Per device: the dynamic shared memory granted so far and the clusters
// the card can hold at that size (0 = not queried yet).
size_t granted[MAX_DEVICES];
int held_clusters[MAX_DEVICES];

cudaLaunchConfig_t config(int tiles, int N, int two_l, cudaLaunchAttribute* attr,
                          cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * CS, 1, 1);
  cfg.blockDim = dim3(shape_of(N, two_l).threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(N, two_l);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Check the shape, opt into the shared memory (once per device) and count
// the clusters the card can hold; a card that can hold none is an error.
cudaError_t prepare(int N, int two_l, int* clusters) {
  if (N % (CS * KPT / 2) != 0 || two_l < 1 || shape_of(N, two_l).threads > MAX_THREADS)
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  const size_t smem = smem_bytes(N, two_l);
  if (smem > granted[dev]) {
    int limit = 0;
    e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    if (smem > (size_t)limit) return cudaErrorInvalidConfiguration;
    e = cudaFuncSetAttribute((const void*)rotate_all_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = config(1, N, two_l, attr, 0);
    int num = 0;
    e = cudaOccupancyMaxActiveClusters(&num, (const void*)rotate_all_kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (num < 1) return cudaErrorInvalidConfiguration;
    granted[dev] = smem;
    held_clusters[dev] = num;
  }
  *clusters = held_clusters[dev];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Every entry returns a cudaError_t (0 = success).

int rustfhe_rotate_all_k(const void* acc, const void* a_steps, const void* bk, void* out, int B,
                         int n, int N, int l, int bgbit, unsigned int mask, void* stream) {
  if (B < 1 || n < 1) return (int)cudaErrorInvalidValue;
  int clusters = 0;
  const cudaError_t e = prepare(N, 2 * l, &clusters);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config((B + TB - 1) / TB, N, 2 * l, attr, (cudaStream_t)stream);
  const cudaError_t le = cudaLaunchKernelEx(&cfg, rotate_all_kernel, (const int32_t*)acc,
                                            (const int32_t*)a_steps, (const int32_t*)bk,
                                            (int32_t*)out, B, n, N, l, bgbit, (uint32_t)mask);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

// The clusters the current device holds at once (one sample each).
int rustfhe_rotate_all_clusters(int N, int l, int* clusters) {
  return (int)prepare(N, 2 * l, clusters);
}

}  // extern "C"
