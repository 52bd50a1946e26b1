// Blocked int8 GEMM on the int8 tensor cores for Hopper (sm_90a):
// C (M, N) int32 = A (M, K) int8 @ B (K, N) int8, exact int32 sums.
//
// Replaces the two Pallas TPU probe kernels that time the matrix unit on
// int8 operands:
//   P7 benches/step_breakdown_probe.py:175  make_dot.f (body dot_kernel, :158):
//      (B, 6144) @ (6144, N=1024), the CMux step's contraction depth 2L*N;
//   P9 benches/pallas_matmul_probe.py:56    make_pallas (its kernel, :42):
//      (B, 6144) @ (6144, 8192), the external product's shape
//      (2 halves x 4 limbs x N columns), a (tb, tn, tk) grid with an int32
//      VMEM accumulator.
// One template serves both, instantiated at a few block tiles (the TPU
// probes' tb/tn/tk sweep becomes a sweep over these tiles).
//
// What bounds it: int8 tensor-core issue (1,979 dense TOP/s published for
// the H100 SXM); at these shapes the operands are re-read from L2 by every
// block row and column, so shared-memory and L2 bandwidth come second.
// The design:
//   * every warp computes a WM x WN sub-tile with mma.sync.aligned.m16n8k32
//     .row.col.s32.s8.s8.s32 (inline PTX), int32 accumulators in registers;
//   * A and B tiles of BK = 64 bytes of depth move from device memory into
//     a ring of STAGES shared-memory buffers with cp.async (16 bytes a
//     thread), so the loads of the next tiles overlap the products of this
//     one (double buffering, with one stage more in flight);
//   * fragments come out of shared memory with ldmatrix.x4, through a
//     16-byte-chunk XOR swizzle that keeps the eight rows one ldmatrix reads
//     in distinct banks;
//   * mma's B operand is "col" (k contiguous for each n), and ldmatrix .trans
//     does not take 8-bit elements, so B is given as Bt (N, K) row-major:
//     the wrapper transposes the weights once (engine/int8_gemm.py
//     prepare_rhs), the counterpart of the TPU probes' panel build.
// Shapes that do not divide the tile (M by BM, N by BN, K by BK) are refused.
// wgmma (warpgroup MMA) with TMA loads, the way to the card's full rate, is
// later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BK = 64;          // bytes of depth per stage (two m16n8k32 steps)
constexpr int CHUNKS = BK / 16;  // 16-byte chunks per tile row

// Byte offset of chunk `c` of tile row `r`: four chunks per 64-byte row,
// XOR-swizzled by (r >> 1) & 3 so that rows r0..r0+7 (r0 a multiple of 8)
// of one chunk column fall in eight distinct 16-byte bank groups.
__device__ __forceinline__ int swz(int r, int c) {
  return r * BK + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BM, int BN, int STAGES>
__host__ __device__ constexpr int gemm_smem() {
  return STAGES * (BM + BN) * BK;
}

// Copy the (ROWS, BK) tile at src (row stride ld bytes) into the swizzled
// stage at dst, 16 bytes a thread, asynchronously.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* __restrict__ src,
                                          size_t ld) {
  static_assert((ROWS * CHUNKS) % THREADS == 0, "the tile splits evenly over the threads");
#pragma unroll
  for (int q = 0; q < ROWS * CHUNKS / THREADS; ++q) {
    const int idx = q * THREADS + (int)threadIdx.x;
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    cp_async16(smem_addr(dst + swz(r, c)), src + (size_t)r * ld + c * 16);
  }
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
int8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ Bt,
                 int32_t* __restrict__ C, int M, int N, int K) {
  constexpr int THREADS = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M;  // warp sub-tile
  constexpr int WN = BN / WARPS_N;
  constexpr int MT = WM / 16;  // m16 tiles per warp
  constexpr int NT = WN / 8;   // n8 tiles per warp
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tiles of whole m16 and n16 blocks");

  extern __shared__ __align__(128) int8_t smem[];
  int8_t* As = smem;                       // STAGES x (BM, BK)
  int8_t* Bs = smem + STAGES * BM * BK;    // STAGES x (BN, BK)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm0 = (warp / WARPS_N) * WM;
  const int wn0 = (warp % WARPS_N) * WN;
  const size_t m0 = (size_t)blockIdx.y * BM;
  const size_t n0 = (size_t)blockIdx.x * BN;
  const int8_t* Ablk = A + m0 * K;
  const int8_t* Bblk = Bt + n0 * K;

  int32_t acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0;

  const int KT = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) {
      load_tile<BM, THREADS>(As + s * BM * BK, Ablk + (size_t)s * BK, K);
      load_tile<BN, THREADS>(Bs + s * BN * BK, Bblk + (size_t)s * BK, K);
    }
    cp_async_commit();
  }

  // ldmatrix.x4 lane roles.  A (m16 x k32 of one mma): matrices (rows 0-7,
  // k 0-15), (rows 8-15, k 0-15), (rows 0-7, k 16-31), (rows 8-15, k 16-31)
  // give a0..a3.  B (two n8 tiles x k32): (n 0-7, k 0-15), (n 0-7, k 16-31),
  // (n 8-15, k 0-15), (n 8-15, k 16-31) give b0, b1 of each tile.
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_chunk = lane >> 4;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_chunk = (lane >> 3) & 1;

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();              // and every warp is done with tile kt - 1
    const int nk = kt + STAGES - 1;
    if (nk < KT) {
      const int st = nk % STAGES;
      load_tile<BM, THREADS>(As + st * BM * BK, Ablk + (size_t)nk * BK, K);
      load_tile<BN, THREADS>(Bs + st * BN * BK, Bblk + (size_t)nk * BK, K);
    }
    cp_async_commit();

    const int8_t* as = As + (kt % STAGES) * BM * BK;
    const int8_t* bs = Bs + (kt % STAGES) * BN * BK;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t af[MT][4];
      uint32_t bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], smem_addr(as + swz(wm0 + i * 16 + a_row, kk * 2 + a_chunk)));
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, smem_addr(bs + swz(wn0 + j * 8 + b_row, kk * 2 + b_chunk)));
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  cp_async_wait<0>();

  // C fragment: c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at row g + 8.
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const size_t row = m0 + wm0 + i * 16 + g;
      const size_t col = n0 + wn0 + j * 8 + t * 2;
      *reinterpret_cast<int2*>(C + row * N + col) = make_int2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<int2*>(C + (row + 8) * N + col) = make_int2(acc[i][j][2], acc[i][j][3]);
    }
}

constexpr int MAX_DEVICES = 64;

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES>
int launch(const void* a, const void* bt, void* c, int M, int N, int K, void* stream) {
  static size_t granted[MAX_DEVICES];
  if (M < 1 || N < 1 || K < 1 || M % BM || N % BN || K % BK) return (int)cudaErrorInvalidValue;
  const auto kernel = int8_gemm_kernel<BM, BN, WARPS_M, WARPS_N, STAGES>;
  constexpr int smem = gemm_smem<BM, BN, STAGES>();
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if ((size_t)smem > granted[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    granted[dev] = smem;
  }
  const dim3 grid(N / BN, M / BM);
  kernel<<<grid, WARPS_M * WARPS_N * 32, smem, (cudaStream_t)stream>>>(
      (const int8_t*)a, (const int8_t*)bt, (int32_t*)c, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// C (M, N) int32 = A (M, K) int8 @ Bt (N, K)^T int8, all row-major and
// 16-byte aligned.  tile: 0 = 64x64 (4 warps), 1 = 128x128 (8 warps),
// 2 = 128x256 (8 warps).  Returns the cudaError_t of the launch.
int rustfhe_int8_gemm(const void* a, const void* bt, void* c, int M, int N, int K, int tile,
                      void* stream) {
  switch (tile) {
    case 0: return launch<64, 64, 2, 2, 3>(a, bt, c, M, N, K, stream);
    case 1: return launch<128, 128, 2, 4, 3>(a, bt, c, M, N, K, stream);
    case 2: return launch<128, 256, 2, 4, 3>(a, bt, c, M, N, K, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
