// Blocked int8 GEMM on the int8 tensor cores of Hopper (sm_90a):
// C (M, N) int32 = A (M, K) int8 @ Bt (N, K)^T int8, exact int32 sums.
//
// Replaces the two Pallas TPU probe kernels that time the matrix unit on
// int8 operands:
//   P7 benches/step_breakdown_probe.py:175  make_dot.f (body dot_kernel, :158):
//      (B, 6144) @ (6144, N=1024), the CMux step's contraction depth 2L*N;
//   P9 benches/pallas_matmul_probe.py:56    make_pallas (its kernel, :42):
//      (B, 6144) @ (6144, 8192), the external product's shape
//      (2 halves x 4 limbs x N columns), a (tb, tn, tk) grid with an int32
//      VMEM accumulator.
// Through engine/matmul.py it is also the product of every blind-rotate
// step of the "matmul" engine (P9's shape at B=4096, 635 launches a pass).
// One template serves all, instantiated at three block tiles (the TPU
// probes' tb/tn/tk sweep becomes a sweep over these tiles).
//
// What bounds it: int8 tensor-core issue, 1,979 dense TOP/s published for
// the H100 SXM at 700 W (0.208 ms at P9's shape); next the output stores,
// 128 MiB of int32 at P9's shape (0.04 ms at 3.35 TB/s).  Only warpgroup
// MMA (wgmma) issues at the card's int8 rate, and it wants its operands in
// shared memory, a stage ahead, without spending the consumers' issue
// slots on copies.  The design:
//   * warp specialisation: warpgroup 0 is the producer, warpgroups 1..C the
//     consumers; the producer gives its registers away (setmaxnreg.dec to
//     40) and the consumers take them (setmaxnreg.inc), which is what lets
//     a 64 x 256 int32 accumulator (128 registers a thread) stay in
//     registers without spills;
//   * loads by TMA: one producer thread issues cp.async.bulk.tensor.2d for
//     the A and Bt tiles of each DEPTH = 128-byte slice of K into a ring of
//     STAGES shared-memory stages, in the 128-byte swizzle; each stage has a
//     full mbarrier (arrive.expect_tx of the stage's bytes, completed by the
//     copies) and an empty one (one arrival per consumer warp);
//   * products by wgmma: consumer warpgroup c computes rows 64c..64c+63 of
//     the block tile with wgmma.mma_async m64nBNk32 .s32.s8.s8, both
//     operands read through shared-memory descriptors (K-major, the swizzle
//     the TMA wrote), four per stage; no .satfinite, so sums wrap as the
//     plain version's do (check_bound keeps them in range anyway).  One
//     commit group per stage and wait_group 1: a stage's products run while
//     the next stage's copies land, and a stage goes back to the producer
//     only once the wgmma that read it has retired;
//   * a persistent grid: one block per SM (two at 64x64) walks the output
//     tiles in groups of GROUP block rows, so that the tiles in flight share
//     their A and Bt panels in L2, and the producer fills the ring for the
//     next tile while the consumers store this one (4-6 % faster than one
//     block per tile at P7's and P9's shapes; PERF.md keeps both times);
//   * epilogue: the accumulators go to C as int2 pairs straight from the
//     wgmma fragment layout, with streaming stores (the output is read by
//     the caller, not by this kernel).
// Both wgmma operands are K-major for 8-bit types, so B is given as Bt
// (N, K) row-major: the wrapper transposes the weights once
// (engine/int8_gemm.py prepare_rhs), the counterpart of the TPU probes'
// panel build.  The TMA descriptors are built on the host at each call with
// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (no -lcuda).  Shapes that do not divide the tile (M by BM, N by BN, K by
// DEPTH) are refused: the kernel has no ragged edge.

#include <cstdint>
#include <cuda.h>  // CUtensorMap and the encoder's types (the encoder comes from the runtime)
#include <cuda_runtime.h>

namespace {

constexpr int DEPTH = 128;  // bytes of K per stage: one row of the 128-byte swizzle
constexpr int STAGES = 4;
constexpr int KSTEP = 32;  // bytes of K per wgmma (k32 for 8-bit types)
constexpr int WG = 128;  // threads of a warpgroup
constexpr int PRODUCER_REGS = 40;
constexpr int ALIGN = 1024;  // a 128-byte swizzle atom: 8 rows of 128 bytes
constexpr int GROUP = 8;  // block rows of one raster group

// The block's shared memory: alignment slack, the ring's A and Bt stages,
// and a full and an empty mbarrier per stage (engine/int8_gemm.py
// smem_bytes mirrors it).
template <int BM, int BN>
constexpr int gemm_smem() {
  return ALIGN + STAGES * (BM + BN) * DEPTH + 2 * STAGES * 8;
}

// Threads, blocks per SM, and the register split of one instantiation: the
// launch gives every thread LAUNCH_REGS (what __launch_bounds__ allows);
// the producer keeps PRODUCER_REGS and the consumers share the rest.
template <int CONSUMERS>
struct Shape {
  static constexpr int THREADS = (CONSUMERS + 1) * WG;
  static constexpr int MIN_BLOCKS = CONSUMERS == 1 ? 2 : 1;
  static constexpr int LAUNCH_REGS = (65536 / (THREADS * MIN_BLOCKS)) / 8 * 8;
  static constexpr int CONSUMER_REGS =
      (LAUNCH_REGS * THREADS - PRODUCER_REGS * WG) / (CONSUMERS * WG) / 8 * 8;
  static_assert(LAUNCH_REGS <= 255 && CONSUMER_REGS <= 256, "setmaxnreg takes 24..256");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA copy of the (rows, DEPTH) box at (x = byte of K, y = row) into
// shared memory at dst, completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int x,
                                         int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// wgmma's shared-memory matrix descriptor of a K-major operand in the
// 128-byte swizzle the TMA writes: start address >> 4 in bits 0-13, the
// leading byte offset (unused by this layout; 1) in bits 16-29, the stride
// byte offset between 8-row atoms (1024 B) >> 4 in bits 32-45, base offset
// 0 (every stage starts on a 1024-byte boundary), layout 1 = 128-byte
// swizzle in bits 62-63.  A k32 step inside the 128-byte row adds 32 bytes
// to the start address; the swizzle applies to the address the hardware
// forms.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// Keep the compiler from moving accumulator accesses across a wgmma fence,
// commit or wait (no instruction is emitted).
template <int R>
__device__ __forceinline__ void fence_acc(int32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define WGMMA_R0                                                                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WGMMA_R32                                                                          \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, " \
  "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define WGMMA_R64                                                                          \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, " \
  "%81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define WGMMA_R96                                                                               \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "  \
  "%127"
#define ACC8(i)                                                                             \
  "+r"(d[(i)]), "+r"(d[(i) + 1]), "+r"(d[(i) + 2]), "+r"(d[(i) + 3]), "+r"(d[(i) + 4]),     \
      "+r"(d[(i) + 5]), "+r"(d[(i) + 6]), "+r"(d[(i) + 7])
#define ACC32(i) ACC8(i), ACC8((i) + 8), ACC8((i) + 16), ACC8((i) + 24)

// d (64 x N int32 over the warpgroup, N/2 a thread) = scale * d + A (64 x 32)
// @ B (N x 32)^T, both int8 in shared memory.  scale 0 starts the sum: no
// other instruction writes the accumulators, so ptxas keeps the wgmmas of a
// stage in flight together (zeroing them first serialises them, C7515).
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(int32_t (&d)[32], uint64_t a, uint64_t b,
                                             uint32_t scale) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {" WGMMA_R0 "}, %32, %33, p;\n}\n"
        : ACC32(0)
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(int32_t (&d)[64], uint64_t a, uint64_t b,
                                             uint32_t scale) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" WGMMA_R0 ", " WGMMA_R32
        "}, %64, %65, p;\n}\n"
        : ACC32(0), ACC32(32)
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void mma(int32_t (&d)[128], uint64_t a, uint64_t b,
                                             uint32_t scale) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" WGMMA_R0 ", " WGMMA_R32
        ", " WGMMA_R64 ", " WGMMA_R96 "}, %128, %129, p;\n}\n"
        : ACC32(0), ACC32(32), ACC32(64), ACC32(96)
        : "l"(a), "l"(b), "r"(scale));
  }
};

// The origin (m0, n0) of output tile `tile`: tiles are taken in groups of
// GROUP block rows, column by column inside a group, so that the blocks
// resident at one time share GROUP row panels of A and a band of Bt in L2.
template <int BM, int BN>
__device__ __forceinline__ void tile_origin(int tile, int tiles_m, int tiles_n, int& m0, int& n0) {
  const int per_group = GROUP * tiles_n;
  const int first = tile / per_group * GROUP;
  const int rows = min(tiles_m - first, GROUP);
  const int r = tile % per_group;
  m0 = (first + r % rows) * BM;
  n0 = r / rows * BN;
}

template <int BM, int BN, int CONSUMERS>
__global__ void __launch_bounds__(Shape<CONSUMERS>::THREADS, Shape<CONSUMERS>::MIN_BLOCKS)
int8_gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
                 const __grid_constant__ CUtensorMap tma_b, int32_t* __restrict__ C, int M, int N,
                 int K) {
  static_assert(BM == 64 * CONSUMERS, "one consumer warpgroup per 64 rows");
  constexpr int A_STAGE = BM * DEPTH;
  constexpr int B_STAGE = BN * DEPTH;
  using S = Shape<CONSUMERS>;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  const uint32_t a_ring = base;
  const uint32_t b_ring = base + STAGES * A_STAGE;
  const uint32_t full = b_ring + STAGES * B_STAGE;  // STAGES barriers of 8 bytes
  const uint32_t empty = full + STAGES * 8;

  const int wg = threadIdx.x / WG;
  const int KT = K / DEPTH;
  const int tiles_m = M / BM, tiles_n = N / BN;
  const int tiles = tiles_m * tiles_n;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);                     // the producer's expect_tx
      mbar_init(empty + 8 * s, CONSUMERS * WG / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The block walks the tiles blockIdx.x, + gridDim.x, ...; `it` counts the
  // stages it has passed through the ring, over all its tiles: stage
  // it % STAGES in round it / STAGES.
  if (wg == 0) {
    // Producer: one thread keeps the ring full, the next tile's first stages
    // landing while the consumers store the last one.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tma_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tma_b))
                   : "memory");
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int m0, n0;
        tile_origin<BM, BN>(tile, tiles_m, tiles_n, m0, n0);
        for (int kb = 0; kb < KT; ++kb, ++it) {
          const int s = it % STAGES;
          // Round r waits for the consumers' release of round r - 1; on a
          // fresh barrier the wait for parity 1 passes at once.
          mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, A_STAGE + B_STAGE);
          tma_load(a_ring + s * A_STAGE, &tma_a, full + 8 * s, kb * DEPTH, m0);
          tma_load(b_ring + s * B_STAGE, &tma_b, full + 8 * s, kb * DEPTH, n0);
        }
      }
    }
  } else {
    // Consumers: warpgroup c computes rows 64c..64c+63 of each tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::CONSUMER_REGS));
    const int c = wg - 1;
    const int t = threadIdx.x % WG;
    const int w = t / 32, l = t % 32;
    int32_t acc[BN / 2];  // set by each tile's first wgmma (scale 0)
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0;
      tile_origin<BM, BN>(tile, tiles_m, tiles_n, m0, n0);
      for (int kb = 0; kb < KT; ++kb, ++it) {
        const int s = it % STAGES;
        mbar_wait(full + 8 * s, (it / STAGES) & 1);
        __syncwarp();  // the warp converges before the .aligned wgmma instructions
        const uint32_t a_s = a_ring + s * A_STAGE + c * 64 * DEPTH;
        const uint32_t b_s = b_ring + s * B_STAGE;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DEPTH / KSTEP; ++kk)
          Wgmma<BN>::mma(acc, smem_desc(a_s + kk * KSTEP), smem_desc(b_s + kk * KSTEP),
                         (kb | kk) != 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products have retired
        fence_acc(acc);
        if (kb > 0 && l == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (l == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));

      // Fragment layout of m64nN: thread (warp w, lane l) holds, for each
      // n8 column block j, d[4j], d[4j+1] at (row 16w + l/4, cols
      // 8j + 2(l%4), +1) and d[4j+2], d[4j+3] eight rows below.
      const size_t row = (size_t)m0 + c * 64 + w * 16 + l / 4;
      int32_t* c0 = C + row * N + n0 + (l % 4) * 2;
      int32_t* c8 = c0 + 8 * (size_t)N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        __stcs(reinterpret_cast<int2*>(c0 + 8 * j), make_int2(acc[4 * j], acc[4 * j + 1]));
        __stcs(reinterpret_cast<int2*>(c8 + 8 * j), make_int2(acc[4 * j + 2], acc[4 * j + 3]));
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// The TMA map of a row-major (rows, K) int8 matrix, cut in boxes of
// (box_rows, DEPTH) bytes, written to shared memory in the 128-byte swizzle.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* base, int rows, int K,
              int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)DEPTH, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int MAX_DEVICES = 64;

template <int BM, int BN, int CONSUMERS>
int launch(const void* a, const void* bt, void* c, int M, int N, int K, void* stream) {
  static bool ready[MAX_DEVICES];
  if (M < 1 || N < 1 || K < 1 || M % BM || N % BN || K % DEPTH)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)a % 16 || (uintptr_t)bt % 16) return (int)cudaErrorMisalignedAddress;
  using S = Shape<CONSUMERS>;
  const auto kernel = int8_gemm_kernel<BM, BN, CONSUMERS>;
  constexpr int smem = gemm_smem<BM, BN>();
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    // The consumers' setmaxnreg.inc waits for registers the producer gave
    // back: it only completes when the launch granted LAUNCH_REGS a thread.
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return (int)e;
    if (attr.numRegs < S::LAUNCH_REGS) return (int)cudaErrorLaunchOutOfResources;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap map_a, map_b;
  if (!make_map(encode, &map_a, a, M, K, BM) || !make_map(encode, &map_b, bt, N, K, BN))
    return (int)cudaErrorInvalidValue;
  // A persistent grid: as many blocks as the SMs hold at once (no more than
  // there are tiles), each walking its share of the tiles.
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int blocks = sms * S::MIN_BLOCKS;
  const int tiles = (M / BM) * (N / BN);
  const int grid = tiles < blocks ? tiles : blocks;
  kernel<<<grid, S::THREADS, smem, (cudaStream_t)stream>>>(map_a, map_b, (int32_t*)c, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// C (M, N) int32 = A (M, K) int8 @ Bt (N, K)^T int8, all row-major and
// 16-byte aligned.  tile: 0 = 64x64 (one consumer warpgroup, m64n64),
// 1 = 128x128 (two, m64n128), 2 = 128x256 (two, m64n256).  Returns the
// cudaError_t of the launch.
int rustfhe_int8_gemm(const void* a, const void* bt, void* c, int M, int N, int K, int tile,
                      void* stream) {
  switch (tile) {
    case 0: return launch<64, 64, 1>(a, bt, c, M, N, K, stream);
    case 1: return launch<128, 128, 2>(a, bt, c, M, N, K, stream);
    case 2: return launch<128, 256, 2>(a, bt, c, M, N, K, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
