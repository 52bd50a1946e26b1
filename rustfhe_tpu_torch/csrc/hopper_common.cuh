// Hopper (sm_90a) building blocks shared by the warp-specialised int8
// tensor-core kernels: the blocked GEMM of P7/P9 (int8_gemm.cu) and the
// CMux step's product of K1/K2, K4/K6 and K5, P5/P6 and the Karatsuba
// leaves of P1-P4/P8 (cmux_step.cuh, in cmux_k.cu, limb_step.cu,
// limb_probe.cu and karatsuba_probe.cu).
//
//   * a ring of STAGES shared-memory stages, each DEPTH = 128 bytes of K
//     (one row of the 128-byte swizzle), filled by TMA copies
//     (cp.async.bulk.tensor.2d) that complete a full mbarrier, and handed
//     back by the consumers through an empty mbarrier;
//   * warpgroup MMA (wgmma.mma_async m64nNk32 .s32.s8.s8) on shared-memory
//     descriptors of K-major operands in that swizzle, with no .satfinite
//     (sums wrap; callers keep them in range);
//   * the register split of a producer warpgroup (setmaxnreg.dec to
//     PRODUCER_REGS) and CONSUMERS consumer warpgroups (setmaxnreg.inc),
//     the check that a launch was granted the registers the split assumes,
//     and the persistent grid's tile order;
//   * stages that threads build themselves: st.shared, the proxy fence
//     that makes the writes visible to wgmma, a named barrier, and an
//     mbarrier phase that expects transaction bytes without an arrival;
//   * the host's TMA maps (cuTensorMapEncodeTiled, reached through the
//     runtime's driver entry point: no -lcuda), cached by their arguments.

#pragma once

#include <cstdint>
#include <cuda.h>  // CUtensorMap and the encoder's types (the encoder comes from the runtime)
#include <cuda_runtime.h>
#include <mutex>

namespace rustfhe {
namespace hopper {

constexpr int DEPTH = 128;  // bytes of K per stage: one row of the 128-byte swizzle
constexpr int STAGES = 4;
constexpr int KSTEP = 32;  // bytes of K per wgmma (k32 for 8-bit types)
constexpr int WG = 128;  // threads of a warpgroup
constexpr int PRODUCER_REGS = 40;
constexpr int ALIGN = 1024;  // a 128-byte swizzle atom: 8 rows of 128 bytes
constexpr int GROUP = 8;  // block rows of one raster group
constexpr int MAX_DEVICES = 64;

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

// The transaction bytes of the current phase, without an arrival: the
// phase then also waits for an mbar_arrive.
__device__ __forceinline__ void mbar_expect_tx_only(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
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

// The ring's barriers at `full` and `empty` (`stages` of 8 bytes each): a
// full barrier takes the producer's one expect_tx, an empty one an arrival
// from each consumer warp.  One thread initialises them before the block's
// first __syncthreads.
__device__ __forceinline__ void ring_init(uint32_t full, uint32_t empty, int consumer_warps,
                                          int stages = STAGES) {
  for (int s = 0; s < stages; ++s) {
    mbar_init(full + 8 * s, 1);
    mbar_init(empty + 8 * s, consumer_warps);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Threads that write shared memory for the async proxy (wgmma) to read:
// st_shared_v4, then fence_proxy_async, then a barrier.
__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// One TMA copy of the (rows, DEPTH) box at (x = byte of K, y = row) into
// shared memory at dst, completing `bar`'s transaction count.  Rows outside
// the map arrive as zeros and count towards the box's bytes.
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
// Fragment layout of m64nN: thread (warp w, lane l) holds, for each n8
// column block j, d[4j], d[4j+1] at (row 16w + l/4, cols 8j + 2(l%4), +1)
// and d[4j+2], d[4j+3] eight rows below.
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

// The (row, column) tile of linear tile `tile` of a persistent grid: tiles
// are taken in groups of GROUP tile rows, column by column inside a group,
// so that the blocks resident at one time share GROUP row panels of the
// first operand and a band of the second in L2.
__device__ __forceinline__ void tile_coords(int tile, int tiles_m, int tiles_n, int& tm, int& tn) {
  const int per_group = GROUP * tiles_n;
  const int first = tile / per_group * GROUP;
  const int rows = min(tiles_m - first, GROUP);
  const int r = tile % per_group;
  tm = first + r % rows;
  tn = r / rows;
}

// Once per kernel and device: refuse a register grant below `launch_regs`
// (the consumers' setmaxnreg.inc waits for registers the producer gave
// back, and only completes when the launch granted that many a thread) and
// opt in to `smem` bytes of dynamic shared memory.  Returns the device's
// SM count in *sms.  Every call makes the device's primary context current
// on the calling thread: a thread's first call into a library may come
// before any launch of it, and the TMA maps encoded next need a context.
inline cudaError_t prepare_kernel(const void* kernel, int smem, int launch_regs,
                                  bool (&ready)[MAX_DEVICES], int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  e = cudaSetDevice(dev);
  if (e != cudaSuccess) return e;
  if (!ready[dev]) {
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return e;
    if (attr.numRegs < launch_regs) return cudaErrorLaunchOutOfResources;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    ready[dev] = true;
  }
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
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
inline bool make_map(EncodeTiled encode, CUtensorMap* map, const void* base, int rows, int K,
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

// make_map through a small cache keyed by every argument, for callers that
// launch on the same buffers many times (the CMux step's digit and panel
// buffers, 635 steps a pass): a map depends on nothing else, so a hit is the map that
// encoding would give.
class MapCache {
 public:
  bool get(CUtensorMap* map, const void* base, int rows, int K, int box_rows) {
    std::lock_guard<std::mutex> lock(mu_);
    for (Entry& e : entries_) {
      if (e.used && e.base == base && e.rows == rows && e.K == K && e.box_rows == box_rows) {
        *map = e.map;
        return true;
      }
    }
    const EncodeTiled encode = encoder();
    if (encode == nullptr || !make_map(encode, map, base, rows, K, box_rows)) return false;
    entries_[next_] = {true, base, rows, K, box_rows, *map};
    next_ = (next_ + 1) % SLOTS;
    return true;
  }

 private:
  static constexpr int SLOTS = 16;
  struct Entry {
    bool used;
    const void* base;
    int rows, K, box_rows;
    CUtensorMap map;
  };
  Entry entries_[SLOTS] = {};
  int next_ = 0;
  std::mutex mu_;
};

}  // namespace hopper
}  // namespace rustfhe
