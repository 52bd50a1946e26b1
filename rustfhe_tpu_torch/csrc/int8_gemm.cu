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
// DEPTH) are refused: the kernel has no ragged edge.  The TMA, mbarrier,
// wgmma and tensor-map helpers live in hopper_common.cuh, shared with the
// CMux step's product (cmux_k.cu).

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "error_string.cuh"
#include "hopper_common.cuh"

namespace {

using namespace rustfhe::hopper;

// The block's shared memory: alignment slack, the ring's A and Bt stages,
// and a full and an empty mbarrier per stage (engine/int8_gemm.py
// smem_bytes mirrors it).
template <int BM, int BN>
constexpr int gemm_smem() {
  return ALIGN + STAGES * (BM + BN) * DEPTH + 2 * STAGES * 8;
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

  if (threadIdx.x == 0) ring_init(full, empty, CONSUMERS * WG / 32);
  __syncthreads();

  // The block walks the tiles blockIdx.x, + gridDim.x, ...; `it` counts the
  // stages it has passed through the ring, over all its tiles: stage
  // it % STAGES in round it / STAGES.
  if (wg == 0) {
    // Producer: one thread keeps the ring full, the next tile's first stages
    // landing while the consumers store the last one.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      prefetch_map(&tma_a);
      prefetch_map(&tma_b);
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int tm, tn;
        tile_coords(tile, tiles_m, tiles_n, tm, tn);
        const int m0 = tm * BM, n0 = tn * BN;
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
      int tm, tn;
      tile_coords(tile, tiles_m, tiles_n, tm, tn);
      const int m0 = tm * BM, n0 = tn * BN;
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

      // The fragment layout of m64nN (hopper_common.cuh, Wgmma).
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

template <int BM, int BN, int CONSUMERS>
int launch(const void* a, const void* bt, void* c, int M, int N, int K, void* stream) {
  static bool ready[MAX_DEVICES];
  if (M < 1 || N < 1 || K < 1 || M % BM || N % BN || K % DEPTH)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)a % 16 || (uintptr_t)bt % 16) return (int)cudaErrorMisalignedAddress;
  using S = Shape<CONSUMERS>;
  const auto kernel = int8_gemm_kernel<BM, BN, CONSUMERS>;
  constexpr int smem = gemm_smem<BM, BN>();
  int sms = 0;
  cudaError_t e = prepare_kernel((const void*)kernel, smem, S::LAUNCH_REGS, ready, &sms);
  if (e != cudaSuccess) return (int)e;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap map_a, map_b;
  if (!make_map(encode, &map_a, a, M, K, BM) || !make_map(encode, &map_b, bt, N, K, BN))
    return (int)cudaErrorInvalidValue;
  // A persistent grid: as many blocks as the SMs hold at once (no more than
  // there are tiles), each walking its share of the tiles.
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
