// The CMux step as one int8 GEMM on Hopper (sm_90a): what the int32-key
// step K1/K2 (cmux_k.cu) and the limb-table steps K4/K6 (limb_step.cu)
// share.  Each library builds its own key panels and then launches:
//
//   * step_digits_kernel: the digits of X^{a~} * acc - acc as int8
//     (B, 2L, Npad), Npad = N rounded up to DEPTH, zeros past N
//     (cmux_common.cuh's rotated_coeff, rounded_diff and digit);
//   * cmux_product_kernel<ADD, HALVES>: the GEMM of the digits against the
//     step's key panels on the warp-specialised mainloop of
//     hopper_common.cuh (a producer warpgroup keeps a 4-stage TMA ring
//     full, two consumer warpgroups run wgmma m64n256k32 .s32.s8.s8, a
//     persistent grid walks the block tiles), with the limb recombination
//     and, for ADD, the add of acc in its epilogue.
//
// The panels (2L, 2, LIMBS, rows, DEPTH) int8 hold, for plane j, output
// half c and limb t, the K-major rows Pt[x][r] = limb_t(T_jc[x - r]) for x
// in [x0, 2N), r in [0, DEPTH), zero for r >= N, T_jc the doubled key
// [-q, q] of engine/plain.py prepare_trgsw.  Row (c, t, k) of the GEMM's
// second operand over the K slice kb of plane j is panel row k + N - DEPTH
// kb: the circulant is a sliding window of rows, so one TMA box of
// consecutive rows is the key tile of consecutive output coefficients.
//
// A block tile is 128 samples x 256 columns, in one of two column layouts:
//   HALVES = 1 (K1, K2, K6): one output half c, LIMBS x 64 coefficients;
//     a stage holds one 128 x DEPTH digit box and four 64-row panel boxes;
//   HALVES = 2 (K4): both output halves, 2 x LIMBS x 32 coefficients; a
//     stage holds the digit box and eight 32-row panel boxes, so each digit
//     stage taken from the ring feeds both halves, as the TPU's merged
//     kernel feeds both halves from one batch tile.
// Box (h, t), BOX = 64 / HALVES rows, fills fragment columns [BOX (h LIMBS
// + t), + BOX): the epilogue finds limb t of the tile's half h at the n8
// column blocks JB (h LIMBS + t) + j, j < JB = BOX / 8 (K4: 16h + 4t + j;
// K1: 8t + j), sums the four limbs of each (b, c, k) in registers with
// the shifts 8t, adds acc and stores one word.  Every box is a multiple of 1024 bytes, so every
// box starts on a 128-byte swizzle atom.
//
// Exactness: each int32 fragment sum is at most 2L * Npad * 128 * 128 in
// magnitude for any int8 digits and limbs; shape_ok keeps it below 2^31.
// Shared memory: 197,696 bytes at any shape, so N may be any power of two
// in [8, 2048] and l any level count whose sums stay exact.
//
// Each library that includes the header compiles its own copy of what it
// launches: the kernels are hidden from the library's exports
// (RUSTFHE_LOCAL), the host functions and the map cache have internal
// linkage.

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "cmux_common.cuh"
#include "hopper_common.cuh"

#define RUSTFHE_LOCAL __attribute__((visibility("hidden")))

namespace rustfhe {
namespace cmux {

using namespace rustfhe::hopper;

constexpr int LIMBS = 4;    // balanced signed 8-bit limbs of a key word
constexpr int COEFFS = 64;  // the most coefficients of one limb in a block tile: a box's rows
constexpr int BM = 128;     // samples of a block tile: two consumer warpgroups
constexpr int BN = 256;     // columns of a block tile
constexpr int CONSUMERS = 2;
constexpr int A_STAGE = BM * DEPTH;
constexpr int B_STAGE = BN * DEPTH;
constexpr int SMEM = ALIGN + STAGES * (A_STAGE + B_STAGE) + 2 * STAGES * 8;
constexpr int MIN_N = 8, MAX_N = 2048;
constexpr int CHUNK = 16;     // panel bytes (one row, consecutive r) per thread of a panel kernel
constexpr int THREADS = 256;  // of the panel and digit kernels

// The column layout of a block tile with HALVES output halves.
template <int HALVES>
struct Tile {
  static_assert(HALVES == 1 || HALVES == 2, "one output half or both");
  static constexpr int BOX = COEFFS / HALVES;  // rows of a panel box: coefficients of one limb
  static constexpr int JB = BOX / 8;           // n8 column blocks of one box
  static_assert(HALVES * LIMBS * BOX == BN, "the boxes fill the tile's columns");
  static_assert(BOX * DEPTH % ALIGN == 0, "every box starts on a swizzle atom");
};

// The shapes of one step at N and 2L planes.
struct Geometry {
  int npad;    // bytes of digits of a plane: N rounded up to DEPTH
  int slices;  // DEPTH-byte K slices of a plane
  int x0;      // key offset of a panel's first row
  int rows;    // rows of one panel: [x0, 2N), at least one box of COEFFS
  __host__ __device__ explicit Geometry(int N) {
    npad = N < DEPTH ? DEPTH : N;
    slices = npad / DEPTH;
    x0 = N + DEPTH - npad;
    rows = 2 * N - x0 < COEFFS ? COEFFS : 2 * N - x0;
  }
};

// acc: (B, 2, N) words; a_tilde: (B,) (reduced mod 2N here); digits:
// (B, 2L, npad) int8, plane p * l + lv.  Thread: four coefficients of one
// half of one sample, all l levels.
__global__ RUSTFHE_LOCAL void __launch_bounds__(THREADS)
step_digits_kernel(const int32_t* __restrict__ acc, const int32_t* __restrict__ a_tilde,
                   int8_t* __restrict__ digits, int B, int N, int l, int bgbit, uint32_t mask) {
  const Geometry g(N);
  const int quads = g.npad / 4;
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= B * 2 * quads) return;
  const int q = idx % quads;
  const int p = idx / quads % 2;
  const int b = idx / (2 * quads);
  const int tn = 2 * N;
  int a = a_tilde[b] % tn;
  if (a < 0) a += tn;
  const int32_t* poly = acc + ((size_t)b * 2 + p) * N;
  const auto at = [poly](int x) { return (uint32_t)poly[x]; };
  uint32_t u[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = 4 * q + m;
    u[m] = i < N ? rounded_diff(rotated_coeff(at, i, a, N), at(i), mask) : 0u;
  }
  for (int lv = 0; lv < l; ++lv) {
    uint32_t word = 0u;
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (4 * q + m < N) word |= (uint32_t)(uint8_t)digit(u[m], lv, bgbit) << (8 * m);
    *reinterpret_cast<uint32_t*>(digits + ((size_t)b * 2 * l + p * l + lv) * g.npad + 4 * q) = word;
  }
}

// tma_d: digits (B rows, 2L * npad bytes), boxes of (BM, DEPTH); tma_p:
// panels (2L * 2 * LIMBS * rows, DEPTH), boxes of (Tile<HALVES>::BOX,
// DEPTH).  out = [acc_in +] the recombined product, (B, 2, N) words.
template <bool ADD, int HALVES>
__global__ RUSTFHE_LOCAL void __launch_bounds__(Shape<CONSUMERS>::THREADS, 1)
cmux_product_kernel(const __grid_constant__ CUtensorMap tma_d,
                    const __grid_constant__ CUtensorMap tma_p, const int32_t* __restrict__ acc_in,
                    int32_t* __restrict__ out, int B, int N, int two_l) {
  using S = Shape<CONSUMERS>;
  using T = Tile<HALVES>;
  const Geometry g(N);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  const uint32_t a_ring = base;
  const uint32_t b_ring = base + STAGES * A_STAGE;
  const uint32_t full = b_ring + STAGES * B_STAGE;  // STAGES barriers of 8 bytes
  const uint32_t empty = full + STAGES * 8;

  const int wg = threadIdx.x / WG;
  const int KT = two_l * g.slices;  // K slices of a tile: plane j = ks / slices, slice ks % slices
  const int ctiles = (N + T::BOX - 1) / T::BOX;  // coefficient tiles of one half
  const int tiles_m = (B + BM - 1) / BM, tiles_n = 2 / HALVES * ctiles;
  const int tiles = tiles_m * tiles_n;
  // Column tile tn: its first output half c0 and first coefficient k0.
  const auto columns = [ctiles](int tn, int& c0, int& k0) {
    c0 = HALVES == 1 ? tn / ctiles : 0;
    k0 = tn % ctiles * T::BOX;
  };

  if (threadIdx.x == 0) ring_init(full, empty, CONSUMERS * WG / 32);
  __syncthreads();

  // The block walks the tiles blockIdx.x, + gridDim.x, ...; `it` counts the
  // stages it has passed through the ring over all its tiles (stage
  // it % STAGES in round it / STAGES), so a tile may start mid-round.
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      prefetch_map(&tma_d);
      prefetch_map(&tma_p);
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int tm, tn, c0, k0;
        tile_coords(tile, tiles_m, tiles_n, tm, tn);
        columns(tn, c0, k0);
        const int m0 = tm * BM;
        for (int ks = 0; ks < KT; ++ks, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, A_STAGE + B_STAGE);
          tma_load(a_ring + s * A_STAGE, &tma_d, full + 8 * s, ks * DEPTH, m0);
          const int j = ks / g.slices, kb = ks - j * g.slices;
          const int y = (j * 2 + c0) * LIMBS * g.rows + k0 + N - kb * DEPTH - g.x0;
#pragma unroll
          for (int box = 0; box < HALVES * LIMBS; ++box)  // box h * LIMBS + t: half c0 + h, limb t
            tma_load(b_ring + s * B_STAGE + box * T::BOX * DEPTH, &tma_p, full + 8 * s, 0,
                     y + box * g.rows);
        }
      }
    }
  } else {
    // Consumers: warpgroup cw computes samples 64cw..64cw+63 of each tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::CONSUMER_REGS));
    const int cw = wg - 1;
    const int t = threadIdx.x % WG;
    const int w = t / 32, ln = t % 32;
    int32_t acc[BN / 2];  // set by each tile's first wgmma (scale 0)
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int tm, tn, c0, k0;
      tile_coords(tile, tiles_m, tiles_n, tm, tn);
      columns(tn, c0, k0);
      const int m0 = tm * BM;
      for (int ks = 0; ks < KT; ++ks, ++it) {
        const int s = it % STAGES;
        mbar_wait(full + 8 * s, (it / STAGES) & 1);
        __syncwarp();  // the warp converges before the .aligned wgmma instructions
        const uint32_t a_s = a_ring + s * A_STAGE + cw * 64 * DEPTH;
        const uint32_t b_s = b_ring + s * B_STAGE;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DEPTH / KSTEP; ++kk)
          Wgmma<BN>::mma(acc, smem_desc(a_s + kk * KSTEP), smem_desc(b_s + kk * KSTEP),
                         (ks | kk) != 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products have retired
        fence_acc(acc);
        if (ks > 0 && ln == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (ln == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));

      // Column block JB (h LIMBS + lt) + j of the fragment is limb lt of
      // half c0 + h, coefficients k0 + 8j + 2(ln % 4), +1: acc[4 (JB (h
      // LIMBS + lt) + j) + e] (e: 0, 1 at row r, 2, 3 at row r + 8).
      // Recombine, add, store one int2 per (row, h, j).
      const int kq = k0 + 2 * (ln % 4);
#pragma unroll
      for (int r8 = 0; r8 < 2; ++r8) {
        const int b = m0 + cw * 64 + w * 16 + ln / 4 + 8 * r8;
        if (b >= B) continue;
#pragma unroll
        for (int h = 0; h < HALVES; ++h) {
          const size_t row = ((size_t)b * 2 + c0 + h) * N + kq;
#pragma unroll
          for (int j = 0; j < T::JB; ++j) {
            if (kq + 8 * j >= N) continue;
            const int e = 4 * (T::JB * h * LIMBS + j) + 2 * r8;
            uint32_t v0 = 0u, v1 = 0u;
#pragma unroll
            for (int lt = 0; lt < LIMBS; ++lt) {
              v0 += (uint32_t)acc[e + 4 * T::JB * lt] << (8 * lt);
              v1 += (uint32_t)acc[e + 1 + 4 * T::JB * lt] << (8 * lt);
            }
            if (ADD) {
              const int2 a = *reinterpret_cast<const int2*>(acc_in + row + 8 * j);
              v0 += (uint32_t)a.x;
              v1 += (uint32_t)a.y;
            }
            *reinterpret_cast<int2*>(out + row + 8 * j) = make_int2((int32_t)v0, (int32_t)v1);
          }
        }
      }
    }
  }
}

// Shapes the kernels take: B >= 1; N a power of two in [MIN_N, MAX_N]; the
// int32 sums exact for any int8 digits.
static bool shape_ok(int B, int N, int two_l) {
  if (B < 1 || N < MIN_N || N > MAX_N || (N & (N - 1)) || two_l < 1) return false;
  return (long long)two_l * Geometry(N).npad * 128 * 128 < (1ll << 31);
}

// Blocks of THREADS threads for `threads` threads.
static int blocks(int threads) { return (threads + THREADS - 1) / THREADS; }

static cudaError_t launch_digits(const void* acc, const void* a_tilde, void* digits, int B, int N,
                                 int l, int bgbit, unsigned int mask, cudaStream_t stream) {
  if ((uintptr_t)digits % 16) return cudaErrorMisalignedAddress;
  step_digits_kernel<<<blocks(B * 2 * (Geometry(N).npad / 4)), THREADS, 0, stream>>>(
      (const int32_t*)acc, (const int32_t*)a_tilde, (int8_t*)digits, B, N, l, bgbit,
      (uint32_t)mask);
  return cudaGetLastError();
}

static MapCache maps;  // the TMA maps of the library's digit and panel buffers

template <bool ADD, int HALVES>
static cudaError_t launch_product(const void* digits, const void* panel, const void* acc_in,
                                  void* out, int B, int N, int two_l, cudaStream_t stream) {
  static bool ready[MAX_DEVICES];
  if ((uintptr_t)digits % 16 || (uintptr_t)panel % 16 || (uintptr_t)acc_in % 8 ||
      (uintptr_t)out % 8)
    return cudaErrorMisalignedAddress;
  const auto kernel = cmux_product_kernel<ADD, HALVES>;
  int sms = 0;
  cudaError_t e = prepare_kernel((const void*)kernel, SMEM, Shape<CONSUMERS>::LAUNCH_REGS, ready,
                                 &sms);
  if (e != cudaSuccess) return e;
  const Geometry g(N);
  CUtensorMap map_d, map_p;
  if (!maps.get(&map_d, digits, B, two_l * g.npad, BM) ||
      !maps.get(&map_p, panel, two_l * 2 * LIMBS * g.rows, DEPTH, Tile<HALVES>::BOX))
    return cudaErrorInvalidValue;
  const int box = Tile<HALVES>::BOX;
  const int tiles = (B + BM - 1) / BM * (2 / HALVES) * ((N + box - 1) / box);
  kernel<<<tiles < sms ? tiles : sms, Shape<CONSUMERS>::THREADS, SMEM, stream>>>(
      map_d, map_p, (const int32_t*)acc_in, (int32_t*)out, B, N, two_l);
  return cudaGetLastError();
}

}  // namespace cmux
}  // namespace rustfhe
