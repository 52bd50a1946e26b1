// The CMux step as one int8 GEMM on Hopper (sm_90a): what the int32-key
// step K1/K2 (cmux_k.cu), the limb-table steps K4/K6 and K5
// (limb_step.cu), their ablations P5/P6 (limb_probe.cu) and the Karatsuba
// step's leaf products (karatsuba_probe.cu) share.  Each library builds its
// own key panels (K1's from the int32 key in cmux_k.cu; the others with
// limb_panel_kernel below) and then launches:
//
//   * limb_panel_kernel<LEAVES>: the K-major panels cut from an int8 limb
//     table, one panel set (LEAVES 1) or one per Karatsuba leaf (9);
//   * step_digits_kernel<ROTATE>: the digits of X^{a~} * acc - acc (of acc
//     itself, ROTATE false: P6 norot) as int8 (B, 2L, Npad), Npad = N
//     rounded up to DEPTH, zeros past N (cmux_common.cuh's rotated_coeff,
//     rounded_diff and digit);
//   * cmux_product_kernel<ADD, HALVES, F>: the GEMM of the digits against
//     the step's key panels on the warp-specialised mainloop of
//     hopper_common.cuh (a producer warpgroup keeps a 4-stage TMA ring
//     full, two consumer warpgroups run wgmma m64n256k32 .s32.s8.s8, a
//     persistent grid walks the block tiles), with the limb recombination
//     and, for ADD, the add of acc in its epilogue.  F (Product below)
//     names what an instantiation changes; Product itself is K1's.
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

// What an instantiation of the product changes in K1's (Product itself):
//   LEAVES  GEMMs of one launch, the leaf the slowest dimension of the
//           persistent tile order: GEMM t reads digit columns [t 2L Npad,
//           (t + 1) 2L Npad) and panel set t, and writes output rows
//           b LEAVES + t (the Karatsuba step's nine leaf products);
//   EPI     the epilogue: RECOMBINE (sum_t limb_t << 8t), LIMB0 (limb 0
//           alone) or PER_LIMB (each limb's int32 sum, rows (b, c, t));
//   DRAIN   the limbs recombine after each plane's K slices, 2L drains in
//           place of one, the sum restarting at each plane (P5 j-outer);
//   SERIAL  the block tile as two 64-sample sub-tiles in turn, each
//           through its own half of the ring: a stage holds one
//           sub-tile's 64-row digit box and feeds one consumer warpgroup,
//           so the panel boxes pass through the ring twice;
//   BUILD   the producer warpgroup builds a GEMM's digit stages when
//           F::sources names the GEMMs whose digits (in device memory)
//           sum to its own: __vadd4 into the stage's 128-byte swizzle
//           (BUILD_PIPELINED: the stage's panel boxes are requested before
//           the build, so their copy runs under it).
enum : int { RECOMBINE = 0, LIMB0 = 1, PER_LIMB = 2 };
enum : int { NO_BUILD = 0, BUILD_LEAF = 1, BUILD_PIPELINED = 2 };

struct Product {
  static constexpr int LEAVES = 1;
  static constexpr int EPI = RECOMBINE;
  static constexpr bool DRAIN = false;
  static constexpr bool SERIAL = false;
  static constexpr int BUILD = NO_BUILD;
};

// P5 j-outer: K4's product with a drain per plane.
struct Drain : Product {
  static constexpr bool DRAIN = true;
};

// panel: (LEAVES, 2L, 2, LIMBS, rows, DEPTH) int8 with panel[p, x - x0, r]
// = table[q(p), x - r] (r < N, x < 2N) and zeros elsewhere, for panel
// p = ((t 2L + j) 2 + c) LIMBS + k and the table's plane q(p): the limb
// table (2L, 2, LIMBS, 2N) (LEAVES 1: q = p) or the Karatsuba leaf table
// (2, LEAVES, LIMBS, 2L, 2N) (q = ((c LEAVES + t) LIMBS + k) 2L + j), read
// as words (4-byte aligned).  Thread: CHUNK bytes of one row x of one
// panel: the table's bytes x - r0 - 15 .. x - r0, reversed.
template <int LEAVES>
__global__ RUSTFHE_LOCAL void __launch_bounds__(THREADS)
limb_panel_kernel(const uint32_t* __restrict__ table, int8_t* __restrict__ panel, int N,
                  int two_l) {
  const Geometry g(N);
  constexpr int chunks = DEPTH / CHUNK;
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= LEAVES * two_l * 2 * LIMBS * g.rows * chunks) return;
  const int r0 = idx % chunks * CHUNK;
  const int xl = idx / chunks % g.rows;
  const int p = idx / (chunks * g.rows);
  const int x = g.x0 + xl;
  int q = p;
  if constexpr (LEAVES > 1) {
    const int k = p % LIMBS, c = p / LIMBS % 2, j = p / (2 * LIMBS) % two_l;
    q = ((c * LEAVES + p / (2 * LIMBS * two_l)) * LIMBS + k) * two_l + j;
  }
  const uint32_t* T = table + (size_t)q * (N / 2);  // a plane: 2N bytes
  uint32_t v[CHUNK / 4];
  if (r0 + CHUNK <= N && x < 2 * N) {
    // Every byte live: s = x - r0 - 15 >= x0 - N + 1 >= 1 and s + 15 < 2N.
    // W[i], the word at byte s + 4i, from the aligned words a[] (the fifth
    // only when s is not aligned: it then holds byte s + 15); panel word k
    // is W[3 - k] byte-reversed.
    const int s = x - r0 - (CHUNK - 1);
    const int w = s >> 2, sh = 8 * (s & 3);
    uint32_t a[5];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = T[w + i];
    a[4] = sh ? T[w + 4] : 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = __byte_perm(__funnelshift_r(a[3 - k], a[4 - k], sh), 0u, 0x0123);
  } else {
    // The edges (N < 128, rows past 2N): byte by byte, zeros where r >= N
    // or x >= 2N (x - r >= 1 wherever both hold).
    const uint8_t* Tb = reinterpret_cast<const uint8_t*>(T);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t word = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = r0 + 4 * k + b;
        if (r < N && x < 2 * N) word |= (uint32_t)Tb[x - r] << (8 * b);
      }
      v[k] = word;
    }
  }
  *reinterpret_cast<uint4*>(panel + ((size_t)p * g.rows + xl) * DEPTH + r0) =
      make_uint4(v[0], v[1], v[2], v[3]);
}

// acc: (B, 2, N) words; a_tilde: (B,) (reduced mod 2N here); digits:
// (B, 2L, npad) int8, plane p * l + lv, of X^{a~} * acc - acc (ROTATE) or
// of acc itself.  Thread: four coefficients of one half of one sample, all
// l levels.
template <bool ROTATE>
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
    if constexpr (ROTATE)
      u[m] = i < N ? rounded_diff(rotated_coeff(at, i, a, N), at(i), mask) : 0u;
    else
      u[m] = i < N ? rounded_diff(at(i), 0u, mask) : 0u;
  }
  for (int lv = 0; lv < l; ++lv) {
    uint32_t word = 0u;
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (4 * q + m < N) word |= (uint32_t)(uint8_t)digit(u[m], lv, bgbit) << (8 * m);
    *reinterpret_cast<uint32_t*>(digits + ((size_t)b * 2 * l + p * l + lv) * g.npad + 4 * q) = word;
  }
}

// P5 j-outer's drain: add the fragment's limbs, recombined, to rec, where
// rec[((r8 HALVES + h) JB + j) 2 + e] is the word of columns e = 0, 1 of
// block j of half h at row r + 8 r8 (the epilogue's order).
template <int HALVES>
__device__ __forceinline__ void drain_fragment(const int32_t (&acc)[BN / 2],
                                               uint32_t (&rec)[4 * HALVES * Tile<HALVES>::JB]) {
  constexpr int JB = Tile<HALVES>::JB;
#pragma unroll
  for (int r8 = 0; r8 < 2; ++r8)
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
#pragma unroll
      for (int j = 0; j < JB; ++j) {
        const int e = 4 * (JB * h * LIMBS + j) + 2 * r8;
        const int i = ((r8 * HALVES + h) * JB + j) * 2;
#pragma unroll
        for (int lt = 0; lt < LIMBS; ++lt) {
          rec[i] += (uint32_t)acc[e + 4 * JB * lt] << (8 * lt);
          rec[i + 1] += (uint32_t)acc[e + 1 + 4 * JB * lt] << (8 * lt);
        }
      }
}

// tma_d: digits (B rows, LEAVES 2L npad bytes), boxes of (BM, DEPTH) (F::SERIAL:
// (BM / 2, DEPTH)); tma_p: panels (LEAVES 2L 2 LIMBS rows, DEPTH), boxes of
// (Tile<HALVES>::BOX, DEPTH).  out = [acc_in +] the recombined product,
// (B LEAVES, 2, N) words (F::EPI PER_LIMB: (B LEAVES, 2, LIMBS, N) int32).
// digits: the digit matrix of tma_d, read by the producer when F::BUILD.
template <bool ADD, int HALVES, class F = Product>
__global__ RUSTFHE_LOCAL void __launch_bounds__(Shape<CONSUMERS>::THREADS, 1)
cmux_product_kernel(const __grid_constant__ CUtensorMap tma_d,
                    const __grid_constant__ CUtensorMap tma_p, const int32_t* __restrict__ acc_in,
                    int32_t* __restrict__ out, int B, int N, int two_l,
                    const int8_t* __restrict__ digits) {
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
  const int tiles = tiles_m * tiles_n * F::LEAVES;
  // F::SERIAL: sub-tile h's stages pass through its own half of the ring,
  // stages h RING + [0, RING), read by consumer warpgroup h alone, so that
  // each barrier has one consumer (a waiter that skipped a phase would
  // take a later round's parity for its own).
  constexpr int RING = STAGES / 2;
  // Column tile tn: its first output half c0 and first coefficient k0.
  const auto columns = [ctiles](int tn, int& c0, int& k0) {
    c0 = HALVES == 1 ? tn / ctiles : 0;
    k0 = tn % ctiles * T::BOX;
  };
  // Tile `tile`: its GEMM (leaf) and its (row, column) tile.
  const auto coords = [tiles_m, tiles_n](int tile, int& leaf, int& tm, int& tn) {
    if constexpr (F::LEAVES == 1) {
      leaf = 0;
      tile_coords(tile, tiles_m, tiles_n, tm, tn);
    } else {
      leaf = tile / (tiles_m * tiles_n);
      tile_coords(tile - leaf * tiles_m * tiles_n, tiles_m, tiles_n, tm, tn);
    }
  };
  // The first panel row of stage ks of a tile.
  const auto panel_row = [&g, two_l, N](int leaf, int ks, int c0, int k0) {
    const int j = ks / g.slices, kb = ks - j * g.slices;
    return ((leaf * two_l + j) * 2 + c0) * LIMBS * g.rows + k0 + N - kb * DEPTH - g.x0;
  };

  if (threadIdx.x == 0) ring_init(full, empty, (F::SERIAL ? 1 : CONSUMERS) * WG / 32);
  __syncthreads();

  // The block walks the tiles blockIdx.x, + gridDim.x, ...; `it` counts the
  // stages it has passed through the ring over all its tiles (stage
  // it % STAGES in round it / STAGES), so a tile may start mid-round.
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if constexpr (F::SERIAL) {
      if (threadIdx.x == 0) {
        prefetch_map(&tma_d);
        prefetch_map(&tma_p);
        int its[2] = {0, 0};  // the stages each sub-tile's ring has passed
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
          int leaf, tm, tn, c0, k0;
          coords(tile, leaf, tm, tn);
          columns(tn, c0, k0);
#pragma unroll
          for (int sub = 0; sub < 2; ++sub) {
            for (int ks = 0; ks < KT; ++ks) {
              const int j = its[sub]++;
              const int s = sub * RING + j % RING;
              mbar_wait(empty + 8 * s, ((j / RING) & 1) ^ 1);
              mbar_expect_tx(full + 8 * s, A_STAGE / 2 + B_STAGE);
              tma_load(a_ring + s * A_STAGE, &tma_d, full + 8 * s, (leaf * KT + ks) * DEPTH,
                       tm * BM + sub * (BM / 2));
              const int y = panel_row(leaf, ks, c0, k0);
#pragma unroll
              for (int box = 0; box < HALVES * LIMBS; ++box)
                tma_load(b_ring + s * B_STAGE + box * T::BOX * DEPTH, &tma_p, full + 8 * s, 0,
                         y + box * g.rows);
            }
          }
        }
      }
    } else if constexpr (F::BUILD == NO_BUILD) {
      if (threadIdx.x == 0) {
        prefetch_map(&tma_d);
        prefetch_map(&tma_p);
        int it = 0;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
          int leaf, tm, tn, c0, k0;
          coords(tile, leaf, tm, tn);
          columns(tn, c0, k0);
          const int m0 = tm * BM;
          for (int ks = 0; ks < KT; ++ks, ++it) {
            const int s = it % STAGES;
            mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
            mbar_expect_tx(full + 8 * s, A_STAGE + B_STAGE);
            tma_load(a_ring + s * A_STAGE, &tma_d, full + 8 * s, (leaf * KT + ks) * DEPTH, m0);
            const int y = panel_row(leaf, ks, c0, k0);
#pragma unroll
            for (int box = 0; box < HALVES * LIMBS; ++box)  // box h * LIMBS + t: half c0 + h, limb t
              tma_load(b_ring + s * B_STAGE + box * T::BOX * DEPTH, &tma_p, full + 8 * s, 0,
                       y + box * g.rows);
          }
        }
      }
    } else {
      // Every producer thread walks the tiles, in step: the threads meet at
      // named barrier 1 after every stage, so none waits on a barrier a
      // phase ahead or behind.  A stage of a GEMM whose digits F::sources
      // builds: the 128 threads sum the sources' 16-byte chunks of the
      // stage's rows into the 128-byte swizzle (chunk q of row r at chunk
      // q ^ (r % 8)) and make the writes visible to the async proxy; after
      // the barrier one thread arrives on the full barrier (expecting the
      // panel boxes' bytes).  Other stages: thread 0 alone, as above.
      static_assert(!F::SERIAL && HALVES == 1, "the builds take the plain tile");
      const int pt = threadIdx.x;
      const size_t row_bytes = (size_t)F::LEAVES * KT * DEPTH;
      if (pt == 0) {
        prefetch_map(&tma_d);
        prefetch_map(&tma_p);
      }
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int leaf, tm, tn, c0, k0;
        coords(tile, leaf, tm, tn);
        columns(tn, c0, k0);
        const int m0 = tm * BM;
        int src[4];
        const int nsrc = F::sources(leaf, src);
        for (int ks = 0; ks < KT; ++ks, ++it) {
          const int s = it % STAGES;
          const int y = panel_row(leaf, ks, c0, k0);
          const auto keys = [&] {
#pragma unroll
            for (int box = 0; box < LIMBS; ++box)
              tma_load(b_ring + s * B_STAGE + box * T::BOX * DEPTH, &tma_p, full + 8 * s, 0,
                       y + box * g.rows);
          };
          if (nsrc == 0) {
            if (pt == 0) {
              mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
              mbar_expect_tx(full + 8 * s, A_STAGE + B_STAGE);
              tma_load(a_ring + s * A_STAGE, &tma_d, full + 8 * s, (leaf * KT + ks) * DEPTH, m0);
              keys();
            }
          } else {
            mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
            if (F::BUILD == BUILD_PIPELINED && pt == 0) {
              mbar_expect_tx_only(full + 8 * s, B_STAGE);
              keys();
            }
            for (int ch = pt; ch < BM * DEPTH / 16; ch += WG) {
              const int r = ch / (DEPTH / 16), q = ch % (DEPTH / 16);
              const int b = m0 + r;
              uint4 v = make_uint4(0u, 0u, 0u, 0u);
              if (b < B) {
                const int8_t* at = digits + (size_t)b * row_bytes + (size_t)ks * DEPTH + q * 16;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  if (i >= nsrc) break;
                  const uint4 w =
                      *reinterpret_cast<const uint4*>(at + (size_t)src[i] * KT * DEPTH);
                  v = make_uint4(__vadd4(v.x, w.x), __vadd4(v.y, w.y), __vadd4(v.z, w.z),
                                 __vadd4(v.w, w.w));
                }
              }
              st_shared_v4(a_ring + s * A_STAGE + r * DEPTH + ((q ^ (r & 7)) << 4), v);
            }
            fence_proxy_async();
          }
          named_barrier_sync(1, WG);
          if (nsrc != 0 && pt == 0) {
            if (F::BUILD == BUILD_PIPELINED) {
              mbar_arrive(full + 8 * s);
            } else {
              mbar_expect_tx(full + 8 * s, B_STAGE);
              keys();
            }
          }
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
    uint32_t rec[F::DRAIN ? 4 * HALVES * T::JB : 1];  // F::DRAIN: drain_fragment's sums
    int it = 0, jc = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int leaf, tm, tn, c0, k0;
      coords(tile, leaf, tm, tn);
      columns(tn, c0, k0);
      const int m0 = tm * BM;
      if constexpr (F::SERIAL) {
        // Sub-tile cw's stages, in its half of the ring (`jc` of them so
        // far); `prev`, the last one not yet handed back.
        int prev = 0;
        for (int ks = 0; ks < KT; ++ks) {
          const int j = jc++;
          const int s = cw * RING + j % RING;
          mbar_wait(full + 8 * s, (j / RING) & 1);
          __syncwarp();
          const uint32_t a_s = a_ring + s * A_STAGE;
          const uint32_t b_s = b_ring + s * B_STAGE;
          fence_acc(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DEPTH / KSTEP; ++kk)
            Wgmma<BN>::mma(acc, smem_desc(a_s + kk * KSTEP), smem_desc(b_s + kk * KSTEP),
                           (ks | kk) != 0);
          wgmma_commit();
          wgmma_wait<1>();
          fence_acc(acc);
          if (ks > 0 && ln == 0) mbar_arrive(empty + 8 * prev);
          prev = s;
        }
        wgmma_wait<0>();
        fence_acc(acc);
        if (ln == 0) mbar_arrive(empty + 8 * prev);
      } else {
        if constexpr (F::DRAIN) {
#pragma unroll
          for (int i = 0; i < 4 * HALVES * T::JB; ++i) rec[i] = 0u;
        }
        for (int ks = 0; ks < KT; ++ks, ++it) {
          const int s = it % STAGES;
          mbar_wait(full + 8 * s, (it / STAGES) & 1);
          __syncwarp();  // the warp converges before the .aligned wgmma instructions
          const uint32_t a_s = a_ring + s * A_STAGE + cw * 64 * DEPTH;
          const uint32_t b_s = b_ring + s * B_STAGE;
          const int k_first = F::DRAIN ? ks % g.slices : ks;  // 0: the sum starts
          fence_acc(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DEPTH / KSTEP; ++kk)
            Wgmma<BN>::mma(acc, smem_desc(a_s + kk * KSTEP), smem_desc(b_s + kk * KSTEP),
                           (k_first | kk) != 0);
          wgmma_commit();
          wgmma_wait<1>();  // the previous stage's products have retired
          fence_acc(acc);
          if (ks > 0 && ln == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
          if constexpr (F::DRAIN) {
            if (k_first == g.slices - 1) {  // plane ks / slices is done: drain it
              wgmma_wait<0>();
              fence_acc(acc);
              drain_fragment<HALVES>(acc, rec);
            }
          }
        }
        wgmma_wait<0>();
        fence_acc(acc);
        if (ln == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
      }

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
          size_t row;  // the output row of (b, leaf, c0 + h), times N
          if constexpr (F::LEAVES == 1)
            row = ((size_t)b * 2 + c0 + h) * N + kq;
          else
            row = (((size_t)b * F::LEAVES + leaf) * 2 + c0 + h) * N + kq;
#pragma unroll
          for (int j = 0; j < T::JB; ++j) {
            if (kq + 8 * j >= N) continue;
            const int e = 4 * (T::JB * h * LIMBS + j) + 2 * r8;
            if constexpr (F::EPI == PER_LIMB) {
              static_assert(!ADD && !F::DRAIN, "the limbs' sums alone");
              const size_t lrow = (row - kq) * LIMBS + kq + 8 * j;
#pragma unroll
              for (int lt = 0; lt < LIMBS; ++lt)
                *reinterpret_cast<int2*>(out + lrow + (size_t)lt * N) =
                    make_int2(acc[e + 4 * T::JB * lt], acc[e + 1 + 4 * T::JB * lt]);
              continue;
            }
            uint32_t v0 = 0u, v1 = 0u;
            if constexpr (F::DRAIN) {
              const int i = ((r8 * HALVES + h) * T::JB + j) * 2;
              v0 = rec[i];
              v1 = rec[i + 1];
            } else if constexpr (F::EPI == LIMB0) {
              v0 = (uint32_t)acc[e];
              v1 = (uint32_t)acc[e + 1];
            } else {
#pragma unroll
              for (int lt = 0; lt < LIMBS; ++lt) {
                v0 += (uint32_t)acc[e + 4 * T::JB * lt] << (8 * lt);
                v1 += (uint32_t)acc[e + 1 + 4 * T::JB * lt] << (8 * lt);
              }
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

template <bool ROTATE = true>
static cudaError_t launch_digits(const void* acc, const void* a_tilde, void* digits, int B, int N,
                                 int l, int bgbit, unsigned int mask, cudaStream_t stream) {
  if ((uintptr_t)digits % 16) return cudaErrorMisalignedAddress;
  step_digits_kernel<ROTATE><<<blocks(B * 2 * (Geometry(N).npad / 4)), THREADS, 0, stream>>>(
      (const int32_t*)acc, (const int32_t*)a_tilde, (int8_t*)digits, B, N, l, bgbit,
      (uint32_t)mask);
  return cudaGetLastError();
}

template <int LEAVES = 1>
static cudaError_t launch_limb_panel(const void* table, void* panel, int N, int two_l,
                                     cudaStream_t stream) {
  if ((uintptr_t)table % 4 || (uintptr_t)panel % 16) return cudaErrorMisalignedAddress;
  const int threads = LEAVES * two_l * 2 * LIMBS * Geometry(N).rows * (DEPTH / CHUNK);
  limb_panel_kernel<LEAVES><<<blocks(threads), THREADS, 0, stream>>>((const uint32_t*)table,
                                                                     (int8_t*)panel, N, two_l);
  return cudaGetLastError();
}

static MapCache maps;  // the TMA maps of the library's digit and panel buffers

template <bool ADD, int HALVES, class F = Product>
static cudaError_t launch_product(const void* digits, const void* panel, const void* acc_in,
                                  void* out, int B, int N, int two_l, cudaStream_t stream) {
  static bool ready[MAX_DEVICES];
  if ((uintptr_t)digits % 16 || (uintptr_t)panel % 16 || (uintptr_t)acc_in % 8 ||
      (uintptr_t)out % 8)
    return cudaErrorMisalignedAddress;
  const auto kernel = cmux_product_kernel<ADD, HALVES, F>;
  int sms = 0;
  cudaError_t e = prepare_kernel((const void*)kernel, SMEM, Shape<CONSUMERS>::LAUNCH_REGS, ready,
                                 &sms);
  if (e != cudaSuccess) return e;
  const Geometry g(N);
  CUtensorMap map_d, map_p;
  if (!maps.get(&map_d, digits, B, F::LEAVES * two_l * g.npad, F::SERIAL ? BM / 2 : BM) ||
      !maps.get(&map_p, panel, F::LEAVES * two_l * 2 * LIMBS * g.rows, DEPTH, Tile<HALVES>::BOX))
    return cudaErrorInvalidValue;
  const int box = Tile<HALVES>::BOX;
  const int tiles = F::LEAVES * ((B + BM - 1) / BM) * (2 / HALVES) * ((N + box - 1) / box);
  kernel<<<tiles < sms ? tiles : sms, Shape<CONSUMERS>::THREADS, SMEM, stream>>>(
      map_d, map_p, (const int32_t*)acc_in, (int32_t*)out, B, N, two_l, (const int8_t*)digits);
  return cudaGetLastError();
}

}  // namespace cmux
}  // namespace rustfhe
