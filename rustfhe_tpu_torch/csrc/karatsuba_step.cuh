// K1's step on the two-level Karatsuba product, for Hopper (sm_90a): the
// step cmux_k.cu issues for wide batches (rustfhe_cmux_rotate_karatsuba).
//
// The function is K1's (cmux_k.cu), word for word:
//   out = acc + ExtProd(bk_i, Decompose(X^{a~} * acc - acc))
// in the standard (B, 2, N) layout, with 9/16 of the schoolbook product's
// int8 multiply-adds (engine/karatsuba.py).  The four residues r of a
// polynomial (its coefficients 4m + r) give T = 9 tree planes
// (cmux_common.cuh tree9) of the digits and of the key; leaf t is a
// negacyclic product of size ns = N/4 against its leaf table; and output
// residue i at position m sums leaves at m and, through Z (the shift by one
// position, -x[ns - 1] at m = 0), at m - 1 (karatsuba.tree_combine written
// out, coef below):
//   r0 = L0 + Z (L1 + L5 - L3 - L4)
//   r1 = L6 - L0 - L3 + Z (L7 - L1 - L4)
//   r2 = L2 - L0 - L1 + L3 + Z L4
//   r3 = L8 - L6 - L7 - L2 + L0 + L1 - L5 + L3 + L4
// Every sum wraps mod 2^32 and every map is linear, so the order of the
// sums does not change a word.
//
// Three launches a step, P4's (benches/k2_floor_probe.py) less its combine:
//   1. limb_panel_kernel<9> (cmux_step.cuh): the step's leaf panels from
//      its leaf table, which is prepared once for the whole key
//      (engine/cmux_k.py leaf_table);
//   2. leaf_digits_kernel: the nine tree planes of the step's digits, int8
//      (B, 9, 2L, npad), and zeros in the words of out that the product
//      adds into with atomics;
//   3. leaf_product_kernel: a block tile's nine leaf GEMMs one after the
//      other on cmux_step.cuh's TMA ring and wgmma mainloop, each leaf's
//      four limbs recombined in registers and added into the tile's four
//      output residues with the leaf's coefficients; the residues plus acc
//      are the step's output.  No leaf product goes to device memory and
//      there is no combine launch.
//
// The tile: 128 samples x one half x SPAN = 32 leaf positions, 4 limbs x 32
// = 128 columns, wgmma m64n128k32 for each of the two consumer warpgroups.
// A consumer thread holds the leaf's fragment (64 int32) and two of the four
// residues of its 16 (sample, position) pairs (32 words), the other two in
// shared memory: ptxas gives a 384-thread block 168 registers a thread,
// whatever setmaxnreg grants later, and with all four residues, or K1's
// 256-column tile, it spills and serialises the wgmmas.  Z moves a
// value one position on: inside the tile by a shuffle from the lane that
// holds position m - 1; across tiles, the Z terms of a tile's last position
// belong to the next tile's first (of the last tile's, negated, to position
// 0), so both tiles add into those words (residues 0-2 of every SPAN-th
// position) with atomics, on zeros the digit launch wrote.  A block walks
// its tiles with the sub-tile fastest, then the half, then the 128 samples,
// so the blocks resident at one time read the digits of a few sample tiles
// and find them in L2.  A stage is 16 KiB of digits and 16 KiB of panels;
// the ring holds RING = 6 of them.
//
// What bounds it, at DEFAULT_PARAMS and B = 16384 a step: 2 x 2 x 4 x 2L x
// 9 x ns^2 int8 operations a sample, 0.47 ms at 1,979 TOP/s; the bytes (the
// tree digits written and read back, 0.23 GB each way, the accumulator in
// and out, 0.13 GB each, the leaf panels 21 MiB) take ~0.22 ms at 3.35
// TB/s, most of it under the product's operations.

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "cmux_step.cuh"

namespace rustfhe {
namespace karatsuba {

using namespace rustfhe::hopper;
using cmux::BM;
using cmux::CONSUMERS;
using cmux::Geometry;
using cmux::LIMBS;
using cmux::THREADS;

constexpr int R = 4;                // residues of a half (two levels)
constexpr int TREE = 9;             // leaves
constexpr int SPAN = 32;            // leaf positions of a block tile: a panel box's rows
constexpr int JB = SPAN / 8;        // n8 column blocks of one limb
constexpr int BN = LIMBS * SPAN;    // columns of a block tile
constexpr int RING = 6;             // stages
constexpr int A_STAGE = BM * DEPTH;
constexpr int B_STAGE = BN * DEPTH;
constexpr int SHARED_RES = 2;       // output residues kept in shared memory (0 and 2)
constexpr int RES_BYTES = SHARED_RES * BM * SPAN * 4;
constexpr int SMEM = ALIGN + RING * (A_STAGE + B_STAGE) + RES_BYTES + 2 * RING * 8;
constexpr int MIN_N = R * SPAN, MAX_N = 2048;
static_assert(SMEM <= 232448, "the ring fits a block's shared memory");
static_assert(SPAN * DEPTH % ALIGN == 0, "every panel box starts on a swizzle atom");

// Four coefficients in [-1, 1], two bits each (1: +1, 3: -1).
__host__ __device__ constexpr int coefs(int c0, int c1, int c2, int c3) {
  return (c0 & 3) | (c1 & 3) << 2 | (c2 & 3) << 4 | (c3 & 3) << 6;
}

// The coefficient (-1, 0 or 1) of leaf t at position m (shifted: at m - 1,
// the Z term) in output residue i at position m.
__host__ __device__ constexpr int coef(int t, int i, bool shifted) {
  int row = 0;
  switch (t) {
    case 0: row = shifted ? 0 : coefs(1, -1, -1, 1); break;
    case 1: row = shifted ? coefs(1, -1, 0, 0) : coefs(0, 0, -1, 1); break;
    case 2: row = shifted ? 0 : coefs(0, 0, 1, -1); break;
    case 3: row = shifted ? coefs(-1, 0, 0, 0) : coefs(0, -1, 1, 1); break;
    case 4: row = shifted ? coefs(-1, -1, 1, 0) : coefs(0, 0, 0, 1); break;
    case 5: row = shifted ? coefs(1, 0, 0, 0) : coefs(0, 0, 0, -1); break;
    case 6: row = shifted ? 0 : coefs(0, 1, 0, -1); break;
    case 7: row = shifted ? coefs(0, 1, 0, 0) : coefs(0, 0, 0, -1); break;
    case 8: row = shifted ? 0 : coefs(0, 0, 0, 1); break;
    default: break;
  }
  const int v = row >> (2 * i) & 3;
  return v == 3 ? -1 : v;
}

// 2. acc (B, 2, N) words; a_tilde (B,) (reduced mod 2N here); digits (B,
// 9, 2L, npad) int8, npad = ns rounded up to DEPTH: byte m of plane p l +
// lv of leaf t is tree plane t of the level-lv digits of the residues of
// X^{a~} * acc - acc at position m of half p, zero for m >= ns; out (B, 2,
// N): residues 0-2 of every SPAN-th position set to zero.  Thread: sample
// b, half p, position m (its four coefficients, one 16-byte load), all
// levels: one byte of each (leaf, plane), a warp's 32 consecutive.
__global__ RUSTFHE_LOCAL void __launch_bounds__(THREADS)
leaf_digits_kernel(const int32_t* __restrict__ acc, const int32_t* __restrict__ a_tilde,
                   int8_t* __restrict__ digits, int32_t* __restrict__ out, int B, int N, int l,
                   int bgbit, uint32_t mask) {
  const int ns = N / R;
  const int npad = Geometry(ns).npad;
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= B * 2 * npad) return;
  const int m = idx % npad;
  const int p = idx / npad % 2;
  const int b = idx / (2 * npad);
  const bool live = m < ns;
  const size_t half = ((size_t)b * 2 + p) * N;
  uint32_t u[R] = {0u, 0u, 0u, 0u};  // residue r at position m
  if (live) {
    const int32_t* poly = acc + half;
    const auto at = [poly](int x) { return (uint32_t)poly[x]; };
    int a = a_tilde[b] % (2 * N);
    if (a < 0) a += 2 * N;
    const int4 cur = *reinterpret_cast<const int4*>(poly + R * m);
    const uint32_t c[R] = {(uint32_t)cur.x, (uint32_t)cur.y, (uint32_t)cur.z, (uint32_t)cur.w};
#pragma unroll
    for (int r = 0; r < R; ++r) u[r] = rounded_diff(rotated_coeff(at, R * m + r, a, N), c[r], mask);
    if (m % SPAN == 0) {
#pragma unroll
      for (int r = 0; r < R - 1; ++r) out[half + R * m + r] = 0;
    }
  }
  int8_t* dst = digits + ((size_t)b * TREE * 2 * l + p * l) * npad + m;
  for (int lv = 0; lv < l; ++lv) {
    int32_t d[R], q[TREE];
#pragma unroll
    for (int r = 0; r < R; ++r) d[r] = digit(u[r], lv, bgbit);
    tree9(d, q, [](int32_t x, int32_t y) { return x + y; });
#pragma unroll
    for (int t = 0; t < TREE; ++t) dst[((size_t)t * 2 * l + lv) * npad] = (int8_t)q[t];
  }
}

// Leaf T's fragment folded into a block tile's output residues: its four
// limbs recombined, shifted by one position for the residues that take its
// Z term, and added with the leaf's coefficients (leaf 0 sets them).  The
// fragment's column block lt JB + j holds limb lt at the tile's positions 8j
// + 2q and + 1 (e = 0, 1) of rows r and r + 8 (r8 = 0, 1): frag[4 (lt JB +
// j) + 2 r8 + e].  Residues 1 and 3 live in registers (reg[0], reg[1], at
// (r8, j, e), zero at the tile's start), 0 and 2 in shared memory (res: the thread's row r of each,
// SPAN words in a swizzle that keeps a warp's rows on distinct banks; row r
// + 8 at res + 8 SPAN); each thread touches its own words alone.  next:
// the Z terms of the next tile's first position, from the tile's last (the
// lanes q = 3 hold it).
template <int T>
__device__ __forceinline__ void fold_leaf(const int32_t (&frag)[BN / 2],
                                          uint32_t (&reg)[2][2][JB][2],
                                          uint32_t (&next)[R - 1][2], uint32_t* res, int q,
                                          int prev_lane, int swizzle) {
  constexpr bool SHIFTED = coef(T, 0, true) || coef(T, 1, true) || coef(T, 2, true);
#pragma unroll
  for (int r8 = 0; r8 < 2; ++r8) {
    uint32_t v[JB][2], z[JB][2];  // leaf T at (j, e), and at the position before
#pragma unroll
    for (int j = 0; j < JB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint32_t x = 0u;
#pragma unroll
        for (int lt = 0; lt < LIMBS; ++lt)
          x += (uint32_t)frag[4 * (lt * JB + j) + 2 * r8 + e] << (8 * lt);
        v[j][e] = x;
        z[j][e] = 0u;
      }
    if (SHIFTED) {
      uint32_t up[JB];  // column 2q - 1 (mod 8) of block j
#pragma unroll
      for (int j = 0; j < JB; ++j) up[j] = __shfl_sync(0xFFFFFFFFu, v[j][1], prev_lane);
#pragma unroll
      for (int j = 0; j < JB; ++j) {
        z[j][1] = v[j][0];
        // q = 0: the last column of block j - 1; before block 0, the previous tile's (its
        // `next`, added with atomics).
        z[j][0] = q ? up[j] : j > 0 ? up[j > 0 ? j - 1 : 0] : 0u;
      }
#pragma unroll
      for (int i = 0; i < R - 1; ++i) next[i][r8] += (uint32_t)coef(T, i, true) * v[JB - 1][1];
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const uint32_t cv = (uint32_t)coef(T, i, false), cz = (uint32_t)coef(T, i, true);
      if (cv == 0u && cz == 0u) continue;
#pragma unroll
      for (int j = 0; j < JB; ++j) {
        const uint32_t a0 = cv * v[j][0] + cz * z[j][0], a1 = cv * v[j][1] + cz * z[j][1];
        if (i % 2) {
          reg[i / 2][r8][j][0] += a0;
          reg[i / 2][r8][j][1] += a1;
        } else {
          uint2* at = reinterpret_cast<uint2*>(res + (i / 2 * BM + 8 * r8) * SPAN +
                                               ((8 * j + 2 * q) ^ swizzle));
          if (T) {
            const uint2 x = *at;
            *at = make_uint2(x.x + a0, x.y + a1);
          } else {
            *at = make_uint2(a0, a1);
          }
        }
      }
    }
  }
}

// 3. tma_d: digits (B rows, 9 2L npad bytes), boxes of (BM, DEPTH); tma_p:
// leaf panels (9 2L 2 LIMBS rows, DEPTH) (limb_panel_kernel<9> at N := ns),
// boxes of (SPAN, DEPTH).  out = acc_in + the step's product, (B, 2, N)
// words, with the words leaf_digits_kernel zeroes at zero.
__global__ RUSTFHE_LOCAL void __launch_bounds__(Shape<CONSUMERS>::THREADS, 1)
leaf_product_kernel(const __grid_constant__ CUtensorMap tma_d,
                    const __grid_constant__ CUtensorMap tma_p, const int32_t* __restrict__ acc_in,
                    int32_t* __restrict__ out, int B, int N, int two_l) {
  using S = Shape<CONSUMERS>;
  const int ns = N / R;
  const Geometry g(ns);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  const uint32_t a_ring = base;
  const uint32_t b_ring = base + RING * A_STAGE;
  const uint32_t res_at = b_ring + RING * B_STAGE;  // (SHARED_RES, BM, SPAN) words
  const uint32_t full = res_at + RES_BYTES;          // RING barriers of 8 bytes
  const uint32_t empty = full + RING * 8;

  const int wg = threadIdx.x / WG;
  const int KT = two_l * g.slices;  // K slices of a leaf: plane j = ks / slices, slice ks % slices
  const int subs = ns / SPAN;       // sub-tiles of a half
  const int units = (B + BM - 1) / BM * 2 * subs;
  // Unit u: samples BM (u / 2 subs) on, half u / subs % 2, positions SPAN (u % subs) on.
  const auto unit = [subs](int u, int& tm, int& c, int& s) {
    tm = u / (2 * subs);
    c = u / subs % 2;
    s = u % subs;
  };

  if (threadIdx.x == 0) ring_init(full, empty, CONSUMERS * WG / 32, RING);
  __syncthreads();

  // As in cmux_product_kernel, `it` counts the stages a thread has passed
  // through the ring over all its tiles (stage it % RING in round it / RING).
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      prefetch_map(&tma_d);
      prefetch_map(&tma_p);
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int tm, c, s;
        unit(u, tm, c, s);
        for (int t = 0; t < TREE; ++t) {
          for (int ks = 0; ks < KT; ++ks, ++it) {
            const int st = it % RING;
            mbar_wait(empty + 8 * st, ((it / RING) & 1) ^ 1);
            mbar_expect_tx(full + 8 * st, A_STAGE + B_STAGE);
            tma_load(a_ring + st * A_STAGE, &tma_d, full + 8 * st, (t * KT + ks) * DEPTH, tm * BM);
            // Limb k's box: the panel rows of positions SPAN s .. over slice kb of plane j.
            const int j = ks / g.slices, kb = ks - j * g.slices;
            const int y = ((t * two_l + j) * 2 + c) * LIMBS * g.rows + s * SPAN + ns - kb * DEPTH -
                          g.x0;
#pragma unroll
            for (int k = 0; k < LIMBS; ++k)
              tma_load(b_ring + st * B_STAGE + k * SPAN * DEPTH, &tma_p, full + 8 * st, 0,
                       y + k * g.rows);
          }
        }
      }
    }
  } else {
    // Consumers: warpgroup cw computes samples 64 cw .. 64 cw + 63 of each tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::CONSUMER_REGS));
    const int cw = wg - 1;
    const int th = threadIdx.x % WG;
    const int w = th / 32, ln = th % 32, q = ln % 4;
    const int prev_lane = (ln & ~3) | ((ln + 3) & 3);  // holds the columns 2q - 2, 2q - 1 (mod 8)
    const int row = cw * 64 + w * 16 + ln / 4;          // the thread's first row of a tile
    const int swizzle = (row & 3) << 3;
    uint32_t* res = reinterpret_cast<uint32_t*>(smem_raw + (res_at - smem_u32(smem_raw))) +
                    row * SPAN;
    int32_t frag[BN / 2];  // set by each leaf's first wgmma (scale 0)
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      int tm, c, s;
      unit(u, tm, c, s);
      uint32_t reg[2][2][JB][2];  // residues 1 and 3 (fold_leaf)
      uint32_t next[R - 1][2];    // the Z terms of the next tile's first position (lanes q = 3)
#pragma unroll
      for (int r8 = 0; r8 < 2; ++r8) {
#pragma unroll
        for (int j = 0; j < JB; ++j) reg[0][r8][j][0] = reg[0][r8][j][1] = reg[1][r8][j][0] =
            reg[1][r8][j][1] = 0u;
#pragma unroll
        for (int i = 0; i < R - 1; ++i) next[i][r8] = 0u;
      }
      for (int t = 0; t < TREE; ++t) {
        for (int ks = 0; ks < KT; ++ks, ++it) {
          const int st = it % RING;
          mbar_wait(full + 8 * st, (it / RING) & 1);
          __syncwarp();  // the warp converges before the .aligned wgmma instructions
          const uint32_t a_s = a_ring + st * A_STAGE + cw * 64 * DEPTH;
          const uint32_t b_s = b_ring + st * B_STAGE;
          fence_acc(frag);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DEPTH / KSTEP; ++kk)
            Wgmma<BN>::mma(frag, smem_desc(a_s + kk * KSTEP), smem_desc(b_s + kk * KSTEP),
                           (ks | kk) != 0);
          wgmma_commit();
          wgmma_wait<1>();  // the previous stage's products have retired
          fence_acc(frag);
          if (ks > 0 && ln == 0) mbar_arrive(empty + 8 * ((it - 1) % RING));
        }
        wgmma_wait<0>();
        fence_acc(frag);
        if (ln == 0) mbar_arrive(empty + 8 * ((it - 1) % RING));
        switch (t) {
#define RUSTFHE_FOLD(T) \
  case T:               \
    fold_leaf<T>(frag, reg, next, res, q, prev_lane, swizzle); \
    break;
          RUSTFHE_FOLD(0) RUSTFHE_FOLD(1) RUSTFHE_FOLD(2) RUSTFHE_FOLD(3) RUSTFHE_FOLD(4)
          RUSTFHE_FOLD(5) RUSTFHE_FOLD(6) RUSTFHE_FOLD(7) RUSTFHE_FOLD(8)
#undef RUSTFHE_FOLD
        }
      }

      // acc plus the residues, four words (the residues of one position) a store; the tile's
      // first position's residues 0-2 and the next tile's Z terms by atomics.
#pragma unroll
      for (int r8 = 0; r8 < 2; ++r8) {
        const int b = tm * BM + row + 8 * r8;
        if (b >= B) continue;
        const size_t half = ((size_t)b * 2 + c) * N;
#pragma unroll
        for (int j = 0; j < JB; ++j) {
          const int col = (8 * j + 2 * q) ^ swizzle;
          const uint2 r0 = *reinterpret_cast<const uint2*>(res + 8 * r8 * SPAN + col);
          const uint2 r2 = *reinterpret_cast<const uint2*>(res + (BM + 8 * r8) * SPAN + col);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const size_t at = half + R * (s * SPAN + 8 * j + 2 * q + e);
            const int4 a = *reinterpret_cast<const int4*>(acc_in + at);
            const uint32_t o0 = (uint32_t)a.x + (e ? r0.y : r0.x);
            const uint32_t o1 = (uint32_t)a.y + reg[0][r8][j][e];
            const uint32_t o2 = (uint32_t)a.z + (e ? r2.y : r2.x);
            const uint32_t o3 = (uint32_t)a.w + reg[1][r8][j][e];
            if (j == 0 && e == 0 && q == 0) {
              uint32_t* o = reinterpret_cast<uint32_t*>(out + at);
              atomicAdd(o, o0);
              atomicAdd(o + 1, o1);
              atomicAdd(o + 2, o2);
              o[3] = o3;
            } else {
              *reinterpret_cast<int4*>(out + at) =
                  make_int4((int32_t)o0, (int32_t)o1, (int32_t)o2, (int32_t)o3);
            }
          }
        }
        if (q == 3) {
          // Z at position 0 is minus the last position's value.
          const bool wraps = (s + 1) * SPAN == ns;
          uint32_t* o = reinterpret_cast<uint32_t*>(out + half + (wraps ? 0 : R * (s + 1) * SPAN));
#pragma unroll
          for (int i = 0; i < R - 1; ++i) atomicAdd(o + i, wraps ? 0u - next[i][r8] : next[i][r8]);
        }
      }
    }
  }
}

// Shapes the step takes: N a power of two in [MIN_N, MAX_N] (whole
// sub-tiles), digit tree sums in int8 (half_bg * 4 <= 128), and the leaf
// product's shapes (cmux_step.cuh shape_ok at N := ns).
static bool step_shape_ok(int B, int N, int l, int bgbit) {
  if (N < MIN_N || N > MAX_N || (N & (N - 1)) || l < 1 || bgbit < 1 || bgbit > 6) return false;
  return cmux::shape_ok(B, N / R, 2 * l);
}

// The bytes of one step's leaf table: (2, 9, LIMBS, 2L, 2ns) int8.
static size_t table_bytes(int N, int l) { return (size_t)2 * TREE * LIMBS * 2 * l * (N / 2); }

static cudaError_t launch_leaf_panel(const void* table, void* panel, int N, int l,
                                     cudaStream_t stream) {
  return cmux::launch_limb_panel<TREE>(table, panel, N / R, 2 * l, stream);
}

static cudaError_t launch_leaf_digits(const void* acc, const void* a_tilde, void* digits, void* out,
                                      int B, int N, int l, int bgbit, unsigned int mask,
                                      cudaStream_t stream) {
  if ((uintptr_t)digits % 16 || (uintptr_t)acc % 16 || (uintptr_t)out % 16)
    return cudaErrorMisalignedAddress;
  leaf_digits_kernel<<<cmux::blocks(B * 2 * Geometry(N / R).npad), THREADS, 0, stream>>>(
      (const int32_t*)acc, (const int32_t*)a_tilde, (int8_t*)digits, (int32_t*)out, B, N, l,
      bgbit, (uint32_t)mask);
  return cudaGetLastError();
}

// The product's TMA maps and grid, fetched once for the steps of a rotation.
struct ProductPlan {
  CUtensorMap map_d, map_p;
  int grid;
};

static cudaError_t plan_product(ProductPlan* plan, const void* digits, const void* panel, int B,
                                int N, int l) {
  static bool ready[MAX_DEVICES];
  if ((uintptr_t)digits % 16 || (uintptr_t)panel % 16) return cudaErrorMisalignedAddress;
  int sms = 0;
  const cudaError_t e = prepare_kernel((const void*)leaf_product_kernel, SMEM,
                                       Shape<CONSUMERS>::LAUNCH_REGS, ready, &sms);
  if (e != cudaSuccess) return e;
  const Geometry g(N / R);
  if (!cmux::maps.get(&plan->map_d, digits, B, TREE * 2 * l * g.npad, BM) ||
      !cmux::maps.get(&plan->map_p, panel, TREE * 2 * l * 2 * LIMBS * g.rows, DEPTH, SPAN))
    return cudaErrorInvalidValue;
  const int units = (B + BM - 1) / BM * 2 * (N / R / SPAN);
  plan->grid = units < sms ? units : sms;
  return cudaSuccess;
}

static cudaError_t launch_product(const ProductPlan& plan, const void* acc_in, void* out, int B,
                                  int N, int l, cudaStream_t stream) {
  if ((uintptr_t)acc_in % 16 || (uintptr_t)out % 16) return cudaErrorMisalignedAddress;
  leaf_product_kernel<<<plan.grid, Shape<CONSUMERS>::THREADS, SMEM, stream>>>(
      plan.map_d, plan.map_p, (const int32_t*)acc_in, (int32_t*)out, B, N, 2 * l);
  return cudaGetLastError();
}

// One step's three launches: acc -> out (distinct buffers), into the
// caller's digit and panel buffers, on the step's leaf table.
static cudaError_t launch_step(const ProductPlan& plan, const void* acc, const void* a_tilde,
                               const void* table, void* out, void* digits, void* panel, int B,
                               int N, int l, int bgbit, unsigned int mask, cudaStream_t stream) {
  cudaError_t e = launch_leaf_panel(table, panel, N, l, stream);
  if (e == cudaSuccess)
    e = launch_leaf_digits(acc, a_tilde, digits, out, B, N, l, bgbit, mask, stream);
  if (e == cudaSuccess) e = launch_product(plan, acc, out, B, N, l, stream);
  return e;
}

}  // namespace karatsuba
}  // namespace rustfhe
