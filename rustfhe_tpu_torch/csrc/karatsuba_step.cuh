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
// Four launches a step, P4's (benches/k2_floor_probe.py) product on the
// standard layout's digits and combine:
//   1. limb_panel_kernel<9> (cmux_step.cuh): the step's leaf panels from
//      its leaf table, which is prepared once for the whole key
//      (engine/cmux_k.py leaf_table);
//   2. leaf_digits_kernel: the nine tree planes of the step's digits, int8
//      (B, 9, 2L, npad), read from acc in the standard layout;
//   3. cmux_product_kernel<false, 1, LeafProduct<RECOMBINE, false,
//      NO_BUILD>> (cmux_step.cuh, the product P1-P4 and P8 of
//      karatsuba_probe.cu run too): the nine leaf GEMMs in one launch on
//      K1's tile (128 samples x one half x 4 limbs x 64 leaf positions,
//      wgmma m64n256k32, a 4-stage TMA ring), the leaf the slowest
//      dimension of the persistent tile order; the epilogue recombines each
//      leaf's four limbs in registers and writes the leaves, (B, 9, 2, ns)
//      words, to device memory;
//   4. leaf_combine_kernel: acc plus the tree combine of the nine leaves, a
//      thread a (sample, half, position): one 16-byte load of acc, the nine
//      leaves there and five at the position before, one 16-byte store.
//
// Why the leaves go through device memory: with the combine in the
// product's epilogue (the design this replaces), the four output residues
// sit beside the 64-word fragment of a consumer thread, and ptxas gives a
// 384-thread block 168 registers a thread, so the tile had to narrow to 128
// columns; it ran at ~54 % of its bound, and the step is 7-19 % slower than
// this one (PERF.md §6).  The product here keeps K1's 256-column tile.
//
// What bounds it, at DEFAULT_PARAMS and B = 16384 a step: 2 x 2 x 4 x 2L x
// 9 x ns^2 int8 operations a sample, 0.47 ms at 1,979 TOP/s.  The bytes:
// the tree digits, 0.23 GB written and read back; the leaves, 18 N bytes a
// sample (0.30 GB) written by the product and read by the combine; the
// accumulator read twice (the digits, the combine) and written once, 0.13
// GB each; the leaf panels 21 MiB: ~1.5 GB in all, 0.45 ms at 3.35 TB/s.
// The product's own bytes (the digits in, the leaves out) run under its
// operations; the digits and the combine are bound by their bytes alone.

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "cmux_step.cuh"

namespace rustfhe {
namespace karatsuba {

using namespace rustfhe::hopper;
using cmux::Geometry;
using cmux::THREADS;

constexpr int R = 4;      // residues of a half (two levels)
constexpr int TREE = 9;   // leaves
constexpr int MIN_N = R * cmux::MIN_N, MAX_N = 2048;

// The leaf product (cmux_step.cuh Product): the nine leaf GEMMs in one
// launch, with its epilogue, its tile order and its builds.  The step takes
// LeafProduct<RECOMBINE, false, NO_BUILD>; karatsuba_probe.cu's forms the
// others.
template <int EPI_, bool SERIAL_, int BUILD_>
struct LeafProduct : cmux::Product {
  static constexpr int LEAVES = TREE;
  static constexpr int EPI = EPI_;
  static constexpr bool SERIAL = SERIAL_;
  static constexpr int BUILD = BUILD_;
  // The residue leaves whose digits sum to leaf t's (r0, r2, r1, r3 are
  // leaves 0, 1, 3, 4); 0 for a residue leaf.
  __device__ static int sources(int t, int (&src)[4]) {
    switch (t) {
      case 2: src[0] = 0; src[1] = 1; return 2;  // r0 + r2
      case 5: src[0] = 3; src[1] = 4; return 2;  // r1 + r3
      case 6: src[0] = 0; src[1] = 3; return 2;  // r0 + r1
      case 7: src[0] = 1; src[1] = 4; return 2;  // r2 + r3
      case 8: src[0] = 0; src[1] = 1; src[2] = 3; src[3] = 4; return 4;
      default: return 0;
    }
  }
};

using StepProduct = LeafProduct<cmux::RECOMBINE, false, cmux::NO_BUILD>;

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
// X^{a~} * acc - acc at position m of half p, zero for m >= ns.  Thread:
// sample b, half p, position m (its four coefficients, one 16-byte load),
// all levels: one byte of each (leaf, plane), a warp's 32 consecutive.
__global__ RUSTFHE_LOCAL void __launch_bounds__(THREADS)
leaf_digits_kernel(const int32_t* __restrict__ acc, const int32_t* __restrict__ a_tilde,
                   int8_t* __restrict__ digits, int B, int N, int l, int bgbit, uint32_t mask) {
  const int ns = N / R;
  const int npad = Geometry(ns).npad;
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= B * 2 * npad) return;
  const int m = idx % npad;
  const int p = idx / npad % 2;
  const int b = idx / (2 * npad);
  uint32_t u[R] = {0u, 0u, 0u, 0u};  // residue r at position m
  if (m < ns) {
    const int32_t* poly = acc + ((size_t)b * 2 + p) * N;
    const auto at = [poly](int x) { return (uint32_t)poly[x]; };
    int a = a_tilde[b] % (2 * N);
    if (a < 0) a += 2 * N;
    const int4 cur = *reinterpret_cast<const int4*>(poly + R * m);
    const uint32_t c[R] = {(uint32_t)cur.x, (uint32_t)cur.y, (uint32_t)cur.z, (uint32_t)cur.w};
#pragma unroll
    for (int r = 0; r < R; ++r) u[r] = rounded_diff(rotated_coeff(at, R * m + r, a, N), c[r], mask);
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

// 4. out = acc + the tree combine of the leaves, both (B, 2, N) words;
// leaves (B, 9, 2, ns) words, leaf t of half c at position m.  Thread:
// sample b, half c, position m: output residues 0-3 there, from the leaves
// at m and (the Z terms of leaves 1, 3, 4, 5, 7) at m - 1, negated from
// ns - 1 at m = 0.
__global__ RUSTFHE_LOCAL void __launch_bounds__(THREADS)
leaf_combine_kernel(const int32_t* __restrict__ acc, const uint32_t* __restrict__ leaves,
                    int32_t* __restrict__ out, int B, int N) {
  const int ns = N / R;
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= B * 2 * ns) return;
  const int m = idx % ns;
  const int bc = idx / ns;  // b 2 + c
  const uint32_t* leaf = leaves + ((size_t)(bc / 2) * TREE * 2 + bc % 2) * ns;  // leaf t at t 2 ns
  const int before = m > 0 ? m - 1 : ns - 1;
  const uint32_t sign = m > 0 ? 1u : 0u - 1u;
  const size_t at = (size_t)bc * N + R * m;
  const int4 a = *reinterpret_cast<const int4*>(acc + at);
  uint32_t o[R] = {(uint32_t)a.x, (uint32_t)a.y, (uint32_t)a.z, (uint32_t)a.w};
#pragma unroll
  for (int t = 0; t < TREE; ++t) {
    const uint32_t v = leaf[(size_t)t * 2 * ns + m];
    const bool shifted = coef(t, 0, true) || coef(t, 1, true) || coef(t, 2, true);
    const uint32_t z = shifted ? sign * leaf[(size_t)t * 2 * ns + before] : 0u;
#pragma unroll
    for (int i = 0; i < R; ++i)
      o[i] += (uint32_t)coef(t, i, false) * v + (uint32_t)coef(t, i, true) * z;
  }
  *reinterpret_cast<int4*>(out + at) =
      make_int4((int32_t)o[0], (int32_t)o[1], (int32_t)o[2], (int32_t)o[3]);
}

// Shapes the step takes: N a power of two in [MIN_N, MAX_N], digit tree
// sums in int8 (half_bg * 4 <= 128), and the leaf product's shapes
// (cmux_step.cuh shape_ok at N := ns).
static bool step_shape_ok(int B, int N, int l, int bgbit) {
  if (N < MIN_N || N > MAX_N || (N & (N - 1)) || l < 1 || bgbit < 1 || bgbit > 6) return false;
  return cmux::shape_ok(B, N / R, 2 * l);
}

// The bytes of one step's leaf table: (2, 9, LIMBS, 2L, 2ns) int8.
static size_t table_bytes(int N, int l) {
  return (size_t)2 * TREE * cmux::LIMBS * 2 * l * (N / 2);
}

static cudaError_t launch_leaf_panel(const void* table, void* panel, int N, int l,
                                     cudaStream_t stream) {
  return cmux::launch_limb_panel<TREE>(table, panel, N / R, 2 * l, stream);
}

static cudaError_t launch_leaf_digits(const void* acc, const void* a_tilde, void* digits, int B,
                                      int N, int l, int bgbit, unsigned int mask,
                                      cudaStream_t stream) {
  if ((uintptr_t)digits % 16 || (uintptr_t)acc % 16) return cudaErrorMisalignedAddress;
  leaf_digits_kernel<<<cmux::blocks(B * 2 * Geometry(N / R).npad), THREADS, 0, stream>>>(
      (const int32_t*)acc, (const int32_t*)a_tilde, (int8_t*)digits, B, N, l, bgbit,
      (uint32_t)mask);
  return cudaGetLastError();
}

static cudaError_t launch_leaf_combine(const void* acc, const void* leaves, void* out, int B,
                                       int N, cudaStream_t stream) {
  if ((uintptr_t)acc % 16 || (uintptr_t)leaves % 4 || (uintptr_t)out % 16)
    return cudaErrorMisalignedAddress;
  leaf_combine_kernel<<<cmux::blocks(B * 2 * (N / R)), THREADS, 0, stream>>>(
      (const int32_t*)acc, (const uint32_t*)leaves, (int32_t*)out, B, N);
  return cudaGetLastError();
}

// The leaf product's TMA maps and grid (cmux_step.cuh ProductPlan), fetched
// once for the steps of a rotation.
static cudaError_t plan_product(cmux::ProductPlan* plan, const void* digits, const void* panel,
                                int B, int N, int l) {
  return cmux::plan_product<false, 1, StepProduct>(plan, digits, panel, B, N / R, 2 * l);
}

// One step's four launches: acc -> out (distinct buffers), into the
// caller's digit, panel and leaf buffers, on the step's leaf table.
static cudaError_t launch_step(const cmux::ProductPlan& plan, const void* acc, const void* a_tilde,
                               const void* table, void* out, void* digits, void* panel,
                               void* leaves, int B, int N, int l, int bgbit, unsigned int mask,
                               cudaStream_t stream) {
  cudaError_t e = launch_leaf_panel(table, panel, N, l, stream);
  if (e == cudaSuccess) e = launch_leaf_digits(acc, a_tilde, digits, B, N, l, bgbit, mask, stream);
  if (e == cudaSuccess)
    e = cmux::launch_planned<false, 1, StepProduct>(plan, digits, nullptr, leaves, B, N / R, 2 * l,
                                                     stream);
  if (e == cudaSuccess) e = launch_leaf_combine(acc, leaves, out, B, N, stream);
  return e;
}

}  // namespace karatsuba
}  // namespace rustfhe
