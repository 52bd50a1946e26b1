// The two-level Karatsuba CMux step in the residue layout, with the
// measurement variants of its probes, for Hopper (sm_90a): nine leaf
// products on the tensor cores.
//
// Replaces the five Pallas TPU probe kernels that time the JAX package's
// production K1 at levels 2 (rustfhe_tpu/engine/pallas_k.py:207
// _kernel_step_k, engine "pallas_k2"):
//   P4 benches/k2_floor_probe.py:164   make_step.step (body _kernel_ablate, :74)
//   P8 benches/vpu_reduce_probe.py:190 step_var (body _kernel_var, :140)
//   P1 benches/karatsuba2_probe.py:179 step_k2 (body kernel_k2, :110)
//   P2 benches/coissue_probe.py:114    make_split.step (body kernel_split, :82)
//   P3 benches/coissue2_probe.py:134   step_coissue (body _kernel_coissue, :52)
//
// Contract, bit for bit (engine/karatsuba.py step_plain, form by form):
// acc and out are (B, 2N) words in the residue layout, segment (p, r) of
// ns = N/4 words holding coefficients 4m + r of half p.  The production
// form is out = acc + ExtProd(key, Decompose(X^{a~} * acc - acc)):
//   * the four residues of each digit plane form T = 9 tree planes
//     [r0, r2, r0+r2, r1, r3, r1+r3, r0+r1, r2+r3, r0+r1+r2+r3] (int8: the
//     sums of four digits lie in [-128, 124] at bgbit = 6, the wrappers
//     check it with karatsuba.check_bound);
//   * per leaf t, output half c and limb k,
//       P_tck[n] = sum_j sum_i q_tj[i] * L_tckj[n - i + ns]   (int32)
//     against the leaf table (engine/karatsuba.py prepare_table), whose
//     planes are [limbs(-k), limbs(k)] of the key rows' tree planes;
//   * the limbs recombine with a wrapping << 8k, per leaf (leaf-first) or
//     after one tree combine per limb (limb-outer); the tree combine
//     (karatsuba.tree_combine, with Z the negacyclic shift by one position
//     inside a segment) gives the four output residues, all uint32.
//
// The design: each leaf's product is the limb step's external product at
// N := ns on tree-plane digits, one int8 GEMM of M = B, K = 2L ns (1536 at
// DEFAULT_PARAMS) and N = 2 halves x 4 limbs x ns (2048), for nine leaves:
// 0.5625x K1's 6144 x 8192 GEMM per sample.  A step is four launches:
//   1. tree_digits_kernel<V>: rotates acc in the residue layout through the
//      standard index (rustfhe::rotated_coeff of coefficient 4m + r, which
//      gives the words of karatsuba.rotate_res), takes the rounded
//      difference and the signed digits, and writes the nine int8 tree
//      planes (B, 9, 2L, npad), npad = ns rounded up to 128, zeros past ns;
//   2. limb_panel_kernel<9> (cmux_step.cuh): per leaf t, plane j, half c
//      and limb k the K-major sliding-window rows Pt[x][r] = L_tckj[x - r]
//      (K4's limb panel at N := ns, on the leaf table's axis order);
//   3. cmux_product_kernel<false, 1, Leaves<..>> (cmux_step.cuh): K1's TMA
//      ring and wgmma m64n256k32 .s32.s8.s8 mainloop, with the leaf as the
//      slowest dimension of the persistent tile order (one launch); the
//      epilogue recombines the four limbs in registers and writes the leaf
//      (B, 9, 2, ns) words.  Every fragment sum is at most 2L ns 128 128
//      (2^24.6 at DEFAULT, 2^26 at PBS_PARAMS) < 2^31;
//   4. combine_kernel<V>: the tree combine of the nine leaves at each
//      position (the previous position for the Z terms), plus acc.
//
// Where the bytes go, per step at DEFAULT_PARAMS and B=8192 (device memory,
// each written once and read once): the accumulator in and out 134 MB; the
// tree digits 13.5 KiB a sample, 113 MB written and read back (2.25x K1's
// digits); the leaf panels 20.25 MiB; the leaf partials 18 KiB a sample,
// 151 MB written and read back; ~0.70 GB in all, 0.21 ms at 3.35 TB/s,
// against the step's 0.234 ms operation bound (2 x 2 x 4 x 2L x 9 x ns^2
// int8 ops a sample at 1,979 TOP/s).  The combine is materialised because
// the fused one does not fit K1's tile: a tile of 128 samples x 64
// positions of one half would hold its positions' nine leaves (288 KiB),
// or the four output residues (128 KiB) plus the Z terms' halo of the
// previous position, beside the ring's 193 KiB of the 227 KiB a block has;
// in registers the four residues take 128 more a consumer thread beside
// the fragment's 128, of the 232 it has.  Fusing it needs a narrower tile
// (64 or 128 columns) and a smaller ring; the measured split (PERF.md)
// says what it would save.
//
// Each form (engine/karatsuba_probe.py FORMS; karatsuba.Step) on this design:
//   rot rotate / norot / skip   kernel 1: diff = X^a~ acc - acc / a~ as a word / 1
//   extract sar / mul / shift   kernel 1: the same digits by other instructions
//   extract top                 kernel 1: every level the top digit
//   planes 32 / 16 / 0          kernel 1: the tree sums in int32 / packed (the
//                               l levels' digits of a residue as the bytes of one
//                               word, summed four lanes at a time by __vadd4) /
//                               none (every plane is residue 0)
//   nodots                      kernels 1, 2, broadcast_kernel (the two parts
//                               of karatsuba.leaf_parts' broadcast add: sum_j
//                               sum_mb L_tckj[n - mb tm + ns] of the table and
//                               sum_j sum_mb q_tj[mb tm] of the digits), then
//                               kernel 4 adds them per leaf: no product launch
//   norecomb (limbs 1)          kernel 3's epilogue keeps limb 0 (LIMB0)
//   limb-outer (P1, P8)         kernel 3 writes each limb's int32 sum (PER_LIMB),
//                               kernel 4 combines per limb, then recombines:
//                               four combines against one recombination in
//                               registers
//   nocombine                   kernel 4: output residue i is leaf i
//   split grouped (P2)          the block tile's two 64-sample sub-tiles taken by
//                               the two consumer warpgroups together: kernel 3's
//                               own tile, the same launches as the mul form
//   split serial (P2)           the sub-tiles in turn (SERIAL): each stage holds
//                               one sub-tile's 64-row digit box and feeds one
//                               warpgroup, the panel boxes pass the ring twice
//   build leaf (P3 B)           kernel 1 writes the four residue leaves (0, 1, 3,
//                               4) only; kernel 3's producer warpgroup builds each
//                               sum leaf's digit stage from them (__vadd4) into
//                               the swizzled stage just before its wgmmas: the
//                               five sum leaves never reach device memory
//   build pipelined (P3 C)      the same, the stage's panel boxes requested
//                               before the build, so their copy runs under it
//   accio                       acc + 1, one elementwise kernel
// The TPU forms' VPU/MXU scheduling questions (the digit build beside the
// dots, the int16 sums) have no counterpart where the digits are built
// apart from the GEMM; each form keeps its function and applies its
// variation where the part still exists.

#include <cstdint>
#include <cuda_runtime.h>

#include "cmux_step.cuh"

namespace rustfhe {
namespace karatsuba {

// The leaf product (cmux_step.cuh Product): the nine leaf GEMMs in one
// launch, with its epilogue, its tile order and its builds.  Outside the
// anonymous namespace: the product kernel it instantiates keeps external
// linkage (and hidden visibility).
template <int EPI_, bool SERIAL_, int BUILD_>
struct LeafProduct : cmux::Product {
  static constexpr int LEAVES = 9;
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

}  // namespace karatsuba
}  // namespace rustfhe

namespace {

using namespace rustfhe::cmux;
using rustfhe::rotated_coeff;
using rustfhe::rounded_diff;

constexpr int R = 4;       // residues per half (levels 2)
constexpr int TREE = 9;    // leaves
constexpr int MAX_NS = 512;

// A form's number (engine/karatsuba_probe.py form_code): its bits.
constexpr int ROT_ROTATE = 0, ROT_NOROT = 1, ROT_SKIP = 2;                     // bits 0-1
constexpr int EXT_SAR = 0, EXT_MUL = 1, EXT_SHIFT = 2, EXT_TOP = 3;            // bits 2-3
constexpr int PLANES_32 = 0, PLANES_PACKED = 1, PLANES_NONE = 2;               // bits 4-5
constexpr int NODOTS = 1 << 6, NORECOMB = 1 << 7, LIMB_OUTER = 1 << 8, NOCOMBINE = 1 << 9;
constexpr int SPLIT_NONE = 0, SPLIT_SERIAL = 1, SPLIT_GROUPED = 2;             // bits 10-11
constexpr int ACCIO = 1 << 12;
constexpr int BUILD_UPFRONT = 0;                                               // bits 13-14

__host__ __device__ constexpr int rot_of(int v) { return v & 3; }
__host__ __device__ constexpr int ext_of(int v) { return (v >> 2) & 3; }
__host__ __device__ constexpr int planes_of(int v) { return (v >> 4) & 3; }
__host__ __device__ constexpr int split_of(int v) { return (v >> 10) & 3; }
__host__ __device__ constexpr int build_of(int v) { return (v >> 13) & 3; }
constexpr int form(int rot, int ext, int planes, int flags = 0, int split = SPLIT_NONE,
                   int build = BUILD_UPFRONT) {
  return rot | ext << 2 | planes << 4 | flags | split << 10 | build << 13;
}
static_assert(BUILD_LEAF == 1 && BUILD_PIPELINED == 2, "bits 13-14 are cmux_step.cuh's builds");

// The forms the entry points run: P4's ablations, P8's variants, P1, P2, P3.
constexpr int FULL = form(ROT_ROTATE, EXT_SAR, PLANES_32);  // also P8's "sar"
constexpr int MUL = form(ROT_ROTATE, EXT_MUL, PLANES_32);
#define RUSTFHE_KARATSUBA_FORMS(X)                                  \
  X(FULL)                                                           \
  X(form(ROT_NOROT, EXT_SAR, PLANES_32))                            \
  X(form(ROT_ROTATE, EXT_TOP, PLANES_32))                           \
  X(form(ROT_ROTATE, EXT_SAR, PLANES_NONE))                         \
  X(FULL | NODOTS)                                                  \
  X(FULL | NORECOMB)                                                \
  X(FULL | NOCOMBINE)                                               \
  X(MUL)                                                            \
  X(MUL | LIMB_OUTER)                                               \
  X(form(ROT_ROTATE, EXT_MUL, PLANES_PACKED))                       \
  X(form(ROT_ROTATE, EXT_SHIFT, PLANES_32))                         \
  X(form(ROT_ROTATE, EXT_SHIFT, PLANES_PACKED))                     \
  X(form(ROT_SKIP, EXT_MUL, PLANES_32))                             \
  X(form(ROT_SKIP, EXT_SAR, PLANES_32))                             \
  X(form(ROT_ROTATE, EXT_MUL, PLANES_32, 0, SPLIT_SERIAL))          \
  X(form(ROT_ROTATE, EXT_MUL, PLANES_32, 0, SPLIT_GROUPED))         \
  X(form(ROT_ROTATE, EXT_MUL, PLANES_32, 0, SPLIT_NONE, BUILD_LEAF)) \
  X(form(ROT_ROTATE, EXT_MUL, PLANES_32, 0, SPLIT_NONE, BUILD_PIPELINED))

// Form V's leaf product: forms that differ elsewhere share one instantiation.
template <int V>
using Leaves = rustfhe::karatsuba::LeafProduct<
    (V & NORECOMB) ? LIMB0 : (V & LIMB_OUTER) ? PER_LIMB : RECOMBINE,
    split_of(V) == SPLIT_SERIAL, build_of(V)>;
static_assert(Leaves<0>::LEAVES == TREE, "nine leaves");

// The digit of level lv of the rounded difference u, in the form's extract.
template <int V>
__device__ __forceinline__ int32_t extract(uint32_t u, int lv, int bgbit) {
  constexpr int e = ext_of(V);
  if constexpr (e == EXT_SAR) {
    return (int32_t)(u << (bgbit * lv)) >> (32 - bgbit);
  } else if constexpr (e == EXT_TOP) {
    return (int32_t)u >> (32 - bgbit);
  } else {
    const uint32_t raw = (u >> (32 - bgbit * (lv + 1))) & ((1u << bgbit) - 1u);
    const uint32_t half = 1u << (bgbit - 1);
    if constexpr (e == EXT_MUL)
      return (int32_t)(raw + (raw & half) * 0xFFFFFFFEu);
    else
      return (int32_t)(raw - ((raw & half) << 1));
  }
}

// The nine tree planes of four residues, in the table's leaf order.
template <class X, class Add>
__device__ __forceinline__ void tree9(const X (&d)[R], X (&q)[TREE], Add add) {
  q[0] = d[0];
  q[1] = d[2];
  q[2] = add(d[0], d[2]);
  q[3] = d[1];
  q[4] = d[3];
  q[5] = add(d[1], d[3]);
  q[6] = add(d[0], d[1]);
  q[7] = add(d[2], d[3]);
  q[8] = add(q[6], q[7]);
}

// 1. acc (B, 2N) words in the residue layout; a~ of sample b is
// a_tilde[b * a_stride]; digits (B, 9, 2L, npad) int8: byte m of plane
// p * l + lv of leaf t is tree plane t of the level-lv digits of half p's
// residues at position m, zero for m >= ns.  P3's forms write leaves 0, 1,
// 3, 4 (the residues) only.  Thread: sample b, half p, position m, all
// levels: one byte per (leaf, plane), a warp's bytes consecutive.
template <int V>
__global__ void __launch_bounds__(THREADS)
tree_digits_kernel(const int32_t* __restrict__ acc, const int32_t* __restrict__ a_tilde,
                   int a_stride, int8_t* __restrict__ digits, int B, int N, int l, int bgbit,
                   uint32_t mask) {
  const int ns = N / R;
  const int npad = Geometry(ns).npad;
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= B * 2 * npad) return;
  const int m = idx % npad;
  const int p = idx / npad % 2;
  const int b = idx / (2 * npad);
  const bool live = m < ns;
  uint32_t u[R] = {0u, 0u, 0u, 0u};  // residue r at position m
  if (live) {
    const int32_t* half = acc + ((size_t)b * 2 + p) * N;  // p's four residues
    const auto at = [half, ns](int x) { return (uint32_t)half[(x & (R - 1)) * ns + (x >> 2)]; };
    const int32_t a_raw = a_tilde[(size_t)b * a_stride];
    int a = a_raw % (2 * N);
    if (a < 0) a += 2 * N;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = R * m + r;
      if constexpr (rot_of(V) == ROT_ROTATE) {
        u[r] = rounded_diff(rotated_coeff(at, i, a, N), at(i), mask);
      } else if constexpr (rot_of(V) == ROT_NOROT) {
        u[r] = rounded_diff((uint32_t)a_raw, 0u, mask);
      } else {
        const uint32_t cur = at(i);
        u[r] = rounded_diff(cur + 1u, cur, mask);
      }
    }
  }
  // byte m of (leaf t, plane p l + lv)
  int8_t* out = digits + ((size_t)b * TREE * 2 * l + p * l) * npad + m;
  const auto store = [&](int t, int lv, int32_t v) {
    if (build_of(V) == BUILD_UPFRONT || t == 0 || t == 1 || t == 3 || t == 4)
      out[((size_t)t * 2 * l + lv) * npad] = live ? (int8_t)v : (int8_t)0;
  };
  if constexpr (planes_of(V) == PLANES_PACKED) {
    // The l levels' digits of a residue as the bytes of one word; __vadd4
    // sums four byte lanes at once (no lane overflows: |sum| <= 128).
    uint32_t d[R] = {0u, 0u, 0u, 0u}, w[TREE];
    for (int lv = 0; lv < l; ++lv)
#pragma unroll
      for (int r = 0; r < R; ++r)
        d[r] |= ((uint32_t)extract<V>(u[r], lv, bgbit) & 0xFFu) << (8 * lv);
    tree9(d, w, [](uint32_t x, uint32_t y) { return __vadd4(x, y); });
    for (int lv = 0; lv < l; ++lv)
#pragma unroll
      for (int t = 0; t < TREE; ++t) store(t, lv, (int32_t)(w[t] >> (8 * lv)));
  } else {
    for (int lv = 0; lv < l; ++lv) {
      int32_t d[R], q[TREE];
#pragma unroll
      for (int r = 0; r < R; ++r) d[r] = extract<V>(u[r], lv, bgbit);
      if constexpr (planes_of(V) == PLANES_NONE) {
#pragma unroll
        for (int t = 0; t < TREE; ++t) q[t] = d[0];
      } else {
        tree9(d, q, [](int32_t x, int32_t y) { return x + y; });
      }
#pragma unroll
      for (int t = 0; t < TREE; ++t) store(t, lv, q[t]);
    }
  }
}

// 3'. nodots in place of the product: the broadcast parts of
// karatsuba.leaf_parts, flat int32: W (2, 9, 4, ns), W[c, t, k, n] =
// sum_j sum_mb L_tckj[n - mb tm + ns] of the leaf table (2, 9, 4, 2L, 2ns)
// int8, then D (B, 9), D[b, t] = sum_j sum_mb q_tj[mb tm] of the digits
// (B, 9, 2L, npad).  Thread: one word.
__global__ void __launch_bounds__(THREADS)
broadcast_kernel(const int8_t* __restrict__ table, const int8_t* __restrict__ digits,
                 int32_t* __restrict__ parts, int B, int ns, int two_l, int tm) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  const int words = 2 * TREE * LIMBS * ns;
  int32_t w = 0;
  if (idx < words) {
    const int n = idx % ns;
    const int8_t* planes = table + (size_t)(idx / ns) * two_l * 2 * ns;  // (c, t, k)
    for (int j = 0; j < two_l; ++j)
      for (int i = 0; i < ns; i += tm) w += planes[(size_t)j * 2 * ns + n - i + ns];
  } else if (idx < words + B * TREE) {
    const int8_t* planes = digits + (size_t)(idx - words) * two_l * Geometry(ns).npad;  // (b, t)
    for (int j = 0; j < two_l; ++j)
      for (int i = 0; i < ns; i += tm) w += planes[(size_t)j * Geometry(ns).npad + i];
  } else {
    return;
  }
  parts[idx] = w;
}

// 4. out (B, 2N) = acc + the tree combine of the leaves, in the residue
// layout.  The leaves: (B, 9, 2, ns) words (RECOMBINE, LIMB0), (B, 9, 2,
// 4, ns) int32 (PER_LIMB: one combine per limb, then the limbs), or
// (NODOTS) sum_k (D[b, t] + W[c, t, k, n]) << 8k from the broadcast parts.
// Thread: sample b, half c, position n: the four output residues there.
template <int V>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const int32_t* __restrict__ acc, const uint32_t* __restrict__ leaves,
               int32_t* __restrict__ out, int B, int N) {
  const int ns = N / R;
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= B * 2 * ns) return;
  const int n = idx % ns;
  const int c = idx / ns % 2;
  const int b = idx / (2 * ns);
  constexpr int PARTS = (V & LIMB_OUTER) ? LIMBS : 1;  // combines
  const uint32_t* dsum = leaves + 2 * TREE * LIMBS * ns + (size_t)b * TREE;  // NODOTS: D[b]
  // Leaf t at position x, in combine k (k: the limb, PER_LIMB).
  const auto L = [&](int k, int t, int x) -> uint32_t {
    if constexpr ((V & NODOTS) != 0) {
      uint32_t v = 0u;
#pragma unroll
      for (int lt = 0; lt < LIMBS; ++lt)
        v += (dsum[t] + leaves[((c * TREE + t) * LIMBS + lt) * ns + x]) << (8 * lt);
      return v;
    } else if constexpr (PARTS == LIMBS) {
      return leaves[((((size_t)b * TREE + t) * 2 + c) * LIMBS + k) * ns + x];
    } else {
      return leaves[(((size_t)b * TREE + t) * 2 + c) * ns + x];
    }
  };
  uint32_t o[R] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < PARTS; ++k) {
    uint32_t r[R];
    if constexpr ((V & NOCOMBINE) != 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) r[i] = L(k, i, n);
    } else {
      // karatsuba.tree_combine at levels 2: E_h = L_3h + Z L_3h+1, O_h =
      // L_3h+2 - L_3h - L_3h+1; the residues E0 + Z O1, E2 - E0 - E1,
      // O0 + E1, O2 - O0 - O1, where Z x at position n is x at n - 1 (-x at
      // ns - 1 for n = 0).
      const auto Z = [&](int t, int x) { return x > 0 ? L(k, t, x - 1) : 0u - L(k, t, ns - 1); };
      const auto eh = [&](int h, int x) { return L(k, 3 * h, x) + Z(3 * h + 1, x); };
      const auto oh = [&](int h, int x) {
        return L(k, 3 * h + 2, x) - L(k, 3 * h, x) - L(k, 3 * h + 1, x);
      };
      const uint32_t e0 = eh(0, n), e1 = eh(1, n), e2 = eh(2, n);
      const uint32_t o0 = oh(0, n), o1 = oh(1, n), o2 = oh(2, n);
      const uint32_t zo1 = n > 0 ? oh(1, n - 1) : 0u - oh(1, ns - 1);
      r[0] = e0 + zo1;
      r[1] = e2 - e0 - e1;
      r[2] = o0 + e1;
      r[3] = o2 - o0 - o1;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) o[i] += r[i] << (8 * k);
  }
  const size_t base = (size_t)b * 2 * N + (size_t)c * R * ns + n;
#pragma unroll
  for (int i = 0; i < R; ++i)
    out[base + i * ns] = (int32_t)((uint32_t)acc[base + i * ns] + o[i]);
}

// accio: out = acc + 1, the accumulator's round trip alone.
__global__ void accio_kernel(const int32_t* __restrict__ acc, int32_t* __restrict__ out,
                             size_t words) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < words;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = (int32_t)((uint32_t)acc[i] + 1u);
}

// Shapes the step takes: N a power of two with ns = N/4 in [8, MAX_NS],
// the product's sums exact (shape_ok at N := ns).
bool step_shape_ok(int B, int N, int l) {
  return N % R == 0 && N / R <= MAX_NS && shape_ok(B, N / R, 2 * l);
}

template <int V>
cudaError_t launch_tree_digits(const void* acc, const void* a_tilde, int a_stride, void* digits,
                               int B, int N, int l, int bgbit, unsigned int mask,
                               cudaStream_t stream) {
  if ((uintptr_t)digits % 16 || a_stride < 1) return cudaErrorInvalidValue;
  tree_digits_kernel<V><<<blocks(B * 2 * Geometry(N / R).npad), THREADS, 0, stream>>>(
      (const int32_t*)acc, (const int32_t*)a_tilde, a_stride, (int8_t*)digits, B, N, l, bgbit,
      (uint32_t)mask);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_combine(const void* acc, const void* leaves, void* out, int B, int N,
                           cudaStream_t stream) {
  combine_kernel<V><<<blocks(B * 2 * (N / R)), THREADS, 0, stream>>>(
      (const int32_t*)acc, (const uint32_t*)leaves, (int32_t*)out, B, N);
  return cudaGetLastError();
}

// Form V's leaves: the product, or (NODOTS) the broadcast parts.
template <int V>
cudaError_t launch_leaves(const void* digits, const void* panel, const void* table, void* leaves,
                          int B, int N, int two_l, int tm, cudaStream_t stream) {
  const int ns = N / R;
  if constexpr ((V & NODOTS) != 0) {
    if (tm < 1 || ns % tm != 0) return cudaErrorInvalidValue;
    broadcast_kernel<<<blocks(2 * TREE * LIMBS * ns + B * TREE), THREADS, 0, stream>>>(
        (const int8_t*)table, (const int8_t*)digits, (int32_t*)leaves, B, ns, two_l, tm);
    return cudaGetLastError();
  } else {
    return launch_product<false, 1, Leaves<V>>(digits, panel, nullptr, leaves, B, ns, two_l,
                                               stream);
  }
}

// One step of form V: four launches, into the caller's digit, panel and
// leaf buffers.
template <int V>
int step(const void* acc, const void* a_tilde, int a_stride, const void* table, void* out,
         void* digits, void* panel, void* leaves, int B, int N, int l, int bgbit,
         unsigned int mask, int tm, cudaStream_t stream) {
  if (!step_shape_ok(B, N, l)) return (int)cudaErrorInvalidValue;
  cudaError_t e = launch_tree_digits<V>(acc, a_tilde, a_stride, digits, B, N, l, bgbit, mask,
                                        stream);
  if (e == cudaSuccess) e = launch_limb_panel<TREE>(table, panel, N / R, 2 * l, stream);
  if (e == cudaSuccess) e = launch_leaves<V>(digits, panel, table, leaves, B, N, 2 * l, tm, stream);
  if (e == cudaSuccess) e = launch_combine<V>(acc, leaves, out, B, N, stream);
  return (int)e;
}

}  // namespace

extern "C" {

// Every entry returns the cudaError_t of its launches (0 = launched);
// cudaErrorInvalidValue, launching nothing, for a form the library does not
// carry or a shape it does not take.  acc, out (B, 2N) words in the residue
// layout; a~ of sample b is a_tilde[b * a_stride], in [0, 2N); table (2, 9,
// 4, 2L, N/2) int8, 4-byte aligned; digits (B, 9, 2L, npad) int8, panel
// (9, 2L, 2, 4, rows, 128) int8 and leaves (B, 9, 2, N/4) words ((B, 9, 2,
// 4, N/4) int32 for the limb-outer form, the broadcast parts (2, 9, 4,
// N/4) then (B, 9) int32 for nodots), all 16-byte aligned
// (engine/karatsuba_probe.py buffers); tm: the nodots form's digit spacing.

// One Karatsuba step of the form numbered `code` (engine/karatsuba_probe.py form_code).
int rustfhe_karatsuba_step(const void* acc, const void* a_tilde, int a_stride, const void* table,
                           void* out, void* digits, void* panel, void* leaves, int B, int N,
                           int l, int bgbit, unsigned int mask, int code, int tm, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (code) {
#define RUSTFHE_CASE(v)                                                                      \
  case v:                                                                                    \
    return step<v>(acc, a_tilde, a_stride, table, out, digits, panel, leaves, B, N, l, bgbit, \
                   mask, tm, st);
    RUSTFHE_KARATSUBA_FORMS(RUSTFHE_CASE)
#undef RUSTFHE_CASE
    case ACCIO: {
      if (B < 1 || N < 1) return (int)cudaErrorInvalidValue;
      const size_t words = (size_t)B * 2 * N;
      const size_t grid = (words + 255) / 256;
      accio_kernel<<<(unsigned)(grid < 4096 ? grid : 4096), 256, 0, st>>>(
          (const int32_t*)acc, (int32_t*)out, words);
      return (int)cudaGetLastError();
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The pieces alone, for their checks and times: the tree digits of form
// `code`, the leaf panels, the leaves of form `code` (its product, on
// digits whose residue leaves 0, 1, 3, 4 P3's forms read to build the
// others; or nodots' broadcast parts from the table), and the combine of
// form `code`.
int rustfhe_karatsuba_tree_digits(const void* acc, const void* a_tilde, void* digits, int B,
                                  int N, int l, int bgbit, unsigned int mask, int code,
                                  void* stream) {
  if (!step_shape_ok(B, N, l)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (code) {
#define RUSTFHE_CASE(v) \
  case v:               \
    return (int)launch_tree_digits<v>(acc, a_tilde, 1, digits, B, N, l, bgbit, mask, st);
    RUSTFHE_KARATSUBA_FORMS(RUSTFHE_CASE)
#undef RUSTFHE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int rustfhe_karatsuba_leaf_panel(const void* table, void* panel, int N, int two_l, void* stream) {
  if (two_l % 2 || !step_shape_ok(1, N, two_l / 2)) return (int)cudaErrorInvalidValue;
  return (int)launch_limb_panel<TREE>(table, panel, N / R, two_l, (cudaStream_t)stream);
}

int rustfhe_karatsuba_leaf_product(const void* digits, const void* panel, const void* table,
                                   void* leaves, int B, int N, int two_l, int code, int tm,
                                   void* stream) {
  if (two_l % 2 || !step_shape_ok(B, N, two_l / 2)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (code) {
#define RUSTFHE_CASE(v) \
  case v:               \
    return (int)launch_leaves<v>(digits, panel, table, leaves, B, N, two_l, tm, st);
    RUSTFHE_KARATSUBA_FORMS(RUSTFHE_CASE)
#undef RUSTFHE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int rustfhe_karatsuba_combine(const void* acc, const void* leaves, void* out, int B, int N, int l,
                              int code, void* stream) {
  if (!step_shape_ok(B, N, l)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (code) {
#define RUSTFHE_CASE(v) \
  case v:               \
    return (int)launch_combine<v>(acc, leaves, out, B, N, st);
    RUSTFHE_KARATSUBA_FORMS(RUSTFHE_CASE)
#undef RUSTFHE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
