// The two-level Karatsuba CMux step in the residue layout, with the
// measurement variants of its probes, for Hopper (sm_90a).
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
//     sums of four digits lie in [-128, 124] at bgbit = 6);
//   * per output half c, leaf t and limb k,
//       P_tck[n] = sum_j sum_i q_tj[i] * L_tckj[n - i + ns]   (int32)
//     against the leaf table (engine/karatsuba.py prepare_table), whose
//     planes are [limbs(-k), limbs(k)] of the key rows' tree planes;
//   * the limbs recombine with a wrapping << 8k, per leaf (leaf-first,
//     _karatsuba_accumulate) or after one tree combine per limb
//     (limb-outer); the tree combine (karatsuba.tree_combine) gives the four
//     output residues; every combine is uint32, equal mod 2^32 to the JAX
//     probes' int32 adds.
// A form changes one part (karatsuba.Step): the rotation (norot: diff = a~;
// skip: diff = 1), the digit extract (sar, mul, shift give the same digits
// by other instructions; top gives every level the top digit), the tree
// sums (int32, or packed: the levels' digits of a residue as the bytes of
// one word, summed by __vadd4, four byte lanes per instruction, in place of
// the TPU probe's int16 sums; none: every plane is residue 0), the
// products (nodots: part = sum_j sum_mb q_tj[mb*tm] + L_tckj[n - mb*tm + ns],
// the TPU probe's broadcast add against its panel row), the limbs (limb 0
// only), the combine (residue i = leaf i), the tile (two sub-tiles of 4,
// serial or grouped), where the tree planes are built (P3, below), or all
// of it (accio: acc + 1).
//
// What bounds it.  Per sample and step 2 halves x 9 leaves x K=4 limbs x
// 2L x ns^2 int8 products, 0.5625x the 2 x 4 x 2L x N^2 of the limb step
// (7.08 M __dp4a at DEFAULT_PARAMS, against K6's 12.58 M), against 2N
// words of accumulator in and out: the card's integer issue of __dp4a
// bounds it, not memory.  The design:
//   * a block holds TB = 8 samples and one output half c (c-split, as K6):
//     the half's leaf table, byte-reversed (221 KB for both halves would
//     leave no room for the digits), 110,592 B at DEFAULT; the tile's digit
//     trees, 110,592 B; one sample's nine leaves for the combine, 9,216 B:
//     230,400 B, one block per SM;
//   * one group of ns/8 threads per leaf (a warp at DEFAULT, 9 warps), each
//     thread 8 consecutive leaf outputs x 8 samples: the products are
//     limb_common.cuh's limb_products at N := ns, once per limb, the same
//     __dp4a loop as K4-K6;
//   * the digits are built in the block from acc, through the standard
//     index (rustfhe::rotated_coeff of coefficient 4m + r), which gives the
//     words of the TPU's residue select stages, and never touch device memory;
//   * the combine takes the leaves of one sample at a time through shared
//     memory: ns threads each give the four outputs at one position.
// wgmma, TMA and a multi-step kernel are later work.
//
// P3's two forms move the tree sums from before the block barrier to the
// leaf that uses them, as the TPU kernel moves build_leaf next to each
// leaf's dots (the TPU kernel, too, computes the rotation and the digit
// planes of every residue for the whole tile first).  The block builds the
// four residues' digits only, into the areas of the leaves that are one
// residue (0: r0, 1: r2, 3: r1, 4: r3); after the barrier, the group of
// each sum leaf (2, 5, 6, 7, 8: a warp at DEFAULT) builds its own plane
// from them, one __vadd4 per word, and passes only a __syncwarp before its
// __dp4a stream:
//   * leaf (P3 B, pipelined=False): the whole leaf's planes, then its products;
//   * pipelined (P3 C, pipelined=True): the leaf's planes in two groups, the
//     input halves p (planes p*l .. p*l + l - 1).  Group 0 is built first;
//     group 1 is built in four chunks, one after each limb's products of
//     group 0 (the TPU kernel builds leaf t+1 between leaf t's dot groups:
//     here a warp's next work is its own next group), then group 1's
//     products.  The two groups fill the leaf's one area, so both forms use
//     the shared memory of the upfront form, 230,400 B at DEFAULT.

#include <cstdint>
#include <cuda_runtime.h>

#include "limb_common.cuh"

namespace {

using rustfhe::KPT;
using rustfhe::rotated_coeff;
using rustfhe::rounded_diff;
using namespace rustfhe::limb;

constexpr int R = 4;  // residues per half (levels 2)
constexpr int T = 9;  // leaves
constexpr int MAX_NS = 256;
constexpr int MAX_BLOCK = T * MAX_NS / KPT;  // 288 threads at N = 1024

// A form's number (engine/karatsuba_probe.py form_code): its bits.
constexpr int ROT_ROTATE = 0, ROT_NOROT = 1, ROT_SKIP = 2;                     // bits 0-1
constexpr int EXT_SAR = 0, EXT_MUL = 1, EXT_SHIFT = 2, EXT_TOP = 3;            // bits 2-3
constexpr int PLANES_32 = 0, PLANES_PACKED = 1, PLANES_NONE = 2;               // bits 4-5
constexpr int NODOTS = 1 << 6, NORECOMB = 1 << 7, LIMB_OUTER = 1 << 8, NOCOMBINE = 1 << 9;
constexpr int SPLIT_NONE = 0, SPLIT_SERIAL = 1, SPLIT_GROUPED = 2;             // bits 10-11
constexpr int ACCIO = 1 << 12;
constexpr int BUILD_UPFRONT = 0, BUILD_LEAF = 1, BUILD_PIPELINED = 2;          // bits 13-14

__host__ __device__ constexpr int rot_of(int v) { return v & 3; }
__host__ __device__ constexpr int ext_of(int v) { return (v >> 2) & 3; }
__host__ __device__ constexpr int planes_of(int v) { return (v >> 4) & 3; }
__host__ __device__ constexpr int split_of(int v) { return (v >> 10) & 3; }
__host__ __device__ constexpr int build_of(int v) { return (v >> 13) & 3; }
constexpr int form(int rot, int ext, int planes, int flags = 0, int split = SPLIT_NONE,
                   int build = BUILD_UPFRONT) {
  return rot | ext << 2 | planes << 4 | flags | split << 10 | build << 13;
}

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

__host__ __device__ inline size_t leaf_table_bytes(int ns, int two_l) {
  return (size_t)T * NUM_LIMBS * two_l * 2 * ns;
}
__host__ __device__ inline size_t leaf_digit_bytes(int ns, int two_l) {
  return (size_t)two_l * ns * TB;
}
__host__ inline size_t karatsuba_smem_bytes(int ns, int two_l) {
  return leaf_table_bytes(ns, two_l) + T * leaf_digit_bytes(ns, two_l) + (size_t)T * ns * 4;
}

// Output half c of the leaf table (2, T, K, 2L, 2ns) int8 -> shared memory,
// each 2ns-byte plane byte-reversed: plane ((t * K + k) * 2L + j).
__device__ __forceinline__ void load_leaf_table(uint32_t* tab_s, const uint32_t* __restrict__ tab,
                                                int c, int two_l, int ns) {
  const int pw = ns / 2;
  const int words = T * NUM_LIMBS * two_l * pw;
  const uint32_t* src = tab + (size_t)c * words;
  for (int idx = threadIdx.x; idx < words; idx += blockDim.x) {
    const int p = idx / pw;
    const int w = idx - p * pw;
    tab_s[idx] = __byte_perm(src[(size_t)p * pw + (pw - 1 - w)], 0u, 0x0123);
  }
}

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
__device__ __forceinline__ void tree9(const X (&d)[R], X (&q)[T], Add add) {
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

// The digit trees of samples [s_lo, s_hi) of the tile: byte (j, m, s) of
// leaf t's area (limb_common.cuh digit_byte at N := ns) holds tree plane t
// of plane j = p*l + lv at position m; P3's forms write the residues only,
// into the areas of leaves 0, 3, 1, 4.  Samples past B get zero digits.
template <int V>
__device__ __forceinline__ void build_digits(int8_t* dig_s, const int32_t* __restrict__ acc_in,
                                             const int32_t* __restrict__ a_tilde, int a_stride,
                                             int B, int b0, int s_lo, int s_hi, int N, int l,
                                             int bgbit, uint32_t mask) {
  const int ns = N / R;
  const size_t leaf = leaf_digit_bytes(ns, 2 * l);
  const int items = (s_hi - s_lo) * 2 * ns;
  for (int idx = threadIdx.x; idx < items; idx += blockDim.x) {
    const int s = s_lo + idx / (2 * ns);
    const int rem = idx - (s - s_lo) * 2 * ns;
    const int p = rem / ns;
    const int m = rem - p * ns;
    const int b = b0 + s;
    uint32_t u[R] = {0u, 0u, 0u, 0u};
    if (b < B) {
      const int32_t* half = acc_in + ((size_t)b * 2 + p) * N;  // p's four residues
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
    if constexpr (planes_of(V) == PLANES_PACKED) {
      // The l levels' digits of residue r as the bytes of one word; __vadd4
      // sums four byte lanes at once (no lane overflows: |sum| <= 128).
      uint32_t w[R] = {0u, 0u, 0u, 0u};
      for (int lv = 0; lv < l; ++lv)
#pragma unroll
        for (int r = 0; r < R; ++r)
          w[r] |= ((uint32_t)extract<V>(u[r], lv, bgbit) & 0xFFu) << (8 * lv);
      uint32_t q[T];
      tree9(w, q, [](uint32_t x, uint32_t y) { return __vadd4(x, y); });
      for (int lv = 0; lv < l; ++lv) {
        const int byte = digit_byte(p * l + lv, m, s, ns);
#pragma unroll
        for (int t = 0; t < T; ++t) dig_s[t * leaf + byte] = (int8_t)(q[t] >> (8 * lv));
      }
    } else {
      for (int lv = 0; lv < l; ++lv) {
        int32_t d[R];
#pragma unroll
        for (int r = 0; r < R; ++r) d[r] = extract<V>(u[r], lv, bgbit);
        const int byte = digit_byte(p * l + lv, m, s, ns);
        if constexpr (build_of(V) != BUILD_UPFRONT) {
#pragma unroll
          for (int r = 0; r < R; ++r)  // residue r alone is leaf 0, 3, 1, 4
            dig_s[((r & 1) * 3 + (r >> 1)) * leaf + byte] = (int8_t)d[r];
          continue;
        }
        int32_t q[T];
        if constexpr (planes_of(V) == PLANES_NONE) {
#pragma unroll
          for (int t = 0; t < T; ++t) q[t] = d[0];
        } else {
          tree9(d, q, [](int32_t x, int32_t y) { return x + y; });
        }
#pragma unroll
        for (int t = 0; t < T; ++t) dig_s[t * leaf + byte] = (int8_t)q[t];
      }
    }
  }
}

// The four output residues at position n from the nine leaves of one
// sample in shared memory (st[t * ns + x]): karatsuba.tree_combine at
// levels 2, with Z the negacyclic shift by one at leaf size.
template <int V>
__device__ __forceinline__ void combine_at(const uint32_t* st, int ns, int n, uint32_t (&o)[R]) {
  const auto L = [st, ns](int t, int x) { return st[t * ns + x]; };
  if constexpr ((V & NOCOMBINE) != 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) o[i] = L(i, n);
  } else {
    const auto Z = [&](int t, int x) { return x > 0 ? L(t, x - 1) : 0u - L(t, ns - 1); };
    const auto eh = [&](int h, int x) { return L(3 * h, x) + Z(3 * h + 1, x); };
    const auto oh = [&](int h, int x) { return L(3 * h + 2, x) - L(3 * h, x) - L(3 * h + 1, x); };
    const uint32_t e0 = eh(0, n), e1 = eh(1, n), e2 = eh(2, n);
    const uint32_t o0 = oh(0, n), o1 = oh(1, n), o2 = oh(2, n);
    const uint32_t zo1 = n > 0 ? oh(1, n - 1) : 0u - oh(1, ns - 1);
    o[0] = e0 + zo1;
    o[1] = e2 - e0 - e1;
    o[2] = o0 + e1;
    o[3] = o2 - o0 - o1;
  }
}

// Stage one sample's leaves (this thread's 8 outputs of leaf t) and combine
// them: threads n < ns get the four residues at position n.  Every thread
// of the block calls it.
template <int V>
__device__ __forceinline__ void stage_combine(uint32_t* st, const uint32_t (&vals)[KPT], int t,
                                              int k0, int ns, uint32_t (&o)[R]) {
  uint4* dst = reinterpret_cast<uint4*>(st + t * ns + k0);
  dst[0] = make_uint4(vals[0], vals[1], vals[2], vals[3]);
  dst[1] = make_uint4(vals[4], vals[5], vals[6], vals[7]);
  __syncthreads();
  if ((int)threadIdx.x < ns) combine_at<V>(st, ns, threadIdx.x, o);
  __syncthreads();
}

// One (leaf, limb) part for SUB samples from s0: the products, or the
// nodots form's broadcast sums.
template <int V, int SUB>
__device__ __forceinline__ void leaf_part(const uint32_t* tab_tk, const int8_t* dig_t, int two_l,
                                          int ns, int k0, int s0, int tm,
                                          int32_t (&part)[SUB][KPT]) {
  if constexpr ((V & NODOTS) == 0) {
#pragma unroll
    for (int s = 0; s < SUB; ++s)
#pragma unroll
      for (int o = 0; o < KPT; ++o) part[s][o] = 0;
    limb_products<SUB>(tab_tk, reinterpret_cast<const uint32_t*>(dig_t), two_l, ns, k0, part, s0);
  } else {
    int32_t dsum[SUB], ksum[KPT];
#pragma unroll
    for (int s = 0; s < SUB; ++s) dsum[s] = 0;
#pragma unroll
    for (int o = 0; o < KPT; ++o) ksum[o] = 0;
    const int8_t* tab_b = reinterpret_cast<const int8_t*>(tab_tk);
    for (int j = 0; j < two_l; ++j) {
      const int8_t* plane = tab_b + (size_t)j * 2 * ns;  // R[y] = L[2ns - 1 - y]
      for (int i = 0; i < ns; i += tm) {
#pragma unroll
        for (int s = 0; s < SUB; ++s) dsum[s] += dig_t[digit_byte(j, i, s0 + s, ns)];
#pragma unroll
        for (int o = 0; o < KPT; ++o) ksum[o] += plane[ns - 1 - (k0 + o) + i];
      }
    }
#pragma unroll
    for (int s = 0; s < SUB; ++s)
#pragma unroll
      for (int o = 0; o < KPT; ++o) part[s][o] = dsum[s] + ksum[o];
  }
}

// P3: leaves 2, 5, 6, 7, 8 are sums of residues; the others hold one.
__device__ __forceinline__ bool is_sum_leaf(int t) { return t == 2 || t >= 5; }

// Words [w_lo, w_hi) of sum leaf t's digit area from the residue areas
// (leaf 0: r0, 1: r2, 3: r1, 4: r3), by the `lanes` threads of its group:
// __vadd4 adds the four int8 digits of a word at once (no byte overflows:
// the sums of four digits lie in [-128, 124]).
__device__ __forceinline__ void build_leaf_words(uint32_t* dig_w, int t, size_t leaf_words,
                                                 size_t w_lo, size_t w_hi, int lane, int lanes) {
  const uint32_t* r0 = dig_w;
  const uint32_t* r2 = dig_w + leaf_words;
  const uint32_t* r1 = dig_w + 3 * leaf_words;
  const uint32_t* r3 = dig_w + 4 * leaf_words;
  uint32_t* dst = dig_w + t * leaf_words;
  for (size_t w = w_lo + lane; w < w_hi; w += lanes) {
    uint32_t v;
    switch (t) {
      case 2: v = __vadd4(r0[w], r2[w]); break;
      case 5: v = __vadd4(r1[w], r3[w]); break;
      case 6: v = __vadd4(r0[w], r1[w]); break;
      case 7: v = __vadd4(r2[w], r3[w]); break;
      default: v = __vadd4(__vadd4(r0[w], r1[w]), __vadd4(r2[w], r3[w])); break;  // 8
    }
    dst[w] = v;
  }
}

// The lanes of leaf t's group in its warp (a group of ns/KPT threads, a
// power of two that divides 32: launch checks it).
__device__ __forceinline__ unsigned group_mask(int t, int per_leaf) {
  return per_leaf >= 32 ? 0xFFFFFFFFu : ((1u << per_leaf) - 1u) << ((t * per_leaf) & 31);
}

struct Tile {
  const uint32_t* tab_s;  // the half's leaf table, reversed planes
  int8_t* dig_s;          // the tile's digit trees
  uint32_t* st;           // one sample's leaves
  const int32_t* acc_in;
  int32_t* out;
  int B, b0, c, ns, two_l, tm;
};

// Products, recombination, combine and stores for SUB samples from s0.
template <int V, int SUB>
__device__ __forceinline__ void products_and_combine(const Tile& tl, int s0) {
  const int ns = tl.ns, two_l = tl.two_l;
  const int per_leaf = ns / KPT;
  const int t = threadIdx.x / per_leaf;
  const int k0 = (threadIdx.x - t * per_leaf) * KPT;
  const uint32_t* tab_t = tl.tab_s + (size_t)t * NUM_LIMBS * two_l * (ns / 2);
  const int8_t* dig_t = tl.dig_s + t * leaf_digit_bytes(ns, two_l);
  constexpr int LIMBS = (V & NORECOMB) ? 1 : NUM_LIMBS;
  const int n = threadIdx.x;
  const auto store = [&](int s, const uint32_t (&o)[R]) {
    const int b = tl.b0 + s0 + s;
    if (n < ns && b < tl.B) {
      const size_t base = (size_t)b * 2 * R * ns + (size_t)tl.c * R * ns + n;
#pragma unroll
      for (int i = 0; i < R; ++i)
        tl.out[base + i * ns] = (int32_t)((uint32_t)tl.acc_in[base + i * ns] + o[i]);
    }
  };
  if constexpr ((V & LIMB_OUTER) == 0) {  // leaf-first: recombine per leaf, combine once
    uint32_t leaf[SUB][KPT];
#pragma unroll
    for (int s = 0; s < SUB; ++s)
#pragma unroll
      for (int o = 0; o < KPT; ++o) leaf[s][o] = 0u;
    constexpr int build = build_of(V);
    if constexpr (build == BUILD_PIPELINED) {
      static_assert(LIMBS == NUM_LIMBS && (V & NODOTS) == 0, "P3 C takes the full products");
      // The products of planes [j0, j0 + planes) for limb k, added to the leaf.
      const auto products = [&](int j0, int planes, int k) {
        int32_t part[SUB][KPT];
#pragma unroll
        for (int s = 0; s < SUB; ++s)
#pragma unroll
          for (int o = 0; o < KPT; ++o) part[s][o] = 0;
        limb_products<SUB>(tab_t + ((size_t)k * two_l + j0) * (ns / 2),
                           reinterpret_cast<const uint32_t*>(dig_t) + (size_t)j0 * ns * TB / 4,
                           planes, ns, k0, part, s0);
#pragma unroll
        for (int s = 0; s < SUB; ++s)
#pragma unroll
          for (int o = 0; o < KPT; ++o) leaf[s][o] += (uint32_t)part[s][o] << (LIMB_BITS * k);
      };
      const int l = two_l / 2, lane = threadIdx.x - t * per_leaf;
      const unsigned mask = group_mask(t, per_leaf);
      const bool sum = is_sum_leaf(t);
      uint32_t* dig_w = reinterpret_cast<uint32_t*>(tl.dig_s);
      const size_t leaf_words = leaf_digit_bytes(ns, two_l) / 4, group = leaf_words / 2;
      if (sum) {
        build_leaf_words(dig_w, t, leaf_words, 0, group, lane, per_leaf);
        __syncwarp(mask);
      }
      for (int k = 0; k < NUM_LIMBS; ++k) {
        products(0, l, k);
        if (sum)
          build_leaf_words(dig_w, t, leaf_words, group + k * group / NUM_LIMBS,
                           group + (k + 1) * group / NUM_LIMBS, lane, per_leaf);
      }
      if (sum) __syncwarp(mask);
      for (int k = 0; k < NUM_LIMBS; ++k) products(l, l, k);
    } else {
      if constexpr (build == BUILD_LEAF) {
        if (is_sum_leaf(t)) {
          const size_t leaf_words = leaf_digit_bytes(ns, two_l) / 4;
          build_leaf_words(reinterpret_cast<uint32_t*>(tl.dig_s), t, leaf_words, 0, leaf_words,
                           threadIdx.x - t * per_leaf, per_leaf);
          __syncwarp(group_mask(t, per_leaf));
        }
      }
      for (int k = 0; k < LIMBS; ++k) {
        int32_t part[SUB][KPT];
        leaf_part<V, SUB>(tab_t + (size_t)k * two_l * (ns / 2), dig_t, two_l, ns, k0, s0, tl.tm,
                          part);
#pragma unroll
        for (int s = 0; s < SUB; ++s)
#pragma unroll
          for (int o = 0; o < KPT; ++o) leaf[s][o] += (uint32_t)part[s][o] << (LIMB_BITS * k);
      }
    }
#pragma unroll
    for (int s = 0; s < SUB; ++s) {
      uint32_t o[R];
      stage_combine<V>(tl.st, leaf[s], t, k0, ns, o);
      store(s, o);
    }
  } else {  // limb-outer: one combine per limb, then the limbs recombine
    uint32_t res[SUB][R];
#pragma unroll
    for (int s = 0; s < SUB; ++s)
#pragma unroll
      for (int i = 0; i < R; ++i) res[s][i] = 0u;
    for (int k = 0; k < LIMBS; ++k) {
      int32_t part[SUB][KPT];
      leaf_part<V, SUB>(tab_t + (size_t)k * two_l * (ns / 2), dig_t, two_l, ns, k0, s0, tl.tm,
                        part);
#pragma unroll
      for (int s = 0; s < SUB; ++s) {
        uint32_t vals[KPT], o[R];
#pragma unroll
        for (int x = 0; x < KPT; ++x) vals[x] = (uint32_t)part[s][x];
        stage_combine<V>(tl.st, vals, t, k0, ns, o);
#pragma unroll
        for (int i = 0; i < R; ++i) res[s][i] += o[i] << (LIMB_BITS * k);
      }
    }
#pragma unroll
    for (int s = 0; s < SUB; ++s) store(s, res[s]);
  }
}

template <int V>
__global__ void __launch_bounds__(MAX_BLOCK)
karatsuba_kernel(const int32_t* __restrict__ acc_in, const int32_t* __restrict__ a_tilde,
                 int a_stride, const uint32_t* __restrict__ table, int32_t* __restrict__ out,
                 int B, int N, int l, int bgbit, uint32_t mask, int tm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ns = N / R, two_l = 2 * l;
  const int b0 = blockIdx.x * TB;
  uint32_t* tab_s = reinterpret_cast<uint32_t*>(smem);
  int8_t* dig_s = reinterpret_cast<int8_t*>(smem + leaf_table_bytes(ns, two_l));
  uint32_t* st = reinterpret_cast<uint32_t*>(smem + leaf_table_bytes(ns, two_l) +
                                             T * leaf_digit_bytes(ns, two_l));
  const Tile tl{tab_s, dig_s, st, acc_in, out, B, b0, (int)blockIdx.y, ns, two_l, tm};

  load_leaf_table(tab_s, table, blockIdx.y, two_l, ns);
  const auto digits = [&](int s_lo, int s_hi) {
    build_digits<V>(dig_s, acc_in, a_tilde, a_stride, B, b0, s_lo, s_hi, N, l, bgbit, mask);
  };
  constexpr int split = split_of(V);
  if constexpr (split == SPLIT_NONE) {
    digits(0, TB);
    __syncthreads();
    products_and_combine<V, TB>(tl, 0);
  } else if constexpr (split == SPLIT_SERIAL) {  // digits A, products A, digits B, products B
    digits(0, TB / 2);
    __syncthreads();
    products_and_combine<V, TB / 2>(tl, 0);
    digits(TB / 2, TB);
    __syncthreads();
    products_and_combine<V, TB / 2>(tl, TB / 2);
  } else {  // grouped: both digit builds first
    digits(0, TB / 2);
    digits(TB / 2, TB);
    __syncthreads();
    products_and_combine<V, TB / 2>(tl, 0);
    products_and_combine<V, TB / 2>(tl, TB / 2);
  }
}

// accio: out = acc + 1, the accumulator's round trip alone.
__global__ void accio_kernel(const int32_t* __restrict__ acc, int32_t* __restrict__ out,
                             size_t words) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < words;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = (int32_t)((uint32_t)acc[i] + 1u);
}

template <int V>
int launch(const void* acc, const void* a_tilde, int a_stride, const void* table, void* out,
           int B, int N, int l, int bgbit, unsigned int mask, int tm, void* stream) {
  static size_t granted[MAX_DEVICES];
  const int ns = N / R;
  if (N % (R * KPT) != 0 || ns > MAX_NS || a_stride < 1) return (int)cudaErrorInvalidValue;
  if ((V & NODOTS) != 0 && (tm < 1 || ns % tm != 0)) return (int)cudaErrorInvalidValue;
  if (build_of(V) != BUILD_UPFRONT && 32 % (ns / KPT) != 0)  // a leaf's group within a warp
    return (int)cudaErrorInvalidValue;
  const size_t smem = karatsuba_smem_bytes(ns, 2 * l);
  const cudaError_t e = prepare((const void*)karatsuba_kernel<V>, B, ns, 2 * l, smem, granted);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + TB - 1) / TB, 2);
  karatsuba_kernel<V><<<grid, T * ns / KPT, smem, (cudaStream_t)stream>>>(
      (const int32_t*)acc, (const int32_t*)a_tilde, a_stride, (const uint32_t*)table,
      (int32_t*)out, B, N, l, bgbit, (uint32_t)mask, tm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One Karatsuba step of the form numbered `code` (engine/karatsuba_probe.py form_code);
// returns the cudaError_t of its launch (0 = launched), cudaErrorInvalidValue
// for a form the library does not carry.  acc, out (B, 2N) words in the
// residue layout; a~ of sample b is a_tilde[b * a_stride], in [0, 2N);
// table (2, 9, 4, 2L, N/2) int8; tm: the nodots form's digit spacing.
int rustfhe_karatsuba_step(const void* acc, const void* a_tilde, int a_stride, const void* table,
                           void* out, int B, int N, int l, int bgbit, unsigned int mask, int code,
                           int tm, void* stream) {
  switch (code) {
#define RUSTFHE_CASE(v) \
  case v:               \
    return launch<v>(acc, a_tilde, a_stride, table, out, B, N, l, bgbit, mask, tm, stream);
    RUSTFHE_KARATSUBA_FORMS(RUSTFHE_CASE)
#undef RUSTFHE_CASE
    case ACCIO: {
      if (B < 1 || N < 1) return (int)cudaErrorInvalidValue;
      const size_t words = (size_t)B * 2 * N;
      const size_t blocks = (words + 255) / 256;
      accio_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, (cudaStream_t)stream>>>(
          (const int32_t*)acc, (int32_t*)out, words);
      return (int)cudaGetLastError();
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
