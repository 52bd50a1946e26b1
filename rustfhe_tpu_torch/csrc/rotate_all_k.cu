// The whole blind rotation in one launch (K3) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the latency path:
//   K3 rustfhe_tpu/engine/pallas_k.py:432  fused_rotate_all_k (body _kernel_rotate_all, :326)
//
// Contract: the K1 step (cmux_k.cu) applied n times,
//   acc_{i+1} = acc_i + ExtProd(bk_i, Decompose(X^{a[i]} * acc_i - acc_i)),
// bit for bit, in the standard (B, 2, N) layout, all torus arithmetic in
// uint32_t.  The key is the standard prepared table K1 reads, (n, 2L, 2, 2N)
// int32 (62 MB at DEFAULT_PARAMS), of which only the q half is read.  The
// TPU kernel's panel tables (12.6 GiB), residue layout and Karatsuba tree
// exist for Mosaic and the MXU; none of them is needed here.
//
// What bounds it.  Per sample and step 2 x 4 limbs x 2L x N^2 int8
// multiply-adds against 2L x 2 x N key words, and the n steps are strictly
// sequential: at a batch of 1 the card holds one sample, and the least time
// is the latency of n dependent steps, not the bytes or the operations.
//
// Design: one sample per thread-block cluster of CS blocks (8 or 16, at
// most N/64), the step on the tensor cores in the orientation that needs
// no padding at B=1 (mma.sync m16n8k32 s8):
//   M = the output coefficient k, N = the 8 columns (half c, limb t),
//   K = (plane j, index m),
//   A[k, (j, m)] = sd_j(k - m) = R_j[N - 1 - k + m],  R_j = reverse([-d_j, d_j]),
//   B[(j, m), (c, t)] = limb_t(q_jc[m]),  q_jc = T_jc[N + m], the key's q half,
// so that sum_t (sum_{j,m} A B) << 8t = sum_j sum_i d_j[i] T_jc[k - i + N].
// The sign goes on the digits, exact in int8 because the kernel takes
// Bg <= 2^7 (|d| <= 64); |P| <= half_bg x 128 x 2L x N < 2^31 (the wrapper
// checks both).
//   * Block r owns the R_B = N/CS coefficients [r R_B, (r+1) R_B) of both
//     halves and keeps that slice of the accumulator in shared memory,
//     double-buffered.
//   * Gather, once per step: each block copies the whole accumulator from
//     its peers' slices over distributed shared memory, 16 bytes a thread,
//     and builds the sample's 2L x N digits from that copy (cmux_common.cuh),
//     as R_j in four copies shifted by 0..3 bytes, in one pass.
//   * Rows of an A tile are k = k_b + p + 4g (g < 16): one phase p, stride
//     4, so all 16 rows read copy 3 - p at word offsets, with no shift; the
//     fragment of k-step m0 + 32 shares half its registers with that of
//     m0, so a warp walking a plane's k-steps loads two words a tile and
//     step.  The B fragments are limb_t of four key words, split in
//     registers ((w + 0x80808080) ^ 0x80808080, as K1) once per k-step and
//     used by all R_B / 16 tiles of the block.
//   * 16 warps (8 at N=2048 on clusters of 8) split the step's k-steps.
//     The key's planes come by bulk copy (cp.async.bulk, one thread, a
//     full mbarrier per plane): where a whole step fits (every shape but
//     N=2048 with l=4) they stay resident, each warp walks a contiguous
//     range of k-steps across planes with no block barrier, and the next
//     step's planes load while the cluster barrier and the digit build
//     run; else they stream through a ring of planes, the warps splitting
//     each plane's k-steps.  Each warp recombines its limbs (wrapping,
//     linear) and stores one partial word per output; the epilogue adds
//     the warps' partials to the slice into the other buffer.
//   * One cluster barrier per step (arrive.release / wait.acquire) orders
//     the slices: a slice is read only after it was written, and
//     overwritten only after every peer read it.
// Shared memory at DEFAULT_PARAMS and CS = 8: digit copies 49.5 KB, the
// step's key 6 planes of 8.3 KB, accumulator copy / partials 16 KB,
// slices 2 KB; at N=2048, l=4 (PBS_PARAMS) a ring of 4 planes.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "cmux_common.cuh"
#include "hopper_common.cuh"

namespace cg = cooperative_groups;

namespace {

using rustfhe::hopper::mbar_expect_tx;
using rustfhe::hopper::mbar_init;
using rustfhe::hopper::mbar_wait;
using rustfhe::hopper::smem_u32;

// Warps of a block with TILES row tiles: 16 while a thread's fragments fit
// in 128 registers, 8 at 16 tiles (N=2048 on clusters of 8).
__host__ __device__ constexpr int warps_of(int tiles) { return tiles <= 8 ? 16 : 8; }
constexpr int ROWS = 64;   // coefficients of one 4-phase group of row tiles
constexpr int KSTEP = 32;  // m per mma k-step
constexpr int KPAD = 16;   // words of padding after each key half in the ring
constexpr int MAX_DEVICES = 64;
constexpr int SMEM_BUDGET = 232448;  // the H100's opt-in shared memory per block
constexpr int MAX_SLOTS = 16;

// The shared-memory layout of one block at ring degree N, 2L planes and
// cluster size cs (warps_of(N / 16 cs) warps): the key takes a whole
// step's 2L planes where they fit beside the rest (resident), else a ring
// of as many planes as fit; a full mbarrier per plane slot.
struct Layout {
  int rb;      // output coefficients per block (of each half)
  int pw;      // words of one digit plane copy: 2N bytes and a pad
  int kw;      // words of one key half in the ring
  int slots;   // planes of the key ring
  int digits;  // byte offsets of each region
  int shared;  // the accumulator copy, then the warps' partials
  int slices;
  int key;
  int bars;
  int bytes;
  __host__ __device__ Layout(int N, int two_l, int cs) {
    rb = N / cs;
    pw = N / 2 + 4;
    kw = N + KPAD;
    digits = 0;
    shared = digits + 4 * two_l * pw * 4;
    const int copy = 2 * N * 4, partial = warps_of(rb / 16) * 2 * rb * 4;
    slices = shared + (copy > partial ? copy : partial);
    bars = slices + 2 * 2 * rb * 4;
    key = bars + 8 * MAX_SLOTS;
    const int fit = (SMEM_BUDGET - key) / (2 * kw * 4);
    slots = fit < two_l ? fit : two_l;
    if (slots > MAX_SLOTS) slots = MAX_SLOTS;
    if (slots < 2) slots = 2;  // past the budget: the launch is refused
    bytes = key + slots * 2 * kw * 4;
  }
};

// Key plane `chunk` (step chunk / 2L, plane chunk % 2L: its q halves
// T_jc[N .. 2N), c = 0, 1) into its ring slot by two bulk copies, which
// complete the slot's full barrier.  One thread issues them.
__device__ __forceinline__ void load_plane(uint32_t ring, uint32_t bars,
                                           const int32_t* __restrict__ bk, int chunk, int N,
                                           int kw, int slots) {
  const int slot = chunk % slots;
  const uint32_t bar = bars + 8 * slot, bytes = N * 4;
  mbar_expect_tx(bar, 2 * bytes);
  const int32_t* src = bk + (size_t)chunk * 2 * 2 * N + N;
#pragma unroll
  for (int c = 0; c < 2; ++c)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(ring + (slot * 2 + c) * kw * 4), "l"(src + (size_t)c * 2 * N), "r"(bytes), "r"(bar)
        : "memory");
}

// The four balanced limbs of w, limb t in byte t (as K1's panel kernel).
__device__ __forceinline__ uint32_t limbs_of(uint32_t w) {
  return (w + 0x80808080u) ^ 0x80808080u;
}

// Byte t of each of four words, in order: limb t of four key words.
__device__ __forceinline__ uint32_t limb_column(uint4 q, uint32_t sel) {
  const uint32_t x = __byte_perm(limbs_of(q.x), limbs_of(q.y), sel);
  const uint32_t y = __byte_perm(limbs_of(q.z), limbs_of(q.w), sel);
  return __byte_perm(x, y, 0x5410);
}

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// k-steps [lo, hi) of plane j: q is the lane's key words in the plane's
// slot, R copy 0 of the plane's digits, copy s at R + s * stride.  The first k-step loads all
// four fragment registers of each tile, each later one two, its rows 8..
// being the rows 0.. of the last.
template <int TILES>
__device__ __forceinline__ void plane_mma(int32_t (&acc)[TILES][4], const uint32_t* q,
                                          const uint32_t* R, int stride, int lo, int hi,
                                          int wbase, uint32_t sel) {
  uint32_t a_reg[TILES][4];
#pragma unroll
  for (int tb = 0; tb < TILES; ++tb) {
    const int w = (3 - tb % 4) * stride + wbase - 16 * (tb / 4) + lo * KSTEP / 4;
    a_reg[tb][0] = R[w - 8];  // rows 8.. of k-step lo - 1, the rows 0.. of lo
    a_reg[tb][2] = R[w - 4];
  }
#pragma unroll 1
  for (int ks = lo; ks < hi; ++ks) {
    const int m0 = ks * KSTEP;
    const uint32_t b0 = limb_column(*reinterpret_cast<const uint4*>(q + m0), sel);
    const uint32_t b1 = limb_column(*reinterpret_cast<const uint4*>(q + m0 + 16), sel);
#pragma unroll
    for (int tb = 0; tb < TILES; ++tb) {
      const int w = (3 - tb % 4) * stride + wbase - 16 * (tb / 4) + m0 / 4;  // copy 3 - phase
      a_reg[tb][1] = a_reg[tb][0];
      a_reg[tb][3] = a_reg[tb][2];
      a_reg[tb][0] = R[w];
      a_reg[tb][2] = R[w + 4];
      mma_s8(acc[tb], a_reg[tb], b0, b1);
    }
  }
}

// acc0, out: (B, 2, N); a_steps: (n, B) (reduced mod 2N here); bk: (n, 2L,
// 2, 2N), 16-byte aligned.  Grid: cs blocks per sample, clusters of cs;
// TILES = N / (16 cs) row tiles per block.
template <int TILES>
__global__ void __launch_bounds__(warps_of(TILES) * 32, 1)
rotate_all_kernel(const int32_t* __restrict__ acc0, const int32_t* __restrict__ a_steps,
                  const int32_t* __restrict__ bk, int32_t* __restrict__ out, int B, int n,
                  int N, int l, int bgbit, uint32_t mask) {
  constexpr int WARPS = warps_of(TILES), THREADS = WARPS * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int two_l = 2 * l;
  const Layout L(N, two_l, cs);
  const int rb = L.rb;
  const int r = (int)cluster.block_rank();
  const int b = (int)(blockIdx.x / cs);
  const int k_start = r * rb;
  const int lrb = __ffs(rb) - 1;  // rb is a power of two
  uint32_t* dig = reinterpret_cast<uint32_t*>(smem + L.digits);  // [4 shifts][2L][pw]
  const uint32_t* ring = reinterpret_cast<const uint32_t*>(smem + L.key);  // [slots][2][kw]
  const uint32_t ring_s = smem_u32(smem + L.key), bars = smem_u32(smem + L.bars);
  uint32_t* accw = reinterpret_cast<uint32_t*>(smem + L.shared);  // [2][N], or partials [W][2][rb]
  uint32_t* slice = reinterpret_cast<uint32_t*>(smem + L.slices);  // [2][2][rb]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;  // fragment group and thread in group
  const int col_c = g / 4;                // this lane's B column (c, t)
  const uint32_t sel = (uint32_t)((g % 4) | ((4 + g % 4) << 4));
  const int ksteps = N / KSTEP;  // k-steps of one plane
  const int ks_lo = ksteps * warp / WARPS, ks_hi = ksteps * (warp + 1) / WARPS;  // ring: a plane's
  const int kr_lo = two_l * ksteps * warp / WARPS;  // resident: the step's k-steps
  const int kr_hi = two_l * ksteps * (warp + 1) / WARPS;
  const bool resident = L.slots >= two_l;
  // Word offset of reg0 of tile (group kb, any phase) at m0 = 0: row k =
  // k_start + 64 kb + p + 4g reads R[N - 1 - k + 4 tq ..] from copy 3 - p.
  const int wbase = (N - 4 - k_start) / 4 + tq - g;

  for (int idx = threadIdx.x; idx < 2 * rb; idx += THREADS) {
    const int c = idx / rb;
    slice[idx] = (uint32_t)acc0[((size_t)b * 2 + c) * N + k_start + (idx - c * rb)];
  }
  for (int idx = threadIdx.x; idx < 4 * two_l; idx += THREADS)
    for (int w = N / 2; w < L.pw; ++w) dig[idx * L.pw + w] = 0u;  // pads, never rewritten
  const int planes = n * two_l;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L.slots; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < (resident ? two_l : L.slots - 1) && c < planes; ++c)
      load_plane(ring_s, bars, bk, c, N, L.kw, L.slots);
  }
  const int tn = 2 * N;
  int a_next = a_steps[b];
  cluster.sync();

  int chunk = 0;  // planes taken through the ring so far
  for (int st = 0; st < n; ++st) {
    const int cur = st & 1;
    int a = a_next % tn;
    if (a < 0) a += tn;
    if (st + 1 < n) a_next = a_steps[(size_t)(st + 1) * B + b];

    // Gather the whole accumulator from the peers' slices.
    for (int v = threadIdx.x; v < N / 2; v += THREADS) {
      const int c = v >= N / 4, k = 4 * v - c * N;
      const int owner = k >> lrb;
      const uint32_t* peer = cluster.map_shared_rank(slice, owner);
      *reinterpret_cast<uint4*>(accw + c * N + k) =
          *reinterpret_cast<const uint4*>(peer + (cur * 2 + c) * rb + (k - (owner << lrb)));
    }
    __syncthreads();

    // Digits of X^a * acc - acc, written straight into the four shifted
    // copies of R_j = reverse([-d_j, d_j]).  A thread takes coefficients
    // i0 .. i0 + 3 of half p and the three below (i < 0: the negated digit
    // of i + N, as in E = [-d, d]): with x = d(i0 - 3) .. d(i0 + 3) in
    // bytes and y its byte reversal, copy s holds y[1 + s .. 4 + s] at
    // word (N - 4 - i0) / 4, and the same of -x at word (2N - 4 - i0) / 4
    // (whose bytes past 2N, at i0 < s, are never read).
    for (int v = threadIdx.x; v < N / 2; v += THREADS) {
      const int p = v >= N / 4, i0 = 4 * v - p * N;
      const uint32_t* poly = accw + p * N;
      const auto at = [poly](int x) { return poly[x]; };
      uint32_t u[7];
#pragma unroll
      for (int m = 0; m < 7; ++m) {
        const int i = i0 - 3 + m, ii = i < 0 ? i + N : i;
        u[m] = rustfhe::rounded_diff(rustfhe::rotated_coeff(at, ii, a, N), poly[ii], mask);
      }
      for (int lv = 0; lv < l; ++lv) {
        uint32_t x[2] = {0u, 0u};
#pragma unroll
        for (int m = 0; m < 7; ++m) {
          const int8_t d = rustfhe::digit(u[m], lv, bgbit);
          x[m / 4] |= (uint32_t)(uint8_t)(i0 - 3 + m < 0 ? -d : d) << (8 * (m % 4));
        }
        const uint32_t y_lo = __byte_perm(x[1], 0u, 0x0123), y_hi = __byte_perm(x[0], 0u, 0x0123);
        const uint32_t n_lo = __vsub4(0u, y_lo), n_hi = __vsub4(0u, y_hi);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          uint32_t* plane = dig + (s * two_l + p * l + lv) * L.pw;
          plane[(N - 4 - i0) / 4] = __funnelshift_rc(y_lo, y_hi, 8 * (1 + s));
          plane[(tn - 4 - i0) / 4] = __funnelshift_rc(n_lo, n_hi, 8 * (1 + s));
        }
      }
    }
    __syncthreads();  // every warp's tiles read every thread's digits

    int32_t acc[TILES][4];
#pragma unroll
    for (int tb = 0; tb < TILES; ++tb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[tb][e] = 0;

    if (resident) {
      // The step's planes are all in their slots: each warp walks its
      // contiguous k-steps across planes, waiting only for their loads.
      for (int j = kr_lo / ksteps; j * ksteps < kr_hi; ++j) {
        const int lo = max(kr_lo - j * ksteps, 0), hi = min(kr_hi - j * ksteps, ksteps);
        mbar_wait(bars + 8 * j, st & 1);
        plane_mma(acc, ring + j * 2 * L.kw + col_c * L.kw + 4 * tq, dig + j * L.pw,
                  two_l * L.pw, lo, hi, wbase, sel);
      }
    } else {
      for (int j = 0; j < two_l; ++j, ++chunk) {
        mbar_wait(bars + 8 * (chunk % L.slots), (chunk / L.slots) & 1);
        __syncthreads();  // plane j landed, and every warp is done with plane j - 1's slot
        if (threadIdx.x == 0 && chunk + L.slots - 1 < planes)
          load_plane(ring_s, bars, bk, chunk + L.slots - 1, N, L.kw, L.slots);
        if (ks_lo < ks_hi)
          plane_mma(acc, ring + (chunk % L.slots) * 2 * L.kw + col_c * L.kw + 4 * tq,
                    dig + j * L.pw, two_l * L.pw, ks_lo, ks_hi, wbase, sel);
      }
    }

    // Each warp's partial: columns 2 tq, 2 tq + 1 are limbs 2 (tq % 2), +1
    // of half tq / 2; the lane pair (tq, tq ^ 1) holds all four limbs.
    uint32_t* part = accw + warp * 2 * rb;
    const int sh = 16 * (tq % 2);
#pragma unroll
    for (int tb = 0; tb < TILES; ++tb) {
      const int row = ROWS * (tb / 4) + tb % 4 + 4 * g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // fragment rows g, g + 8
        uint32_t v = ((uint32_t)acc[tb][2 * h] << sh) + ((uint32_t)acc[tb][2 * h + 1] << (sh + 8));
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        if (tq % 2 == 0) part[(tq / 2) * rb + row + 32 * h] = v;
      }
    }
    __syncthreads();
    if (resident && threadIdx.x == 0 && st + 1 < n)  // every warp is done with this step's key
      for (int j = 0; j < two_l; ++j)
        load_plane(ring_s, bars, bk, (st + 1) * two_l + j, N, L.kw, L.slots);
    uint32_t* nxt = slice + (cur ^ 1) * 2 * rb;
    for (int idx = threadIdx.x; idx < 2 * rb; idx += THREADS) {
      uint32_t v = slice[cur * 2 * rb + idx];
#pragma unroll
      for (int w = 0; w < WARPS; ++w) v += accw[w * 2 * rb + idx];
      nxt[idx] = v;
    }
    cluster.sync();
  }

  const uint32_t* fin = slice + (n & 1) * 2 * rb;
  for (int idx = threadIdx.x; idx < 2 * rb; idx += THREADS) {
    const int c = idx / rb;
    out[((size_t)b * 2 + c) * N + k_start + (idx - c * rb)] = (int32_t)fin[idx];
  }
}

// The latency floor of a rotation: n cluster barriers and nothing else, on
// K3's cluster and block shape (a measurement, not on any path).
__global__ void __launch_bounds__(512, 1) barrier_floor_kernel(int n) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int st = 0; st < n; ++st) cluster.sync();
}

// The cluster size at ring degree N for a largest size `cluster`.
int cluster_size(int N, int cluster) { return N / ROWS < cluster ? N / ROWS : cluster; }

cudaLaunchConfig_t config(int B, int cs, int threads, int smem, cudaLaunchAttribute* attr,
                          cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cs, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Per device and instantiation: the dynamic shared memory granted so far.
int granted[3][MAX_DEVICES];

// Opt the instantiation into `smem` bytes and into clusters past 8, once
// per device and size.
template <int TILES>
cudaError_t prepare(int smem, int slot) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem <= granted[slot][dev]) return cudaSuccess;
  int limit = 0;
  e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (smem > limit) return cudaErrorInvalidConfiguration;
  const void* kernel = (const void*)rotate_all_kernel<TILES>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) granted[slot][dev] = smem;
  return e;
}

// The clusters of cs blocks the card holds at once; none is an error.
template <int TILES>
cudaError_t clusters_held(int cs, int smem, int slot, int* clusters) {
  cudaError_t e = prepare<TILES>(smem, slot);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(1, cs, warps_of(TILES) * 32, smem, attr, 0);
  e = cudaOccupancyMaxActiveClusters(clusters, (const void*)rotate_all_kernel<TILES>, &cfg);
  if (e != cudaSuccess) return e;
  return *clusters < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

template <int TILES>
cudaError_t launch(const void* acc, const void* a_steps, const void* bk, void* out, int B, int n,
                   int N, int l, int bgbit, unsigned int mask, int cs, int slot,
                   cudaStream_t stream) {
  const int smem = Layout(N, 2 * l, cs).bytes;
  cudaError_t e = prepare<TILES>(smem, slot);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(B, cs, warps_of(TILES) * 32, smem, attr, stream);
  e = cudaLaunchKernelEx(&cfg, rotate_all_kernel<TILES>, (const int32_t*)acc,
                         (const int32_t*)a_steps, (const int32_t*)bk, (int32_t*)out, B, n, N, l,
                         bgbit, (uint32_t)mask);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Shapes the kernel takes: N a power of two in [64, 2048], a largest
// cluster size of 8 or 16, digits whose negation fits int8, int32 sums
// that stay exact.
bool shape_ok(int N, int l, int bgbit, int cluster) {
  if (N < ROWS || N > 2048 || (N & (N - 1)) || l < 1 || bgbit < 1 || bgbit > 7) return false;
  if (cluster != 8 && cluster != 16) return false;
  return (1ll << (bgbit - 1)) * 128 * 2 * l * N < (1ll << 31);
}

}  // namespace

extern "C" {

// Every entry returns a cudaError_t (0 = success); a shape the kernel does
// not take launches nothing and returns cudaErrorInvalidValue.

int rustfhe_rotate_all_k(const void* acc, const void* a_steps, const void* bk, void* out, int B,
                         int n, int N, int l, int bgbit, unsigned int mask, int cluster,
                         void* stream) {
  if (B < 1 || n < 1 || !shape_ok(N, l, bgbit, cluster)) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)bk % 16 || (uintptr_t)acc % 4 || (uintptr_t)out % 4)
    return (int)cudaErrorMisalignedAddress;
  const int cs = cluster_size(N, cluster);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (N / (16 * cs)) {
    case 4: return (int)launch<4>(acc, a_steps, bk, out, B, n, N, l, bgbit, mask, cs, 0, st);
    case 8: return (int)launch<8>(acc, a_steps, bk, out, B, n, N, l, bgbit, mask, cs, 1, st);
    case 16: return (int)launch<16>(acc, a_steps, bk, out, B, n, N, l, bgbit, mask, cs, 2, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The clusters (one sample each) the current device holds at once.
int rustfhe_rotate_all_clusters(int N, int l, int cluster, int* clusters) {
  if (!shape_ok(N, l, 1, cluster)) return (int)cudaErrorInvalidValue;
  const int cs = cluster_size(N, cluster);
  const int smem = Layout(N, 2 * l, cs).bytes;
  switch (N / (16 * cs)) {
    case 4: return (int)clusters_held<4>(cs, smem, 0, clusters);
    case 8: return (int)clusters_held<8>(cs, smem, 1, clusters);
    case 16: return (int)clusters_held<16>(cs, smem, 2, clusters);
  }
  return (int)cudaErrorInvalidValue;
}

// B clusters of K3's shape at ring degree N, each passing n cluster
// barriers: the floor under n dependent steps.
int rustfhe_rotate_all_barrier_floor(int B, int n, int N, int cluster, void* stream) {
  if (B < 1 || n < 1 || !shape_ok(N, 1, 1, cluster)) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute((const void*)barrier_floor_kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(B, cluster_size(N, cluster), 512, 0, attr, (cudaStream_t)stream);
  e = cudaLaunchKernelEx(&cfg, barrier_floor_kernel, n);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // extern "C"
