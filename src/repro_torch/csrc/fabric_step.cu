// Fused fabric-simulator step core for Hopper (sm_90a): segment sums in a
// fixed order, per-hop work on the links a hop touches, and a thread-block
// cluster for a large cell.
//
// Replaces the TPU kernel src/repro/kernels/fabric_step.py:175
// (fabric_step_core, Pallas body _kernel at :61). Its specification is the
// plain PyTorch version src/repro_torch/kernels/ref.py::fabric_step_core:
// NIC limit, backpressure stall, H-hop staged propagation and the queue
// update of one simulator step (DESIGN.md §13).
//
// Bound on the H100 SXM: bytes. A launch moves about 4*F*H + 20*F +
// 32*(L+1) bytes a cell, under a microsecond at every shape of the
// characterization grids. Its time is the latency of a chain of
// dependent phases on one SM (each a few shared-memory round trips, an
// IEEE divide or a barrier), so the design keeps that chain short.
//
// Layout. One cell runs on a cluster of C blocks of T threads; C, T and
// the layout depend on the cell's shapes (F, H, L+1, n_src, n_sw) alone,
// never on the batch (kernels/fabric_step.py::launch_config): C = 1 up to
// 2048 flows, and more only where a block's rows would not fit. The unit
// of summation is the part: the flows [p*2048, (p+1)*2048) of a cell on
// a cluster (all its flows on one block). Block `rank` owns P consecutive
// parts, the flows [rank*nf, (rank+1)*nf) with nf = P*2048 (F on one
// block), the links [rank*nl, ...), the sources [rank*ns, ...) and the
// switches [rank*nw, ...) (nl = ceil((L+1)/C), and so on); the other
// blocks reach its rows through distributed shared memory, with
// barrier.cluster between phases. P = 1 up to C*2048 flows; above 8*2048
// (an alltoall over more than 256 nodes) the cluster is 8 and P =
// ceil(F / (8*2048)), so a cell has V = C*P <= MAX_PARTS parts. Flow i is
// part i / 2048's whatever the cluster and P, and flows appended to a
// cell (a bucket's padding) never move a real flow to another part.
//
// Wide layout. Where a block's rows do not fit 227 KB of shared memory
// (an alltoall over 128 or more LUMI nodes: L+1 up to 34,300 links and
// 2048 flows x 7 hops a block), the launch moves rows to a global-memory
// workspace, one stretch a block, which the wrapper allocates: a row's
// offset at or past Layout::total is a word of that stretch. Only where
// a row lives changes; every operation and its order stay, so a cell
// gives the same bits in either layout. A peer reaches a workspace row at
// its own stretch's offset; barrier.cluster (arrive.release,
// wait.acquire) orders those accesses across the cluster as it orders
// distributed shared memory, and __syncthreads within a block.
//
// 1. Prologue: every operand row is copied into shared memory at once
//    (cp.async), the path table hop-major.
// 2. Grouping, in an order fixed by the cell's operands alone:
//    * the block's flows by source, and every link of the cell whose
//      switch the block owns by switch (switch 0, whose stall is pinned
//      to 1, left out), in one counting sort: integer counts, one block
//      scan, placement by integer atomics; a bucket's order is restored
//      by index where it is summed (a sorting network in registers, or a
//      warp that ranks each item);
//    * each hop's flows by link: a stable LSD radix sort of the F*H hop
//      items (h*(L+1) + link, flow), 8 bits a pass (counts by shared
//      atomics, ranks in a tile by eight ballots), padded hops left out;
//      the segments and the long ones (see 3) are listed by ballots and
//      one block scan.
// 3. Every segment sum is a fold in this order:
//    * a part's share with n <= SERIAL_MAX = 8 contributions, in
//      ascending index (flow or link), is one thread's left fold from 0:
//      ((0 + v0) + v1) + ...;
//    * a longer one is one warp's: lane j folds v_j, v_{j+32}, ... from
//      0, then a butterfly p += shfl_xor(p, o) for o = 16, 8, 4, 2, 1;
//    * with C > 1 the parts' shares are added in part order: src_load
//      over every part, a part without a share adding 0, ((S_0 + S_1) +
//      ...) + S_{V-1}; a hop's link loads and served rates over the parts
//      that contributed, starting from the first. A block with P > 1
//      folds each of its parts on its own: its flows are grouped by
//      (part, source), and a hop's segment is a run of one (link, part)
//      in the sorted items, whose words carry the part in their index's
//      top bits.
//    A switch's sums are one part, whatever C: its owner folds all its
//    links (reading q and occ of another block's links from the
//    operands), so they do not depend on how the links are split, and a
//    cell padded into a larger bucket (more links, a larger cluster)
//    sums them as it does alone. The switch's sat is a max (maximum from
//    0, order-free). No float atomics: integer atomics only count, place,
//    mark and list.
// 4. Hops, each on the links it touches: with C = 1 one thread (or warp)
//    a segment sums the load, adds it to arrival and takes the
//    over-subscription divide; after a barrier each flow divides its rate
//    by its link's factor (one IEEE divide a thread); with aux a third
//    pass sums the served rate. With C > 1 the blocks post each part's
//    share to the link's owner and mark the part in the link's 32-bit
//    mask; the owner adds the shares of the links on its list; the blocks
//    read the factor back: two cluster barriers a hop (four with aux).
//    Only the prologue and the epilogue (arrival, q_new with the sink
//    pinned, caps_eff) pass over every link.
//
// Two launches are bit-equal, and a cell gives the same bits alone or in
// any batch. Build with --fmad=false and without fast math so every
// other operation rounds as the plain version does; bit-exact against it
// where every segment has one contributor, within DESIGN.md §13 (rtol
// 2e-4, atol 1.0) elsewhere. Every clamp and max keeps torch's NaN
// semantics (a NaN operand propagates): an unloaded zero-capacity link
// gives 0 / 0 = NaN in the over-subscription divide as in the plain
// version; a padded hop adds nothing, also for a NaN rate. No allocation
// and no synchronisation with the host: the launch can be captured in a
// CUDA graph once its first launch has set the shared-memory attribute.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstring>

namespace cg = cooperative_groups;

namespace {

constexpr int SERIAL_MAX = 8;  // longest segment part one thread sums
constexpr int PART_BITS = 11;  // a part: FLOWS_PER_PART = 2^11 flows
constexpr int FLOWS_PER_PART = 1 << PART_BITS;
constexpr int MAX_CLUSTER = 8;   // blocks a cell: the portable cluster size
constexpr int MAX_PARTS = 32;    // parts a cell: a link's mask is 32 bits
constexpr int MAX_ITEMS = 65536;  // hop items a block: 17-bit head counts
constexpr int KEY_BITS = 32;      // an item's (key, index) word
constexpr unsigned FULL = 0xffffffffu;
constexpr int ERR_SHAPE = -2;  // items or keys do not fit the encoding

// torch.maximum / torch.minimum: a NaN in either operand propagates, where
// fmaxf / fminf would return the other operand
__device__ __forceinline__ float maximum(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float minimum(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}

__host__ __device__ inline int bit_width(unsigned x) {
  int n = 0;
  while (x) {
    ++n;
    x >>= 1;
  }
  return n;
}

// A cell's geometry and what each block of its cluster holds.
struct Shape {
  int F, H, L1, n_src, n_sw, C, with_aux;
  int P, V;            // parts a block owns, parts a cell has (C * P)
  int nf, nl, ns, nw;  // flows, links, sources, switches a block owns
  int N;               // hop items a block sorts: nf * H
  int ib, kb;          // index bits and key bits of an item
  int sb;              // an item word >> sb: its segment, (key, part)
};

__host__ __device__ inline Shape make_shape(int F, int H, int L1, int n_src,
                                            int n_sw, int C, int with_aux) {
  Shape s;
  s.F = F;
  s.H = H;
  s.L1 = L1;
  s.n_src = n_src;
  s.n_sw = n_sw;
  s.C = C;
  s.with_aux = with_aux;
  s.P = C > 1 ? (F + C * FLOWS_PER_PART - 1) / (C * FLOWS_PER_PART) : 1;
  if (s.P < 1) s.P = 1;
  s.V = C * s.P;
  s.nf = C > 1 ? s.P * FLOWS_PER_PART : F;
  s.nl = (L1 + C - 1) / C;
  s.ns = (n_src + C - 1) / C;
  s.nw = (n_sw + C - 1) / C;
  s.N = s.nf * H;
  s.ib = bit_width(static_cast<unsigned>(s.nf - 1));
  s.kb = bit_width(static_cast<unsigned>(H * L1));
  s.sb = s.P > 1 ? PART_BITS : s.ib;
  return s;
}

// Offsets, in 4-byte words, of a block's rows in dynamic shared memory,
// and their total. The launch passes them: they are laid out, row by row,
// by kernels/fabric_step.py::smem_layout alone, whose LAYOUT_FIELDS lists
// these fields in this order. The grouping scratch of the prologue
// (tmp ... ord) and a cluster's hop tables (part ... list) share one
// stretch.
// An offset at or past `total` (the shared words) is a word of the block's
// workspace stretch, of gtotal - total words.
struct Layout {
  int ws, small, items, segs, longl, longb, spl;
  int r, hcap, sid;                  // [nf]
  int q, sat, ce, arr, ovr, smax;    // [nl]
  int srcp, srcl, swp, stall;        // sources and switches
  int tmp, ssw, boff, scr, ord;      // grouping
  int part, spart, touch, list;      // C > 1: a hop's parts, touched links
  int total, gtotal;
};
constexpr int LAYOUT_WORDS = 31;
static_assert(sizeof(Layout) == LAYOUT_WORDS * sizeof(int),
              "Layout is LAYOUT_WORDS ints");

struct Ptrs {
  const int* plinks;
  const float* inject;
  const int* src_id;
  const float* host_caps;
  const float* q;
  const float* occ;
  const float* caps_finite;
  const int* src_sw;
  const int* dst_sw;
  const float* scalars;
  float* inject_out;
  float* achieved;
  float* arrival;
  float* q_new;
  float* caps_eff;
  float* served_max;
  unsigned* gws;  // the wide layout's workspace: gtotal - total words a block
  long long s_src_id, s_host_caps, s_caps_finite, s_src_sw, s_dst_sw;
};

// ---- staging: 4-byte asynchronous copies into shared memory ----
__device__ __forceinline__ void copy_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Exclusive block-wide scan of one int a thread; ws holds 33 ints.
__device__ int block_exclusive_scan(int v, int* ws, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int y = lane < W ? ws[lane] : 0;
    int z = y;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, z, o);
      if (lane >= o) z += u;
    }
    if (lane < W) ws[lane] = z - y;
    if (lane == 31) ws[32] = z;
  }
  __syncthreads();
  total = ws[32];
  return ws[warp] + x - v;
}

// The lanes of the warp whose 8-bit value equals this lane's, among those
// in `live`: eight ballots, one a bit (__match_any_sync is slow when the
// values are many).
__device__ __forceinline__ unsigned same8(unsigned d, unsigned live) {
  unsigned m = live;
#pragma unroll
  for (int bit = 0; bit < 8; ++bit) {
    const unsigned ones = __ballot_sync(FULL, (d >> bit) & 1u);
    m &= ((d >> bit) & 1u) ? ones : ~ones;
  }
  return m;
}

// The 32-item tiles warp `warp` of W takes, in order: [t0, t1).
__device__ __forceinline__ void my_tiles(int N, int& t0, int& t1) {
  const int W = blockDim.x >> 5, tiles = (N + 31) >> 5;
  const int tw = (tiles + W - 1) / W;
  t0 = min(tiles, static_cast<int>(threadIdx.x >> 5) * tw);
  t1 = min(tiles, t0 + tw);
}

// Stable LSD radix sort of a[0, N) on bits [lo, lo + nbits), 8 bits a
// pass; b is scratch of N words. Warp w takes its tiles in order. A pass
// counts each warp's digits (shared atomics), scans the (digit, warp)
// counts in digit-major order into first slots, and places each tile's
// items at their digit's slot plus their rank among the tile's lanes of
// that digit (same8). hist holds 256 x W ints, ws 33. Returns the buffer
// that holds the result.
__device__ unsigned* radix_sort(unsigned* a, unsigned* b, int N, int lo,
                                int nbits, int* hist, int* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  int t0, t1;
  my_tiles(N, t0, t1);
  const unsigned below = (1u << lane) - 1u;  // lanes before this one
  for (int sh = lo; sh < lo + nbits; sh += 8) {
#pragma unroll 1
    for (int d = lane; d < 256; d += 32) hist[d * W + warp] = 0;
    __syncwarp();
#pragma unroll 4
    for (int t = t0; t < t1; ++t) {
      const int i = t * 32 + lane;
      if (i < N) atomicAdd(&hist[((a[i] >> sh) & 255u) * W + warp], 1);
    }
    __syncthreads();
    {  // 8 consecutive (digit, warp) counts a thread: 256 * W = 8 * T
      int4* h = reinterpret_cast<int4*>(hist + 8 * threadIdx.x);
      const int4 c0 = h[0], c1 = h[1];
      int total;
      int run = block_exclusive_scan(
          c0.x + c0.y + c0.z + c0.w + c1.x + c1.y + c1.z + c1.w, ws, total);
      int4 o0, o1;
      o0.x = run;
      o0.y = o0.x + c0.x;
      o0.z = o0.y + c0.y;
      o0.w = o0.z + c0.z;
      o1.x = o0.w + c0.w;
      o1.y = o1.x + c1.x;
      o1.z = o1.y + c1.y;
      o1.w = o1.z + c1.z;
      h[0] = o0;
      h[1] = o1;
    }
    __syncthreads();
    for (int t = t0; t < t1; ++t) {
      const int i = t * 32 + lane;
      const bool in = i < N;
      const unsigned x = in ? a[i] : 0u;
      const unsigned d = (x >> sh) & 255u;
      const unsigned m = same8(d, __ballot_sync(FULL, in));
      const int slot = in ? hist[d * W + warp] : 0;
      if (in) b[slot + __popc(m & below)] = x;
      __syncwarp();
      if (in && !(m & below)) hist[d * W + warp] = slot + __popc(m);
      __syncwarp();
    }
    __syncthreads();
    unsigned* t = a;
    a = b;
    b = t;
  }
  return a;
}

// ---- segment folds (header note, item 3) ----
// A short part (n <= SERIAL_MAX) is held in registers: its members'
// indices, then their values, each loaded all at once, then folded.
__device__ __forceinline__ void members(const unsigned* srt, int st, int n,
                                        unsigned imask,
                                        int (&fi)[SERIAL_MAX]) {
#pragma unroll
  for (int j = 0; j < SERIAL_MAX; ++j)
    if (j < n) fi[j] = static_cast<int>(srt[st + j] & imask);
}

__device__ __forceinline__ void gather(const float* row, int n,
                                       const int (&fi)[SERIAL_MAX],
                                       float (&v)[SERIAL_MAX]) {
#pragma unroll
  for (int j = 0; j < SERIAL_MAX; ++j)
    if (j < n) v[j] = row[fi[j]];
}

__device__ __forceinline__ float fold(int n, const float (&v)[SERIAL_MAX]) {
  float p = 0.0f;
#pragma unroll
  for (int j = 0; j < SERIAL_MAX; ++j)
    if (j < n) p = p + v[j];
  return p;
}

// The rate through a short part's link: v /= over, stored back to r;
// returns the served sum of the new rates.
__device__ __forceinline__ float rescale(int n, const int (&fi)[SERIAL_MAX],
                                         float (&v)[SERIAL_MAX], float ov,
                                         float* r) {
  float sv = 0.0f;
#pragma unroll
  for (int j = 0; j < SERIAL_MAX; ++j)
    if (j < n) {
      v[j] = v[j] / ov;
      r[fi[j]] = v[j];
      sv = sv + v[j];
    }
  return sv;
}

template <class V>
__device__ __forceinline__ float warp_sum(int n, V val) {
  const int lane = threadIdx.x & 31;
  float p = 0.0f;
#pragma unroll 1
  for (int j = lane; j < n; j += 32) p = p + val(j);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) p = p + __shfl_xor_sync(FULL, p, o);
  return p;
}

// hot_q, tot_q and sat of a switch's long part, by one warp: lane j folds
// its members j, j+32, ... (sums from 0, the max from 0), then a butterfly
// each. qv and satv give a link's queue and sat.
template <class V, class QV, class SV>
__device__ __forceinline__ void warp_fold3(int n, V link, QV qv, SV satv,
                                           float& hot, float& tot,
                                           float& mx) {
  const int lane = threadIdx.x & 31;
  hot = 0.0f;
  tot = 0.0f;
  mx = 0.0f;
#pragma unroll 1
  for (int j = lane; j < n; j += 32) {
    const int i = link(j);
    const float ql = qv(i), sa = satv(i);
    hot = hot + ql * sa;
    tot = tot + ql;
    mx = maximum(mx, sa);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    hot = hot + __shfl_xor_sync(FULL, hot, o);
    tot = tot + __shfl_xor_sync(FULL, tot, o);
    mx = maximum(mx, __shfl_xor_sync(FULL, mx, o));
  }
}

// In-place inclusive scan of c[0, n) by the block; ws holds 33 ints.
__device__ void scan_counts(int* c, int n, int* ws) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int i0 = min(n, static_cast<int>(threadIdx.x) * per);
  const int i1 = min(n, i0 + per);
  int sum = 0;
  for (int i = i0; i < i1; ++i) sum += c[i];
  int total;
  int run = block_exclusive_scan(sum, ws, total);
  for (int i = i0; i < i1; ++i) {
    run += c[i];
    c[i] = run;
  }
  __syncthreads();
}

// Sorts 8 ints ascending in registers (a 19-comparator network).
__device__ __forceinline__ void sort8(int (&x)[SERIAL_MAX]) {
  static_assert(SERIAL_MAX == 8, "the network sorts 8");
#define FS_CAS(a, b)                         \
  {                                          \
    const int lo_ = min(x[a], x[b]);         \
    x[b] = max(x[a], x[b]);                  \
    x[a] = lo_;                              \
  }
  FS_CAS(0, 2) FS_CAS(1, 3) FS_CAS(4, 6) FS_CAS(5, 7)
  FS_CAS(0, 4) FS_CAS(1, 5) FS_CAS(2, 6) FS_CAS(3, 7)
  FS_CAS(0, 1) FS_CAS(2, 3) FS_CAS(4, 5) FS_CAS(6, 7)
  FS_CAS(2, 4) FS_CAS(3, 5)
  FS_CAS(1, 4) FS_CAS(3, 6)
  FS_CAS(1, 2) FS_CAS(3, 4) FS_CAS(5, 6)
#undef FS_CAS
}

// The shape and the layout stay in the parameter bank (__grid_constant__):
// a by-value copy of them took registers and spilled. WIDE: some rows are
// in the workspace, so a row pointer is generic; without it every row is
// in shared memory and its accesses compile to shared loads and stores
// with 32-bit addresses (generic ones cost the shared layout 15-23% a
// launch on an H100). MULTI: a block owns more than one part (P > 1);
// without it every part step below compiles away.
template <bool WIDE, bool MULTI>
__global__ void __launch_bounds__(512)
    fabric_step_core_kernel(const Ptrs P, const __grid_constant__ Shape S,
                            const __grid_constant__ Layout Y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned* const smu = reinterpret_cast<unsigned*>(smem_raw);
  float* const smf = reinterpret_cast<float*>(smem_raw);
  int* const smi = reinterpret_cast<int*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = S.C;
  const int rank = C > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const long long b = blockIdx.x / C;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, W = T >> 5;
  const int F = S.F, H = S.H, L1 = S.L1, sink = L1 - 1;
  const bool aux = S.with_aux != 0;
  const int f0 = rank * S.nf, nf = max(0, min(S.nf, F - f0));
  const int l0 = rank * S.nl, nl = max(0, min(S.nl, L1 - l0));
  const int w0 = rank * S.nw, nw = max(0, min(S.nw, S.n_sw - w0));
  const int ns = max(0, min(S.ns, S.n_src - rank * S.ns));
  const int N = nf * H;
  const int ib = S.ib;
  const unsigned imask = (1u << ib) - 1u;
  const unsigned maxkey = (1u << S.kb) - 1u;
  const int R = H + 1;  // regions of the sorted items: the hops, left out
  // parts a block owns and a cell has
  const int PB = MULTI ? S.P : 1, V = MULTI ? S.V : C;
  const unsigned dmag = 0xffffffffu / static_cast<unsigned>(L1);

  // per-cell rows carry their own stride; geometry rows shared by every
  // cell of a batched run come with stride 0
  const int* plinks = P.plinks + b * F * H;
  const float* inject = P.inject + b * F;
  const int* src_id = P.src_id + b * P.s_src_id;
  const float* host_caps = P.host_caps + b * P.s_host_caps;
  const float* q = P.q + b * L1;
  const float* occ = P.occ + b * L1;
  const float* caps_finite = P.caps_finite + b * P.s_caps_finite;
  const int* src_sw = P.src_sw + b * P.s_src_sw;
  const int* dst_sw = P.dst_sw + b * P.s_dst_sw;
  float* inject_out = P.inject_out + b * F;
  float* achieved = P.achieved + b * F;
  float* arrival_out = P.arrival + b * L1;
  float* q_new = P.q_new + b * L1;
  float* caps_eff_out = P.caps_eff + b * L1;
  float* served_out = aux ? P.served_max + b * L1 : nullptr;
  const float dt = P.scalars[b * 5 + 0];
  const float qmax = P.scalars[b * 5 + 1];
  const float hol_factor = P.scalars[b * 5 + 2];
  const float hol_start = P.scalars[b * 5 + 3];
  const float jitter = P.scalars[b * 5 + 4];

  // a row at a layout offset: shared memory below Y.total, else the
  // block's stretch of the workspace
  const long long gstride = Y.gtotal - Y.total;
  unsigned* const gblk = P.gws + static_cast<long long>(blockIdx.x) * gstride;
  auto word = [&](int off) {
    if constexpr (WIDE) {
      return off < Y.total ? smu + off : gblk + (off - Y.total);
    } else {
      return smu + off;
    }
  };
  auto rowi = [&](int off) { return reinterpret_cast<int*>(word(off)); };
  auto rowf = [&](int off) { return reinterpret_cast<float*>(word(off)); };
  auto shared_row = [&](const void* p) {
    if constexpr (WIDE) {
      const unsigned char* c = static_cast<const unsigned char*>(p);
      return c >= smem_raw && c < smem_raw + 4ll * Y.total;
    } else {
      return true;
    }
  };
  int* reg_lo = smi + Y.small;  // [R] first segment of each hop
  int* reg_hi = reg_lo + R;     // [R] one past its last
  int* long_lo = reg_hi + R;    // [R] its first long segment in longl
  int* long_hi = long_lo + R;   // [R] one past its last
  int* nlist = long_hi + R;     // [2] touched links listed, by hop parity
  int* nlong = nlist + 2;       // long source and switch buckets
  unsigned* items = word(Y.items);
  int* segs = rowi(Y.segs);
  int* spl = rowi(Y.spl);        // the block's plinks, hop-major [H][nf]
  int* longl = rowi(Y.longl);
  int* longb = rowi(Y.longb);
  float* r = rowf(Y.r);          // inject, then the rate through the hops
  float* hcap = rowf(Y.hcap);    // host_caps, then the NIC-scaled inject
  int* sid = rowi(Y.sid);
  float* qr = rowf(Y.q);
  float* satr = rowf(Y.sat);     // occ, then sat
  float* ce = rowf(Y.ce);        // caps_finite, then caps_eff
  float* arr = rowf(Y.arr);
  float* ovr = rowf(Y.ovr);      // over factor of the hop
  int* dsw = rowi(Y.ovr);        // dst_sw until caps_eff is formed
  float* smax = rowf(Y.smax);
  float* srcp = smf + Y.srcp;    // [V][ns] parts of src_load by part
  float* srcl = smf + Y.srcl;
  float* swp = smf + Y.swp;      // [3][nw] hot_q, tot_q, sat by switch
  float* stall = smf + Y.stall;
  int* ssw = rowi(Y.ssw);        // src_sw of every link
  // buckets: source s of the block's part p is bucket p*n_src + s, switch
  // s bucket P*n_src + s; a flow's index and nf + a link's index are its
  // items
  const int NSB = PB * S.n_src, NB = NSB + S.n_sw;
  auto bucket_of = [&](int i) {  // a flow's bucket
    if constexpr (MULTI) return (i >> PART_BITS) * S.n_src + sid[i];
    else return sid[i];
  };
  int* boff = rowi(Y.boff);      // counts, then bucket bounds
  int* scr = rowi(Y.scr);        // items by bucket, in placement order
  int* ord = rowi(Y.ord);        // a long bucket's items in index order
  float* part = rowf(Y.part);    // [V][nl] a hop's load shares by part
  float* spart = rowf(Y.spart);  // [V][nl] its served shares
  unsigned* touch = word(Y.touch);  // parts that posted a share, by link
  int* list = rowi(Y.list);      // [2][nl] touched links, by hop parity

  // a row of the block that owns it: this block's own, its peer's
  // through distributed shared memory, or its peer's workspace stretch
  auto at = [&](auto* row, int owner) {
    if (C == 1 || owner == rank) return row;
    return shared_row(row) ? cluster.map_shared_rank(row, owner)
                           : row + (owner - rank) * gstride;
  };
  auto sync_cluster = [&]() {
    if (C > 1) cluster.sync();
    else __syncthreads();
  };
  // the hop of a sorted item's key (key / L1), or H for a left-out item
  auto hop_of = [&](unsigned key) {
    if (key == maxkey) return H;
    unsigned h = __umulhi(key, dmag);
    if (key - h * static_cast<unsigned>(L1) >= static_cast<unsigned>(L1))
      ++h;
    return static_cast<int>(h);
  };

  // ---- 1. prologue: operands in, tables zeroed, counts and items ----
  // every operand row the block reads is in flight at once (a workspace
  // row is a plain copy)
  auto stage = [&](auto* dst, const auto* src) {
    if (shared_row(dst)) copy_async(dst, src);
    else *dst = *src;
  };
#pragma unroll 1
  for (int i = tid; i < nf; i += T) {
    stage(r + i, inject + f0 + i);
    stage(hcap + i, host_caps + f0 + i);
    stage(sid + i, src_id + f0 + i);
  }
#pragma unroll 1
  for (int i = tid; i < nl; i += T) {
    stage(qr + i, q + l0 + i);
    stage(satr + i, occ + l0 + i);
    stage(ce + i, caps_finite + l0 + i);
    stage(dsw + i, dst_sw + l0 + i);
  }
#pragma unroll 1
  for (int i = tid; i < L1; i += T) stage(ssw + i, src_sw + i);
  const int* pl = plinks + static_cast<long long>(f0) * H;
  for (int h = 0; h < H; ++h) {
#pragma unroll 1
    for (int i = tid; i < nf; i += T) stage(spl + h * nf + i, pl + i * H + h);
  }
#pragma unroll 1
  for (int i = tid; i <= NB; i += T) boff[i] = 0;
#pragma unroll 1
  for (int i = tid; i < V * S.ns; i += T) srcp[i] = 0.0f;
#pragma unroll 1
  for (int i = tid; i < 3 * S.nw; i += T) swp[i] = 0.0f;
  if (aux) {
#pragma unroll 1
    for (int i = tid; i < nl; i += T) smax[i] = 0.0f;
  }
#pragma unroll 1
  for (int i = tid; i < 4 * R + 4; i += T) reg_lo[i] = 0;
  copy_async_wait();
  __syncthreads();
  const float hs_den = 1.0f - hol_start;
  auto sat_of = [&](float o) {
    return minimum(maximum((o - hol_start) / hs_den, 0.0f), 1.0f);
  };
#pragma unroll 1
  for (int i = tid; i < nl; i += T) satr[i] = sat_of(satr[i]);
  // fn(l, s) for each link l whose switch s this block owns (switch 0 left
  // out)
  auto my_links = [&](auto fn) {
#pragma unroll 1
    for (int l = tid; l < L1; l += T) {
      const int s = ssw[l];
      if (s != 0 && s >= w0 && s < w0 + nw) fn(l, s);
    }
  };
  my_links([&](int, int s) { atomicAdd(&boff[NSB + s + 1], 1); });
#pragma unroll 1
  for (int i = tid; i < nf; i += T) atomicAdd(&boff[bucket_of(i) + 1], 1);
  for (int h = 0; h < H; ++h) {
#pragma unroll 1
    for (int i = tid; i < nf; i += T) {
      const int lk = spl[h * nf + i];
      const unsigned key =
          lk < sink ? static_cast<unsigned>(h * L1 + lk) : maxkey;
      items[h * nf + i] = (key << ib) | static_cast<unsigned>(i);
    }
  }
  sync_cluster();  // with C > 1 also: every block of the cluster runs

  // ---- 2. group: flows by source and links by switch (a counting sort;
  // a bucket's order is restored by index where it is summed), each hop's
  // flows by link (a radix sort of the hop items), then the hops'
  // segments listed ----
  scan_counts(boff + 1, NB, smi + Y.ws);
#pragma unroll 1
  for (int i = tid; i < nf; i += T)
    scr[atomicAdd(&boff[bucket_of(i)], 1)] = i;
  my_links([&](int l, int s) {
    scr[atomicAdd(&boff[NSB + s], 1)] = nf + l;
  });
  const unsigned* srt = radix_sort(items, word(Y.tmp), N, ib, S.kb,
                                   smi + Y.ws, smi + Y.ws + 256 * 16);
  {
    // an odd number of passes leaves the sorted items in tmp, whose
    // shared memory a cluster's hop tables reuse: where one of them
    // overlaps it, the items move back to their own row first
    auto clash = [&](int off, int words) {
      return words > 0 && off < Y.total && off < Y.tmp + S.N &&
             Y.tmp < off + words;
    };
    if (C > 1 && srt != items && Y.tmp < Y.total &&
        (clash(Y.part, V * S.nl) || clash(Y.spart, aux ? V * S.nl : 0) ||
         clash(Y.touch, S.nl) || clash(Y.list, 2 * S.nl))) {
#pragma unroll 1
      for (int i = tid; i < N; i += T) items[i] = srt[i];
      __syncthreads();
      srt = items;
    }
  }
  auto key_at = [&](int pos) { return srt[pos] >> ib; };
  // a segment: one key (hop and link) and, with MULTI, one part
  auto seg_at = [&](int pos) {
    if constexpr (MULTI) return srt[pos] >> S.sb;
    else return srt[pos] >> ib;
  };
  // the part of the cell a segment starting at pos belongs to
  auto part_of = [&](int pos) {
    if constexpr (MULTI)
      return rank * PB + static_cast<int>((srt[pos] & imask) >> PART_BITS);
    else return rank;
  };
  {
    // a head opens a segment; it is long (a warp's) when the item
    // SERIAL_MAX places on is still in its segment. Each warp counts its
    // tiles' heads and long heads (ballots), one scan of the two counts
    // packed (heads in the low 17 bits: up to MAX_ITEMS) places both lists
    // in key order, and each warp writes its part.
    int t0, t1;
    my_tiles(N, t0, t1);
    const unsigned below = (1u << lane) - 1u;
    auto flags = [&](int i, unsigned& key, unsigned& prev, bool& head,
                     bool& lng) {
      const bool in = i < N;
      key = in ? key_at(i) : maxkey;
      prev = in && i > 0 ? key_at(i - 1) : ~0u;
      head = in && (i == 0 || (MULTI ? seg_at(i) != seg_at(i - 1)
                                     : key != prev));
      lng = head && key != maxkey && i + SERIAL_MAX < N &&
            (MULTI ? seg_at(i + SERIAL_MAX) == seg_at(i)
                   : key_at(i + SERIAL_MAX) == key);
    };
    int heads = 0, longs = 0;
    for (int t = t0; t < t1; ++t) {
      unsigned key, prev;
      bool head, lng;
      flags(t * 32 + lane, key, prev, head, lng);
      heads += __popc(__ballot_sync(FULL, head));
      longs += __popc(__ballot_sync(FULL, lng));
    }
    int total;
    const int ex = block_exclusive_scan(
        lane == 0 ? heads + (longs << 17) : 0, smi + Y.ws, total);
    int k = __shfl_sync(FULL, ex, 0) & 0x1ffff;
    int g = __shfl_sync(FULL, ex, 0) >> 17;
    for (int t = t0; t < t1; ++t) {
      const int i = t * 32 + lane;
      unsigned key, prev;
      bool head, lng;
      flags(i, key, prev, head, lng);
      const unsigned hb = __ballot_sync(FULL, head);
      const unsigned lb = __ballot_sync(FULL, lng);
      if (head) {
        const int kk = k + __popc(hb & below), gg = g + __popc(lb & below);
        segs[kk] = i;
        if (lng) longl[gg] = kk;
        const int rg = hop_of(key), prg = i == 0 ? -1 : hop_of(prev);
        if (rg != prg) {
          reg_lo[rg] = kk;
          long_lo[rg] = gg;
          if (prg >= 0) {
            reg_hi[prg] = kk;
            long_hi[prg] = gg;
          }
        }
      }
      if (i == N - 1) {
        const int rg = hop_of(key);
        reg_hi[rg] = total & 0x1ffff;
        long_hi[rg] = total >> 17;
      }
      k += __popc(hb);
      g += __popc(lb);
    }
    if (tid == 0) segs[total & 0x1ffff] = N;
  }

  // ---- 3. NIC and backpressure segment sums, posted to their owners ----
  // source bucket k: source s of the block's part p
  auto post_src = [&](int k, float v) {
    int p = 0, s = k;
    if constexpr (MULTI) {
      p = k / S.n_src;
      s = k - p * S.n_src;
    }
    const int o = C == 1 ? 0 : s / S.ns;
    at(srcp, o)[(rank * PB + p) * S.ns + (s - o * S.ns)] = v;
  };
  // a switch's sums, whole: this block owns the switch
  auto post_sw = [&](int s, float hot, float tot, float mx) {
    swp[0 * S.nw + s - w0] = hot;
    swp[1 * S.nw + s - w0] = tot;
    swp[2 * S.nw + s - w0] = mx;
  };
  // a link's queue and sat: its own rows with C == 1 (every link is this
  // block's), else the operands
  auto q_of = [&](int l) { return C == 1 ? qr[l] : q[l]; };
  auto s_of = [&](int l) { return C == 1 ? satr[l] : sat_of(occ[l]); };
#pragma unroll 1
  // bucket k spans [k ? boff[k-1] : 0, boff[k]) of scr; a short one is
  // ordered in registers, a long one by a warp into ord
#pragma unroll 1
  for (int k = tid; k < NB; k += T) {
    const int lo = k ? boff[k - 1] : 0, n = boff[k] - lo;
    if (n == 0) continue;
    if (n > SERIAL_MAX) {
      longb[atomicAdd(nlong, 1)] = k;
      continue;
    }
    int fi[SERIAL_MAX];
#pragma unroll
    for (int j = 0; j < SERIAL_MAX; ++j) fi[j] = j < n ? scr[lo + j] : INT_MAX;
    if (n > 1) sort8(fi);
    if (k < NSB) {
      float v[SERIAL_MAX];
      gather(r, n, fi, v);
      post_src(k, fold(n, v));
      continue;
    }
    float qv[SERIAL_MAX], sv[SERIAL_MAX];
#pragma unroll
    for (int j = 0; j < SERIAL_MAX; ++j)
      if (j < n) {
        qv[j] = q_of(fi[j] - nf);
        sv[j] = s_of(fi[j] - nf);
      }
    float hot = 0.0f, tot = 0.0f, mx = 0.0f;
#pragma unroll
    for (int j = 0; j < SERIAL_MAX; ++j)
      if (j < n) {
        hot = hot + qv[j] * sv[j];
        tot = tot + qv[j];
        mx = maximum(mx, sv[j]);
      }
    post_sw(k - NSB, hot, tot, mx);
  }
  __syncthreads();
#pragma unroll 1
  for (int j = warp; j < *nlong; j += W) {
    const int k = longb[j], lo = k ? boff[k - 1] : 0, n = boff[k] - lo;
#pragma unroll 1
    for (int m = lane; m < n; m += 32) {  // rank among the bucket's items
      const int id = scr[lo + m];
      int rk = 0;
#pragma unroll 4
      for (int e = 0; e < n; ++e) rk += scr[lo + e] < id;
      ord[lo + rk] = id;
    }
    __syncwarp();
    if (k < NSB) {
      const float v = warp_sum(n, [&](int m) { return r[ord[lo + m]]; });
      if (lane == 0) post_src(k, v);
    } else {
      float hot, tot, mx;
      warp_fold3(n, [&](int m) { return ord[lo + m] - nf; }, q_of, s_of, hot,
                 tot, mx);
      if (lane == 0) post_sw(k - NSB, hot, tot, mx);
    }
  }
  sync_cluster();

  // ---- owners add the parts' shares of src_load; the stall per switch ----
#pragma unroll 1
  for (int i = tid; i < ns; i += T) {
    float v = srcp[i];
    for (int c = 1; c < V; ++c) v = v + srcp[c * S.ns + i];
    srcl[i] = v;
  }
#pragma unroll 1
  for (int i = tid; i < nw; i += T) {
    const float hot = swp[0 * S.nw + i], tot = swp[1 * S.nw + i];
    const float mx = swp[2 * S.nw + i];
    const float share = hot / maximum(tot, 1.0f);
    const float st = 1.0f - hol_factor * mx * share;
    stall[i] = w0 + i == 0 ? 1.0f : st;  // 0 == host endpoint
  }
  if (C > 1) {
#pragma unroll 1
    for (int i = tid; i < S.nl; i += T) touch[i] = 0u;
  }
  sync_cluster();
#pragma unroll 1
  for (int i = tid; i < nl; i += T) {
    const int d = dsw[i], o = C == 1 ? 0 : d / S.nw;
    ce[i] = ce[i] * at(stall, o)[d - o * S.nw];
    arr[i] = 0.0f;
  }
#pragma unroll 1
  for (int i = tid; i < nf; i += T) {
    const int s = sid[i], o = C == 1 ? 0 : s / S.ns;
    const float sl = at(srcl, o)[s - o * S.ns];
    const float scale = minimum(hcap[i] / maximum(sl, 1.0f), 1.0f);
    const float x = r[i] * scale;
    r[i] = x;
    hcap[i] = x;  // the NIC-scaled inject, written out at the end
  }
  __syncthreads();

  // ---- 4. H-hop staged propagation ----
  for (int h = 0; h < H; ++h) {
    const int koff = h * L1;
    const int lo = reg_lo[h], hi = reg_hi[h];
    if (C == 1) {
      // each segment: its load, arrival and over factor
#pragma unroll 1
      for (int k = lo + tid; k < hi; k += T) {
        const int st = segs[k], n = segs[k + 1] - st;
        if (n > SERIAL_MAX) continue;
        const int l = static_cast<int>(key_at(st)) - koff;
        int fi[SERIAL_MAX];
        float v[SERIAL_MAX];
        members(srt, st, n, imask, fi);
        gather(r, n, fi, v);
        const float ld = fold(n, v);
        arr[l] = arr[l] + ld;
        ovr[l] = maximum(ld / ce[l], 1.0f);  // over-subscription
      }
#pragma unroll 1
      for (int j = long_lo[h] + warp; j < long_hi[h]; j += W) {
        const int k = longl[j], st = segs[k];
        const float ld = warp_sum(segs[k + 1] - st, [&](int m) {
          return r[srt[st + m] & imask];
        });
        if (lane == 0) {
          const int l = static_cast<int>(key_at(st)) - koff;
          arr[l] = arr[l] + ld;
          ovr[l] = maximum(ld / ce[l], 1.0f);
        }
      }
      __syncthreads();
      // each flow: the rate through its link at this hop
#pragma unroll 1
      for (int i = tid; i < nf; i += T) {
        const int lk = spl[h * nf + i];
        if (lk < sink) r[i] = r[i] / ovr[lk];
      }
      __syncthreads();
      if (!aux) continue;
      // the served rate of each segment's link
#pragma unroll 1
      for (int k = lo + tid; k < hi; k += T) {
        const int st = segs[k], n = segs[k + 1] - st;
        if (n > SERIAL_MAX) continue;
        const int l = static_cast<int>(key_at(st)) - koff;
        int fi[SERIAL_MAX];
        float v[SERIAL_MAX];
        members(srt, st, n, imask, fi);
        gather(r, n, fi, v);
        smax[l] = maximum(smax[l], fold(n, v));
      }
#pragma unroll 1
      for (int j = long_lo[h] + warp; j < long_hi[h]; j += W) {
        const int k = longl[j], st = segs[k];
        const float sv = warp_sum(segs[k + 1] - st, [&](int m) {
          return r[srt[st + m] & imask];
        });
        if (lane == 0) {
          const int l = static_cast<int>(key_at(st)) - koff;
          smax[l] = maximum(smax[l], sv);
        }
      }
      __syncthreads();
      continue;
    }
    // C > 1: (a) each part's share to the link's owner, which lists the
    // links touched
    const int par = h & 1;
    auto post = [&](int l, int vp, float v) {
      const int o = l / S.nl, loc = l - o * S.nl;
      at(part, o)[vp * S.nl + loc] = v;
      if (atomicOr(at(touch, o) + loc, 1u << vp) == 0u)
        at(list, o)[par * S.nl + atomicAdd(at(nlist, o) + par, 1)] = loc;
    };
#pragma unroll 1
    for (int k = lo + tid; k < hi; k += T) {
      const int st = segs[k], n = segs[k + 1] - st;
      if (n > SERIAL_MAX) continue;
      int fi[SERIAL_MAX];
      float v[SERIAL_MAX];
      members(srt, st, n, imask, fi);
      gather(r, n, fi, v);
      post(static_cast<int>(key_at(st)) - koff, part_of(st), fold(n, v));
    }
#pragma unroll 1
    for (int j = long_lo[h] + warp; j < long_hi[h]; j += W) {
      const int k = longl[j], st = segs[k], n = segs[k + 1] - st;
      const float v =
          warp_sum(n, [&](int m) { return r[srt[st + m] & imask]; });
      if (lane == 0)
        post(static_cast<int>(key_at(st)) - koff, part_of(st), v);
    }
    cluster.sync();
    // (b) the owner adds the shares of its touched links in part order
    const int nt = nlist[par];
#pragma unroll 1
    for (int j = tid; j < nt; j += T) {
      const int loc = list[par * S.nl + j];
      const unsigned m = touch[loc];
      float ld = 0.0f;
      bool first = true;
      for (int c = 0; c < V; ++c) {
        if (!((m >> c) & 1u)) continue;
        const float v = part[c * S.nl + loc];
        ld = first ? v : ld + v;
        first = false;
      }
      arr[loc] = arr[loc] + ld;
      ovr[loc] = maximum(ld / ce[loc], 1.0f);
      if (!aux) touch[loc] = 0u;
    }
    if (tid == 0) nlist[par ^ 1] = 0;
    cluster.sync();
    // (c) each block rescales its flows by the owner's over factor
    auto post_served = [&](int l, int vp, float v) {
      const int o = l / S.nl;
      at(spart, o)[vp * S.nl + (l - o * S.nl)] = v;
    };
#pragma unroll 1
    for (int k = lo + tid; k < hi; k += T) {
      const int st = segs[k], n = segs[k + 1] - st;
      if (n > SERIAL_MAX) continue;
      const int l = static_cast<int>(key_at(st)) - koff, o = l / S.nl;
      int fi[SERIAL_MAX];
      float v[SERIAL_MAX];
      members(srt, st, n, imask, fi);
      gather(r, n, fi, v);
      const float sv = rescale(n, fi, v, at(ovr, o)[l - o * S.nl], r);
      if (aux) post_served(l, part_of(st), sv);
    }
#pragma unroll 1
    for (int j = long_lo[h] + warp; j < long_hi[h]; j += W) {
      const int k = longl[j], st = segs[k], n = segs[k + 1] - st;
      const int l = static_cast<int>(key_at(st)) - koff, o = l / S.nl;
      const float ov = at(ovr, o)[l - o * S.nl];
#pragma unroll 1
      for (int m = lane; m < n; m += 32) {
        const int i = srt[st + m] & imask;
        r[i] = r[i] / ov;
      }
      if (aux) {
        __syncwarp();
        const float sv =
            warp_sum(n, [&](int m) { return r[srt[st + m] & imask]; });
        if (lane == 0) post_served(l, part_of(st), sv);
      }
    }
    if (!aux) {
      __syncthreads();
      continue;
    }
    cluster.sync();
    // (d) the owner adds the served shares and clears its touched marks
#pragma unroll 1
    for (int j = tid; j < nt; j += T) {
      const int loc = list[par * S.nl + j];
      const unsigned m = touch[loc];
      float sv = 0.0f;
      bool first = true;
      for (int c = 0; c < V; ++c) {
        if (!((m >> c) & 1u)) continue;
        const float v = spart[c * S.nl + loc];
        sv = first ? v : sv + v;
        first = false;
      }
      smax[loc] = maximum(smax[loc], sv);
      touch[loc] = 0u;
    }
    cluster.sync();
  }

  // ---- 5. epilogue: the queue update, sink pinned to 0 ----
#pragma unroll 1
  for (int i = tid; i < nl; i += T) {
    const int l = l0 + i;
    const float a = arr[i];
    arrival_out[l] = a;
    const float x = qr[i] + (a * (1.0f + jitter) - ce[i]) * dt;
    q_new[l] = l == sink ? 0.0f : minimum(maximum(x, 0.0f), qmax);
    caps_eff_out[l] = ce[i];
    if (aux) served_out[l] = smax[i];
  }
#pragma unroll 1
  for (int i = tid; i < nf; i += T) {
    inject_out[f0 + i] = hcap[i];
    achieved[f0 + i] = r[i];
  }
  if (C > 1) cluster.sync();  // peers may still read this block's rows
}

// dynamic shared memory each instantiation is allowed so far, by [wide][multi]
int g_smem_set[2][2] = {{-1, -1}, {-1, -1}};

}  // namespace

extern "C" {

// Launches one step core for B cells on `stream`, each on a cluster of
// `cluster` blocks of `threads` threads, with a block's rows laid out by
// `layout` (LAYOUT_WORDS host ints: Layout's fields in order) in shared
// memory and, past layout total, in `workspace` (B * cluster stretches of
// gtotal - total words; null when there are none).
// Pointers are device pointers; s_* are batch strides in elements (0 =
// shared by all cells). Returns the cudaError_t of the attribute call or
// the launch, or ERR_SHAPE when the wrapper's configuration does not fit
// the kernel.
int fabric_step_core_launch(
    const void* plinks, const void* inject, const void* src_id,
    const void* host_caps, const void* q, const void* occ,
    const void* caps_finite, const void* src_sw, const void* dst_sw,
    const void* scalars, void* inject_out, void* achieved, void* arrival,
    void* q_new, void* caps_eff, void* served_max, void* workspace, int B,
    int F, int H,
    int L1, int n_src, int n_sw, long long s_src_id, long long s_host_caps,
    long long s_caps_finite, long long s_src_sw, long long s_dst_sw,
    int with_aux, int threads, int cluster, const int* layout,
    void* stream) {
  const Shape s = make_shape(F, H, L1, n_src, n_sw, cluster, with_aux);
  Layout y;
  memcpy(&y, layout, sizeof(Layout));
  const int smem_bytes = 4 * y.total;
  if (F > cluster * s.nf || s.ib + s.kb > KEY_BITS || s.kb >= 32 ||
      s.N > MAX_ITEMS || s.V > MAX_PARTS || threads % 32 || threads < 64 ||
      threads > 512 || cluster < 1 || cluster > MAX_CLUSTER ||
      y.gtotal < y.total || (y.gtotal > y.total && workspace == nullptr))
    return ERR_SHAPE;
  const bool wide = y.gtotal > y.total, multi = s.P > 1;
  using Kernel = void (*)(Ptrs, Shape, Layout);
  const Kernel kernels[2][2] = {
      {fabric_step_core_kernel<false, false>,
       fabric_step_core_kernel<false, true>},
      {fabric_step_core_kernel<true, false>,
       fabric_step_core_kernel<true, true>}};
  const Kernel kernel = kernels[wide][multi];
  if (smem_bytes > g_smem_set[wide][multi]) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    g_smem_set[wide][multi] = smem_bytes;
  }
  const Ptrs p = {
      static_cast<const int*>(plinks), static_cast<const float*>(inject),
      static_cast<const int*>(src_id), static_cast<const float*>(host_caps),
      static_cast<const float*>(q), static_cast<const float*>(occ),
      static_cast<const float*>(caps_finite),
      static_cast<const int*>(src_sw), static_cast<const int*>(dst_sw),
      static_cast<const float*>(scalars), static_cast<float*>(inject_out),
      static_cast<float*>(achieved), static_cast<float*>(arrival),
      static_cast<float*>(q_new), static_cast<float*>(caps_eff),
      static_cast<float*>(served_max), static_cast<unsigned*>(workspace),
      s_src_id, s_host_caps, s_caps_finite, s_src_sw, s_dst_sw};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p, s, y);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

const char* fabric_step_error_string(int code) {
  if (code == ERR_SHAPE)
    return "the shape does not fit the kernel's item encoding or block";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
