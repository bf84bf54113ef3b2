// Backward of the flash attention for Hopper (sm_90a) on bfloat16
// inputs: wgmma on the tensor cores, TMA-fed tiles, warp-specialised
// blocks (consumer warpgroups and one producer warpgroup).
//
// The TPU package has no backward kernel: XLA differentiates its attention
// (src/repro/models/layers.py::flash_attention_xla). This is the bfloat16
// gradient of kernel 7 (flash_attention_sm90.cu) on the port's training
// path; float32 stays on flash_attention_bwd.cu. Its specification is the
// plain PyTorch version src/repro_torch/kernels/ref.py::flash_attention_bwd:
// with s = (q * scale) . k over the live keys (causal, inside the window,
// before Skv), P = exp(s - lse) from the forward's row log-sum-exp lse
// (B, H, Sq), and delta = rowsum(dO * O) (B, H, Sq), both float32,
//     dV_j = sum_i P_ij dO_i           dS_ij = P_ij (dO_i . V_j - delta_i)
//     dK_j = sum_i dS_ij (q_i * scale) dQ_i  = scale * sum_j dS_ij K_j
// where i runs over the query rows of the G = H / KH heads that read KV
// head j's head. A row with no live key (lse = -inf) gets P = 0, so every
// gradient it touches is 0, not NaN. Products run on bf16 operands with
// float32 sums; P and dS, float32 in the plain version, enter the second
// products as bf16 hi + lo pairs (hi = bf16(x), lo = bf16(x - hi)), two
// wgmmas each, which keeps the bf16 limit that a single rounding breaks.
//
// Design: three kernels (four for G > kHeadsABlock) and no atomics, so a
// launch is deterministic; the wrapper counts them as one launch.
// * Pass 0: delta from o and dO, one pass over both.
// * Pass 1, dK and dV: one block per (128 keys, KV head, batch row), the
//   first key blocks of every head launched first (under a causal mask
//   the most queries see them, so the short last ones fill the tail). Two
//   consumer warpgroups keep 64 keys each of K and V in shared memory and
//   dK, dV in registers (240 registers a thread). The producer warp
//   streams the query tiles that can see the block's keys -- causally
//   from its first key, up to its last key + window - 1 -- for each of the
//   G heads: Q and dO tiles of 64 positions by TMA, and lse and delta by
//   its 32 lanes, fetched a tile ahead, into a ring of three stages. Per
//   tile: S^T = K . Q^T and dP^T = V . dO^T (wgmma m64n64k16 from shared
//   memory), P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta) in
//   registers, then dV += P^T . dO and dK += dS^T . Q, each as hi + lo
//   (m64nDk16, A from registers, B read MN-major). dK is scaled once at
//   the end. Above kHeadsABlock heads a KV head (granite-20b's MQA), the
//   heads are split over blocks and a fourth kernel adds their float32
//   sums in a fixed order.
// * Pass 2, dQ: one block per (3 x P query positions, KV head, batch
//   row), rows grouped as in the forward (P = 64 / G positions x G heads a
//   warpgroup; two warpgroups for D = 128), Q and dO resident, K and V
//   tiles of 64 keys through the ring: S = Q . K^T, dP = dO . V^T, P and
//   dS as above, dQ += dS . K as hi + lo, scaled at the end.
// Tiles wholly outside a warpgroup's causal limit or window are skipped;
// only edge tiles mask per element. TMA reads zeros past the ends.
// (On the H100, overlapping a tile's elementwise work with the previous
// tile's products inside a warpgroup, as the forward of FlashAttention-3
// does, measured slower, with spills at these register budgets.)
//
// Bound on the H100 SXM: operations. Per live (query, key) pair the
// function needs five D-long products (the recomputed score, dO . V and
// the dV, dK and dQ updates): 10 * D flops; at the training shape (B = 4,
// S = 1280, 25/5 heads x 64, window 1024) 50.4 GFLOP, 0.051 ms at the bf16
// tensor-core peak (989 TFLOP/s), against 79 MB of q, k, v, o, dO, lse and
// the gradients (24 us at 3.35 TB/s). The two passes do 20 * D: pass 2
// recomputes the score and dO . V, and hi + lo doubles the three
// products that take P or dS.

#include "sm90.cuh"

#include <math.h>

namespace {

using namespace sm90;

constexpr int kStages = 3;  // ring stages
constexpr int kNC1 = 2;     // pass 1's consumer warpgroups (240 registers)
// pass 1's heads a block: dK and dV sum over the G heads' query rows in
// the tensor cores' float32 accumulators, whose adds round toward zero,
// so the error grows with the rows summed. Above this many heads
// (granite-20b: G = 48, 61,440 rows a key at S = 1,280, 4e-3 relative)
// the heads are cut into chunks of at most this many, each a block, and
// their float32 sums added in chunk order by attn_bwd_dkdv_reduce. The
// wrapper sizes the chunks' workspace with the same number
// (kernels/flash_attention.py BWD_HEADS_A_BLOCK).
constexpr int kHeadsABlock = 8;

// pass 2's consumer warpgroups: three (160 registers each) where the
// accumulators fit (D = 96 and 112 too), two (240) for D = 128
template <int D>
constexpr int consumers2() {
  return D == 128 ? 2 : 3;
}

// ------------------------------------------------------------ pass 0
// delta = rowsum(dO * O) in float32, (B, H, Sq), from o and dO (B, Sq, H,
// D) in bf16: a row's D / 8 pieces of 16 bytes, one a thread, over a
// power-of-two group of threads (D / 8 but for D = 96 and 112, whose 12
// and 14 pieces take 16 threads, the last idle), summed over the group
// with xor shuffles
template <int D>
__host__ __device__ constexpr int delta_threads() {
  int t = 1;
  while (t < D / 8) t *= 2;
  return t;
}

template <int D>
__global__ void __launch_bounds__(256)
    attn_bwd_delta_sm90(const __nv_bfloat16* __restrict__ o,
                        const __nv_bfloat16* __restrict__ dout,
                        float* __restrict__ delta, int Sq, int H,
                        long long rows) {
  constexpr int TPR = delta_threads<D>();
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / TPR;
  const int part = threadIdx.x % TPR;
  float sum = 0.f;
  if (row < rows && part < D / 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + row * D + part * 8);
    const uint4 c =
        *reinterpret_cast<const uint4*>(dout + row * D + part * 8);
    const uint32_t av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&av[i]));
      const float2 y = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&cv[i]));
      sum += x.x * y.x + x.y * y.y;
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (row < rows && part == 0) {
    const long long pos = row / H % Sq, b = row / (static_cast<long long>(H)
                                                  * Sq);
    delta[(b * H + row % H) * Sq + pos] = sum;
  }
}

// ------------------------------------------------------------ pass 1
// shared memory: each warpgroup's K and V tiles, then the ring of (Q, dO,
// lse[64], delta[64]) stages, then the mbarriers
template <int D>
struct Smem1 {
  static constexpr int kTile = Chunk<D>::kTileBytes;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kNC1 * kTile;
  static constexpr int kRing = kV + kNC1 * kTile;
  static constexpr int kStage = (2 * kTile + 512 + 1023) / 1024 * 1024;
  static constexpr int kBar = kRing + kStages * kStage;  // kv, full, empty
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(Roles<kNC1>::kThreads, 1)
    attn_bwd_dkdv_sm90(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv,
                       float* __restrict__ part, int Sq, int Skv, int H,
                       int KH, int Gs, int causal, int window,
                       float scale) {
  using C = Chunk<D>;
  using L = Smem1<D>;
  constexpr int NC = kNC1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + kStages;

  const int G = H / KH;
  // blockIdx.x runs over (batch row, KV head) and blockIdx.y over key
  // blocks, so the first blocks launched are the first key blocks of
  // every head, which the most queries see under a causal mask
  const int kvh = blockIdx.x % KH, b = blockIdx.x / KH;
  const int k0 = blockIdx.y * NC * kTileRows;
  // the query positions that can see a key of this block
  const int k_end = min(k0 + NC * kTileRows, Skv);
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k_end - 1 + window) : Sq;
  const int n_pos =
      q_hi > q_lo ? (q_hi - q_lo + kTileRows - 1) / kTileRows : 0;
  // blockIdx.z picks the block's Gs heads of the G (all of them but for
  // G > kHeadsABlock)
  const int g_lo = blockIdx.z * Gs;
  const int n_tiles = min(Gs, G - g_lo) * n_pos;  // head-major

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);       // the producer warp's lanes
      mbar_init(&empty[s], NC * 4);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NC * 128) {  // ------------------ producer warpgroup
    regs_down<Roles<NC>::kProducerRegs>();
    if (threadIdx.x < NC * 128 + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_arrive_tx(bar_kv, 2 * NC * L::kTile);
        for (int w = 0; w < NC; ++w)
          for (int c = 0; c < C::kCount; ++c) {
            tma_load_4d(smem + L::kK + w * L::kTile + c * C::kBytes, &tm_k,
                        bar_kv, c * C::kCols, kvh, k0 + w * kTileRows, b);
            tma_load_4d(smem + L::kV + w * L::kTile + c * C::kBytes, &tm_v,
                        bar_kv, c * C::kCols, kvh, k0 + w * kTileRows, b);
          }
      }
      // lse and delta of a tile's rows, two a lane, fetched one tile
      // ahead so their latency overlaps the wait for a free stage; rows
      // past Sq get lse = +inf, which makes their P 0
      float l_next[2], d_next[2];
      auto fetch = [&](int t) {
        const int head = kvh * G + g_lo + t / n_pos;
        const int p0 = q_lo + (t % n_pos) * kTileRows;
        const long long row0 = (static_cast<long long>(b) * H + head) * Sq;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int pos = p0 + lane + 32 * i;
          l_next[i] = pos < Sq ? lse[row0 + pos] : INFINITY;
          d_next[i] = pos < Sq ? delta[row0 + pos] : 0.f;
        }
      };
      if (n_tiles > 0) fetch(0);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const int head = kvh * G + g_lo + t / n_pos;
        const int p0 = q_lo + (t % n_pos) * kTileRows;
        uint8_t* stage = smem + L::kRing + s * L::kStage;
        float* lse_s = reinterpret_cast<float*>(stage + 2 * L::kTile);
        float* delta_s = lse_s + kTileRows;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          lse_s[lane + 32 * i] = l_next[i];
          delta_s[lane + 32 * i] = d_next[i];
        }
        if (lane == 0) {
          mbar_arrive_tx(&full[s], 2 * L::kTile);
          for (int c = 0; c < C::kCount; ++c) {
            tma_load_4d(stage + c * C::kBytes, &tm_q, &full[s],
                        c * C::kCols, head, p0, b);
            tma_load_4d(stage + L::kTile + c * C::kBytes, &tm_do, &full[s],
                        c * C::kCols, head, p0, b);
          }
        } else {
          mbar_arrive(&full[s]);
        }
        if (t + 1 < n_tiles) fetch(t + 1);
      }
    }
  } else {  // ------------------------------------- consumer warpgroups
    regs_up<Roles<NC>::kConsumerRegs>();
    const int wg = threadIdx.x / 128, wl = threadIdx.x / 32 % 4;
    const int lane = threadIdx.x % 32;
    const int kw0 = k0 + wg * kTileRows;  // this warpgroup's keys
    const int kw_last = min(kw0 + kTileRows, Skv) - 1;
    int key[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) key[h] = kw0 + 16 * wl + lane / 4 + 8 * h;
    const uint8_t* k_tile = smem + L::kK + wg * L::kTile;
    const uint8_t* v_tile = smem + L::kV + wg * L::kTile;
    const float c2 = scale * kLog2e;
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(bar_kv, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int p0 = q_lo + (t % n_pos) * kTileRows;
      mbar_wait(&full[s], (t / kStages) & 1);
      const bool dead = kw0 >= Skv ||
                        (causal && p0 + kTileRows - 1 < kw0) ||
                        (window > 0 && p0 - window >= kw_last);
      if (!dead) {
        const bool edge =
            (causal && p0 < kw0 + kTileRows - 1) ||
            (window > 0 && p0 + kTileRows - 1 - window >= kw0) ||
            kw0 + kTileRows > Skv;
        const uint8_t* q_tile = smem + L::kRing + s * L::kStage;
        const uint8_t* do_tile = q_tile + L::kTile;
        const float* lse_s =
            reinterpret_cast<const float*>(q_tile + 2 * L::kTile);
        const float* delta_s = lse_s + kTileRows;
        float st[32], dpt[32];
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          wgmma_ss_n64(st, desc_k<D>(k_tile, ks), desc_k<D>(q_tile, ks),
                       ks > 0);
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          wgmma_ss_n64(dpt, desc_k<D>(v_tile, ks), desc_k<D>(do_tile, ks),
                       ks > 0);
        wg_commit();
        wg_wait_all();
        keep(st);
        keep(dpt);
        // columns are query positions p0 + col; rows are the thread's keys
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = acc_col(4 * j + e, lane);
            const float nl = -lse_s[col] * kLog2e, dl = delta_s[col];
            const int q_pos = p0 + col;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * j + 2 * h + e;
              const bool live =
                  !edge || (key[h] < Skv && (!causal || key[h] <= q_pos) &&
                            (window <= 0 || key[h] > q_pos - window));
              const float p = live ? ex2(fmaf(st[i], c2, nl)) : 0.f;
              st[i] = p;
              dpt[i] = p * (dpt[i] - dl);
            }
          }
        uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
        split_hi_lo(st, p_hi, p_lo);
        split_hi_lo(dpt, ds_hi, ds_lo);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs<D>(dv_acc, p_hi[kk], desc_mn<D>(do_tile, kk));
          wgmma_rs<D>(dv_acc, p_lo[kk], desc_mn<D>(do_tile, kk));
          wgmma_rs<D>(dk_acc, ds_hi[kk], desc_mn<D>(q_tile, kk));
          wgmma_rs<D>(dk_acc, ds_lo[kk], desc_mn<D>(q_tile, kk));
        }
        wg_commit();
        wg_wait_all();
        keep(dk_acc);
        keep(dv_acc);
        keep(p_hi);
        keep(p_lo);
        keep(ds_hi);
        keep(ds_lo);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // one block of the heads: dK (scaled) and dV in bf16; one of several:
    // its float32 sums into its chunk's slice of `part`, which
    // attn_bwd_dkdv_reduce adds up
    const long long n = static_cast<long long>(gridDim.x) * Skv * D;
    float* part_k = part == nullptr ? nullptr : part + 2 * blockIdx.z * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (key[h] >= Skv) continue;
      const long long off =
          ((static_cast<long long>(b) * Skv + key[h]) * KH + kvh) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = acc_col(4 * j, lane);
        const int i = 4 * j + 2 * h;
        if (part == nullptr) {
          *reinterpret_cast<uint32_t*>(dk + off + col) =
              pack_bf16(dk_acc[i] * scale, dk_acc[i + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + off + col) =
              pack_bf16(dv_acc[i], dv_acc[i + 1]);
        } else {
          *reinterpret_cast<float2*>(part_k + off + col) =
              make_float2(dk_acc[i], dk_acc[i + 1]);
          *reinterpret_cast<float2*>(part_k + n + off + col) =
              make_float2(dv_acc[i], dv_acc[i + 1]);
        }
      }
    }
  }
}

// dK and dV (B, Skv, KH, D) in bf16 from the n_split head chunks' float32
// partial sums in `part` ([chunk][dK, dV][B, Skv, KH, D]), added in chunk
// order in float32; dK scaled once at the end
__global__ void __launch_bounds__(256)
    attn_bwd_dkdv_reduce(const float* __restrict__ part,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, long long n,
                         int n_split, float scale) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float a = 0.f, c = 0.f;
    for (int z = 0; z < n_split; ++z) {
      a += part[2 * z * n + i];
      c += part[(2 * z + 1) * n + i];
    }
    dk[i] = __float2bfloat16_rn(a * scale);
    dv[i] = __float2bfloat16_rn(c);
  }
}

// ------------------------------------------------------------ pass 2
// shared memory: each warpgroup's Q and dO tiles, the K and V rings, the
// mbarriers
template <int D, int NC>
struct Smem2 {
  static constexpr int kTile = Chunk<D>::kTileBytes;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + NC * kTile;
  static constexpr int kK = kDO + NC * kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;  // q, full[], empty[]
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8 + 1024;
};

template <int D, int NC>
__global__ void __launch_bounds__(Roles<NC>::kThreads, 1)
    attn_bwd_dq_sm90(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H,
                     int KH, int Gc, int P, int causal, int window,
                     float scale) {
  using C = Chunk<D>;
  using L = Smem2<D, NC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kStages;

  const int G = H / KH;
  const int n_chunks = (G + Gc - 1) / Gc;
  const int kvh = blockIdx.y / n_chunks;
  const int g0 = (blockIdx.y % n_chunks) * Gc;
  const int b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * NC * P;  // late ones first
  const int q_last = min(q0 + NC * P, Sq) - 1;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kv_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int n_tiles =
      kv_hi > kv_lo ? (kv_hi - kv_lo + kTileRows - 1) / kTileRows : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NC * 128) {  // ------------------ producer warpgroup
    regs_down<Roles<NC>::kProducerRegs>();
    if (threadIdx.x == NC * 128) {
      mbar_arrive_tx(bar_q, 2 * NC * C::kCount * P * Gc * C::kRowBytes);
      for (int w = 0; w < NC; ++w)
        for (int c = 0; c < C::kCount; ++c) {
          tma_load_4d(smem + L::kQ + w * L::kTile + c * C::kBytes, &tm_q,
                      bar_q, c * C::kCols, kvh * G + g0, q0 + w * P, b);
          tma_load_4d(smem + L::kDO + w * L::kTile + c * C::kBytes, &tm_do,
                      bar_q, c * C::kCols, kvh * G + g0, q0 + w * P, b);
        }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        mbar_arrive_tx(&full[s], 2 * L::kTile);
        const int t0 = kv_lo + t * kTileRows;
        for (int c = 0; c < C::kCount; ++c) {
          tma_load_4d(smem + L::kK + s * L::kTile + c * C::kBytes, &tm_k,
                      &full[s], c * C::kCols, kvh, t0, b);
          tma_load_4d(smem + L::kV + s * L::kTile + c * C::kBytes, &tm_v,
                      &full[s], c * C::kCols, kvh, t0, b);
        }
      }
    }
  } else {  // ------------------------------------- consumer warpgroups
    regs_up<Roles<NC>::kConsumerRegs>();
    const int wg = threadIdx.x / 128, wl = threadIdx.x / 32 % 4;
    const int lane = threadIdx.x % 32;
    const int p_lo = q0 + wg * P;
    const int p_hi = min(p_lo + P, Sq) - 1;
    int pos[2], head[2], k_first[2], k_last[2];
    bool valid[2];
    float nl[2], dl[2];  // -lse * log2(e) and delta of the thread's rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * wl + lane / 4 + 8 * h;
      const int g = g0 + r % Gc;
      pos[h] = p_lo + r / Gc;
      head[h] = kvh * G + g;
      valid[h] = r < P * Gc && g < G && pos[h] < Sq;
      k_first[h] = window > 0 ? pos[h] - window + 1 : 0;
      k_last[h] = causal ? min(pos[h], Skv - 1) : Skv - 1;
      const long long off =
          (static_cast<long long>(b) * H + head[h]) * Sq + pos[h];
      nl[h] = valid[h] ? -lse[off] * kLog2e : -INFINITY;  // invalid: P = 0
      dl[h] = valid[h] ? delta[off] : 0.f;
    }
    const float c2 = scale * kLog2e;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const uint8_t* q_tile = smem + L::kQ + wg * L::kTile;
    const uint8_t* do_tile = smem + L::kDO + wg * L::kTile;

    mbar_wait(bar_q, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      mbar_wait(&full[s], (t / kStages) & 1);
      const int t0 = kv_lo + t * kTileRows;
      const bool dead = p_hi < p_lo || (causal && t0 > p_hi) ||
                        (window > 0 && t0 + kTileRows - 1 <= p_lo - window);
      if (!dead) {
        const bool edge = (causal && t0 + kTileRows - 1 > p_lo) ||
                          (window > 0 && t0 <= p_hi - window) ||
                          t0 + kTileRows > Skv;
        const uint8_t* k_tile = smem + L::kK + s * L::kTile;
        const uint8_t* v_tile = smem + L::kV + s * L::kTile;
        float sc[32], dp[32];
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          wgmma_ss_n64(sc, desc_k<D>(q_tile, ks), desc_k<D>(k_tile, ks),
                       ks > 0);
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          wgmma_ss_n64(dp, desc_k<D>(do_tile, ks), desc_k<D>(v_tile, ks),
                       ks > 0);
        wg_commit();
        wg_wait_all();
        keep(sc);
        keep(dp);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int h = (i / 2) % 2, kv = t0 + acc_col(i, lane);
          const bool live = !edge || (kv >= k_first[h] && kv <= k_last[h]);
          const float p = live ? ex2(fmaf(sc[i], c2, nl[h])) : 0.f;
          dp[i] = p * (dp[i] - dl[h]);
        }
        uint32_t ds_hi[4][4], ds_lo[4][4];
        split_hi_lo(dp, ds_hi, ds_lo);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs<D>(acc, ds_hi[kk], desc_mn<D>(k_tile, kk));
          wgmma_rs<D>(acc, ds_lo[kk], desc_mn<D>(k_tile, kk));
        }
        wg_commit();
        wg_wait_all();
        keep(acc);
        keep(ds_hi);
        keep(ds_lo);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!valid[h]) continue;
      __nv_bfloat16* row =
          dq + ((static_cast<long long>(b) * Sq + pos[h]) * H + head[h]) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(row + acc_col(4 * j, lane)) =
            pack_bf16(acc[4 * j + 2 * h] * scale,
                      acc[4 * j + 2 * h + 1] * scale);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq,
           void* dk, void* dv, void* part, int B, int Sq, int Skv, int H,
           int KH, int causal, int window, cudaStream_t stream) {
  constexpr int NC2 = consumers2<D>();
  const int G = H / KH;
  // pass 1's head chunks: Gs heads a block, n_split blocks a key block
  const int n_split = (G + kHeadsABlock - 1) / kHeadsABlock;
  const int Gs = (G + n_split - 1) / n_split;
  if (n_split > 1 && part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Gc = G < kTileRows ? G : kTileRows;
  const int P = kTileRows / Gc;
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  // pass 1 reads q and dO in tiles of 64 positions of one head; pass 2
  // in the forward's grouped rows; both read k and v in tiles of 64 keys
  CUtensorMap tm_q1, tm_do1, tm_q2, tm_do2, tm_k, tm_v;
  int err = make_map<D>(&tm_q1, q, H, Sq, B, 1, kTileRows, 1);
  if (err == 0) err = make_map<D>(&tm_do1, dout, H, Sq, B, 1, kTileRows, 1);
  if (err == 0) err = make_map<D>(&tm_q2, q, H, Sq, B, Gc, P, 1);
  if (err == 0) err = make_map<D>(&tm_do2, dout, H, Sq, B, Gc, P, 1);
  if (err == 0) err = make_map<D>(&tm_k, k, KH, Skv, B, 1, kTileRows, 1);
  if (err == 0) err = make_map<D>(&tm_v, v, KH, Skv, B, 1, kTileRows, 1);
  if (err == 0)
    err = check_register_budget<kNC1>(
        reinterpret_cast<const void*>(attn_bwd_dkdv_sm90<D>));
  if (err == 0)
    err = check_register_budget<NC2>(
        reinterpret_cast<const void*>(attn_bwd_dq_sm90<D, NC2>));
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      attn_bwd_dkdv_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem1<D>::kBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attn_bwd_dq_sm90<D, NC2>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem2<D, NC2>::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rows = static_cast<long long>(B) * Sq * H;
  const long long rows_per_block = 256 / delta_threads<D>();
  attn_bwd_delta_sm90<D>
      <<<static_cast<unsigned>((rows + rows_per_block - 1) / rows_per_block),
         256, 0, stream>>>(static_cast<const __nv_bfloat16*>(o),
                           static_cast<const __nv_bfloat16*>(dout),
                           static_cast<float*>(delta), Sq, H, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* lse_ = static_cast<const float*>(lse);
  const float* delta_ = static_cast<const float*>(delta);
  const int keys = kNC1 * kTileRows;
  const dim3 grid1(B * KH, (Skv + keys - 1) / keys, n_split);
  float* part_ = n_split > 1 ? static_cast<float*>(part) : nullptr;
  attn_bwd_dkdv_sm90<D>
      <<<grid1, Roles<kNC1>::kThreads, Smem1<D>::kBytes, stream>>>(
          tm_q1, tm_do1, tm_k, tm_v, lse_, delta_,
          static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
          part_, Sq, Skv, H, KH, Gs, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_split > 1) {
    const long long n = static_cast<long long>(B) * Skv * KH * D;
    const long long blocks = (n + 255) / 256;
    attn_bwd_dkdv_reduce<<<static_cast<unsigned>(blocks < 4096 ? blocks
                                                               : 4096),
                           256, 0, stream>>>(
        part_, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), n, n_split, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid2((Sq + NC2 * P - 1) / (NC2 * P), KH * ((G + Gc - 1) / Gc),
                   B);
  attn_bwd_dq_sm90<D, NC2>
      <<<grid2, Roles<NC2>::kThreads, Smem2<D, NC2>::kBytes, stream>>>(
          tm_q2, tm_do2, tm_k, tm_v, lse_, delta_,
          static_cast<__nv_bfloat16*>(dq), Sq, Skv, H, KH, Gc, P, causal,
          window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the kernels on `stream`: delta = rowsum(dO * O) into delta
// (B, H, Sq) float32, then dk and dv (B, Skv, KH, D), then dq (B, Sq, H,
// D), all bfloat16, from bfloat16 q, k, v, o and dout in the same layouts
// (contiguous, 16-byte aligned) and the forward's lse (B, H, Sq) float32.
// For G = H / KH > kHeadsABlock, part is a float32 workspace of 2 x
// ceil(G / kHeadsABlock) x B x Skv x KH x D (else unused, may be null).
// D is 16, 64, 96, 112 or 128; H a multiple of KH. Returns a cudaError_t
// (cudaErrorInvalidValue for a D it does not take, a missing workspace or
// a tensor map cuTensorMapEncodeTiled refuses).
int flash_attention_bwd_sm90_launch(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* dout, const void* lse,
                                    void* delta, void* dq, void* dk,
                                    void* dv, void* part, int B, int Sq,
                                    int Skv, int H, int KH, int D,
                                    int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, dout, lse, delta, dq, dk, dv, part, B,
                        Sq, Skv, H, KH, causal, window, s);
    case 64:
      return launch<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, part, B,
                        Sq, Skv, H, KH, causal, window, s);
    case 96:
      return launch<96>(q, k, v, o, dout, lse, delta, dq, dk, dv, part, B,
                        Sq, Skv, H, KH, causal, window, s);
    case 112:
      return launch<112>(q, k, v, o, dout, lse, delta, dq, dk, dv, part, B,
                         Sq, Skv, H, KH, causal, window, s);
    case 128:
      return launch<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, part, B,
                         Sq, Skv, H, KH, causal, window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_bwd_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
