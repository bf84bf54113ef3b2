// Flash attention for Hopper (sm_90a) on bfloat16 inputs: wgmma on the
// tensor cores, TMA-fed tiles, one producer warp and two consumer
// warpgroups.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:74
// (flash_attention, Pallas body _kernel at :23) for bfloat16, with the
// models' window mask (src/repro/models/layers.py:269-270); float32 stays
// on flash_attention.cu. Its specification is the plain PyTorch version
// src/repro_torch/kernels/ref.py::flash_attention: q (B, Sq, H, D), k/v
// (B, Skv, KH, D), query head h reads KV head h / G (G = H / KH), scale
// 1/sqrt(D), causal mask q_pos >= kv_pos, keys past Skv masked, and with
// window > 0 keys at kv_pos <= q_pos - window masked; D is 16, 64, 96,
// 112 or 128 (phi3-mini's 96 and kimi-k2's 112 in 16-value chunks,
// sm90.cuh).
// With an lse buffer (B, H, Sq) float32 it also writes each row's
// log-sum-exp of its scaled scores (-inf for a row with no live key),
// from which the backward (flash_attention_bwd_sm90.cu) recomputes P.
//
// Numerics. Scores are q . k in float32 on the tensor cores (bf16
// operands, exact products, float32 sums), scaled in float32. The online
// softmax keeps the Pallas kernel's guards: m_safe = 0 while a row has no
// live key, corr = 0 while the running max is -inf, l floored at 1e-30,
// so a row whose keys are all masked gives 0. P stays float32 in the
// plain version; a single bf16 rounding of P for P . V breaks the bf16
// limit on one output in ten at hymba's shapes, so P is split into two
// bf16 terms, hi = bf16(P) and lo = bf16(P - hi), and P . V runs as two
// wgmmas into one float32 accumulator: about 16 significant bits of P.
//
// Design. One block per (3 x P query positions, KV head, batch row),
// where a warpgroup's 64 rows are P = 64 / G positions x the G query heads
// that read the KV head (hymba: G = 5, P = 12, 60 rows), so each K/V tile
// serves all G heads and the block's key range is only 3P keys wider than
// a row's window. (For G > 64 the heads are cut into chunks of 64, one
// block row each.) The last query blocks launch first: under a causal
// mask they see the most keys, and the short first ones fill the tail.
// * Producer warpgroup: it gives its registers to the consumers
//   (setmaxnreg) and one thread issues the TMA loads: the consumers' Q
//   tiles once, then K and V tiles of 64 keys into a ring of three
//   stages, each with a full and an empty mbarrier. The tiles start at
//   the first key inside the window of the block's first query and end
//   at the causal limit of its last; TMA reads zeros past Skv.
// * Three consumer warpgroups (160 registers a thread; two with 240 for
//   D = 128): per tile, S = Q . K^T (wgmma m64n64k16, Q and K from shared
//   memory), the online softmax in the accumulator's registers (a row
//   lies in one quad: two xor shuffles for its max; the sum stays per
//   thread until the end), then O += P_hi . V + P_lo . V (m64nDk16, P
//   from registers, V from shared memory read MN-major). Tiles wholly
//   outside a warpgroup's causal limit or window are skipped; only edge
//   tiles (the diagonal, the window's start, Skv's end) mask per element.
//   The epilogue writes O / l in bf16 and lse. On the H100, three
//   warpgroups measured faster than two, and overlapping a tile's softmax
//   with the previous tile's P . V inside a warpgroup (FlashAttention-3's
//   intra-warpgroup pipelining) measured slower, so it is not used.
//
// Bound on the H100 SXM: operations. At the serve shape (B = 8, S = 1280,
// H = 25, KH = 5, D = 64, window 1024) the live pairs need 4 * D flops
// each, 40 GFLOP: 0.041 ms at the 989 TFLOP/s bf16 tensor-core peak,
// against 79 MB of q/k/v/o (23 us at 3.35 TB/s). The hi + lo split makes
// it 6 * D flops a pair on the tensor cores.

#include "sm90.cuh"

#include <math.h>

namespace {

using namespace sm90;

constexpr int kStages = 3;  // K/V ring

// consumer warpgroups a block: three (160 registers each) where the
// accumulators fit (D = 96 and 112 too: 48 and 56 a thread), two (240)
// for D = 128
template <int D>
constexpr int consumers() {
  return D == 128 ? 2 : 3;
}

// shared-memory byte offsets: Q tiles, the K and V rings, the mbarriers
template <int D, int NC>
struct Smem {
  static constexpr int kTile = Chunk<D>::kTileBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + NC * kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;  // q, full[], empty[]
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8 + 1024;
};

// The online-softmax step of one 64-key tile on a warpgroup's score
// accumulator: masks the edge tile's dead pairs, moves each row's running
// max m and sum l (l per thread; rows lie in quads), returns the rows'
// rescale factors corr and leaves P (relative to the new max) in s.
__device__ __forceinline__ void softmax_tile(
    float (&s)[32], float (&m)[2], float (&l)[2], float (&corr)[2],
    bool edge, int t0, const int (&k_first)[2], const int (&k_last)[2],
    int lane, float c2) {
  if (edge) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i / 2) % 2, kv = t0 + acc_col(i, lane);
      if (kv < k_first[h] || kv > k_last[h]) s[i] = -INFINITY;
    }
  }
  float neg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if ((i / 2) % 2 == h) mx = fmaxf(mx, s[i]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx);
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    corr[h] = m[h] == -INFINITY ? 0.f : ex2((m[h] - m_safe) * c2);
    l[h] *= corr[h];
    neg[h] = -m_safe * c2;
    m[h] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i / 2) % 2;
    s[i] = ex2(fmaf(s[i], c2, neg[h]));  // 2^-inf = 0 where masked
    l[h] += s[i];
  }
}

template <int D, int NC>
__global__ void __launch_bounds__(Roles<NC>::kThreads, 1)
    flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                __nv_bfloat16* __restrict__ o,
                                float* __restrict__ lse, int Sq, int Skv,
                                int H, int KH, int Gc, int P, int causal,
                                int window, float scale) {
  using C = Chunk<D>;
  using L = Smem<D, NC>;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment for the 128-byte swizzle
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kStages;

  const int G = H / KH;
  const int n_chunks = (G + Gc - 1) / Gc;
  const int kvh = blockIdx.y / n_chunks;
  const int g0 = (blockIdx.y % n_chunks) * Gc;
  const int b = blockIdx.z;
  // the last query blocks first: under a causal mask they see the most
  // keys, and the short early blocks then fill the last wave
  const int q0 = (gridDim.x - 1 - blockIdx.x) * NC * P;
  // the block's keys: from the window start of its first query to the
  // causal limit of its last
  const int q_last = min(q0 + NC * P, Sq) - 1;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kv_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int n_tiles =
      kv_hi > kv_lo ? (kv_hi - kv_lo + kTileRows - 1) / kTileRows : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * 4);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NC * 128) {  // ------------------ producer warpgroup
    regs_down<Roles<NC>::kProducerRegs>();
    if (threadIdx.x == NC * 128) {
      mbar_arrive_tx(bar_q, NC * C::kCount * P * Gc * C::kRowBytes);
      for (int w = 0; w < NC; ++w)
        for (int c = 0; c < C::kCount; ++c)
          tma_load_4d(smem + L::kQ + w * L::kTile + c * C::kBytes, &tm_q,
                      bar_q, c * C::kCols, kvh * G + g0, q0 + w * P, b);
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
    const int p_lo = q0 + wg * P;            // this warpgroup's positions
    const int p_hi = min(p_lo + P, Sq) - 1;  // its last (< p_lo: none)
    // the thread's two rows: 16 wl + lane / 4 and 8 below it
    int pos[2], head[2], k_first[2], k_last[2];
    bool valid[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * wl + lane / 4 + 8 * h;
      const int g = g0 + r % Gc;
      pos[h] = p_lo + r / Gc;
      head[h] = kvh * G + g;
      valid[h] = r < P * Gc && g < G && pos[h] < Sq;
      k_first[h] = window > 0 ? pos[h] - window + 1 : 0;  // live keys
      k_last[h] = causal ? min(pos[h], Skv - 1) : Skv - 1;
    }
    const float c2 = scale * kLog2e;  // exp(x * scale) = 2^(x * c2)
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
    const uint8_t* q_tile = smem + L::kQ + wg * L::kTile;

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
        float sc[32];
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          wgmma_ss_n64(sc, desc_k<D>(q_tile, ks), desc_k<D>(k_tile, ks),
                       ks > 0);
        wg_commit();
        wg_wait_all();
        keep(sc);
        softmax_tile(sc, m, l, corr, edge, t0, k_first, k_last, lane, c2);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i / 2) % 2];
        uint32_t p_hi_f[4][4], p_lo_f[4][4];
        split_hi_lo(sc, p_hi_f, p_lo_f);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs<D>(acc, p_hi_f[kk], desc_mn<D>(v_tile, kk));
          wgmma_rs<D>(acc, p_lo_f[kk], desc_mn<D>(v_tile, kk));
        }
        wg_commit();
        wg_wait_all();
        keep(acc);
        keep(p_hi_f);
        keep(p_lo_f);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[h];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (!valid[h]) continue;
      const float inv = 1.f / fmaxf(sum, 1e-30f);
      __nv_bfloat16* row =
          o + ((static_cast<long long>(b) * Sq + pos[h]) * H + head[h]) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(row + acc_col(4 * j, lane)) =
            pack_bf16(acc[4 * j + 2 * h] * inv,
                      acc[4 * j + 2 * h + 1] * inv);
      if (lse != nullptr && lane % 4 == 0)
        lse[(static_cast<long long>(b) * H + head[h]) * Sq + pos[h]] =
            m[h] == -INFINITY ? -INFINITY : m[h] * scale + logf(sum);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Sq, int Skv, int H, int KH, int causal, int window,
           cudaStream_t stream) {
  constexpr int NC = consumers<D>();
  const int G = H / KH;
  const int Gc = G < kTileRows ? G : kTileRows;  // heads a row group
  const int P = kTileRows / Gc;                  // positions a warpgroup
  CUtensorMap tm_q, tm_k, tm_v;
  int err = make_map<D>(&tm_q, q, H, Sq, B, Gc, P, 1);
  if (err == 0) err = make_map<D>(&tm_k, k, KH, Skv, B, 1, kTileRows, 1);
  if (err == 0) err = make_map<D>(&tm_v, v, KH, Skv, B, 1, kTileRows, 1);
  if (err != 0) return err;
  const int smem = Smem<D, NC>::kBytes;
  err = check_register_budget<NC>(
      reinterpret_cast<const void*>(flash_attention_sm90_kernel<D, NC>));
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_sm90_kernel<D, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + NC * P - 1) / (NC * P), KH * ((G + Gc - 1) / Gc), B);
  flash_attention_sm90_kernel<D, NC>
      <<<grid, Roles<NC>::kThreads, smem, stream>>>(
          tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o),
          static_cast<float*>(lse), Sq, Skv, H, KH, Gc, P, causal, window,
          1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches o = attention(q, k, v) on `stream` for bfloat16 q, k, v, o,
// and writes the rows' log-sum-exp to lse (B, H, Sq) float32 unless lse
// is null. Pointers are device pointers to contiguous, 16-byte aligned
// buffers in the layouts above; D is 16, 64, 96, 112 or 128 and H a
// multiple of KH. Returns a cudaError_t (cudaErrorInvalidValue for a D it
// does not take or a tensor map cuTensorMapEncodeTiled refuses).
int flash_attention_sm90_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int B, int Sq, int Skv,
                                int H, int KH, int D, int causal, int window,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, lse, B, Sq, Skv, H, KH, causal, window,
                        s);
    case 64:
      return launch<64>(q, k, v, o, lse, B, Sq, Skv, H, KH, causal, window,
                        s);
    case 96:
      return launch<96>(q, k, v, o, lse, B, Sq, Skv, H, KH, causal, window,
                        s);
    case 112:
      return launch<112>(q, k, v, o, lse, B, Sq, Skv, H, KH, causal, window,
                         s);
    case 128:
      return launch<128>(q, k, v, o, lse, B, Sq, Skv, H, KH, causal, window,
                         s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
