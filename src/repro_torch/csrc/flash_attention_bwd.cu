// Backward of the blockwise GQA flash attention for Hopper (sm_90a).
//
// The TPU package has no backward kernel: XLA differentiates its attention
// (src/repro/models/layers.py::flash_attention_xla). This is the gradient
// of kernel 7 (flash_attention.cu) on the port's training path. Its
// specification is the plain PyTorch version
// src/repro_torch/kernels/ref.py::flash_attention_bwd: with s = (q * scale)
// . k over the live keys (causal, inside the window, before Skv),
// P = exp(s - lse) from the forward's row log-sum-exp lse (B, H, Sq), and
// delta = rowsum(dO * O) (B, H, Sq), both float32,
//     dV_j = sum_i P_ij dO_i           dS_ij = P_ij (dO_i . V_j - delta_i)
//     dK_j = sum_i dS_ij (q_i * scale) dQ_i  = scale * sum_j dS_ij K_j
// where i runs over the query rows of the G = H / KH heads that read KV
// head j's head. A row with no live key (lse = -inf) gets P = 0, so every
// gradient it touches is 0, not NaN. q, k, v, dO, the gradients, scores,
// P and the sums are all float32: this is the backward's float32 path;
// bfloat16 runs on the wgmma kernels of flash_attention_bwd_sm90.cu.
//
// Design: two passes, each a kernel, and no atomics, so a launch is
// deterministic; the wrapper counts the pair as one launch.
// * Pass 1, dK and dV: one block per (key tile, KV head, batch row). A key
//   belongs to TPR = D/16 adjacent threads (one for D = 16; four for D =
//   96 and 112, so that a power of two splits the row evenly) that hold
//   D / TPR of its dimensions of k, v, dK and dV in registers (64 keys a
//   block at D = 64). The block walks the query positions that can see its
//   keys -- causally from its first key, and up to its last key + window -
//   1 -- times all G heads of its KV head, staging 64 query rows at a time
//   (q * scale, dO, lse, delta) in shared memory, where every thread reads
//   the same row at once (a broadcast). Dot products are the group's
//   partial sums added with xor shuffles. Above kCompensateAbove heads a
//   KV head, dK and dV carry Kahan's compensation through the long sum.
// * Pass 2, dQ: one block per (query tile, KV head, batch row), as the
//   forward: block_q positions x G heads of rows (a block takes a chunk of
//   the heads where its rows cannot hold all G), each row TPR threads
//   holding D / TPR dimensions of q * scale, dO and dQ; it walks the key
//   tiles of 64 its rows can see (staged as float32 in shared memory),
//   recomputes P and dS and accumulates dS . K.
// Ragged last tiles are masked, not padded.
//
// Bound on the H100 SXM: operations. Per live (query, key) pair the
// function needs five D-long products (the recomputed score, dO . V and
// the dV, dK and dQ updates): 10 * D flops; at the training shape (B = 4,
// S = 1280, 25/5 heads x 64, window 1024) 50.4 GFLOP, 0.051 ms at the bf16
// tensor-core peak (989 TFLOP/s), against 79 MB of q, k, v, o, dO, lse
// and the gradients in bfloat16 (24 us at 3.35 TB/s). This version does
// seven (pass 2 recomputes the score and dO . V: 14 * D flops) on the
// float32 CUDA cores (67 TFLOP/s, 1.05 ms for that work): the float32
// reference checks need full float32 products, which TF32 does not give.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsQ = 64;    // query rows staged at a time (pass 1)
constexpr int kBlockKV = 64;  // keys staged at a time (pass 2)
constexpr int kCompensateAbove = 8;  // heads a KV head (pass 1)

// threads a row (a key in pass 1): the largest power of two at most D / 16
// that splits the row's D / 4 float4 chunks evenly, so a group's xor
// shuffles stay inside it (16 dimensions a thread, but 24 and 28 for D =
// 96 and 112)
template <int D>
__host__ __device__ constexpr int threads_per_row() {
  int t = 1;
  while (32 * t <= D && (D / 4) % (2 * t) == 0) t *= 2;
  return t;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

template <int TPR>
__device__ __forceinline__ float group_sum(float a) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    a += __shfl_xor_sync(0xffffffffu, a, off);
  return a;
}

__device__ __forceinline__ bool live_pair(int q_pos, int kv_pos, int Skv,
                                          int causal, int window) {
  return kv_pos < Skv && (!causal || kv_pos <= q_pos) &&
         (window <= 0 || kv_pos > q_pos - window);
}

// sum += x with Kahan's compensation c, which carries each add's rounding
// error into the next
__device__ __forceinline__ void kahan_add(float& sum, float& c, float x) {
  const float y = x - c;
  const float t = sum + y;
  c = (t - sum) - y;
  sum = t;
}

// ------------------------------------------------------------ pass 1
// kCompensate: dK and dV summed with Kahan's compensation, for G above
// kCompensateAbove heads a KV head, where a key's sum runs over G x Sq
// rows (granite-20b: 61,440 at S = 1,280) and a plain float32 chain drifts
// 1.2e-5 of the largest gradient from the plain version's sums
template <int D, bool kCompensate>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dkdv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int Sq, int Skv, int H, int KH, int causal,
                         int window, float scale) {
  constexpr int TPR = threads_per_row<D>();  // threads per key
  constexpr int DPT = D / TPR;               // dimensions a thread
  constexpr int C4 = DPT / 4;                // float4 chunks a thread
  constexpr int BK = kThreads / TPR;         // keys per block
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRowsQ][D], q * scale
  float* dos = qs + kRowsQ * D;                 // [kRowsQ][D]
  float* lse_s = dos + kRowsQ * D;              // [kRowsQ]
  float* delta_s = lse_s + kRowsQ;              // [kRowsQ]

  const int G = H / KH;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int j = tid / TPR, part = tid % TPR;
  const int kv_pos = k0 + j;
  const bool kv_ok = kv_pos < Skv;
  const long long kv_off =
      ((static_cast<long long>(b) * Skv + kv_pos) * KH + kvh) * D;

  float kr[DPT], vr[DPT], dkr[DPT], dvr[DPT];
  float dkc[kCompensate ? DPT : 1], dvc[kCompensate ? DPT : 1];
#pragma unroll
  for (int c = 0; c < C4; ++c) {
    float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
    if (kv_ok) {
      kx = load4(k + kv_off + (part + c * TPR) * 4);
      vx = load4(v + kv_off + (part + c * TPR) * 4);
    }
    kr[4 * c] = kx.x, kr[4 * c + 1] = kx.y, kr[4 * c + 2] = kx.z,
    kr[4 * c + 3] = kx.w;
    vr[4 * c] = vx.x, vr[4 * c + 1] = vx.y, vr[4 * c + 2] = vx.z,
    vr[4 * c + 3] = vx.w;
  }
#pragma unroll
  for (int i = 0; i < DPT; ++i) dkr[i] = dvr[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kCompensate ? DPT : 1); ++i) dkc[i] = dvc[i] = 0.f;

  // the query positions that can see a key of this tile
  const int k_end = min(k0 + BK, Skv);
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(Sq, k_end - 1 + window) : Sq;
  const int r_lo = q_lo * G, r_hi = max(q_hi, q_lo) * G;  // rows i*G + g

  for (int r0 = r_lo; r0 < r_hi; r0 += kRowsQ) {
    __syncthreads();  // the previous rows are consumed
    for (int i = tid; i < kRowsQ * (D / 4); i += kThreads) {
      const int r = i / (D / 4), c = i % (D / 4);
      const int row = r0 + r;
      float4 qx = make_float4(0.f, 0.f, 0.f, 0.f), dx = qx;
      if (row < r_hi) {
        const int q_pos = row / G, head = kvh * G + row % G;
        const long long off =
            ((static_cast<long long>(b) * Sq + q_pos) * H + head) * D + c * 4;
        qx = load4(q + off);
        dx = load4(dout + off);
        qx.x *= scale, qx.y *= scale, qx.z *= scale, qx.w *= scale;
      }
      store4(qs + r * D + c * 4, qx);
      store4(dos + r * D + c * 4, dx);
    }
    if (tid < kRowsQ) {
      const int row = r0 + tid;
      float l = -INFINITY, dl = 0.f;
      if (row < r_hi) {
        const int q_pos = row / G, head = kvh * G + row % G;
        const long long off = (static_cast<long long>(b) * H + head) * Sq +
                              q_pos;
        l = lse[off];
        dl = delta[off];
      }
      lse_s[tid] = l;
      delta_s[tid] = dl;
    }
    __syncthreads();
    const int n_rows = min(kRowsQ, r_hi - r0);
    for (int r = 0; r < n_rows; ++r) {
      const float* qrow = qs + r * D;
      const float* drow = dos + r * D;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < C4; ++c) {
        const float4 q4 = *reinterpret_cast<const float4*>(
            qrow + (part + c * TPR) * 4);
        const float4 d4 = *reinterpret_cast<const float4*>(
            drow + (part + c * TPR) * 4);
        s += q4.x * kr[4 * c] + q4.y * kr[4 * c + 1] + q4.z * kr[4 * c + 2] +
             q4.w * kr[4 * c + 3];
        dp += d4.x * vr[4 * c] + d4.y * vr[4 * c + 1] + d4.z * vr[4 * c + 2] +
              d4.w * vr[4 * c + 3];
      }
      s = group_sum<TPR>(s);
      dp = group_sum<TPR>(dp);
      const int q_pos = (r0 + r) / G;
      const float l = lse_s[r];
      const bool live =
          live_pair(q_pos, kv_pos, Skv, causal, window) && l != -INFINITY;
      const float p = live ? expf(s - l) : 0.f;
      const float ds = p * (dp - delta_s[r]);
#pragma unroll
      for (int c = 0; c < C4; ++c) {
        const float4 q4 = *reinterpret_cast<const float4*>(
            qrow + (part + c * TPR) * 4);
        const float4 d4 = *reinterpret_cast<const float4*>(
            drow + (part + c * TPR) * 4);
        if constexpr (kCompensate) {
          const float dx[4] = {d4.x, d4.y, d4.z, d4.w};
          const float qx[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            kahan_add(dvr[4 * c + e], dvc[4 * c + e], p * dx[e]);
            kahan_add(dkr[4 * c + e], dkc[4 * c + e], ds * qx[e]);
          }
        } else {
          dvr[4 * c] += p * d4.x, dvr[4 * c + 1] += p * d4.y,
              dvr[4 * c + 2] += p * d4.z, dvr[4 * c + 3] += p * d4.w;
          dkr[4 * c] += ds * q4.x, dkr[4 * c + 1] += ds * q4.y,
              dkr[4 * c + 2] += ds * q4.z, dkr[4 * c + 3] += ds * q4.w;
        }
      }
    }
  }
  if (kv_ok) {
#pragma unroll
    for (int c = 0; c < C4; ++c) {
      store4(dk + kv_off + (part + c * TPR) * 4,
             make_float4(dkr[4 * c], dkr[4 * c + 1], dkr[4 * c + 2],
                         dkr[4 * c + 3]));
      store4(dv + kv_off + (part + c * TPR) * 4,
             make_float4(dvr[4 * c], dvr[4 * c + 1], dvr[4 * c + 2],
                         dvr[4 * c + 3]));
    }
  }
}

// ------------------------------------------------------------ pass 2
template <int D>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dq_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, float* __restrict__ dq,
                       int Sq, int Skv, int H, int KH, int Gc, int block_q,
                       int causal, int window, float scale) {
  constexpr int TPR = threads_per_row<D>();  // threads per row
  constexpr int DPT = D / TPR;
  constexpr int C4 = DPT / 4;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kBlockKV][D]
  float* vs = ks + kBlockKV * D;                // [kBlockKV][D]

  // the block's rows: block_q positions x Gc of the G heads (all of them
  // where a block's rows hold them; else blockIdx.y picks the chunk)
  const int G = H / KH;
  const int n_chunks = (G + Gc - 1) / Gc;
  const int b = blockIdx.z, kvh = blockIdx.y / n_chunks;
  const int g0 = (blockIdx.y % n_chunks) * Gc;
  const int q0 = blockIdx.x * block_q;
  const int tid = threadIdx.x;
  const int row = tid / TPR, part = tid % TPR;
  const int q_pos = q0 + row / Gc;
  const int g = g0 + row % Gc;
  const int head = kvh * G + g;
  const bool active = row < block_q * Gc && q_pos < Sq && g < G;
  const long long q_off =
      ((static_cast<long long>(b) * Sq + q_pos) * H + head) * D;

  float qr[DPT], dor[DPT], dqr[DPT];
#pragma unroll
  for (int c = 0; c < C4; ++c) {
    float4 qx = make_float4(0.f, 0.f, 0.f, 0.f), dx = qx;
    if (active) {
      qx = load4(q + q_off + (part + c * TPR) * 4);
      dx = load4(dout + q_off + (part + c * TPR) * 4);
    }
    qr[4 * c] = qx.x * scale, qr[4 * c + 1] = qx.y * scale,
    qr[4 * c + 2] = qx.z * scale, qr[4 * c + 3] = qx.w * scale;
    dor[4 * c] = dx.x, dor[4 * c + 1] = dx.y, dor[4 * c + 2] = dx.z,
    dor[4 * c + 3] = dx.w;
  }
#pragma unroll
  for (int i = 0; i < DPT; ++i) dqr[i] = 0.f;
  float l = -INFINITY, dl = 0.f;
  if (active) {
    const long long off = (static_cast<long long>(b) * H + head) * Sq + q_pos;
    l = lse[off];
    dl = delta[off];
  }

  const int q_last = min(q0 + block_q, Sq) - 1;
  const int kv_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int t0 = kv_lo; t0 < kv_hi; t0 += kBlockKV) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kBlockKV * (D / 4); i += kThreads) {
      const int r = i / (D / 4), c = i % (D / 4);
      const int pos = t0 + r;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (pos < kv_hi) {
        const long long off =
            ((static_cast<long long>(b) * Skv + pos) * KH + kvh) * D + c * 4;
        kx = load4(k + off);
        vx = load4(v + off);
      }
      store4(ks + r * D + c * 4, kx);
      store4(vs + r * D + c * 4, vx);
    }
    __syncthreads();
    const int n_keys = min(kBlockKV, kv_hi - t0);
    for (int jj = 0; jj < n_keys; ++jj) {
      const float* krow = ks + jj * D;
      const float* vrow = vs + jj * D;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < C4; ++c) {
        const float4 k4 = *reinterpret_cast<const float4*>(
            krow + (part + c * TPR) * 4);
        const float4 v4 = *reinterpret_cast<const float4*>(
            vrow + (part + c * TPR) * 4);
        s += qr[4 * c] * k4.x + qr[4 * c + 1] * k4.y + qr[4 * c + 2] * k4.z +
             qr[4 * c + 3] * k4.w;
        dp += dor[4 * c] * v4.x + dor[4 * c + 1] * v4.y +
              dor[4 * c + 2] * v4.z + dor[4 * c + 3] * v4.w;
      }
      s = group_sum<TPR>(s);
      dp = group_sum<TPR>(dp);
      const bool live = active &&
                        live_pair(q_pos, t0 + jj, kv_hi, causal, window) &&
                        l != -INFINITY;
      const float p = live ? expf(s - l) : 0.f;
      const float ds = p * (dp - dl);
#pragma unroll
      for (int c = 0; c < C4; ++c) {
        const float4 k4 = *reinterpret_cast<const float4*>(
            krow + (part + c * TPR) * 4);
        dqr[4 * c] += ds * k4.x, dqr[4 * c + 1] += ds * k4.y,
            dqr[4 * c + 2] += ds * k4.z, dqr[4 * c + 3] += ds * k4.w;
      }
    }
  }
  if (active) {
#pragma unroll
    for (int c = 0; c < C4; ++c)
      store4(dq + q_off + (part + c * TPR) * 4,
             make_float4(dqr[4 * c] * scale, dqr[4 * c + 1] * scale,
                         dqr[4 * c + 2] * scale, dqr[4 * c + 3] * scale));
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, void* dk, void* dv,
           int B, int Sq, int Skv, int H, int KH, int causal, int window,
           cudaStream_t stream) {
  constexpr int TPR = threads_per_row<D>();
  // pass 2's rows: the G heads of a position side by side, cut into
  // chunks of as many as a block's rows hold (granite-20b: G = 48 over 32
  // rows at D = 128)
  const int G = H / KH;
  const int rows = kThreads / TPR;
  const int Gc = G < rows ? G : rows;
  const int block_q = rows / Gc;
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const size_t smem1 = (2 * kRowsQ * D + 2 * kRowsQ) * sizeof(float);
  const size_t smem2 = 2 * kBlockKV * D * sizeof(float);
  auto* dkdv = G > kCompensateAbove ? attn_bwd_dkdv_kernel<D, true>
                                     : attn_bwd_dkdv_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attn_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* do_ = static_cast<const float*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  const float* delta_ = static_cast<const float*>(delta);
  const int BK = kThreads / TPR;
  const dim3 grid1((Skv + BK - 1) / BK, KH, B);
  dkdv<<<grid1, kThreads, smem1, stream>>>(
      q_, k_, v_, do_, lse_, delta_, static_cast<float*>(dk),
      static_cast<float*>(dv), Sq, Skv, H, KH, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2((Sq + block_q - 1) / block_q, KH * ((G + Gc - 1) / Gc),
                   B);
  attn_bwd_dq_kernel<D><<<grid2, kThreads, smem2, stream>>>(
      q_, k_, v_, do_, lse_, delta_, static_cast<float*>(dq), Sq, Skv, H, KH,
      Gc, block_q, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches both passes on `stream`: dq (B, Sq, H, D), dk and dv (B, Skv,
// KH, D) from q, k, v, dout in the same layouts (all float32, contiguous,
// 16-byte aligned) and lse, delta (B, H, Sq) float32. D is 16, 64, 96,
// 112 or 128; H a multiple of KH. Returns the cudaError_t of the launches
// (cudaErrorInvalidValue for a D it does not take).
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, void* dk,
                               void* dv, int B, int Sq, int Skv, int H,
                               int KH, int D, int causal, int window,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H,
                        KH, causal, window, s);
    case 64:
      return launch<64>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H,
                        KH, causal, window, s);
    case 96:
      return launch<96>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H,
                        KH, causal, window, s);
    case 112:
      return launch<112>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Skv,
                         H, KH, causal, window, s);
    case 128:
      return launch<128>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Skv,
                         H, KH, causal, window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
