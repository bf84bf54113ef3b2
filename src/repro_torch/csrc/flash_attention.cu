// Blockwise GQA flash attention for Hopper (sm_90a), with a sliding window.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:74
// (flash_attention, Pallas body _kernel at :23) and adds the models' window
// mask (src/repro/models/layers.py:269-270). Its specification is the plain
// PyTorch version src/repro_torch/kernels/ref.py::flash_attention:
// q (B, Sq, H, D), k/v (B, Skv, KH, D), query head h reads KV head h / G
// (G = H / KH), scale 1/sqrt(D), causal mask q_pos >= kv_pos, keys past
// Skv masked, and with window > 0 keys at kv_pos <= q_pos - window masked.
// q, k, v and o are float32, the head sizes {16, 64, 96, 112, 128}
// template instances. This is kernel 7's float32 path; bfloat16 runs on the
// wgmma kernel flash_attention_sm90.cu.
//
// With an lse buffer (B, H, Sq) float32, the kernel also writes each row's
// log-sum-exp of its scaled scores, m + log(l) (-inf for a row with no live
// key), which the backward (flash_attention_bwd.cu) recomputes P from; the
// serve path passes none.
//
// Numerics, as the Pallas kernel: q is scaled in float32, scores and P.V
// are float32, and the online softmax keeps the same -inf guards (m_safe
// = 0 for a row with no live key yet, corr = 0 while the running max is
// -inf, l floored at 1e-30), so a row whose keys are all masked gives 0.
//
// Design. One block per (q tile, KV head, batch row): the tile is
// block_q query positions x the G query heads that read this KV head, so
// each K/V tile staged in shared memory serves G heads (hymba: G = 5, 25
// positions x 5 heads = 125 rows). A query row belongs to a group of
// TPR adjacent threads, the least power of two with TPR * 32 >= D (one for
// D <= 32; four for D = 96, 112 and 128), each holding DPT = D/TPR of its
// q and accumulator dimensions in registers; a score is the group's
// partial dot products summed with xor shuffles. Thread p of a group holds
// the float4 chunks p, p + TPR, ..., so the group's reads of one K or V row
// fall in distinct banks, and every row of the block reads the same K/V
// row at once (a shared-memory broadcast). K and V tiles of 64 keys are
// converted to float32 as they are staged; the block walks the tiles from
// the first key inside the window of its first query to the causal limit
// of its last (causal block skipping; in the window the first tile starts
// at q0 - window + 1), masks per key, and updates the online softmax every
// 16 keys. Ragged last q and kv tiles are masked, not padded: keys past
// the range are zero in shared memory and masked in the scores.
//
// Bound on the H100 SXM: operations. At the serve shape (B = 8, S = 1280,
// H = 25, KH = 5, D = 64, window 1024) the causal keys inside the window
// cost 4 * D flops each, 40 GFLOP in all: 0.04 ms at the 989 TFLOP/s bf16
// tensor-core peak, against 79 MB of q/k/v/o (23 us at 3.35 TB/s). This
// first version runs the products on the float32 CUDA cores (67 TFLOP/s
// peak, 0.6 ms for the same work): the float32 reference checks need
// full float32 products, which the tensor cores' TF32 does not give.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockKV = 64;  // keys per shared-memory tile
constexpr int kChunk = 16;    // keys per online-softmax update

// threads a query row: the least power of two with 32 of them per thread
// covering D, so a group's xor shuffles stay inside it
template <int D>
__host__ __device__ constexpr int threads_per_row() {
  int t = 1;
  while (32 * t < D) t *= 2;
  return t;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int Sq, int Skv, int H,
                           int KH, int block_q, int causal, int window,
                           float scale) {
  constexpr int TPR = threads_per_row<D>();  // threads per query row
  constexpr int DPT = D / TPR;               // dimensions per thread
  constexpr int C4 = DPT / 4;                // float4 chunks per thread
  static_assert(D % (4 * TPR) == 0, "a row's float4 chunks split evenly");
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kBlockKV][D]
  float* vs = ks + kBlockKV * D;                // [kBlockKV][D]

  const int G = H / KH;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int q0 = blockIdx.x * block_q;
  const int tid = threadIdx.x;
  const int row = tid / TPR, part = tid % TPR;
  const int q_pos = q0 + row / G;
  const int head = kvh * G + row % G;
  const bool active = row < block_q * G && q_pos < Sq;
  const long long q_off = ((static_cast<long long>(b) * Sq + q_pos) * H +
                           head) * D;

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int c = 0; c < C4; ++c) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (active) x = load4(q + q_off + (part + c * TPR) * 4);
    qr[4 * c] = x.x * scale;
    qr[4 * c + 1] = x.y * scale;
    qr[4 * c + 2] = x.z * scale;
    qr[4 * c + 3] = x.w * scale;
  }
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  // the block's key range: causal limit of its last query, window start
  // of its first
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
    for (int j0 = 0; j0 < n_keys; j0 += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float* kr = ks + (j0 + j) * D;
        float a = 0.f;
#pragma unroll
        for (int c = 0; c < C4; ++c) {
          const float4 kv4 = *reinterpret_cast<const float4*>(
              kr + (part + c * TPR) * 4);
          a += qr[4 * c] * kv4.x + qr[4 * c + 1] * kv4.y +
               qr[4 * c + 2] * kv4.z + qr[4 * c + 3] * kv4.w;
        }
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1)
          a += __shfl_xor_sync(0xffffffffu, a, off);
        const int kv_pos = t0 + j0 + j;
        const bool live = kv_pos < kv_hi && (!causal || kv_pos <= q_pos) &&
                          (window <= 0 || kv_pos > q_pos - window);
        s[j] = live ? a : -INFINITY;
      }
      float m_new = m;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) m_new = fmaxf(m_new, s[j]);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = m == -INFINITY ? 0.f : expf(m - m_safe);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        s[j] = expf(s[j] - m_safe);  // exp(-inf) == 0 for masked keys
        psum += s[j];
      }
      l = l * corr + psum;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] *= corr;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float* vr = vs + (j0 + j) * D;
#pragma unroll
        for (int c = 0; c < C4; ++c) {
          const float4 v4 = *reinterpret_cast<const float4*>(
              vr + (part + c * TPR) * 4);
          acc[4 * c] += s[j] * v4.x;
          acc[4 * c + 1] += s[j] * v4.y;
          acc[4 * c + 2] += s[j] * v4.z;
          acc[4 * c + 3] += s[j] * v4.w;
        }
      }
      m = m_new;
    }
  }
  if (active) {
    if (lse != nullptr && part == 0)
      lse[(static_cast<long long>(b) * H + head) * Sq + q_pos] =
          m == -INFINITY ? -INFINITY : m + logf(l);
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < C4; ++c)
      store4(o + q_off + (part + c * TPR) * 4,
             make_float4(acc[4 * c] * inv, acc[4 * c + 1] * inv,
                         acc[4 * c + 2] * inv, acc[4 * c + 3] * inv));
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Sq, int Skv, int H, int KH, int causal, int window,
           cudaStream_t stream) {
  // query positions per block: a row is threads_per_row threads, and the
  // G heads of one position sit side by side
  constexpr int TPR = threads_per_row<D>();
  const int block_q = (kThreads / TPR) / (H / KH);
  if (block_q < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * kBlockKV * D * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + block_q - 1) / block_q, KH, B);
  flash_attention_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), Sq, Skv, H, KH, block_q, causal, window,
      1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches o = attention(q, k, v) on `stream`, and writes the rows'
// log-sum-exp to lse (B, H, Sq) float32 unless lse is null. Pointers are
// device pointers to contiguous, 16-byte aligned buffers in the layouts
// above, all float32; D is 16, 64, 96, 112 or 128; H a multiple of KH,
// with H / KH rows of threads_per_row threads within 256 threads. Returns
// the cudaError_t of the launch (cudaErrorInvalidValue for a D or a head
// ratio it does not take).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, void* lse, int B, int Sq, int Skv, int H,
                           int KH, int D, int causal, int window,
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

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
