// Fused Mamba selective scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py:87
// (fused_selective_scan, Pallas body _fused_kernel at :67). Its
// specification is the plain PyTorch version
// src/repro_torch/kernels/ref.py::fused_selective_scan: for each batch row
// b and channel d, from h = h0[b, d, :], per step t
//     h[n]  = exp(dt[b,t,d] * A[d,n]) * h[n] + (dt[b,t,d] * x[b,t,d]) * B[b,t,n]
//     y[b,t,d] = sum_n h[n] * C[b,t,n]
// and h_T[b, d, :] = h after the last step. dt, A, B, C and h0 are float32;
// x is float32 or bfloat16 (template instances); y and h_T are float32.
//
// Design. The Pallas kernel keeps a (block_d, N) state tile in VMEM and
// steps over T, so the (B, T, Di, N) state never reaches HBM; here the
// state stays in registers. B * Di channels alone (25,600 at the serve
// shape, B = 8, Di = 3200) would leave most of the card idle on a serial
// loop, so each channel's N states are split over TPC = N / 4 adjacent
// threads of four states each (102,400 threads at N = 16), and y_t is
// their partial sums over n added with xor shuffles. A block of 128
// threads holds 128 / TPC channels of one batch row; per stretch of 32
// steps it stages dt and x for its channels (read coalesced across d, x
// converted to float32) and the shared B_t and C_t rows in shared memory,
// then every thread walks the stretch from shared memory. T = 1 and ragged
// stretches are masked; channels past Di compute on zeros and store
// nothing.
//
// Bound on the H100 SXM: operations, the exponentials. At the serve shape
// (B = 8, T = 1280, Di = 3200, N = 16) it takes 524M exp(dt * A), one per
// state per step, against 327 MB of dt, x (bf16) and y: 0.10 ms at
// 3.35 TB/s, while the SFUs do 16 exps per SM per clock (132 SMs), 0.13 ms
// at 1.98 GHz. The exps use expf (full float precision) so the result
// stays within float32 rounding of the plain version's torch.exp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSteps = 32;  // steps staged in shared memory at a time
constexpr int kNPT = 4;     // states per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TX, int N>
__global__ void __launch_bounds__(kThreads)
    fused_selective_scan_kernel(const float* __restrict__ dt,
                                const float* __restrict__ A,
                                const float* __restrict__ Bc,
                                const float* __restrict__ Cc,
                                const TX* __restrict__ x,
                                const float* __restrict__ h0,
                                float* __restrict__ y, float* __restrict__ hT,
                                int T, int Di) {
  constexpr int TPC = N / kNPT;          // threads per channel
  constexpr int CPB = kThreads / TPC;    // channels per block
  __shared__ float dt_s[kSteps][CPB];
  __shared__ float x_s[kSteps][CPB];
  __shared__ float b_s[kSteps][N];
  __shared__ float c_s[kSteps][N];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CPB;
  const int tid = threadIdx.x;
  const int ch = tid / TPC, part = tid % TPC;
  const int d = d0 + ch;
  const bool active = d < Di;
  const int n0 = part * kNPT;

  float a[kNPT], h[kNPT];
#pragma unroll
  for (int i = 0; i < kNPT; ++i) {
    a[i] = active ? A[static_cast<long long>(d) * N + n0 + i] : 0.f;
    h[i] = active ? h0[(static_cast<long long>(b) * Di + d) * N + n0 + i]
                  : 0.f;
  }

  for (int t0 = 0; t0 < T; t0 += kSteps) {
    const int nt = min(kSteps, T - t0);
    __syncthreads();  // the previous stretch is consumed
    for (int i = tid; i < kSteps * CPB; i += kThreads) {
      const int tt = i / CPB, c = i % CPB;
      const bool ok = tt < nt && d0 + c < Di;
      const long long off =
          (static_cast<long long>(b) * T + t0 + tt) * Di + d0 + c;
      dt_s[tt][c] = ok ? dt[off] : 0.f;
      x_s[tt][c] = ok ? to_f32(x[off]) : 0.f;
    }
    for (int i = tid; i < kSteps * N; i += kThreads) {
      const int tt = i / N, n = i % N;
      const bool ok = tt < nt;
      const long long off = (static_cast<long long>(b) * T + t0 + tt) * N + n;
      b_s[tt][n] = ok ? Bc[off] : 0.f;
      c_s[tt][n] = ok ? Cc[off] : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float dtv = dt_s[tt][ch];
      const float dx = dtv * x_s[tt][ch];
      float yp = 0.f;
#pragma unroll
      for (int i = 0; i < kNPT; ++i) {
        h[i] = expf(dtv * a[i]) * h[i] + dx * b_s[tt][n0 + i];
        yp += h[i] * c_s[tt][n0 + i];
      }
#pragma unroll
      for (int off = TPC / 2; off > 0; off >>= 1)
        yp += __shfl_xor_sync(0xffffffffu, yp, off);
      if (active && part == 0)
        y[(static_cast<long long>(b) * T + t0 + tt) * Di + d] = yp;
    }
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < kNPT; ++i)
      hT[(static_cast<long long>(b) * Di + d) * N + n0 + i] = h[i];
  }
}

template <typename TX, int N>
int launch(const void* dt, const void* A, const void* Bc, const void* Cc,
           const void* x, const void* h0, void* y, void* hT, int B, int T,
           int Di, cudaStream_t stream) {
  constexpr int CPB = kThreads / (N / kNPT);
  const dim3 grid((Di + CPB - 1) / CPB, B);
  fused_selective_scan_kernel<TX, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(Bc), static_cast<const float*>(Cc),
      static_cast<const TX*>(x), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(hT), T, Di);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX>
int launch_n(const void* dt, const void* A, const void* Bc, const void* Cc,
             const void* x, const void* h0, void* y, void* hT, int B, int T,
             int Di, int N, cudaStream_t s) {
  switch (N) {
    case 8:
      return launch<TX, 8>(dt, A, Bc, Cc, x, h0, y, hT, B, T, Di, s);
    case 16:
      return launch<TX, 16>(dt, A, Bc, Cc, x, h0, y, hT, B, T, Di, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches the scan on `stream`. Pointers are device pointers to
// contiguous buffers in the layouts above; x_bf16 picks bfloat16 (1) or
// float32 (0) for x; N is 8 or 16; B and Di positive. Returns the
// cudaError_t of the launch.
int fused_selective_scan_launch(const void* dt, const void* A, const void* Bc,
                                const void* Cc, const void* x, const void* h0,
                                void* y, void* hT, int B, int T, int Di, int N,
                                int x_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch_n<__nv_bfloat16>(dt, A, Bc, Cc, x, h0, y, hT, B, T, Di, N,
                                   s);
  return launch_n<float>(dt, A, Bc, Cc, x, h0, y, hT, B, T, Di, N, s);
}

const char* ssm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
