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
// state stays in registers. Each channel's N states are split over TPC =
// N / 4 adjacent threads of four states each (102,400 threads at the serve
// shape B = 8, Di = 3200, N = 16; 51,200 at the training shape B = 4), and
// a block of 128 threads holds 128 / TPC channels of one batch row. Per
// stretch of 32 steps the block stages dt and x for its channels and the
// shared B_t and C_t rows in shared memory with cp.async (scan_stage.cuh),
// double-buffered: the next stretch is in flight while this one is
// computed, and each thread's copies step through fixed columns, so a full
// stretch costs a few instructions a copy. Each thread reads its four B
// and C values as one 16-byte vector. The exponentials do not depend on
// the state, so the steps are unrolled 16 deep and only h = a h + b is
// serial. A group's four partial sums of y over the thread's states are
// reduced across the channel's TPC threads by a butterfly that leaves each
// thread the sum of one step (of two at N = 8): log2(TPC) shuffles per
// four steps instead of per step. Steps past T and channels past Di
// compute on the zeros staging leaves (dt = 0 keeps h as it is) and store
// nothing.
//
// Numerics: expf at full precision, as the plain version's torch.exp, so
// each a = exp(dt A) is bit-equal to it; ex2.approx on A log2(e) would
// save seven instructions of the ~16 a state and step, but its errors,
// summed over the long-memory states, come close to the 2e-6 of the
// largest |y| the kernel is held to. The update h = a h + (dt x) B and the
// sum y += h C each take one fused multiply-add (__fmaf_rn), so h and y
// differ from the plain version's separately rounded ones by a few float32
// roundings: at most 5.3e-7 of the largest |y| or |h_T| on the shapes
// chip_smoke.py checks (H100).
//
// Bound on the H100 SXM: operations, the exponentials. At the serve shape
// (B = 8, T = 1280, Di = 3200, N = 16) it takes 524M exp(dt * A), one per
// state per step, against 327 MB of dt, x (bf16) and y: 0.10 ms at
// 3.35 TB/s, while the SFUs do 16 exps per SM per clock (132 SMs), 0.13 ms
// at 1.98 GHz. expf is eight instructions around its one SFU op, so the
// rate at which ~14 instructions a state and step are dispatched, not the
// SFUs, sets the time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include "scan_stage.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSteps = 32;  // steps staged in shared memory at a time
constexpr int kNPT = 4;     // states per thread
constexpr int kGroup = 4;   // steps whose y partials are reduced together

template <typename TX, int CPB, int N>
struct Stage {
  float dt[kSteps][CPB];
  scan::XRow<TX, CPB> x[kSteps];
  alignas(16) float b[kSteps][N];
  alignas(16) float c[kSteps][N];
};

template <typename TX, int CPB, int N>
__device__ __forceinline__ void stage(Stage<TX, CPB, N>& s, const float* dt,
                                      const TX* x, const float* Bc,
                                      const float* Cc, long long row0,
                                      int nt, int Di, int d0,
                                      long long x_total, int tid) {
  scan::stage_rows<kSteps, CPB, kThreads>(s.dt, dt, row0, nt, Di, d0,
                                          Di - d0, tid);
  scan::stage_x<kSteps, CPB, kThreads>(s.x, x, row0, nt, Di, d0, x_total,
                                       tid);
  scan::stage_rows<kSteps, N, kThreads>(s.b, Bc, row0, nt, N, 0, N, tid);
  scan::stage_rows<kSteps, N, kThreads>(s.c, Cc, row0, nt, N, 0, N, tid);
  scan::cp_async_commit();
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
                                int T, int Di, long long x_total) {
  constexpr int TPC = N / kNPT;          // threads per channel
  constexpr int CPB = kThreads / TPC;    // channels per block
  constexpr int kPer = kGroup / TPC;     // steps of y each thread stores
  __shared__ Stage<TX, CPB, N> st[2];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CPB;
  const int tid = threadIdx.x;
  const int ch = tid / TPC, part = tid % TPC;
  const int d = d0 + ch;
  const bool active = d < Di;
  const int n0 = part * kNPT;
  const long long row0 = static_cast<long long>(b) * T;

  float a[kNPT], h[kNPT];
#pragma unroll
  for (int i = 0; i < kNPT; ++i) {
    a[i] = active ? A[static_cast<long long>(d) * N + n0 + i] : 0.f;
    h[i] = active ? h0[(static_cast<long long>(b) * Di + d) * N + n0 + i]
                  : 0.f;
  }

  const int n_st = (T + kSteps - 1) / kSteps;
  if (n_st > 0)
    stage(st[0], dt, x, Bc, Cc, row0, min(kSteps, T), Di, d0, x_total, tid);
  for (int s = 0; s < n_st; ++s) {
    const int t0 = s * kSteps;
    if (s + 1 < n_st) {
      stage(st[(s + 1) & 1], dt, x, Bc, Cc, row0 + t0 + kSteps,
            min(kSteps, T - t0 - kSteps), Di, d0, x_total, tid);
      scan::cp_async_wait<1>();
    } else {
      scan::cp_async_wait<0>();
    }
    __syncthreads();  // this stretch has landed for every thread
    const Stage<TX, CPB, N>& S = st[s & 1];
    // bfloat16 x rows of even and odd steps sit at these shifts
    const int sh_even = scan::x_shift(row0 + t0, Di);
    const int sh_odd = sh_even ^ (Di & 1);
    // y of step t0 + g + part * kPer + j, for each group g
    float* yp_out = y + (row0 + t0 + part * kPer) * Di + d;
    const int n_out = T - t0 - part * kPer;  // steps of this stretch to store
#pragma unroll 4
    for (int g = 0; g < kSteps; g += kGroup) {
      float yp[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int tt = g + u;
        // a channel past Di reads zeros (dt) and whatever x holds; its
        // threads store nothing and exchange sums only with each other
        const float dtv = S.dt[tt][ch];
        const float dx =
            __fmul_rn(dtv, S.x[tt].get(ch, (u & 1) ? sh_odd : sh_even));
        const float4 bv = *reinterpret_cast<const float4*>(&S.b[tt][n0]);
        const float4 cv = *reinterpret_cast<const float4*>(&S.c[tt][n0]);
        const float bb[kNPT] = {bv.x, bv.y, bv.z, bv.w};
        const float cc[kNPT] = {cv.x, cv.y, cv.z, cv.w};
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < kNPT; ++i) {
          const float ai = expf(__fmul_rn(dtv, a[i]));
          h[i] = __fmaf_rn(ai, h[i], __fmul_rn(dx, bb[i]));
          acc = __fmaf_rn(h[i], cc[i], acc);
        }
        yp[u] = acc;
      }
      // butterfly over the channel's TPC threads: the thread with part p
      // keeps the sums of steps g + p * kPer ... + kPer - 1
      int cnt = kGroup;
#pragma unroll
      for (int o = TPC / 2; o > 0; o >>= 1) {
        const bool hi = part & o;
        cnt >>= 1;
#pragma unroll
        for (int j = 0; j < kGroup / 2; ++j) {
          if (j < cnt) {
            const float send = hi ? yp[j] : yp[j + cnt];
            const float keep = hi ? yp[j + cnt] : yp[j];
            yp[j] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, o));
          }
        }
      }
      if (active) {
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          if (g + j < n_out)
            yp_out[static_cast<long long>(g + j) * Di] = yp[j];
      }
    }
    __syncthreads();  // every thread is done with this buffer
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
      static_cast<float*>(y), static_cast<float*>(hT), T, Di,
      static_cast<long long>(B) * T * Di);
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
