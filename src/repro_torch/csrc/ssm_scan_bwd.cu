// Fused backward of the Mamba selective scan for Hopper (sm_90a).
//
// The gradient of kernel 6 (ssm_scan.cu, which replaces the TPU kernel
// src/repro/kernels/ssm_scan.py:87). The TPU package has no backward
// kernel: its training path differentiates an XLA associative scan
// (src/repro/models/ssm.py:91-103). The specification is the plain PyTorch
// version src/repro_torch/kernels/ref.py::fused_selective_scan_bwd: for
// each channel (b, d) and state n, with a_t = exp(dt_t A_n), u_t = dt_t x_t,
// h_t = a_t h_{t-1} + u_t B_{t,n} (h_{-1} = h0) and the adjoint
//     lambda_t = dy_t C_{t,n} + a_{t+1} lambda_{t+1},
//     lambda_{T-1} = dy_{T-1} C_{T-1,n} + dh_T,
// and g_t = lambda_t h_{t-1} a_t:
//     d_dt_t = sum_n (g_t A_n + lambda_t x_t B_{t,n})
//     d_x_t  = dt_t sum_n lambda_t B_{t,n}   (rounded once to x's type)
//     d_A_n  = sum_{b,t} g_t dt_t
//     d_B_{t,n} = sum_d lambda_t u_t,   d_C_{t,n} = sum_d dy_t h_t
//     d_h0   = a_0 lambda_0
// dt, A, B, C, h0, dy and dh_T are float32; x is float32 or bfloat16.
//
// Design: the (B, T, Di, N) states and adjoints never reach HBM.
// - Threads: as kernel 6, each channel's N states over TPC = N / 4
//   adjacent threads of four; a block of 128 threads holds 128 / TPC
//   channels of one batch row (400 blocks of four warps at the training
//   shape B = 4, Di = 3200, N = 16). At most 128 registers a thread, so
//   four blocks fit an SM and the whole grid is resident at once.
// - Checkpoints: a forward sweep walks the states through T and writes
//   the state entering every chunk of kL steps to a scratch buffer (the
//   thread reads back only its own writes). A reverse sweep then takes
//   the chunks from last to first: it recomputes the chunk's kL + 1 states
//   into registers from its checkpoint, then walks the adjoint back through
//   them, recomputing a_t.
// - Staging: per chunk, dt, x, dy, B_t and C_t go to shared memory with
//   cp.async, double-buffered, as in kernel 6 (scan_stage.cuh); steps past
//   T and channels past Di are zeros, which leave h and lambda unchanged
//   and add nothing to any sum.
// - Sums, in a fixed order and with no atomics, so two launches are
//   bit-equal: over n in the thread (four states) and across the channel's
//   TPC threads by xor shuffles; over t for d_A in registers; over d for
//   d_B and d_C by a butterfly across the warp's channels (each lane keeps
//   one of the 2N sums), then across the block's four warps in shared
//   memory into one partial per block and step; over blocks (d_B, d_C) and
//   over b (d_A) by a second small kernel that adds the partials in order.
//
// Numerics: h and lambda are formed with every product and sum rounded
// apart, as the plain version's torch ops and its two state scans round
// them, so they are bit-equal to it; the gradients differ from it only by
// the order of their sums.
//
// Bound on the H100 SXM: bytes. At the training shape (B = 4, T = 1280,
// Di = 3200, N = 16) it reads dt, dy (float32), x (bf16), A, B, C, h0 and
// dh_T and writes d_dt, d_x (bf16), d_A, d_B, d_C and d_h0: about 266 MB,
// 0.080 ms at 3.35 TB/s, against 262M exponentials, 0.063 ms at 16 per SM
// per clock (132 SMs, 1.98 GHz). The design spends three exps a state and
// step (forward sweep, recompute, reverse) and moves 65 MB of checkpoints
// and 65 MB of per-block partials each way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include "scan_stage.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kL = 16;    // steps a chunk: checkpoint interval and stretch
constexpr int kNPT = 4;   // states per thread
constexpr int kReduceThreads = 256;

template <typename TX, int CPB, int N>
struct Stage {
  float dt[kL][CPB];
  float dy[kL][CPB];
  scan::XRow<TX, CPB> x[kL];
  alignas(16) float b[kL][N];
  alignas(16) float c[kL][N];
};

__device__ __forceinline__ void store_x(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_x(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// stages chunk `c`; the forward sweep needs no dy and no C
template <typename TX, int CPB, int N>
__device__ __forceinline__ void stage(Stage<TX, CPB, N>& s, bool adjoint,
                                      const float* dt, const TX* x,
                                      const float* dy, const float* Bc,
                                      const float* Cc, long long row0, int c,
                                      int T, int Di, int d0,
                                      long long x_total, int tid) {
  const long long r = row0 + static_cast<long long>(c) * kL;
  const int nt = min(kL, T - c * kL);
  scan::stage_rows<kL, CPB, kThreads>(s.dt, dt, r, nt, Di, d0, Di - d0,
                                      tid);
  scan::stage_x<kL, CPB, kThreads>(s.x, x, r, nt, Di, d0, x_total, tid);
  scan::stage_rows<kL, N, kThreads>(s.b, Bc, r, nt, N, 0, N, tid);
  if (adjoint) {
    scan::stage_rows<kL, CPB, kThreads>(s.dy, dy, r, nt, Di, d0, Di - d0,
                                        tid);
    scan::stage_rows<kL, N, kThreads>(s.c, Cc, r, nt, N, 0, N, tid);
  }
  scan::cp_async_commit();
}

template <typename TX, int N>
__global__ void __launch_bounds__(kThreads, 4)
    scan_bwd_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                    const float* __restrict__ Bc, const float* __restrict__ Cc,
                    const TX* __restrict__ x, const float* __restrict__ h0,
                    const float* __restrict__ dy,
                    const float* __restrict__ dhT, float* __restrict__ d_dt,
                    TX* __restrict__ d_x, float* __restrict__ d_h0,
                    float* __restrict__ ckpt, float* __restrict__ part_bc,
                    float* __restrict__ part_a, int T, int Di,
                    long long x_total) {
  constexpr int TPC = N / kNPT;          // threads per channel
  constexpr int CPB = kThreads / TPC;    // channels per block
  __shared__ Stage<TX, CPB, N> st[2];
  __shared__ float red[kL][kWarps][2 * N];

  const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int d0 = blk * CPB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ch = tid / TPC, part = tid % TPC;
  const int d = d0 + ch;
  const bool active = d < Di;
  const int n0 = part * kNPT;
  const long long row0 = static_cast<long long>(b) * T;
  const long long state = (static_cast<long long>(b) * Di + d) * N + n0;
  const long long DN = static_cast<long long>(Di) * N;
  const int nch = (T + kL - 1) / kL;

  float a_n[kNPT], h[kNPT];
#pragma unroll
  for (int i = 0; i < kNPT; ++i) {
    a_n[i] = active ? A[static_cast<long long>(d) * N + n0 + i] : 0.f;
    h[i] = active ? h0[state + i] : 0.f;
  }

  // 1. forward sweep: the state entering chunk c + 1 -> ckpt[b, c]
  stage(st[0], false, dt, x, dy, Bc, Cc, row0, 0, T, Di, d0, x_total, tid);
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      stage(st[(c + 1) & 1], false, dt, x, dy, Bc, Cc, row0, c + 1, T, Di,
            d0, x_total, tid);
      scan::cp_async_wait<1>();
    } else {
      scan::cp_async_wait<0>();
    }
    __syncthreads();
    const Stage<TX, CPB, N>& S = st[c & 1];
#pragma unroll
    for (int tt = 0; tt < kL; ++tt) {
      const float dtv = S.dt[tt][ch];
      const float xv = active ? S.x[tt].get(
          ch, scan::x_shift(row0 + c * kL + tt, Di)) : 0.f;
      const float dx = __fmul_rn(dtv, xv);
      const float4 bv = *reinterpret_cast<const float4*>(&S.b[tt][n0]);
      const float bb[kNPT] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kNPT; ++i)
        h[i] = __fadd_rn(__fmul_rn(expf(__fmul_rn(dtv, a_n[i])), h[i]),
                         __fmul_rn(dx, bb[i]));
    }
    if (c + 1 < nch && active)
      *reinterpret_cast<float4*>(
          &ckpt[(static_cast<long long>(b) * (nch - 1) + c) * DN + d * N +
                n0]) = make_float4(h[0], h[1], h[2], h[3]);
    __syncthreads();
  }

  // 2. reverse sweep, chunk by chunk from the last
  float carry[kNPT], dA_acc[kNPT];  // carry: a_{t+1} lambda_{t+1}
#pragma unroll
  for (int i = 0; i < kNPT; ++i) {
    carry[i] = active ? dhT[state + i] : 0.f;
    dA_acc[i] = 0.f;
  }
  stage(st[0], true, dt, x, dy, Bc, Cc, row0, nch - 1, T, Di, d0, x_total,
        tid);
  for (int k = 0; k < nch; ++k) {
    const int c = nch - 1 - k;
    if (c > 0) {
      stage(st[(k + 1) & 1], true, dt, x, dy, Bc, Cc, row0, c - 1, T, Di,
            d0, x_total, tid);
      scan::cp_async_wait<1>();
    } else {
      scan::cp_async_wait<0>();
    }
    __syncthreads();
    const Stage<TX, CPB, N>& S = st[k & 1];
    const long long t0 = static_cast<long long>(c) * kL;

    // hs[tt] = h_{t0 + tt - 1}: the chunk's states, from its checkpoint
    float hs[kL + 1][kNPT];
    const float* start =
        c == 0 ? h0 + state
               : ckpt + (static_cast<long long>(b) * (nch - 1) + c - 1) * DN +
                     d * N + n0;
#pragma unroll
    for (int i = 0; i < kNPT; ++i) hs[0][i] = active ? start[i] : 0.f;
#pragma unroll
    for (int tt = 0; tt < kL; ++tt) {
      const float dtv = S.dt[tt][ch];
      const float xv = active ? S.x[tt].get(
          ch, scan::x_shift(row0 + t0 + tt, Di)) : 0.f;
      const float dx = __fmul_rn(dtv, xv);
      const float4 bv = *reinterpret_cast<const float4*>(&S.b[tt][n0]);
      const float bb[kNPT] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kNPT; ++i)
        hs[tt + 1][i] =
            __fadd_rn(__fmul_rn(expf(__fmul_rn(dtv, a_n[i])), hs[tt][i]),
                      __fmul_rn(dx, bb[i]));
    }

#pragma unroll
    for (int tt = kL - 1; tt >= 0; --tt) {
      const float dtv = S.dt[tt][ch];
      const float dyv = S.dy[tt][ch];
      const float xv = active ? S.x[tt].get(
          ch, scan::x_shift(row0 + t0 + tt, Di)) : 0.f;
      const float dx = __fmul_rn(dtv, xv);
      const float4 bv = *reinterpret_cast<const float4*>(&S.b[tt][n0]);
      const float4 cv = *reinterpret_cast<const float4*>(&S.c[tt][n0]);
      const float bb[kNPT] = {bv.x, bv.y, bv.z, bv.w};
      const float cc[kNPT] = {cv.x, cv.y, cv.z, cv.w};
      float sA = 0.f, sB = 0.f, v[2 * kNPT];
#pragma unroll
      for (int i = 0; i < kNPT; ++i) {
        const float ai = expf(__fmul_rn(dtv, a_n[i]));
        const float lam = __fadd_rn(carry[i], __fmul_rn(dyv, cc[i]));
        const float g = __fmul_rn(__fmul_rn(lam, hs[tt][i]), ai);
        dA_acc[i] = __fmaf_rn(g, dtv, dA_acc[i]);
        sA = __fmaf_rn(g, a_n[i], sA);
        sB = __fmaf_rn(lam, bb[i], sB);
        v[i] = __fmul_rn(lam, dx);                   // -> d_B
        v[kNPT + i] = __fmul_rn(dyv, hs[tt + 1][i]);  // -> d_C
        carry[i] = __fmul_rn(ai, lam);
      }
      // d_dt and d_x: the sums over the channel's TPC threads
#pragma unroll
      for (int o = 1; o < TPC; o <<= 1) {
        sA = __fadd_rn(sA, __shfl_xor_sync(0xffffffffu, sA, o));
        sB = __fadd_rn(sB, __shfl_xor_sync(0xffffffffu, sB, o));
      }
      const long long t = t0 + tt;
      if (part == 0 && active && t < T) {
        const long long off = (row0 + t) * Di + d;
        d_dt[off] = __fadd_rn(sA, __fmul_rn(xv, sB));
        store_x(&d_x[off], __fmul_rn(dtv, sB));
      }
      // d_B and d_C: butterfly over the warp's channels (lane bits 2-4;
      // and bit 1 at N = 8, where lanes 2 apart then hold the same sum).
      // Lane l keeps value (l >> 2) & 7 of the eight of its part.
      int cnt = 2 * kNPT;
#pragma unroll
      for (int o = 16; o >= 4; o >>= 1) {
        const bool hi = lane & o;
        cnt >>= 1;
#pragma unroll
        for (int j = 0; j < kNPT; ++j) {
          if (j < cnt) {
            const float send = hi ? v[j] : v[j + cnt];
            const float keep = hi ? v[j + cnt] : v[j];
            v[j] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, o));
          }
        }
      }
#pragma unroll
      for (int o = 2; o >= TPC; o >>= 1)
        v[0] = __fadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], o));
      if (TPC == 4 || !(lane & 2)) {
        const int j = (lane >> 2) & 7;  // value j: d_B (j < 4) or d_C
        red[tt][warp][(j >> 2) * N + n0 + (j & 3)] = v[0];
      }
    }
    __syncthreads();
    // the block's partial of d_B and d_C for each step of the chunk
    for (int i = tid; i < kL * 2 * N; i += kThreads) {
      const int tt = i / (2 * N), j = i % (2 * N);
      const long long t = t0 + tt;
      if (t < T) {
        float s = red[tt][0][j];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, red[tt][w][j]);
        part_bc[((static_cast<long long>(b) * nblk + blk) * T + t) * 2 * N +
                j] = s;
      }
    }
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < kNPT; ++i) {
      d_h0[state + i] = carry[i];  // a_0 lambda_0
      part_a[state + i] = dA_acc[i];
    }
  }
}

// d_B, d_C (B, T, N): the blocks' partials added in block order; d_A (Di,
// N): the batch rows' partials added in row order.
__global__ void __launch_bounds__(kReduceThreads)
    scan_bwd_reduce_kernel(const float* __restrict__ part_bc,
                           const float* __restrict__ part_a,
                           float* __restrict__ d_B, float* __restrict__ d_C,
                           float* __restrict__ d_A, int B, int T, int N,
                           int nblk, long long DN) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kReduceThreads + threadIdx.x;
  const long long per_b = static_cast<long long>(T) * 2 * N;
  const long long n_bc = B * per_b;
  if (i < n_bc) {
    const long long b = i / per_b, r = i % per_b;
    const float* p = part_bc + b * nblk * per_b + r;
    float s = p[0];
    for (int k = 1; k < nblk; ++k) s = __fadd_rn(s, p[k * per_b]);
    const long long t = r / (2 * N);
    const int j = static_cast<int>(r % (2 * N));
    float* out = j < N ? d_B : d_C;
    out[(b * T + t) * N + j % N] = s;
  } else if (i - n_bc < DN) {
    const long long e = i - n_bc;
    float s = part_a[e];
    for (int b = 1; b < B; ++b) s = __fadd_rn(s, part_a[b * DN + e]);
    d_A[e] = s;
  }
}

template <typename TX, int N>
int launch(const void* dt, const void* A, const void* Bc, const void* Cc,
           const void* x, const void* h0, const void* dy, const void* dhT,
           void* d_dt, void* d_A, void* d_B, void* d_C, void* d_x,
           void* d_h0, void* ckpt, void* part_bc, void* part_a, int B, int T,
           int Di, cudaStream_t stream) {
  constexpr int CPB = kThreads / (N / kNPT);
  const int nblk = (Di + CPB - 1) / CPB;
  scan_bwd_kernel<TX, N><<<dim3(nblk, B), kThreads, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(Bc), static_cast<const float*>(Cc),
      static_cast<const TX*>(x), static_cast<const float*>(h0),
      static_cast<const float*>(dy), static_cast<const float*>(dhT),
      static_cast<float*>(d_dt), static_cast<TX*>(d_x),
      static_cast<float*>(d_h0), static_cast<float*>(ckpt),
      static_cast<float*>(part_bc), static_cast<float*>(part_a), T, Di,
      static_cast<long long>(B) * T * Di);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const long long DN = static_cast<long long>(Di) * N;
  const long long n = static_cast<long long>(B) * T * 2 * N + DN;
  scan_bwd_reduce_kernel<<<static_cast<unsigned>(
                               (n + kReduceThreads - 1) / kReduceThreads),
                           kReduceThreads, 0, stream>>>(
      static_cast<const float*>(part_bc), static_cast<const float*>(part_a),
      static_cast<float*>(d_B), static_cast<float*>(d_C),
      static_cast<float*>(d_A), B, T, N, nblk, DN);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX>
int launch_n(const void* dt, const void* A, const void* Bc, const void* Cc,
             const void* x, const void* h0, const void* dy, const void* dhT,
             void* d_dt, void* d_A, void* d_B, void* d_C, void* d_x,
             void* d_h0, void* ckpt, void* part_bc, void* part_a, int B,
             int T, int Di, int N, cudaStream_t s) {
  switch (N) {
    case 8:
      return launch<TX, 8>(dt, A, Bc, Cc, x, h0, dy, dhT, d_dt, d_A, d_B,
                           d_C, d_x, d_h0, ckpt, part_bc, part_a, B, T, Di,
                           s);
    case 16:
      return launch<TX, 16>(dt, A, Bc, Cc, x, h0, dy, dhT, d_dt, d_A, d_B,
                            d_C, d_x, d_h0, ckpt, part_bc, part_a, B, T, Di,
                            s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The scratch's shapes: chunks of ssm_scan_bwd_chunk() steps, blocks of
// ssm_scan_bwd_channels_per_block(N) channels.
int ssm_scan_bwd_chunk() { return kL; }

int ssm_scan_bwd_channels_per_block(int N) {
  return N > 0 && N % kNPT == 0 ? kThreads / (N / kNPT) : 0;
}

// Launches the backward on `stream`. Pointers are device pointers to
// contiguous buffers in the layouts above; d_x is in x's type (x_bf16: 1
// bfloat16, 0 float32), every other gradient float32. Scratch, allocated
// by the caller: ckpt (B, ceil(T / chunk) - 1, Di, N), part_bc (B, nblk,
// T, 2N) with nblk = ceil(Di / channels_per_block), part_a (B, Di, N),
// all float32. N is 8 or 16; B, T and Di positive. Returns the
// first failed launch's cudaError_t, or 0.
int ssm_scan_bwd_launch(const void* dt, const void* A, const void* Bc,
                        const void* Cc, const void* x, const void* h0,
                        const void* dy, const void* dhT, void* d_dt,
                        void* d_A, void* d_B, void* d_C, void* d_x,
                        void* d_h0, void* ckpt, void* part_bc, void* part_a,
                        int B, int T, int Di, int N, int x_bf16,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch_n<__nv_bfloat16>(dt, A, Bc, Cc, x, h0, dy, dhT, d_dt, d_A,
                                   d_B, d_C, d_x, d_h0, ckpt, part_bc,
                                   part_a, B, T, Di, N, s);
  return launch_n<float>(dt, A, Bc, Cc, x, h0, dy, dhT, d_dt, d_A, d_B, d_C,
                         d_x, d_h0, ckpt, part_bc, part_a, B, T, Di, N, s);
}

const char* ssm_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
