// Linear state recurrence over time for Hopper (sm_90a), every state kept.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py:33 (ssm_scan,
// Pallas body _kernel at :19). Its specification is the plain PyTorch
// version src/repro_torch/kernels/ref.py::ssm_scan: for each state element
// (b, d, n), from h = h0[b, d, n], per step t
//     h = dA[b, t, d, n] * h + dBx[b, t, d, n];   hs[b, t, d, n] = h
// and hT[b, d, n] = h after the last step. With reverse = 1 the steps run
// from t = T - 1 down to 0 (the adjoint recurrence of the selective
// scan's backward). Everything is float32.
//
// Numerics: a product then a sum, each rounded (the library is built with
// --fmad=false), as the plain version's torch ops round them, so hs and hT
// are bit-equal to it.
//
// Design. The Pallas kernel keeps a (block_d, N) state tile in VMEM and
// walks T; here each thread owns one state element in a register and walks
// T, so the grid is B * Di * N threads (204,800 at the training shape B =
// 4, Di = 3200, N = 16), consecutive threads on consecutive (d, n), and
// every step's loads and stores are coalesced across a warp. The loads do
// not depend on h: each thread fetches kUnroll steps of dA and dBx into
// registers before it runs their chain, which keeps 2 * kUnroll loads in
// flight a thread.
//
// Bound on the H100 SXM: bytes. At the training shape (B = 4, T = 1280, Di
// = 3200, N = 16) it reads dA and dBx (1.05 GB each) and writes hs (1.05
// GB): 0.94 ms at 3.35 TB/s, against 0.5 GFLOP.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
    ssm_scan_kernel(const float* __restrict__ dA, const float* __restrict__ dBx,
                    const float* __restrict__ h0, float* __restrict__ hs,
                    float* __restrict__ hT, int T, long long DN,
                    long long n_states, int reverse) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;  // = b * DN + (d * N + n)
  if (i >= n_states) return;
  const long long b = i / DN, dn = i % DN;
  const long long base = b * T * DN + dn;  // element (b, 0, d, n)
  const long long stride = reverse ? -DN : DN;
  long long off = base + (reverse ? static_cast<long long>(T - 1) * DN : 0);
  float h = h0[i];
  int t = 0;
  for (; t + kUnroll <= T; t += kUnroll) {
    float a[kUnroll], c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a[u] = dA[off + u * stride];
      c[u] = dBx[off + u * stride];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(a[u], h), c[u]);
      hs[off + u * stride] = h;
    }
    off += kUnroll * stride;
  }
  for (; t < T; ++t) {
    h = __fadd_rn(__fmul_rn(dA[off], h), dBx[off]);
    hs[off] = h;
    off += stride;
  }
  hT[i] = h;
}

}  // namespace

extern "C" {

// Launches the scan on `stream`. dA, dBx and hs are (B, T, Di, N), h0 and
// hT (B, Di, N), all float32, contiguous device buffers; reverse 0 walks t
// upwards, 1 downwards. Returns the cudaError_t of the launch.
int ssm_scan_launch(const void* dA, const void* dBx, const void* h0,
                    void* hs, void* hT, int B, int T, int Di, int N,
                    int reverse, void* stream) {
  const long long DN = static_cast<long long>(Di) * N;
  const long long n_states = B * DN;
  if (n_states == 0) return 0;
  const unsigned grid =
      static_cast<unsigned>((n_states + kThreads - 1) / kThreads);
  ssm_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dA), static_cast<const float*>(dBx),
      static_cast<const float*>(h0), static_cast<float*>(hs),
      static_cast<float*>(hT), T, DN, n_states, reverse);
  return static_cast<int>(cudaGetLastError());
}

const char* state_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
