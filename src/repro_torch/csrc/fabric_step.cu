// Fused fabric-simulator step core for Hopper (sm_90a), one block per cell.
//
// Replaces the TPU kernel src/repro/kernels/fabric_step.py:175
// (fabric_step_core, Pallas body _kernel at :61). Its specification is the
// plain PyTorch version src/repro_torch/kernels/ref.py::fabric_step_core:
// NIC limit, backpressure stall, H-hop staged propagation and the queue
// update of one simulator step (DESIGN.md §13).
//
// Design. The body is a chain of data-dependent scatters separated by
// block-wide barriers, so one thread block owns one cell (grid = B) and
// keeps every per-link and per-switch row it scatters into in dynamic
// shared memory: src_load[n_src], hot_q/tot_q/sw_sat[n_sw], caps_eff,
// load (reused for `over`) and arrival [L+1], plus served [L+1] when the
// aux observer is on. The per-flow rate r lives in the `achieved` output
// between hops; each thread owns the same flows and links in every phase,
// so those rows need no barrier of their own. Segment sums are float
// atomicAdd on shared memory, the segment max of sat in [0, 1] is
// atomicMax on its int bit pattern (exact for non-negative floats).
//
// The order of the atomic sums is not fixed, so results may differ from
// the plain version in the last bits wherever a segment has more than one
// contributor: parity is the DESIGN.md §13 contract (rtol 2e-4, atol 1.0),
// and bit-exact when every segment has at most one contributor. Build
// with --fmad=false and without fast math so every other operation rounds
// exactly as the plain version does. Every clamp and max keeps torch's NaN
// semantics (a NaN operand propagates), so a zero-capacity link with no
// load gives NaN here as it does in the plain version and the JAX
// reference (0 / 0 in the over-subscription divide); a padded hop adds
// nothing, also for a NaN rate, as the reference runs.
//
// Bound on the H100 SXM: bytes. Per launch and cell it moves about
// 4*F*H + 20*F + 32*(L+1) bytes (each input read once, each output
// written once) against 3.35 TB/s: under a microsecond at every shape of
// the characterization grids, so launch latency and the serial hop loop,
// not DRAM, set its time today.

#include <cuda_runtime.h>

namespace {

// torch.maximum / torch.minimum: a NaN in either operand propagates, where
// fmaxf / fminf would return the other operand
__device__ __forceinline__ float maximum(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float minimum(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}

__global__ void fabric_step_core_kernel(
    const int* __restrict__ plinks, const float* __restrict__ inject,
    const int* __restrict__ src_id, const float* __restrict__ host_caps,
    const float* __restrict__ q, const float* __restrict__ occ,
    const float* __restrict__ caps_finite, const int* __restrict__ src_sw,
    const int* __restrict__ dst_sw, const float* __restrict__ scalars,
    float* __restrict__ inject_out, float* __restrict__ achieved,
    float* __restrict__ arrival_out, float* __restrict__ q_new,
    float* __restrict__ caps_eff_out, float* __restrict__ served_max,
    int F, int H, int L1, int n_src, int n_sw, long long s_src_id,
    long long s_host_caps, long long s_caps_finite, long long s_src_sw,
    long long s_dst_sw, int with_aux) {
  extern __shared__ float smem[];
  float* src_load = smem;                          // [n_src]
  float* hot_q = src_load + n_src;                 // [n_sw], then stall
  float* tot_q = hot_q + n_sw;                     // [n_sw]
  int* sw_sat = reinterpret_cast<int*>(tot_q + n_sw);  // [n_sw] float bits
  float* caps_eff = reinterpret_cast<float*>(sw_sat + n_sw);  // [L1]
  float* load = caps_eff + L1;                     // [L1], then over
  float* arrival = load + L1;                      // [L1]
  float* served = arrival + L1;                    // [L1] if with_aux

  const long long b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int sink = L1 - 1;
  // per-cell rows carry their own stride; geometry rows shared by every
  // cell of a batched run come with stride 0
  plinks += b * F * H;
  inject += b * F;
  src_id += b * s_src_id;
  host_caps += b * s_host_caps;
  q += b * L1;
  occ += b * L1;
  caps_finite += b * s_caps_finite;
  src_sw += b * s_src_sw;
  dst_sw += b * s_dst_sw;
  inject_out += b * F;
  achieved += b * F;
  arrival_out += b * L1;
  q_new += b * L1;
  caps_eff_out += b * L1;
  if (with_aux) served_max += b * L1;
  const float dt = scalars[b * 5 + 0];
  const float qmax = scalars[b * 5 + 1];
  const float hol_factor = scalars[b * 5 + 2];
  const float hol_start = scalars[b * 5 + 3];
  const float jitter = scalars[b * 5 + 4];

  for (int i = tid; i < n_src; i += nt) src_load[i] = 0.0f;
  for (int i = tid; i < n_sw; i += nt) {
    hot_q[i] = 0.0f;
    tot_q[i] = 0.0f;
    sw_sat[i] = 0;
  }
  for (int l = tid; l < L1; l += nt) {
    arrival[l] = 0.0f;
    if (with_aux) {
      served[l] = 0.0f;
      served_max[l] = 0.0f;
    }
  }
  __syncthreads();

  // ---- NIC segment sum; backpressure segment sums and max ----
  for (int f = tid; f < F; f += nt) atomicAdd(&src_load[src_id[f]], inject[f]);
  const float hs_den = 1.0f - hol_start;
  for (int l = tid; l < L1; l += nt) {
    const float ql = q[l];
    const float sat =
        minimum(maximum((occ[l] - hol_start) / hs_den, 0.0f), 1.0f);
    const int s = src_sw[l];
    atomicAdd(&hot_q[s], ql * sat);
    atomicAdd(&tot_q[s], ql);
    atomicMax(&sw_sat[s], __float_as_int(sat));
  }
  __syncthreads();

  // ---- NIC scale per flow; stall per switch (0 == host endpoint) ----
  for (int f = tid; f < F; f += nt) {
    const float scale =
        minimum(host_caps[f] / maximum(src_load[src_id[f]], 1.0f), 1.0f);
    const float x = inject[f] * scale;
    inject_out[f] = x;
    achieved[f] = x;
  }
  for (int s = tid; s < n_sw; s += nt) {
    const float share = hot_q[s] / maximum(tot_q[s], 1.0f);
    const float stall = 1.0f - hol_factor * __int_as_float(sw_sat[s]) * share;
    hot_q[s] = s == 0 ? 1.0f : stall;
  }
  __syncthreads();
  for (int l = tid; l < L1; l += nt) {
    const float ce = caps_finite[l] * hot_q[dst_sw[l]];
    caps_eff[l] = ce;
    caps_eff_out[l] = ce;
  }

  // ---- H-hop staged propagation ----
  for (int h = 0; h < H; ++h) {
    for (int l = tid; l < L1; l += nt) load[l] = 0.0f;
    __syncthreads();
    for (int f = tid; f < F; f += nt) {
      const int lk = plinks[f * H + h];
      if (lk < sink) atomicAdd(&load[lk], achieved[f]);
    }
    __syncthreads();
    for (int l = tid; l < L1; l += nt) {
      const float ld = load[l];
      arrival[l] = arrival[l] + ld;
      load[l] = maximum(ld / caps_eff[l], 1.0f);  // over-subscription
    }
    __syncthreads();
    for (int f = tid; f < F; f += nt) {
      const int lk = plinks[f * H + h];
      if (lk < sink) {
        const float r = achieved[f] / load[lk];
        achieved[f] = r;
        if (with_aux) atomicAdd(&served[lk], r);
      }
    }
    __syncthreads();
    if (with_aux) {
      for (int l = tid; l < L1; l += nt) {
        served_max[l] = maximum(served_max[l], served[l]);
        served[l] = 0.0f;
      }
    }
  }

  // ---- queue update ----
  for (int l = tid; l < L1; l += nt) {
    const float a = arrival[l];
    arrival_out[l] = a;
    const float x = q[l] + (a * (1.0f + jitter) - caps_eff[l]) * dt;
    q_new[l] = l == sink ? 0.0f : minimum(maximum(x, 0.0f), qmax);
  }
}

int g_smem_set = -1;  // dynamic shared memory the kernel is allowed so far

}  // namespace

extern "C" {

// Launches one step core for B cells on `stream`. Pointers are device
// pointers; s_* are batch strides in elements (0 = shared by all cells).
// Returns the cudaError_t of the attribute call or the launch.
int fabric_step_core_launch(
    const void* plinks, const void* inject, const void* src_id,
    const void* host_caps, const void* q, const void* occ,
    const void* caps_finite, const void* src_sw, const void* dst_sw,
    const void* scalars, void* inject_out, void* achieved, void* arrival,
    void* q_new, void* caps_eff, void* served_max, int B, int F, int H,
    int L1, int n_src, int n_sw, long long s_src_id, long long s_host_caps,
    long long s_caps_finite, long long s_src_sw, long long s_dst_sw,
    int with_aux, int smem_bytes, int threads, void* stream) {
  if (smem_bytes > g_smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        fabric_step_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    g_smem_set = smem_bytes;
  }
  fabric_step_core_kernel<<<B, threads, smem_bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(plinks), static_cast<const float*>(inject),
      static_cast<const int*>(src_id), static_cast<const float*>(host_caps),
      static_cast<const float*>(q), static_cast<const float*>(occ),
      static_cast<const float*>(caps_finite),
      static_cast<const int*>(src_sw), static_cast<const int*>(dst_sw),
      static_cast<const float*>(scalars), static_cast<float*>(inject_out),
      static_cast<float*>(achieved), static_cast<float*>(arrival),
      static_cast<float*>(q_new), static_cast<float*>(caps_eff),
      static_cast<float*>(served_max), F, H, L1, n_src, n_sw, s_src_id,
      s_host_caps, s_caps_finite, s_src_sw, s_dst_sw, with_aux);
  return static_cast<int>(cudaGetLastError());
}

const char* fabric_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
