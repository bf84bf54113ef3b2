// Fused ring-allreduce receive-accumulate for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_reduce.py:27
// (fused_accumulate, Pallas body _kernel at :19). Its specification is the
// plain PyTorch version src/repro_torch/kernels/ref.py::fused_accumulate:
// out = round_to(acc.dtype, float(acc) + scale * float(x)) over an (R, C)
// tile, into a new tensor; acc and x are each float32 or bfloat16, so the
// four (acc, x) type pairs are template instances.
//
// Design. The Pallas kernel keeps one (256, 512) tile of both operands in
// VMEM per grid step so the summand never goes back to HBM between the
// upcast, the scale and the add. On Hopper the same pass is an elementwise
// grid-stride loop with nothing to stage: each thread reads four elements
// of acc and of x per iteration as one vector load each (16 bytes for
// float32, 8 for bfloat16), computes in float32 in registers and writes
// four elements of out. When a pointer is not aligned to its vector width
// the whole launch takes the scalar loop; the elements past the last whole
// vector are done one by one. The edge tiles of the Pallas grid need no
// counterpart: the loop runs over R * C elements.
//
// Exactness. The multiply and the add are __fmul_rn and __fadd_rn, which
// are never contracted into a fused multiply-add (the file is also built
// with --fmad=false), so they round as the plain version's two operations
// do; bfloat16 is read exactly (__bfloat162float) and written with
// round-to-nearest-even (__float2bfloat16_rn), as torch's cast does. The
// result is bit-equal to the plain version.
//
// Bound on the H100 SXM: bytes. It reads acc and x once and writes out
// once: R * C * (2 * sizeof(acc) + sizeof(x)) bytes over 3.35 TB/s, with
// two float operations per element (far below the 67 TFLOP/s float32
// peak). At the fig1 tiles, float32: 0.12 us at (64, 512), 1.9 us at
// (1024, 512) and 15.0 us at (8192, 512), so launch latency sets the time
// of the two small tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// four elements as one aligned vector load or store
template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T v[4];
};

template <typename TA, typename TX>
__device__ __forceinline__ TA accumulate(TA a, TX x, float scale) {
  return from_f32<TA>(__fadd_rn(to_f32(a), __fmul_rn(scale, to_f32(x))));
}

template <typename TA, typename TX, bool kVec>
__global__ void fused_accumulate_kernel(const TA* __restrict__ acc,
                                        const TX* __restrict__ x,
                                        TA* __restrict__ out, long long n,
                                        float scale) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                threadIdx.x;
  long long done = 0;
  if (kVec) {
    const long long nv = n / 4;
    const Vec4<TA>* a4 = reinterpret_cast<const Vec4<TA>*>(acc);
    const Vec4<TX>* x4 = reinterpret_cast<const Vec4<TX>*>(x);
    Vec4<TA>* o4 = reinterpret_cast<Vec4<TA>*>(out);
    for (long long j = i; j < nv; j += stride) {
      const Vec4<TA> a = a4[j];
      const Vec4<TX> b = x4[j];
      Vec4<TA> o;
#pragma unroll
      for (int k = 0; k < 4; ++k) o.v[k] = accumulate(a.v[k], b.v[k], scale);
      o4[j] = o;
    }
    done = nv * 4;
  }
  for (long long j = done + i; j < n; j += stride)
    out[j] = accumulate(acc[j], x[j], scale);
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename TA, typename TX>
int launch(const void* acc, const void* x, void* out, long long n,
           float scale, cudaStream_t stream) {
  const bool vec = aligned(acc, 4 * sizeof(TA)) &&
                   aligned(x, 4 * sizeof(TX)) && aligned(out, 4 * sizeof(TA));
  const long long items = vec ? (n + 3) / 4 : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const TA* a = static_cast<const TA*>(acc);
  const TX* b = static_cast<const TX*>(x);
  TA* o = static_cast<TA*>(out);
  if (vec)
    fused_accumulate_kernel<TA, TX, true>
        <<<static_cast<int>(blocks), kThreads, 0, stream>>>(a, b, o, n, scale);
  else
    fused_accumulate_kernel<TA, TX, false>
        <<<static_cast<int>(blocks), kThreads, 0, stream>>>(a, b, o, n, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches out = acc + scale * x over n elements on `stream`. Pointers are
// device pointers to contiguous buffers; acc_bf16 / x_bf16 pick bfloat16
// (1) or float32 (0) for acc (and out) and for x. n must be positive.
// Returns the cudaError_t of the launch.
int fused_accumulate_launch(const void* acc, const void* x, void* out,
                            long long n, float scale, int acc_bf16,
                            int x_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (acc_bf16 && x_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(acc, x, out, n, scale, s);
  if (acc_bf16)
    return launch<__nv_bfloat16, float>(acc, x, out, n, scale, s);
  if (x_bf16)
    return launch<float, __nv_bfloat16>(acc, x, out, n, scale, s);
  return launch<float, float>(acc, x, out, n, scale, s);
}

const char* fused_reduce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
