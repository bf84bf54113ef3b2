// Per-block symmetric int8 quantize and dequantize for Hopper (sm_90a).
//
// Replace the TPU kernels src/repro/kernels/quant.py:30 (quantize_int8,
// Pallas body _q_kernel at :14) and :53 (dequantize_int8, body _dq_kernel
// at :23). Their specification is the plain PyTorch versions
// src/repro_torch/kernels/ref.py::quantize_int8 / dequantize_int8: x (R, C)
// float32 with C a multiple of 256 is cut into blocks of 256 consecutive
// elements of a row; per block
//     scale = max(max|x| / 127, 1e-12)
//     q     = clip(rint(x / scale), -127, 127)   (int8)
// and back, out = q * scale (float32).
//
// Numerics. The result is bit-equal to the plain version (and to the JAX
// package): max|x| is exact in any order, x / scale is an IEEE division
// (nvcc's default -prec-div=true; the library is built without
// --use_fast_math, and never multiplies by a reciprocal), rintf rounds half
// to even as torch.round and jnp.round do, and an all-zero block takes the
// 1e-12 scale, so its q is 0.
//
// Design. One warp per block of 256: lane i holds elements 8i .. 8i+7 (two
// float4 loads, one 16-byte store of 8 int8 for q; the reverse for the
// dequantize), the block's max|x| is a five-step xor-shuffle max, and lane
// 0 writes the scale. Eight warps to a CUDA block of 256 threads; a ragged
// last CUDA block masks whole warps.
//
// Bound on the H100 SXM: bytes. At the largest leaf of hymba-1.5b's
// gradient tree (embed.tok, 32256 x 1600 = 51.6M elements) the quantize
// moves 4 + 1 + 4/256 bytes an element, 259 MB: 0.077 ms at 3.35 TB/s; the
// dequantize the same.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;        // elements per quantization block
constexpr int kThreads = 256;      // 8 warps, one quantization block each
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    quantize_int8_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ scales, long long n_blocks) {
  const long long blk =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (blk >= n_blocks) return;  // whole warps only
  const float* src = x + blk * kBlock + lane * 8;
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = fmaxf(amax / 127.f, 1e-12f);
  union {
    int8_t b[8];
    uint2 u;
  } out;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    out.b[i] = static_cast<int8_t>(
        fminf(fmaxf(rintf(v[i] / scale), -127.f), 127.f));
  *reinterpret_cast<uint2*>(q + blk * kBlock + lane * 8) = out.u;
  if (lane == 0) scales[blk] = scale;
}

__global__ void __launch_bounds__(kThreads)
    dequantize_int8_kernel(const int8_t* __restrict__ q,
                           const float* __restrict__ scales,
                           float* __restrict__ out, long long n_blocks) {
  const long long blk =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (blk >= n_blocks) return;
  const float scale = scales[blk];
  union {
    int8_t b[8];
    uint2 u;
  } in;
  in.u = *reinterpret_cast<const uint2*>(q + blk * kBlock + lane * 8);
  float* dst = out + blk * kBlock + lane * 8;
  *reinterpret_cast<float4*>(dst) =
      make_float4(in.b[0] * scale, in.b[1] * scale, in.b[2] * scale,
                  in.b[3] * scale);
  *reinterpret_cast<float4*>(dst + 4) =
      make_float4(in.b[4] * scale, in.b[5] * scale, in.b[6] * scale,
                  in.b[7] * scale);
}

unsigned grid_for(long long n_blocks) {
  return static_cast<unsigned>((n_blocks + kWarps - 1) / kWarps);
}

}  // namespace

extern "C" {

// Launches the quantize of n_blocks blocks of 256 float32 on `stream`:
// x (n_blocks * 256) float32, 16-byte aligned; q (n_blocks * 256) int8,
// 8-byte aligned; scales (n_blocks) float32. Returns the cudaError_t of
// the launch.
int quantize_int8_launch(const void* x, void* q, void* scales,
                         long long n_blocks, void* stream) {
  if (n_blocks <= 0) return 0;
  quantize_int8_kernel<<<grid_for(n_blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scales), n_blocks);
  return static_cast<int>(cudaGetLastError());
}

// Launches the dequantize of n_blocks blocks on `stream`: q int8 and
// scales float32 as above, out (n_blocks * 256) float32, 16-byte aligned.
int dequantize_int8_launch(const void* q, const void* scales, void* out,
                           long long n_blocks, void* stream) {
  if (n_blocks <= 0) return 0;
  dequantize_int8_kernel<<<grid_for(n_blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out), n_blocks);
  return static_cast<int>(cudaGetLastError());
}

const char* quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
