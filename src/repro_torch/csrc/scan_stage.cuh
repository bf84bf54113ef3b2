// Asynchronous staging of the selective scan's operands into shared
// memory, shared by the scan (ssm_scan.cu) and its backward
// (ssm_scan_bwd.cu).
//
// A block owns CPB adjacent channels [d0, d0 + CPB) of one batch row and
// walks time in stretches of S steps. Per stretch it copies, with
// cp.async, the per-channel operands (dt, x, dy: rows of Di values) and
// the per-step ones (B_t, C_t: rows of N values) into shared memory, while
// the previous stretch is computed. Steps past T and channels past Di are
// zero-filled (cp.async's source size 0), so a ragged stretch computes on
// zeros: with dt = 0 and B = 0 a step leaves the state as it was.
//
// cp.async moves 4, 8 or 16 bytes from an address aligned to that size.
// float32 operands go 4 bytes an element. A bfloat16 x row goes 4 bytes a
// pair from the pair-aligned element at or before the row's first channel,
// CPB + 2 elements in all, and is read back shifted by that element's
// parity (XRow::get); the pair that holds the tensor's last element copies
// only its first half.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace scan {

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most `Pending` of this thread's committed groups are in
// flight
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// One step's x values for CPB channels, in x's own type.
template <typename TX, int CPB>
struct XRow;

template <int CPB>
struct XRow<float, CPB> {
  float v[CPB];
  __device__ __forceinline__ float get(int c, int) const { return v[c]; }
};

template <int CPB>
struct XRow<__nv_bfloat16, CPB> {
  __nv_bfloat16 v[CPB + 2];
  __device__ __forceinline__ float get(int c, int shift) const {
    return __bfloat162float(v[c + shift]);
  }
};

// The shift XRow<bfloat16>::get reads row `row` with: the parity of its
// first channel's element, (row * Di + d0) & 1, for an even d0.
__device__ __forceinline__ int x_shift(long long row, int Di) {
  return static_cast<int>(row & Di & 1);
}

// dst[tt][c] = src[(row0 + tt) * stride + col0 + c] for tt < nt and
// c < n_valid; 0 elsewhere. W columns, S rows, NT threads (a multiple of
// W): thread tid copies column tid % W of every (NT / W)-th row, so its
// source address only steps by a row from one copy to the next, and a
// full stretch (nt = S) needs no test per copy.
template <int S, int W, int NT>
__device__ __forceinline__ void stage_rows(float (*dst)[W],
                                           const float* __restrict__ src,
                                           long long row0, int nt, int stride,
                                           long long col0, int n_valid,
                                           int tid) {
  static_assert(NT % W == 0 && S % (NT / W) == 0, "rows split evenly");
  constexpr int R = NT / W;
  const int c = tid % W, r = tid / W;
  const bool col_ok = c < n_valid;
  const float* g = col_ok ? src + (row0 + r) * stride + col0 + c : src;
  const int step = col_ok ? R * stride : 0;
  const int bytes = col_ok ? 4 : 0;
  if (nt >= S) {
#pragma unroll
    for (int k = 0; k < S / R; ++k, g += step)
      cp_async4(&dst[r + k * R][c], g, bytes);
  } else {
#pragma unroll
    for (int k = 0; k < S / R; ++k, g += step) {
      const bool ok = r + k * R < nt;
      cp_async4(&dst[r + k * R][c], ok ? g : src, ok ? bytes : 0);
    }
  }
}

template <int S, int CPB, int NT>
__device__ __forceinline__ void stage_x(XRow<float, CPB>* dst,
                                        const float* __restrict__ src,
                                        long long row0, int nt, int Di,
                                        int d0, long long, int tid) {
  stage_rows<S, CPB, NT>(reinterpret_cast<float (*)[CPB]>(dst), src, row0,
                         nt, Di, d0, Di - d0, tid);
}

// total: the number of elements of x, B * T * Di. Thread tid copies pair
// tid % CPB of every (NT / CPB)-th row, if the row has that many pairs.
// Only a stretch that is short or whose last pairs reach the tensor's end
// tests each copy.
template <int S, int CPB, int NT>
__device__ __forceinline__ void stage_x(XRow<__nv_bfloat16, CPB>* dst,
                                        const __nv_bfloat16* __restrict__ src,
                                        long long row0, int nt, int Di,
                                        int d0, long long total, int tid) {
  static_assert(NT % CPB == 0 && S % (NT / CPB) == 0, "rows split evenly");
  constexpr int kPairs = CPB / 2 + 1;  // pairs a row
  constexpr int R = NT / CPB;
  const int w = tid % CPB, r = tid / CPB;
  if (w >= kPairs) return;
  long long first = (row0 + r) * Di + d0;  // the row's first channel
  const long long rstep = static_cast<long long>(R) * Di;
  if (nt >= S && (row0 + S - 1) * Di + d0 + CPB + 2 <= total) {
#pragma unroll
    for (int k = 0; k < S / R; ++k, first += rstep)
      cp_async4(&dst[r + k * R].v[2 * w], src + (first & ~1LL) + 2 * w, 4);
  } else {
#pragma unroll
    for (int k = 0; k < S / R; ++k, first += rstep) {
      const long long e = (first & ~1LL) + 2 * w;
      const long long left = total - e;  // elements from e to the end
      const int bytes =
          r + k * R < nt ? (left >= 2 ? 4 : left == 1 ? 2 : 0) : 0;
      cp_async4(&dst[r + k * R].v[2 * w], bytes ? src + e : src, bytes);
    }
  }
}

}  // namespace scan
