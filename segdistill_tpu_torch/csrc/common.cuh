// Helpers shared by the loss kernels (group_kl.cu, seg_ce.cu, pixel_kl.cu):
// dtype conversion, torch's bilinear taps (align_corners=False), the bounds
// of the outputs that read one source index (for the gather backward), and
// block-wide sums and maxima. Blocks have kThreads threads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace segdistill {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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
  return __float2bfloat16(v);
}

// One axis of a bilinear tap: out index dst reads source i0 with weight
// 1 - f and i1 with weight f (torch's area_pixel_compute_source_index).
struct Tap {
  int i0;
  int i1;
  float f;
};

__device__ __forceinline__ Tap tap(int dst, int in, int out) {
  const float scale = static_cast<float>(in) / static_cast<float>(out);
  const float src =
      fmaxf((static_cast<float>(dst) + 0.5f) * scale - 0.5f, 0.0f);
  Tap t;
  t.i0 = min(static_cast<int>(src), in - 1);
  t.i1 = min(t.i0 + 1, in - 1);
  t.f = src - static_cast<float>(t.i0);
  return t;
}

// Weight of source index i in output index dst's tap (0 if it does not
// read i; both weights when i0 == i1 at the last source index).
__device__ __forceinline__ float tap_weight(const Tap& t, int i) {
  return (t.i0 == i ? 1.0f - t.f : 0.0f) + (t.i1 == i ? t.f : 0.0f);
}

// An output index at or below the first one whose tap reads source i.
// Outputs before it have i0 <= i - 2 (their source position is at most
// i - 1 - 2 * in / out), so they cannot read i; the tap's i0 grows with
// dst, so a scan from here can stop at the first i0 > i.
__device__ __forceinline__ int first_reader(int i, int in, int out) {
  const float scale = static_cast<float>(in) / static_cast<float>(out);
  const float est = (static_cast<float>(i) - 0.5f) / scale - 0.5f;
  return max(static_cast<int>(floorf(est)) - 2, 0);
}

// Bilinear value of a (h, w) plane at one output position.
template <typename T>
__device__ __forceinline__ float bilerp(const T* __restrict__ p, int w,
                                        const Tap& ty, const Tap& tx) {
  const T* r0 = p + static_cast<long long>(ty.i0) * w;
  const T* r1 = p + static_cast<long long>(ty.i1) * w;
  const float gx = 1.0f - tx.f;
  const float top = gx * to_f32(r0[tx.i0]) + tx.f * to_f32(r0[tx.i1]);
  const float bot = gx * to_f32(r1[tx.i0]) + tx.f * to_f32(r1[tx.i1]);
  return (1.0f - ty.f) * top + ty.f * bot;
}

// In-place block reductions of N values per thread; the result is valid
// in thread 0. Every thread of the block must call them.
template <typename A, int N>
__device__ __forceinline__ void block_sum(A (&v)[N]) {
  __shared__ A sh[N][kWarps];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[n] += __shfl_down_sync(0xffffffffu, v[n], off);
    if (lane == 0) sh[n][wid] = v[n];
  }
  __syncthreads();
  if (wid == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      v[n] = lane < kWarps ? sh[n][lane] : A(0);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v[n] += __shfl_down_sync(0xffffffffu, v[n], off);
    }
  }
}

template <int N>
__device__ __forceinline__ void block_max(float (&v)[N]) {
  __shared__ float sh[N][kWarps];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[n] = fmaxf(v[n], __shfl_down_sync(0xffffffffu, v[n], off));
    if (lane == 0) sh[n][wid] = v[n];
  }
  __syncthreads();
  if (wid == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      v[n] = lane < kWarps ? sh[n][lane] : -INFINITY;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v[n] = fmaxf(v[n], __shfl_down_sync(0xffffffffu, v[n], off));
    }
  }
}

}  // namespace segdistill
