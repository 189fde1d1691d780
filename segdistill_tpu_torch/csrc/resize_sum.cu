// K1: multi-scale bilinear upsample-and-sum for Hopper (sm_90a).
//
// Replaces segdistill_tpu/ops/pallas/resize_sum.py::fused_resize_sum, the
// SegFormer head's "upsample K feature maps to one grid and add them".
//
//   out[b, y, x, c] = sum_k bilinear(parts[k], y, x)[b, c]
//
// with torch F.interpolate(mode='bilinear', align_corners=False) taps:
// src = (dst + 0.5) * in / out - 0.5, clamped at 0 and at in - 1. Lerps and
// the sum over parts run in fp32; the result is stored once in the parts'
// dtype. Any ratio works, integer or not.
//
// What bounds it: memory traffic. At the B0 head (batch 8, E = 256, bf16)
// the output is 67 MB and the parts a few MB, which stay in L2; each
// 16-byte store needs four 16-byte tap loads per part, served by L1/L2.
// So one thread owns one 16-byte vector of channels at one (b, y, x): channel
// is fastest across threads, every load and the one store are 16 bytes and
// coalesced, and the output is written exactly once. The grid is (row of
// x * channel vectors, y, b), so a thread finds its place with 32-bit
// arithmetic. The TPU kernel's phase-plane and sub-plane machinery is not
// needed here: the taps are a few integer operations per thread.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxParts = 8;
constexpr int kThreads = 256;

struct Parts {
  const void* ptr[kMaxParts];
  int h[kMaxParts];
  int w[kMaxParts];
  int n;
};

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

// VEC elements moved as one aligned load or store.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// torch's area_pixel_compute_source_index for align_corners=False.
__device__ __forceinline__ void taps(int dst, int in, int out, int& i0,
                                     int& i1, float& frac) {
  const float scale = static_cast<float>(in) / static_cast<float>(out);
  const float src =
      fmaxf((static_cast<float>(dst) + 0.5f) * scale - 0.5f, 0.0f);
  i0 = min(static_cast<int>(src), in - 1);
  i1 = min(i0 + 1, in - 1);
  frac = src - static_cast<float>(i0);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    resize_sum_kernel(Parts parts, T* __restrict__ out, int H, int W,
                      int C) {
  using P = Pack<T, VEC>;
  // grid (row of W * C/VEC vectors, y, b): 32-bit index math only
  const int cvecs = C / VEC;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= W * cvecs) return;
  const int x = t / cvecs;
  const int cv = t - x * cvecs;
  const int y = blockIdx.y;
  const int b = blockIdx.z;

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;

#pragma unroll
  for (int k = 0; k < kMaxParts; ++k) {
    if (k < parts.n) {
      const int h = parts.h[k];
      const int w = parts.w[k];
      int y0, y1, x0, x1;
      float fy, fx;
      taps(y, h, H, y0, y1, fy);
      taps(x, w, W, x0, x1, fx);
      const T* base = static_cast<const T*>(parts.ptr[k]) +
                      static_cast<long long>(b) * h * w * C + cv * VEC;
      const P p00 = *reinterpret_cast<const P*>(
          base + static_cast<long long>(y0 * w + x0) * C);
      const P p01 = *reinterpret_cast<const P*>(
          base + static_cast<long long>(y0 * w + x1) * C);
      const P p10 = *reinterpret_cast<const P*>(
          base + static_cast<long long>(y1 * w + x0) * C);
      const P p11 = *reinterpret_cast<const P*>(
          base + static_cast<long long>(y1 * w + x1) * C);
      const float gx = 1.0f - fx;
      const float gy = 1.0f - fy;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float top = gx * to_f32(p00.v[i]) + fx * to_f32(p01.v[i]);
        const float bot = gx * to_f32(p10.v[i]) + fx * to_f32(p11.v[i]);
        acc[i] += gy * top + fy * bot;
      }
    }
  }

  P o;
#pragma unroll
  for (int i = 0; i < VEC; ++i) o.v[i] = from_f32<T>(acc[i]);
  const long long row = static_cast<long long>(b) * H + y;
  *reinterpret_cast<P*>(out + (row * W + x) * C + cv * VEC) = o;
}

template <typename T, int VEC>
void launch(const Parts& parts, void* out, int B, int H, int W, int C,
            cudaStream_t stream) {
  const int row = W * (C / VEC);
  const dim3 grid((row + kThreads - 1) / kThreads, H, B);
  resize_sum_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      parts, static_cast<T*>(out), H, W, C);
}

}  // namespace

// ptrs/hs/ws: host arrays of n_parts entries. dtype: 0 float32, 1 bfloat16.
// vec: 16 bytes' worth of elements (4 float32, 8 bfloat16); the caller
// guarantees C % vec == 0 and 16-byte-aligned base pointers.
extern "C" int resize_sum_fwd(const void* const* ptrs, const int* hs,
                              const int* ws, int n_parts, void* out, int B,
                              int H, int W, int C, int dtype, int vec,
                              void* stream) {
  if (n_parts < 1 || n_parts > kMaxParts || B < 1 || B > 65535 || H < 1 ||
      H > 65535 || W < 1 || C < 1 ||
      static_cast<long long>(W) * C > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Parts parts = {};
  parts.n = n_parts;
  for (int k = 0; k < n_parts; ++k) {
    if (hs[k] < 1 || ws[k] < 1 ||
        static_cast<long long>(hs[k]) * ws[k] > 0x7fffffffLL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    parts.ptr[k] = ptrs[k];
    parts.h[k] = hs[k];
    parts.w[k] = ws[k];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4 && C % 4 == 0) {
    launch<float, 4>(parts, out, B, H, W, C, s);
  } else if (dtype == 1 && vec == 8 && C % 8 == 0) {
    launch<__nv_bfloat16, 8>(parts, out, B, H, W, C, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
