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
// What it is bound by: bytes, the output above all: 67 MB at the B0 head
// (batch 8, E = 256, bf16) and 201 MB at the B3 teacher's (E = 768),
// against a few MB of parts, which stay in L2. One thread owns one 16-byte
// vector of channels at one output column (channel fastest across threads:
// every load and store is 16 bytes and coalesced) and walks kRows output
// rows of it. Per part it keeps the x-lerped values of the two source rows
// it stands between (top, and the next row less top) in registers (the
// number of parts is a template argument), and loads and x-lerps a source
// row only when that part's y tap moves on, the parts' loads independent of
// each other; the block's y taps are found once, into a table in shared
// memory. So a stored vector costs one FMA a channel and part, and at the
// head's ratios (2, 4, 8) ~2.5 sixteen-byte loads in all, where a thread per
// stored vector took 12 (4 a part) from L1/L2. Each row's sum is stored as
// soon as it is complete, once, with a streaming store (no kernel reads the
// output from L2). The grid is (row of x * channel vectors, group of kRows
// rows, b), so a thread finds its place with 32-bit arithmetic. The TPU
// kernel's phase-plane and sub-plane machinery is not needed here. Where it
// stands: fp32 at ~1.5x its bound; bf16 at ~2.3x, in about the time of
// fp32 for the same number of elements (PERF.md), so per-element work, not
// bytes, holds bf16 back.
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

// Output rows a thread walks (8 and 32 were slower: tools/sweep_fwd.py).
constexpr int kRows = 16;

// The x-lerp of one source row at a thread's column: p0, p1 its two taps.
template <typename T, int VEC>
__device__ __forceinline__ void xlerp(const T* p0, const T* p1, float fx,
                                      float (&v)[VEC]) {
  using P = Pack<T, VEC>;
  const P a = *reinterpret_cast<const P*>(p0);
  const P b = *reinterpret_cast<const P*>(p1);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float a0 = to_f32(a.v[i]);
    v[i] = fmaf(fx, to_f32(b.v[i]) - a0, a0);
  }
}

// One part's walk down a thread's column: c0, c1 its two x taps' columns
// of the part's rows (pitch apart), top source row `at` x-lerped and d row
// min(at + 1, h - 1) less top, so that a value is top + fy * d.
template <typename T, int VEC>
struct PartWalk {
  const T* c0;
  const T* c1;
  long long pitch;
  float fx;
  int h;
  int at;
  float top[VEC], d[VEC];

  __device__ __forceinline__ void move_to(int a0, int a1) {
    if (a0 == at) return;
    if (a0 == at + 1) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) top[i] += d[i];
    } else {
      xlerp<T, VEC>(c0 + a0 * pitch, c1 + a0 * pitch, fx, top);
    }
    float bot[VEC];
    xlerp<T, VEC>(c0 + a1 * pitch, c1 + a1 * pitch, fx, bot);
#pragma unroll
    for (int i = 0; i < VEC; ++i) d[i] = bot[i] - top[i];
    at = a0;
  }
};

// NP parts (a template argument, so that every part's walk stays in
// registers): per output row, each part's walk moves on (their loads are
// independent of each other) and adds its value to the row's sum, which is
// stored at once.
template <typename T, int VEC, int NP>
__global__ void __launch_bounds__(kThreads)
    resize_sum_kernel(Parts parts, T* __restrict__ out, int H, int W,
                      int C) {
  using P = Pack<T, VEC>;
  // grid (row of W * C/VEC vectors, group of kRows rows, b): 32-bit index
  // math only
  const int cvecs = C / VEC;
  const int y0 = blockIdx.y * kRows;
  // each part's y taps of the block's rows, found once: (source row as
  // float bits, fraction)
  __shared__ float2 ytab[NP][kRows];
  if (threadIdx.x < NP * kRows) {
    const int k = threadIdx.x / kRows, r = threadIdx.x - k * kRows;
    int a0, a1;
    float fy;
    taps(min(y0 + r, H - 1), parts.h[k], H, a0, a1, fy);
    ytab[k][r] = make_float2(__int_as_float(a0), fy);
  }
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= W * cvecs) return;
  const int x = t / cvecs;
  const int cv = t - x * cvecs;
  const int b = blockIdx.z;

  PartWalk<T, VEC> walk[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int h = parts.h[k];
    const int w = parts.w[k];
    int x0, x1;
    taps(x, w, W, x0, x1, walk[k].fx);
    const T* base = static_cast<const T*>(parts.ptr[k]) +
                    static_cast<long long>(b) * h * w * C + cv * VEC;
    walk[k].c0 = base + static_cast<long long>(x0) * C;
    walk[k].c1 = base + static_cast<long long>(x1) * C;
    walk[k].pitch = static_cast<long long>(w) * C;
    walk[k].h = h;
    walk[k].at = -2;
  }
  T* o_row = out + ((static_cast<long long>(b) * H + y0) * W + x) * C +
             cv * VEC;
  const long long o_pitch = static_cast<long long>(W) * C;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (y0 + r >= H) break;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const float2 yt = ytab[k][r];
      const int a0 = __float_as_int(yt.x);
      walk[k].move_to(a0, min(a0 + 1, walk[k].h - 1));
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc[i] += fmaf(yt.y, walk[k].d[i], walk[k].top[i]);
    }
    P o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) o.v[i] = from_f32<T>(acc[i]);
    // a streaming store (evict first): no kernel reads the output from L2
    __stcs(reinterpret_cast<int4*>(o_row + r * o_pitch),
           *reinterpret_cast<const int4*>(&o));
  }
}

template <typename T, int VEC, int NP>
void launch_parts(const Parts& parts, void* out, int B, int H, int W, int C,
                  cudaStream_t stream) {
  const int row = W * (C / VEC);
  const dim3 grid((row + kThreads - 1) / kThreads, (H + kRows - 1) / kRows,
                  B);
  resize_sum_kernel<T, VEC, NP><<<grid, kThreads, 0, stream>>>(
      parts, static_cast<T*>(out), H, W, C);
}

template <typename T, int VEC>
void launch(const Parts& parts, void* out, int B, int H, int W, int C,
            cudaStream_t stream) {
  switch (parts.n) {
    case 1: return launch_parts<T, VEC, 1>(parts, out, B, H, W, C, stream);
    case 2: return launch_parts<T, VEC, 2>(parts, out, B, H, W, C, stream);
    case 3: return launch_parts<T, VEC, 3>(parts, out, B, H, W, C, stream);
    case 4: return launch_parts<T, VEC, 4>(parts, out, B, H, W, C, stream);
    case 5: return launch_parts<T, VEC, 5>(parts, out, B, H, W, C, stream);
    case 6: return launch_parts<T, VEC, 6>(parts, out, B, H, W, C, stream);
    case 7: return launch_parts<T, VEC, 7>(parts, out, B, H, W, C, stream);
    default: return launch_parts<T, VEC, 8>(parts, out, B, H, W, C, stream);
  }
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
