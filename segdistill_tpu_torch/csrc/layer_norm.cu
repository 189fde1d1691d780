// K10 and K11: LayerNorm over the last axis for Hopper (sm_90a), forward
// and backward.
//
// Replaces segdistill_tpu/ops/pallas/layer_norm.py::fused_layer_norm (the
// pallas_calls at layer_norm.py:113, forward, and :144, backward).
//
// For each row of x (rows, C), in fp32 whatever the storage type:
//
//   mu   = mean(x)            var = mean((x - mu)^2)      (centred first)
//   xhat = (x - mu) * rsqrt(var + eps)
//   y    = xhat * w + b                                   (x's dtype)
//   dx   = rstd * (g - mean(g) - xhat * mean(g * xhat)),  g = dy * w
//   dw   = sum over rows of dy * xhat,  db = sum over rows of dy
//
// What bounds it: bytes. The forward reads x and writes y once (2 B per
// element and direction in bf16), the backward reads x and dy and writes
// dx; the arithmetic is a few tens of operations per element. So a row is
// loaded once, as 16-byte vectors, and stays in registers through both
// reductions; nothing but y (or dx and the small partials) is written.
//
// A row belongs to a group of G lanes of one warp, G in {4, 8, 16, 32}
// chosen by C so that a lane holds at most 16 values (32 at C > 512): at
// C = 32 in bf16 a row is four 16-byte vectors, so eight rows share a warp
// and no lane idles, where one warp per row would leave 28 of 32 without a
// load. Widths that are not a power of two (160, 320) mask the vectors past
// the row's end. Rows may be strided (the row stride is an argument); the
// last axis is contiguous and every row starts on a 16-byte boundary (the
// wrapper copies a tensor whose last axis is strided).
//
// The backward recomputes mu and rstd from x, as the TPU kernel does: x is
// read for xhat anyway, two more group reductions cost no memory traffic,
// and the forward then saves nothing but its inputs, so the frozen
// teacher's forward and the student's are the same launch. Each block
// walks rows in a grid-stride loop with per-thread dw/db sums, adds them
// over its row groups through shared memory in group order and writes one
// (C,) partial each; a second small kernel of the same call sums the
// partials over the blocks in block order (the TPU kernel leaves that sum
// to XLA). No atomics: the gradients are deterministic.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// blocks of the backward: 4 per SM of an H100, each with its own partials
constexpr int kMaxBwdBlocks = 528;

// 16-byte vectors of T, widened to fp32 registers.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p,
                                               const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

// N consecutive fp32 parameters (N = 4 or 8), 16-byte aligned.
template <int N>
__device__ __forceinline__ void load_param(const float* __restrict__ p,
                                           float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 t = *reinterpret_cast<const float4*>(p + i);
    v[i] = t.x;
    v[i + 1] = t.y;
    v[i + 2] = t.z;
    v[i + 3] = t.w;
  }
}

// Sum over the aligned group of G lanes that holds one row; every lane of
// the warp calls it, and every lane of the group gets the sum.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Loads lane's vectors of one row into v (zeros past the row's end or for
// an inactive row), subtracts the mean in place and returns rstd.
template <typename T, int G, int NCH>
__device__ __forceinline__ float centre(const T* __restrict__ row, bool active,
                                        int lane, int nvec, int C, float eps,
                                        float (&v)[NCH][Vec<T>::N]) {
  constexpr int V = Vec<T>::N;
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = lane + i * G;
    if (active && c < nvec) {
      Vec<T>::load(row + c * V, v[i]);
#pragma unroll
      for (int j = 0; j < V; ++j) sum += v[i][j];
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[i][j] = 0.0f;
    }
  }
  const float inv_c = 1.0f / static_cast<float>(C);
  const float mu = group_sum<G>(sum) * inv_c;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    if (lane + i * G < nvec) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        v[i][j] -= mu;
        sq += v[i][j] * v[i][j];
      }
    }
  }
  return rsqrtf(group_sum<G>(sq) * inv_c + eps);
}

template <typename T, int G, int NCH>
__global__ void __launch_bounds__(kThreads)
    ln_fwd(const T* __restrict__ x, long long sx, const float* __restrict__ w,
           const float* __restrict__ b, int rows, int C, float eps,
           T* __restrict__ y) {
  constexpr int V = Vec<T>::N;
  constexpr int kGroups = kThreads / G;
  const int lane = threadIdx.x % G;
  const long long r =
      static_cast<long long>(blockIdx.x) * kGroups + threadIdx.x / G;
  const bool active = r < rows;
  const int nvec = C / V;
  float v[NCH][V];
  const float rstd =
      centre<T, G, NCH>(x + r * sx, active, lane, nvec, C, eps, v);
  if (!active) return;
  T* out = y + r * C;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = lane + i * G;
    if (c < nvec) {
      float wv[V], bv[V];
      load_param<V>(w + c * V, wv);
      load_param<V>(b + c * V, bv);
#pragma unroll
      for (int j = 0; j < V; ++j) v[i][j] = v[i][j] * rstd * wv[j] + bv[j];
      Vec<T>::store(out + c * V, v[i]);
    }
  }
}

template <typename T, int G, int NCH>
__global__ void __launch_bounds__(kThreads)
    ln_bwd(const T* __restrict__ x, long long sx, const T* __restrict__ dy,
           long long sdy, const float* __restrict__ w, int rows, int C,
           float eps, T* __restrict__ dx, float* __restrict__ part) {
  constexpr int V = Vec<T>::N;
  constexpr int kGroups = kThreads / G;
  // one (kGroups, C) plane, C <= G * NCH * V
  __shared__ float sh[kThreads * NCH * V];
  const int lane = threadIdx.x % G;
  const int group = threadIdx.x / G;
  const int nvec = C / V;
  const float inv_c = 1.0f / static_cast<float>(C);

  float wv[NCH][V], dw[NCH][V], db[NCH][V];
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = lane + i * G;
    if (c < nvec) load_param<V>(w + c * V, wv[i]);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (c >= nvec) wv[i][j] = 0.0f;
      dw[i][j] = 0.0f;
      db[i][j] = 0.0f;
    }
  }

  // every thread takes the same number of turns: the group sums are
  // warp-wide shuffles
  const long long step = static_cast<long long>(gridDim.x) * kGroups;
  for (long long base = static_cast<long long>(blockIdx.x) * kGroups;
       base < rows; base += step) {
    const long long r = base + group;
    const bool active = r < rows;
    float xh[NCH][V], g[NCH][V];
    const float rstd =
        centre<T, G, NCH>(x + r * sx, active, lane, nvec, C, eps, xh);
    float sg = 0.0f, sgx = 0.0f;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int c = lane + i * G;
      if (active && c < nvec) {
        Vec<T>::load(dy + r * sdy + c * V, g[i]);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          xh[i][j] *= rstd;
          dw[i][j] += g[i][j] * xh[i][j];
          db[i][j] += g[i][j];
          g[i][j] *= wv[i][j];
          sg += g[i][j];
          sgx += g[i][j] * xh[i][j];
        }
      }
    }
    const float gm = group_sum<G>(sg) * inv_c;
    const float gxm = group_sum<G>(sgx) * inv_c;
    if (active) {
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const int c = lane + i * G;
        if (c < nvec) {
#pragma unroll
          for (int j = 0; j < V; ++j)
            g[i][j] = rstd * (g[i][j] - gm - xh[i][j] * gxm);
          Vec<T>::store(dx + r * C + c * V, g[i]);
        }
      }
    }
  }

  // the block's partial dw, then db: over its row groups, in group order
#pragma unroll
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int c = lane + i * G;
      if (c < nvec) {
#pragma unroll
        for (int j = 0; j < V; ++j)
          sh[group * C + c * V + j] = which == 0 ? dw[i][j] : db[i][j];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float s = 0.0f;
      for (int k = 0; k < kGroups; ++k) s += sh[k * C + c];
      part[(static_cast<long long>(which) * gridDim.x + blockIdx.x) * C + c] =
          s;
    }
    __syncthreads();
  }
}

// dwdb[which][c] = sum over the blocks, in block order, of
// part[which][block][c]; one thread per (which, c).
__global__ void __launch_bounds__(kThreads)
    ln_sum_partials(const float* __restrict__ part, int blocks, int C,
                    float* __restrict__ dwdb) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= 2 * C) return;
  const int which = i / C;
  const int c = i - which * C;
  const float* p = part + static_cast<long long>(which) * blocks * C + c;
  float s = 0.0f;
#pragma unroll 8
  for (int k = 0; k < blocks; ++k) s += p[static_cast<long long>(k) * C];
  dwdb[i] = s;
}

// Vectors of T per lane that make 16 values: the widths up to 16 * G.
template <typename T>
constexpr int base_nch() {
  return 16 / Vec<T>::N;
}

template <typename T, int G, int NCH>
void launch_fwd(const void* x, long long sx, const float* w, const float* b,
                int rows, int C, float eps, void* y, cudaStream_t s) {
  constexpr int kGroups = kThreads / G;
  const unsigned blocks = (rows + kGroups - 1) / kGroups;
  ln_fwd<T, G, NCH><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), sx, w, b, rows, C, eps, static_cast<T*>(y));
}

template <typename T, int G, int NCH>
void launch_bwd(const void* x, long long sx, const void* dy, long long sdy,
                const float* w, int rows, int C, float eps, void* dx,
                float* part, int blocks, cudaStream_t s) {
  ln_bwd<T, G, NCH><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), sx, static_cast<const T*>(dy), sdy, w, rows,
      C, eps, static_cast<T*>(dx), part);
}

// Lanes per row for width C: the fewest of 4, 8, 16, 32 that keep a lane
// at 16 values; 0 with wide = true for 512 < C <= 1024 (32 lanes, 32
// values); -1 for an unsupported width.
int lanes_for(int C, bool* wide) {
  *wide = false;
  if (C <= 0 || C % 8 != 0) return -1;
  for (int g = 4; g <= 32; g *= 2)
    if (C <= 16 * g) return g;
  *wide = true;
  return C <= 1024 ? 32 : -1;
}

bool bad_rows(int rows, long long stride, int C) {
  return rows <= 0 || stride < C;
}

template <typename T>
bool dispatch_fwd(const void* x, long long sx, const float* w, const float* b,
                  int rows, int C, float eps, void* y, cudaStream_t s) {
  constexpr int B = base_nch<T>();
  bool wide;
  switch (lanes_for(C, &wide)) {
    case 4: launch_fwd<T, 4, B>(x, sx, w, b, rows, C, eps, y, s); break;
    case 8: launch_fwd<T, 8, B>(x, sx, w, b, rows, C, eps, y, s); break;
    case 16: launch_fwd<T, 16, B>(x, sx, w, b, rows, C, eps, y, s); break;
    case 32:
      if (wide) launch_fwd<T, 32, 2 * B>(x, sx, w, b, rows, C, eps, y, s);
      else launch_fwd<T, 32, B>(x, sx, w, b, rows, C, eps, y, s);
      break;
    default: return false;
  }
  return true;
}

template <typename T>
bool dispatch_bwd(const void* x, long long sx, const void* dy, long long sdy,
                  const float* w, int rows, int C, float eps, void* dx,
                  float* part, int blocks, cudaStream_t s) {
  constexpr int B = base_nch<T>();
  bool wide;
  switch (lanes_for(C, &wide)) {
    case 4:
      launch_bwd<T, 4, B>(x, sx, dy, sdy, w, rows, C, eps, dx, part, blocks,
                          s);
      break;
    case 8:
      launch_bwd<T, 8, B>(x, sx, dy, sdy, w, rows, C, eps, dx, part, blocks,
                          s);
      break;
    case 16:
      launch_bwd<T, 16, B>(x, sx, dy, sdy, w, rows, C, eps, dx, part, blocks,
                           s);
      break;
    case 32:
      if (wide)
        launch_bwd<T, 32, 2 * B>(x, sx, dy, sdy, w, rows, C, eps, dx, part,
                                 blocks, s);
      else
        launch_bwd<T, 32, B>(x, sx, dy, sdy, w, rows, C, eps, dx, part,
                             blocks, s);
      break;
    default: return false;
  }
  return true;
}

// Blocks the backward runs for (rows, C), each writing one (C,) partial of
// dw and of db; 0 for an unsupported width. The wrapper sizes `part` by the
// same rule.
int bwd_blocks(int rows, int C) {
  bool wide;
  const int g = lanes_for(C, &wide);
  if (g <= 0 || rows <= 0) return 0;
  const int groups = kThreads / g;
  const long long blocks = (static_cast<long long>(rows) + groups - 1) / groups;
  return static_cast<int>(blocks < kMaxBwdBlocks ? blocks : kMaxBwdBlocks);
}

}  // namespace


// x: rows of C values in float32 (dtype 0) or bfloat16 (1), row r at
// x + r * sx elements, every row 16-byte aligned; w, b: (C,) float32.
// y: (rows, C) contiguous in x's dtype. C % 8 == 0 and C <= 1024.
extern "C" int layer_norm_fwd(const void* x, long long sx, const float* w,
                              const float* b, int rows, int C, float eps,
                              int dtype, void* y, void* stream) {
  if (bad_rows(rows, sx, C)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == 0) {
    ok = dispatch_fwd<float>(x, sx, w, b, rows, C, eps, y, s);
  } else if (dtype == 1) {
    ok = dispatch_fwd<__nv_bfloat16>(x, sx, w, b, rows, C, eps, y, s);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// x, dy: rows of C values with row strides sx, sdy (elements), as above.
// dx: (rows, C) contiguous in x's dtype. part: scratch, (2, blocks, C)
// float32 with blocks = min(ceil(rows / (256 / lanes)), 528), lanes as
// lanes_for(C): each block's sum of dy * xhat (plane 0) and of dy (plane 1)
// over its rows. dwdb: (2, C) float32, dweight then dbias.
extern "C" int layer_norm_bwd(const void* x, long long sx, const void* dy,
                              long long sdy, const float* w, int rows, int C,
                              float eps, int dtype, void* dx, float* part,
                              int blocks, float* dwdb, void* stream) {
  if (bad_rows(rows, sx, C) || bad_rows(rows, sdy, C) ||
      blocks != bwd_blocks(rows, C)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == 0) {
    ok = dispatch_bwd<float>(x, sx, dy, sdy, w, rows, C, eps, dx, part, blocks,
                             s);
  } else if (dtype == 1) {
    ok = dispatch_bwd<__nv_bfloat16>(x, sx, dy, sdy, w, rows, C, eps, dx, part,
                                     blocks, s);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  ln_sum_partials<<<(2 * C + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      part, blocks, C, dwdb);
  return static_cast<int>(cudaGetLastError());
}
