// K2: MiT spatial-reduction attention, forward, for Hopper (sm_90a).
//
// Replaces segdistill_tpu/ops/pallas/sra_attn.py::fused_sra_attention:
//
//   out = softmax(q @ k^T * scale) @ v,   q (B, h, N, d), k/v (B, h, M, d)
//
// Scores, the softmax statistics and the output sum are fp32 in registers;
// the (N, M) score plane never reaches device memory; the output is stored
// in the input dtype.
//
// What bounds it: arithmetic. At B0 stage 1 (512^2 input) N = 16384 query
// rows attend to M = 256 keys with d = 32, so each row does 4*M*d = 32k
// FLOPs against 2*d*2 bytes of its own traffic; K/V (M*d) are shared by all
// rows of a head and stay in L2. This first version runs on CUDA cores:
// one block per (b*h, tile of 128 query rows), one thread per query row
// holding q and its output row in registers. K/V stream through shared
// memory in chunks of KC keys, fp32, and every thread reads the same key at
// the same time (a shared-memory broadcast). An online softmax (running max
// and sum, rescaled once per chunk) lets any M work; rows past N are masked,
// so any N works. mma.sync / wgmma / TMA are later work.
//
// Strides: q, k, v and out are addressed as (b, h, n) strides with a
// contiguous last dim, so the caller's head-split views need no copy.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 128;  // query rows (threads) per block

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

struct Strides {
  long long b, h, n;
};

template <typename T, int DMAX, int KC>
__global__ void __launch_bounds__(kRows)
    sra_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out, int heads,
                    int N, int M, int d, Strides qs, Strides ks, Strides vs,
                    Strides os, float scale) {
  __shared__ float k_s[KC][DMAX];
  __shared__ float v_s[KC][DMAX];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int hh = bh % heads;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool active = row < N;

  const T* q_row = q + b * qs.b + hh * qs.h + (active ? row : 0) * qs.n;
  const T* k_head = k + b * ks.b + hh * ks.h;
  const T* v_head = v + b * vs.b + hh * vs.h;

  float q_r[DMAX];
  float acc[DMAX];
#pragma unroll
  for (int i = 0; i < DMAX; ++i) {
    q_r[i] = (i < d) ? to_f32(q_row[i]) : 0.0f;
    acc[i] = 0.0f;
  }
  float m_run = -INFINITY;
  float l_run = 0.0f;

  for (int c0 = 0; c0 < M; c0 += KC) {
    const int kc = min(KC, M - c0);
    __syncthreads();  // the previous chunk has been consumed
    for (int e = threadIdx.x; e < KC * DMAX; e += kRows) {
      const int j = e / DMAX;
      const int col = e % DMAX;
      float kv = 0.0f, vv = 0.0f;
      if (j < kc && col < d) {
        kv = to_f32(k_head[(c0 + j) * ks.n + col]);
        vv = to_f32(v_head[(c0 + j) * vs.n + col]);
      }
      k_s[j][col] = kv;
      v_s[j][col] = vv;
    }
    __syncthreads();

    float s[KC];
    float c_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < DMAX; ++i) dot = fmaf(q_r[i], k_s[j][i], dot);
      s[j] = (j < kc) ? dot * scale : -INFINITY;
      c_max = fmaxf(c_max, s[j]);
    }
    const float m_new = fmaxf(m_run, c_max);  // finite: kc >= 1
    const float corr = expf(m_run - m_new);   // 0 on the first chunk
    l_run *= corr;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const float p = expf(s[j] - m_new);  // 0 for masked keys
      l_run += p;
#pragma unroll
      for (int i = 0; i < DMAX; ++i) acc[i] = fmaf(p, v_s[j][i], acc[i]);
    }
    m_run = m_new;
  }

  if (active) {
    T* o_row = out + b * os.b + hh * os.h + row * os.n;
    const float inv_l = 1.0f / l_run;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      if (i < d) o_row[i] = from_f32<T>(acc[i] * inv_l);
    }
  }
}

template <typename T, int DMAX, int KC>
void launch(const void* q, const void* k, const void* v, void* out, int B,
            int heads, int N, int M, int d, Strides qs, Strides ks,
            Strides vs, Strides os, float scale, cudaStream_t stream) {
  const dim3 grid((N + kRows - 1) / kRows, B * heads);
  sra_attn_kernel<T, DMAX, KC><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), heads, N, M, d, qs, ks,
      vs, os, scale);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int heads, int N, int M, int d, Strides qs, Strides ks,
             Strides vs, Strides os, float scale, cudaStream_t stream) {
  if (d <= 32) {
    launch<T, 32, 32>(q, k, v, out, B, heads, N, M, d, qs, ks, vs, os, scale,
                      stream);
  } else if (d <= 64) {
    launch<T, 64, 32>(q, k, v, out, B, heads, N, M, d, qs, ks, vs, os, scale,
                      stream);
  } else {
    launch<T, 128, 16>(q, k, v, out, B, heads, N, M, d, qs, ks, vs, os, scale,
                       stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides are in elements, for the (b, h, n) dims; the last dim is
// contiguous. dtype: 0 float32, 1 bfloat16. d <= 128 and d % 8 == 0.
extern "C" int sra_attn_fwd(const void* q, const void* k, const void* v,
                            void* out, int B, int heads, int N, int M, int d,
                            const long long* q_strides,
                            const long long* k_strides,
                            const long long* v_strides,
                            const long long* o_strides, float scale,
                            int dtype, void* stream) {
  if (B < 1 || heads < 1 || N < 1 || M < 1 || d < 8 || d > 128 || d % 8 ||
      static_cast<long long>(B) * heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs = {q_strides[0], q_strides[1], q_strides[2]};
  const Strides ks = {k_strides[0], k_strides[1], k_strides[2]};
  const Strides vs = {v_strides[0], v_strides[1], v_strides[2]};
  const Strides os = {o_strides[0], o_strides[1], o_strides[2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(q, k, v, out, B, heads, N, M, d, qs, ks, vs, os,
                           scale, s);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(q, k, v, out, B, heads, N, M, d, qs, ks,
                                   vs, os, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
