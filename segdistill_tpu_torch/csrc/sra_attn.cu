// K2 and K9: MiT spatial-reduction attention for Hopper (sm_90a), forward
// and backward.
//
// K2 replaces segdistill_tpu/ops/pallas/sra_attn.py::fused_sra_attention
// (the pallas_call at sra_attn.py:78) and is the forward of
// sra_attention_train; K9 replaces that function's backward (the
// pallas_call at sra_attn.py:182):
//
//   out = softmax(q @ k^T * scale) @ v,   q (B, h, N, d), k/v (B, h, M, d)
//
// K2. Scores, the softmax statistics and the output sum are fp32 in
// registers; the (N, M) score plane never reaches device memory; the output
// is stored in the input dtype. For training it also stores each row's
// log-sum-exp of the scaled scores, and, for bf16 inputs, the output in fp32
// (the row term D of the backward is formed from it, as the plain version's
// autograd forms it from its fp32 product).
//
// What bounds K2: arithmetic. At B0 stage 1 (512^2 input) N = 16384 query
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
// K9, the flash-attention backward with the JAX kernel's math, P recomputed
// from q, k and the saved log-sum-exp, all sums in fp32:
//
//   P = exp(s q k^T - lse),  D = rowsum(dO o O),  dS = P o (dO v^T - D) s
//   dq = dS k,  dk = dS^T q,  dv = P^T dO
//
// Three launches. (1) One thread per query row, K/V streamed through shared
// memory as in K2: D for the row, then dq (q, dO and the dq sum in
// registers). (2) One thread per key row (k, v and the dk, dv sums in
// registers), the query rows of one split of N streamed through shared
// memory: each split writes fp32 partial dk, dv. At B0 stage 1 there are
// only B*h = 8 heads of M = 256 keys, 16 blocks, so N is split (~32 ways
// there) to fill the 132 SMs. (3) The partials are summed in a fixed order
// and stored in the inputs' dtype: no atomics, the gradients are
// deterministic, as the JAX kernel's sequential accumulation is. P and dS
// stay fp32 (the JAX kernel rounds them to the input dtype under bf16).
// Bound by CUDA-core FMAs like K2: 7*N*M*d per head against K2's 2*N*M*d.
//
// Strides: q, k, v, the outputs and the gradients are addressed as (b, h,
// n) strides with a contiguous last dim, so the caller's head-split views
// need no copy.
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
                    const T* __restrict__ v, T* __restrict__ out,
                    float* __restrict__ lse, float* __restrict__ out32,
                    int heads, int N, int M, int d, Strides qs, Strides ks,
                    Strides vs, Strides os, float scale) {
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
    const long long o_off = b * os.b + hh * os.h + row * os.n;
    const float inv_l = 1.0f / l_run;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      if (i < d) out[o_off + i] = from_f32<T>(acc[i] * inv_l);
    }
    if (out32 != nullptr) {
#pragma unroll
      for (int i = 0; i < DMAX; ++i) {
        if (i < d) out32[o_off + i] = acc[i] * inv_l;
      }
    }
    if (lse != nullptr) {
      lse[static_cast<long long>(bh) * N + row] = m_run + logf(l_run);
    }
  }
}

// K9 (1): dq and D = rowsum(dO o O) of one query row per thread.
template <typename T, int DMAX, int KC>
__global__ void __launch_bounds__(kRows)
    sra_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ o,
               const T* __restrict__ g, const float* __restrict__ lse,
               float* __restrict__ dsum, T* __restrict__ dq, int heads,
               int N, int M, int d, Strides qs, Strides ks, Strides vs,
               Strides os, Strides gs, Strides dqs, float scale) {
  __shared__ float k_s[KC][DMAX];
  __shared__ float v_s[KC][DMAX];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int hh = bh % heads;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool active = row < N;
  const int r = active ? row : 0;

  const T* q_row = q + b * qs.b + hh * qs.h + r * qs.n;
  const float* o_row = o + b * os.b + hh * os.h + r * os.n;
  const T* g_row = g + b * gs.b + hh * gs.h + r * gs.n;
  const T* k_head = k + b * ks.b + hh * ks.h;
  const T* v_head = v + b * vs.b + hh * vs.h;

  float q_r[DMAX];
  float g_r[DMAX];
  float acc[DMAX];
  float dsum_r = 0.0f;
#pragma unroll
  for (int i = 0; i < DMAX; ++i) {
    q_r[i] = (i < d) ? to_f32(q_row[i]) : 0.0f;
    g_r[i] = (i < d) ? to_f32(g_row[i]) : 0.0f;
    if (i < d) dsum_r = fmaf(g_r[i], o_row[i], dsum_r);
    acc[i] = 0.0f;
  }
  const float lse_r = lse[static_cast<long long>(bh) * N + r];

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

#pragma unroll 4
    for (int j = 0; j < kc; ++j) {
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int i = 0; i < DMAX; ++i) {
        s = fmaf(q_r[i], k_s[j][i], s);
        dp = fmaf(g_r[i], v_s[j][i], dp);
      }
      const float ds = expf(s * scale - lse_r) * (dp - dsum_r) * scale;
#pragma unroll
      for (int i = 0; i < DMAX; ++i) acc[i] = fmaf(ds, k_s[j][i], acc[i]);
    }
  }

  if (active) {
    T* dq_row = dq + b * dqs.b + hh * dqs.h + row * dqs.n;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      if (i < d) dq_row[i] = from_f32<T>(acc[i]);
    }
    dsum[static_cast<long long>(bh) * N + row] = dsum_r;
  }
}

// K9 (2): fp32 partial dk, dv of one key row per thread over one split of
// the query rows, written to part_dk/part_dv[split][b*h][key][:d].
template <typename T, int DMAX, int QC>
__global__ void __launch_bounds__(kRows)
    sra_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ g,
                 const float* __restrict__ lse,
                 const float* __restrict__ dsum, float* __restrict__ part_dk,
                 float* __restrict__ part_dv, int heads, int N, int M, int d,
                 int rows_per_split, Strides qs, Strides ks, Strides vs,
                 Strides gs, float scale) {
  __shared__ float q_s[QC][DMAX];
  __shared__ float g_s[QC][DMAX];
  __shared__ float lse_s[QC];
  __shared__ float dsum_s[QC];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int hh = bh % heads;
  const int key = blockIdx.x * kRows + threadIdx.x;
  const bool active = key < M;
  const int kr = active ? key : 0;

  const T* k_row = k + b * ks.b + hh * ks.h + kr * ks.n;
  const T* v_row = v + b * vs.b + hh * vs.h + kr * vs.n;
  const T* q_head = q + b * qs.b + hh * qs.h;
  const T* g_head = g + b * gs.b + hh * gs.h;
  const float* lse_head = lse + static_cast<long long>(bh) * N;
  const float* dsum_head = dsum + static_cast<long long>(bh) * N;

  float k_r[DMAX];
  float v_r[DMAX];
  float dk[DMAX];
  float dv[DMAX];
#pragma unroll
  for (int i = 0; i < DMAX; ++i) {
    k_r[i] = (i < d) ? to_f32(k_row[i]) : 0.0f;
    v_r[i] = (i < d) ? to_f32(v_row[i]) : 0.0f;
    dk[i] = 0.0f;
    dv[i] = 0.0f;
  }

  const int n0 = blockIdx.z * rows_per_split;
  const int n1 = min(N, n0 + rows_per_split);
  for (int r0 = n0; r0 < n1; r0 += QC) {
    const int rc = min(QC, n1 - r0);
    __syncthreads();  // the previous chunk has been consumed
    for (int e = threadIdx.x; e < QC * DMAX; e += kRows) {
      const int j = e / DMAX;
      const int col = e % DMAX;
      float qv = 0.0f, gv = 0.0f;
      if (j < rc && col < d) {
        qv = to_f32(q_head[(r0 + j) * qs.n + col]);
        gv = to_f32(g_head[(r0 + j) * gs.n + col]);
      }
      q_s[j][col] = qv;
      g_s[j][col] = gv;
    }
    for (int j = threadIdx.x; j < QC; j += kRows) {
      lse_s[j] = j < rc ? lse_head[r0 + j] : 0.0f;
      dsum_s[j] = j < rc ? dsum_head[r0 + j] : 0.0f;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < rc; ++j) {
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int i = 0; i < DMAX; ++i) {
        s = fmaf(q_s[j][i], k_r[i], s);
        dp = fmaf(g_s[j][i], v_r[i], dp);
      }
      const float p = expf(s * scale - lse_s[j]);
      const float ds = p * (dp - dsum_s[j]) * scale;
#pragma unroll
      for (int i = 0; i < DMAX; ++i) {
        dv[i] = fmaf(p, g_s[j][i], dv[i]);
        dk[i] = fmaf(ds, q_s[j][i], dk[i]);
      }
    }
  }

  if (active) {
    const long long off =
        ((static_cast<long long>(blockIdx.z) * gridDim.y + bh) * M + key) *
        d;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      if (i < d) {
        part_dk[off + i] = dk[i];
        part_dv[off + i] = dv[i];
      }
    }
  }
}

// K9 (3): dk, dv = the sums of the partials over the splits, in split
// order, one element per thread.
template <typename T>
__global__ void __launch_bounds__(256)
    sra_bwd_reduce(const float* __restrict__ part_dk,
                   const float* __restrict__ part_dv, int splits, int heads,
                   int M, int d, long long n, T* __restrict__ dk,
                   T* __restrict__ dv, Strides dks, Strides dvs) {
  const long long e = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= n) return;
  float sk = 0.0f, sv = 0.0f;
  for (int s = 0; s < splits; ++s) {
    sk += part_dk[s * n + e];
    sv += part_dv[s * n + e];
  }
  const int i = static_cast<int>(e % d);
  const long long rest = e / d;
  const int m = static_cast<int>(rest % M);
  const int bh = static_cast<int>(rest / M);
  const int b = bh / heads;
  const int hh = bh % heads;
  dk[b * dks.b + hh * dks.h + m * dks.n + i] = from_f32<T>(sk);
  dv[b * dvs.b + hh * dvs.h + m * dvs.n + i] = from_f32<T>(sv);
}

template <typename T, int DMAX, int KC>
void launch(const void* q, const void* k, const void* v, void* out,
            float* lse, float* out32, int B, int heads, int N, int M, int d,
            Strides qs, Strides ks, Strides vs, Strides os, float scale,
            cudaStream_t stream) {
  const dim3 grid((N + kRows - 1) / kRows, B * heads);
  sra_attn_kernel<T, DMAX, KC><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, out32, heads, N,
      M, d, qs, ks, vs, os, scale);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, float* out32, int B, int heads, int N, int M, int d,
             Strides qs, Strides ks, Strides vs, Strides os, float scale,
             cudaStream_t stream) {
  if (d <= 32) {
    launch<T, 32, 32>(q, k, v, out, lse, out32, B, heads, N, M, d, qs, ks,
                      vs, os, scale, stream);
  } else if (d <= 64) {
    launch<T, 64, 32>(q, k, v, out, lse, out32, B, heads, N, M, d, qs, ks,
                      vs, os, scale, stream);
  } else {
    launch<T, 128, 16>(q, k, v, out, lse, out32, B, heads, N, M, d, qs, ks,
                       vs, os, scale, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// The arguments of one K9 call.
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* o;
  const void* g;
  const float* lse;
  float* dsum;
  float* part_dk;
  float* part_dv;
  void* dq;
  void* dk;
  void* dv;
  int B, heads, N, M, d, splits, rows_per_split;
  Strides qs, ks, vs, os, gs, dqs, dks, dvs;
  float scale;
};

template <typename T, int DMAX, int KC>
void launch_bwd(const BwdArgs& a, cudaStream_t s) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.g);
  const dim3 g1((a.N + kRows - 1) / kRows, a.B * a.heads);
  sra_bwd_dq<T, DMAX, KC><<<g1, kRows, 0, s>>>(
      q, k, v, a.o, g, a.lse, a.dsum, static_cast<T*>(a.dq), a.heads, a.N,
      a.M, a.d, a.qs, a.ks, a.vs, a.os, a.gs, a.dqs, a.scale);
  const dim3 g2((a.M + kRows - 1) / kRows, a.B * a.heads, a.splits);
  sra_bwd_dkdv<T, DMAX, KC><<<g2, kRows, 0, s>>>(
      q, k, v, g, a.lse, a.dsum, a.part_dk, a.part_dv, a.heads, a.N, a.M,
      a.d, a.rows_per_split, a.qs, a.ks, a.vs, a.gs, a.scale);
  const long long n = static_cast<long long>(a.B) * a.heads * a.M * a.d;
  sra_bwd_reduce<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      a.part_dk, a.part_dv, a.splits, a.heads, a.M, a.d, n,
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.dks, a.dvs);
}

template <typename T>
int dispatch_bwd(const BwdArgs& a, cudaStream_t s) {
  if (a.d <= 32) {
    launch_bwd<T, 32, 32>(a, s);
  } else if (a.d <= 64) {
    launch_bwd<T, 64, 32>(a, s);
  } else {
    launch_bwd<T, 128, 16>(a, s);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int heads, int N, int M, int d) {
  return B < 1 || heads < 1 || N < 1 || M < 1 || d < 8 || d > 128 || d % 8 ||
         static_cast<long long>(B) * heads > 65535;
}

Strides strides_at(const long long* s, int i) {
  return {s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

}  // namespace

// Strides are in elements, for the (b, h, n) dims; the last dim is
// contiguous. dtype: 0 float32, 1 bfloat16. d <= 128 and d % 8 == 0.
// lse (B*h, N) float32 and out32 (out's shape and strides, float32) are
// optional outputs for the backward: nullptr leaves them out.
extern "C" int sra_attn_fwd(const void* q, const void* k, const void* v,
                            void* out, int B, int heads, int N, int M, int d,
                            const long long* q_strides,
                            const long long* k_strides,
                            const long long* v_strides,
                            const long long* o_strides, float scale,
                            int dtype, float* lse, float* out32,
                            void* stream) {
  if (bad_shape(B, heads, N, M, d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs = strides_at(q_strides, 0);
  const Strides ks = strides_at(k_strides, 0);
  const Strides vs = strides_at(v_strides, 0);
  const Strides os = strides_at(o_strides, 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(q, k, v, out, lse, out32, B, heads, N, M, d, qs,
                           ks, vs, os, scale, s);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(q, k, v, out, lse, out32, B, heads, N, M,
                                   d, qs, ks, vs, os, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K9. q, k, v: the forward's inputs; o: its output in float32 (out32, or
// out itself for float32 inputs), with strides; g: dO in the inputs' dtype;
// lse: the forward's. strides: 24 values, the (b, h, n) strides of q, k, v,
// o, g, dq, dk, dv in that order. Scratch: dsum (B*h, N) float32; part_dk
// and part_dv, splits * B*h * M * d float32 each; the split s covers query
// rows [s * rows_per_split, (s + 1) * rows_per_split). Outputs dq, dk, dv in
// the inputs' dtype, every element written.
extern "C" int sra_attn_bwd(const void* q, const void* k, const void* v,
                            const float* o, const void* g, const float* lse,
                            float* dsum, float* part_dk, float* part_dv,
                            void* dq, void* dk, void* dv, int B, int heads,
                            int N, int M, int d, int splits,
                            int rows_per_split, const long long* strides,
                            float scale, int dtype, void* stream) {
  if (bad_shape(B, heads, N, M, d) || splits < 1 || splits > 65535 ||
      rows_per_split < 1 ||
      static_cast<long long>(splits) * rows_per_split < N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdArgs a = {q, k, v, o, g, lse, dsum, part_dk, part_dv, dq, dk, dv,
               B, heads, N, M, d, splits, rows_per_split,
               strides_at(strides, 0), strides_at(strides, 1),
               strides_at(strides, 2), strides_at(strides, 3),
               strides_at(strides, 4), strides_at(strides, 5),
               strides_at(strides, 6), strides_at(strides, 7), scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_bwd<float>(a, s);
  if (dtype == 1) return dispatch_bwd<__nv_bfloat16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
