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
// A row belongs to a group of G lanes of one warp. The forward takes G,
// the vectors a lane holds and the grid from its plan (ops/ln_plan.py; the
// K10 section below): no idle lane at C = 160 and 320, small blocks that
// cover every SM at small row counts, two rows in flight at large ones.
// The backward takes G in {4, 8, 16, 32} by C so that a lane holds at most
// 8 values (more beyond 32 lanes): at C = 32 in bf16 a row is four 16-byte
// vectors, so eight rows share a warp, where one warp per row would leave
// 28 of 32 without a load; widths that are not a power of two (160, 320)
// mask the vectors past the row's end. Rows may be strided (the row
// stride is an argument); the last axis is contiguous and every row starts
// on a 16-byte boundary (the wrapper copies a tensor whose last axis is
// strided).
//
// The backward recomputes mu and rstd from x, as the TPU kernel does: x is
// read for xhat anyway, two more group reductions cost no memory traffic,
// and the forward then saves nothing but its inputs, so the frozen
// teacher's forward and the student's are the same launch. Each block
// walks rows in a grid-stride loop with per-thread dw/db sums, adds them
// over its row groups (by shuffles inside a warp, then over the warps
// through shared memory in warp order) and writes one (2, C) partial.
//
// The sum over the blocks (the TPU kernel leaves it to XLA) is part of the
// same launch, in two rounds: a block makes its partial visible
// (__threadfence), then takes a ticket from its group's counter in the
// workspace (16 neighbouring blocks a group); the block that draws the
// group's last ticket sums the group's partials with its 256 threads (each
// column over fixed slices of the rows in row order, the slices in slice
// order), sets the counter back to 0 and takes a ticket of the second
// round, whose last block sums the groups' sums into dwdb the same way.
// Which block comes last varies; the order of every sum does not, so the
// gradients are bitwise reproducible. No atomics touch a gradient. One
// round would leave one SM reading every partial (512 KB at C = 256 and
// 256 blocks); with two no block reads more than 16 + blocks / 16 of them.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// blocks of the backward whose partials one of them sums into one
constexpr int kGroupBlocks = 16;

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

// ---- K10, the forward --------------------------------------------------
//
// A group of G lanes holds a row, lane l its vectors l, l + G, ... (NCH of
// them), so that a group reads neighbouring 16-byte vectors. G, NCH and
// the rows in flight R are template arguments, one instance for each entry
// of LN_FWD_INSTANCES below; the plan (ops/ln_plan.py) picks the instance,
// the block size and the grid. What sets the time at the small row counts
// of the SRA norms (2048 rows) is not bytes but a launch's fixed cost and
// the chain of latencies a thread walks, so a lane loads its weight and
// bias into registers before its row (their loads overlap the row's,
// where loading them at the store was a second round trip). At R = 1 a
// group owns one row and the grid covers the rows. At R = 2 the grid is
// persistent: a group walks rows grid-stride, the next row's loads issued
// before the current row's sums and store. The sums are taken in one order
// (a lane's values in order, then an xor tree over the group): two
// launches on the same input give the same bits. K10 is launched as a
// programmatic dependent launch: its grid is set up while the kernel ahead
// finishes (the floor of a queued launch, ~2 us, is most of a 2048-row
// launch), and it waits (griddepcontrol.wait) before it reads anything,
// since x, the weight or the bias may be that kernel's output.

// the most values a lane of the forward holds (ops/ln_plan.py MAX_VALUES),
// the largest block
constexpr int kFwdMaxValues = 40;
constexpr int kFwdMaxThreads = 256;

// The lane's vectors of one row, widened to fp32; zeros past the row's end
// or for a row past the last.
template <typename T, int G, int NCH>
__device__ __forceinline__ void load_lane(const T* __restrict__ row,
                                          bool active, int lane, int nvec,
                                          float (&v)[NCH][Vec<T>::N]) {
  constexpr int V = Vec<T>::N;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = lane + i * G;
    if (active && c < nvec) {
      Vec<T>::load(row + c * V, v[i]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[i][j] = 0.0f;
    }
  }
}

// The weight and bias of the lane's columns (zeros past the row's end).
template <int G, int NCH, int V>
__device__ __forceinline__ void load_params(const float* __restrict__ w,
                                            const float* __restrict__ b,
                                            int lane, int nvec,
                                            float (&wv)[NCH][V],
                                            float (&bv)[NCH][V]) {
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = lane + i * G;
    if (c < nvec) {
      load_param<V>(w + c * V, wv[i]);
      load_param<V>(b + c * V, bv[i]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) wv[i][j] = bv[i][j] = 0.0f;
    }
  }
}

// Normalises the lane's part of row r, held in v: the mean, then the mean
// square of the centred values, each summed over the group; y = (v - mu)
// * rstd * w + b, stored unless the row is past the last.
template <typename T, int G, int NCH>
__device__ __forceinline__ void finish_row(
    float (&v)[NCH][Vec<T>::N], long long r, int rows, int lane, int nvec,
    float inv_c, float eps, const float (&wv)[NCH][Vec<T>::N],
    const float (&bv)[NCH][Vec<T>::N], T* __restrict__ y, int C) {
  constexpr int V = Vec<T>::N;
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < NCH; ++i)
#pragma unroll
    for (int j = 0; j < V; ++j) sum += v[i][j];
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
  const float rstd = rsqrtf(group_sum<G>(sq) * inv_c + eps);
  if (r >= rows) return;
  T* out = y + r * C;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = lane + i * G;
    if (c < nvec) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        v[i][j] = v[i][j] * rstd * wv[i][j] + bv[i][j];
      Vec<T>::store(out + c * V, v[i]);
    }
  }
}

// Waits for the grid this launch depends on (a programmatic dependent
// launch); pdl is 0 for an ordinary launch.
__device__ __forceinline__ void grid_dependency_wait(int pdl) {
  if (pdl) asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <typename T, int G, int NCH, int R>
__global__ void __launch_bounds__(kFwdMaxThreads)
    ln_fwd(const T* __restrict__ x, long long sx, const float* __restrict__ w,
           const float* __restrict__ b, int rows, int C, float eps,
           T* __restrict__ y, int pdl) {
  constexpr int V = Vec<T>::N;
  const int lane = threadIdx.x % G;
  const int group = threadIdx.x / G;
  const int groups = blockDim.x / G;
  const int nvec = C / V;
  const float inv_c = 1.0f / static_cast<float>(C);
  long long base = static_cast<long long>(blockIdx.x) * groups;
  float wv[NCH][V], bv[NCH][V], a[NCH][V];
  grid_dependency_wait(pdl);
  load_params<G, NCH, V>(w, b, lane, nvec, wv, bv);
  long long r = base + group;
  load_lane<T, G, NCH>(x + r * sx, r < rows, lane, nvec, a);
  if constexpr (R == 1) {
    finish_row<T, G, NCH>(a, r, rows, lane, nvec, inv_c, eps, wv, bv, y, C);
  } else {
    static_assert(R == 2, "one or two rows in flight");
    // every group of a block takes the same turns: the group sums are
    // warp-wide shuffles
    const long long step = static_cast<long long>(gridDim.x) * groups;
    float n[NCH][V];
    for (; base < rows; base += 2 * step) {
      r = base + group;
      // the next row's loads first, then this row's sums and store
      load_lane<T, G, NCH>(x + (r + step) * sx, r + step < rows, lane, nvec,
                           n);
      finish_row<T, G, NCH>(a, r, rows, lane, nvec, inv_c, eps, wv, bv, y, C);
      if (base + step >= rows) break;
      load_lane<T, G, NCH>(x + (r + 2 * step) * sx, r + 2 * step < rows,
                           lane, nvec, a);
      finish_row<T, G, NCH>(n, r + step, rows, lane, nvec, inv_c, eps, wv,
                            bv, y, C);
    }
  }
}

// Does nothing: the floor of a launch, which tools/bench_kernels.py times
// beside K10 with K10's grid.
__global__ void ln_empty() {}

// dst[col] = sum over the n rows of src (ncol floats each, ncol % 16 == 0),
// by all kThreads threads of one block: 16-byte loads that bypass L1
// (other SMs wrote the rows), a column's rows cut into S interleaved slices
// (slice s: rows s, s + S, ... in that order) that meet in shared memory
// `sh` (4 * kThreads floats) in slice order. A fixed order for fixed n.
__device__ __forceinline__ void sum_partials(const float* src, int n,
                                             int ncol, float* dst,
                                             float* sh) {
  const int nq = ncol / 4;  // float4 columns
  const float4* src4 = reinterpret_cast<const float4*>(src);
  if (nq <= kThreads) {
    const int S = kThreads / nq;
    const int slice = threadIdx.x / nq;
    const int q = threadIdx.x - slice * nq;
    if (slice < S) {
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
      for (int k = slice; k < n; k += S) {
        const float4 v = __ldcg(src4 + static_cast<long long>(k) * nq + q);
        a.x += v.x;
        a.y += v.y;
        a.z += v.z;
        a.w += v.w;
      }
      reinterpret_cast<float4*>(sh)[slice * nq + q] = a;
    }
    __syncthreads();
    for (int col = threadIdx.x; col < ncol; col += kThreads) {
      float a = 0.0f;
      for (int s = 0; s < S; ++s) a += sh[s * ncol + col];
      dst[col] = a;
    }
  } else {
    for (int q = threadIdx.x; q < nq; q += kThreads) {
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
      for (int k = 0; k < n; ++k) {
        const float4 v = __ldcg(src4 + static_cast<long long>(k) * nq + q);
        a.x += v.x;
        a.y += v.y;
        a.z += v.z;
        a.w += v.w;
      }
      reinterpret_cast<float4*>(dst)[q] = a;
    }
  }
}

template <typename T, int G, int NCH>
__global__ void __launch_bounds__(kThreads)
    ln_bwd(const T* __restrict__ x, long long sx, const T* __restrict__ dy,
           long long sdy, const float* __restrict__ w, int rows, int C,
           float eps, T* __restrict__ dx, float* __restrict__ part,
           float* __restrict__ gpart, unsigned* __restrict__ tickets,
           float* __restrict__ dwdb) {
  constexpr int V = Vec<T>::N;
  constexpr int kGroups = kThreads / G;
  // one (warps, C) plane, C <= G * NCH * V; the last block's (slices, 2 C)
  constexpr int kPlane = (kThreads / 32) * G * NCH * V;
  __shared__ __align__(16) float sh[kPlane > 4 * kThreads ? kPlane
                                                          : 4 * kThreads];
  __shared__ bool last;
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

  if (dwdb == nullptr) return;  // the parameters are frozen

  // the block's partial dw, then db. The lanes of a warp that hold the same
  // columns of different rows (G apart) add up by shuffles, a fixed tree;
  // then the eight warps' sums meet in shared memory, in warp order.
  const int warp = threadIdx.x / 32;
  const bool writer = threadIdx.x % 32 < G;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int c = lane + i * G;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float v = which == 0 ? dw[i][j] : db[i][j];
#pragma unroll
        for (int off = G; off < 32; off <<= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (writer && c < nvec) sh[warp * C + c * V + j] = v;
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < kThreads / 32; ++k) s += sh[k * C + c];
      part[(static_cast<long long>(blockIdx.x) * 2 + which) * C + c] = s;
    }
    __syncthreads();
  }

  // Two rounds of "the last one sums": the last block of each group of
  // kGroupBlocks neighbours sums the group's partials into one, and the
  // last of those sums the groups' into dwdb. Which block that is varies;
  // the order of every sum does not.
  const int ncol = 2 * C;
  const int grp = blockIdx.x / kGroupBlocks;
  const int first = grp * kGroupBlocks;
  const int gsize = min(kGroupBlocks, static_cast<int>(gridDim.x) - first);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + 1 + grp, 1u) == gsize - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  sum_partials(part + static_cast<long long>(first) * ncol, gsize, ncol,
               gpart + static_cast<long long>(grp) * ncol, sh);
  if (threadIdx.x == 0) tickets[1 + grp] = 0u;
  __threadfence();
  __syncthreads();
  const int groups = (gridDim.x + kGroupBlocks - 1) / kGroupBlocks;
  if (threadIdx.x == 0) last = atomicAdd(tickets, 1u) == groups - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  sum_partials(gpart, groups, ncol, dwdb, sh);
  if (threadIdx.x == 0) tickets[0] = 0u;
}

// One K10 launch; with pdl, a programmatic dependent launch (it may start
// before the grid ahead of it ends, and waits for it before reading
// anything).
template <typename T, int G, int NCH, int R>
void launch_fwd(const void* x, long long sx, const float* w, const float* b,
                int rows, int C, float eps, void* y, int threads, int blocks,
                bool pdl, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (!pdl) {
    ln_fwd<T, G, NCH, R><<<blocks, threads, 0, s>>>(xt, sx, w, b, rows, C,
                                                    eps, yt, 0);
    return;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, ln_fwd<T, G, NCH, R>, xt, sx, w, b, rows, C, eps,
                     yt, 1);
}

template <typename T, int G, int NCH>
void launch_bwd(const void* x, long long sx, const void* dy, long long sdy,
                const float* w, int rows, int C, float eps, void* dx,
                float* part, float* gpart, unsigned* tickets, int blocks,
                float* dwdb, cudaStream_t s) {
  ln_bwd<T, G, NCH><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), sx, static_cast<const T*>(dy), sdy, w, rows,
      C, eps, static_cast<T*>(dx), part, gpart, tickets, dwdb);
}

// Lanes per row for width C: the fewest of 4, 8, 16, 32 that keep a lane
// at per_lane values, with *mult = 1; beyond 32 lanes a lane holds 2 or 4
// times per_lane (*mult), up to C = 1024; -1 for an unsupported width.
// The backward holds 8 values a lane: it keeps x, dy and two running sums, and at 16 its ~106 registers leave an SM two blocks
// of loads in flight, too few for the memory's latency.
int lanes_for(int C, int per_lane, int* mult) {
  *mult = 1;
  if (C <= 0 || C % 8 != 0 || C > 1024) return -1;
  for (int g = 4; g <= 32; g *= 2)
    if (C <= per_lane * g) return g;
  while (C > *mult * per_lane * 32) *mult *= 2;
  return 32;
}

constexpr int kBwdPerLane = 8;

bool bad_rows(int rows, long long stride, int C) {
  return rows <= 0 || stride < C;
}

// The instances of ln_fwd: (dtype code, storage type, lanes a row,
// vectors a lane, rows in flight). ops/ln_plan.py::INSTANCES mirrors this
// list.
#define LN_FWD_INSTANCES(X)        \
  X(1, __nv_bfloat16, 4, 1, 1)     \
  X(1, __nv_bfloat16, 4, 2, 1)     \
  X(1, __nv_bfloat16, 4, 5, 1)     \
  X(1, __nv_bfloat16, 8, 2, 1)     \
  X(1, __nv_bfloat16, 8, 5, 1)     \
  X(1, __nv_bfloat16, 16, 2, 1)    \
  X(1, __nv_bfloat16, 16, 4, 1)    \
  X(1, __nv_bfloat16, 32, 4, 1)    \
  X(1, __nv_bfloat16, 4, 1, 2)     \
  X(1, __nv_bfloat16, 8, 1, 2)     \
  X(1, __nv_bfloat16, 16, 1, 2)    \
  X(1, __nv_bfloat16, 32, 1, 2)    \
  X(0, float, 4, 1, 1)             \
  X(0, float, 8, 1, 1)             \
  X(0, float, 8, 2, 1)             \
  X(0, float, 8, 5, 1)             \
  X(0, float, 16, 2, 1)            \
  X(0, float, 16, 4, 1)            \
  X(0, float, 16, 5, 1)            \
  X(0, float, 32, 4, 1)            \
  X(0, float, 32, 8, 1)            \
  X(0, float, 8, 1, 2)             \
  X(0, float, 16, 1, 2)

// K10's plan (ops/ln_plan.py::forward_plan), checked: an instance, whole
// warps up to kFwdMaxThreads, the row covered (lanes * NCH vectors), and a
// grid that covers the rows at one row a group (R = 1) or has no block
// without a row (R = 2); false, launching nothing, for any other. The
// instance list keeps a lane at kFwdMaxValues values or fewer.
bool dispatch_fwd(int dtype, const void* x, long long sx, const float* w,
                  const float* b, int rows, int C, float eps, void* y,
                  int lanes, int nch, int rif, int threads, int blocks,
                  bool pdl, cudaStream_t s) {
  if (threads < 32 || threads > kFwdMaxThreads || threads % 32 != 0)
    return false;
  const int V = dtype == 0 ? 4 : 8;
  if (lanes < 1 || lanes > 32 || nch < 1 || lanes * nch * V < C)
    return false;
  const long long groups = threads / lanes;
  const long long need = (rows + groups - 1) / groups;
  if (blocks < 1 || blocks > need || (rif == 1 && blocks != need))
    return false;
#define LN_FWD(CODE, TYPE, LANES, NCH, ROWS)                               \
  static_assert(NCH * Vec<TYPE>::N <= kFwdMaxValues, "too many values");   \
  if (dtype == CODE && lanes == LANES && nch == NCH && rif == ROWS) {      \
    launch_fwd<TYPE, LANES, NCH, ROWS>(x, sx, w, b, rows, C, eps, y,       \
                                       threads, blocks, pdl, s);           \
    return true;                                                           \
  }
  LN_FWD_INSTANCES(LN_FWD)
#undef LN_FWD
  return false;
}

template <typename T>
bool dispatch_bwd(const void* x, long long sx, const void* dy, long long sdy,
                  const float* w, int rows, int C, float eps, void* dx,
                  float* part, float* gpart, unsigned* tickets, int blocks,
                  float* dwdb, cudaStream_t s) {
  constexpr int B = kBwdPerLane / Vec<T>::N;
#define LN_BWD(G, NCH)                                                     \
  launch_bwd<T, G, NCH>(x, sx, dy, sdy, w, rows, C, eps, dx, part, gpart, \
                        tickets, blocks, dwdb, s)
  int mult;
  switch (lanes_for(C, kBwdPerLane, &mult)) {
    case 4: LN_BWD(4, B); break;
    case 8: LN_BWD(8, B); break;
    case 16: LN_BWD(16, B); break;
    case 32:
      if (mult == 1) LN_BWD(32, B);
      else if (mult == 2) LN_BWD(32, 2 * B);
      else LN_BWD(32, 4 * B);
      break;
    default: return false;
  }
#undef LN_BWD
  return true;
}

// The most blocks the backward can use for (rows, C): one pass of every
// block over its row groups covers the rows; 0 for an unsupported width.
int bwd_blocks_needed(int rows, int C) {
  int mult;
  const int g = lanes_for(C, kBwdPerLane, &mult);
  if (g <= 0 || rows <= 0) return 0;
  const int groups = kThreads / g;
  return static_cast<int>((static_cast<long long>(rows) + groups - 1) / groups);
}

}  // namespace


// x: rows of C values in float32 (dtype 0) or bfloat16 (1), row r at
// x + r * sx elements, every row 16-byte aligned; w, b: (C,) float32.
// y: (rows, C) contiguous in x's dtype. C % 8 == 0 and C <= 1024. lanes,
// nch, rif (rows in flight), threads, blocks: the plan of
// ops/ln_plan.py::forward_plan; pdl: launch as a programmatic dependent
// launch.
extern "C" int layer_norm_fwd(const void* x, long long sx, const float* w,
                              const float* b, int rows, int C, float eps,
                              int dtype, void* y, int lanes, int nch, int rif,
                              int threads, int blocks, int pdl,
                              void* stream) {
  if (bad_rows(rows, sx, C) || C % 8 != 0 || C > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool ok = (dtype == 0 || dtype == 1) &&
                  dispatch_fwd(dtype, x, sx, w, b, rows, C, eps, y, lanes,
                               nch, rif, threads, blocks, pdl != 0,
                               static_cast<cudaStream_t>(stream));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// x, dy: rows of C values with row strides sx, sdy (elements), as above.
// dx: (rows, C) contiguous in x's dtype. blocks: the grid, any count from 1
// to ceil(rows / (256 / lanes)), lanes as lanes_for(C, 8). ws: the
// workspace of this stream, float32: capacity * 2 * C partials (block k's
// sums of dy * xhat, then of dy, over its rows), then groups * 2 * C sums of
// 16 neighbouring blocks' partials, groups = ceil(capacity / 16), then
// 1 + groups ticket counters, which are 0 between launches; blocks <=
// capacity. dwdb: (2, C) float32, dweight then dbias, or null where neither
// is wanted (ws is then unused).
extern "C" int layer_norm_bwd(const void* x, long long sx, const void* dy,
                              long long sdy, const float* w, int rows, int C,
                              float eps, int dtype, void* dx, float* ws,
                              int capacity, int blocks, float* dwdb,
                              void* stream) {
  if (bad_rows(rows, sx, C) || bad_rows(rows, sdy, C) || blocks < 1 ||
      blocks > bwd_blocks_needed(rows, C) ||
      (dwdb != nullptr && (ws == nullptr || blocks > capacity))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* gpart = nullptr;
  unsigned* tickets = nullptr;
  if (dwdb != nullptr) {
    const long long groups = (capacity + kGroupBlocks - 1) / kGroupBlocks;
    gpart = ws + static_cast<long long>(capacity) * 2 * C;
    tickets = reinterpret_cast<unsigned*>(gpart + groups * 2 * C);
  }
  bool ok = false;
  if (dtype == 0) {
    ok = dispatch_bwd<float>(x, sx, dy, sdy, w, rows, C, eps, dx, ws, gpart,
                             tickets, blocks, dwdb, s);
  } else if (dtype == 1) {
    ok = dispatch_bwd<__nv_bfloat16>(x, sx, dy, sdy, w, rows, C, eps, dx, ws,
                                     gpart, tickets, blocks, dwdb, s);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// K10's floor: an empty kernel on a grid of blocks x threads, which
// tools/bench_kernels.py and chip_smoke.py time beside K10.
extern "C" int layer_norm_empty(int blocks, int threads, void* stream) {
  if (blocks < 1 || threads < 1 || threads > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  ln_empty<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
