// Helpers shared by the loss kernels (group_kl.cu, seg_ce.cu, pixel_kl.cu):
// dtype conversion, torch's bilinear taps (align_corners=False), the bounds
// of the outputs that read one source index (for the gather backward),
// block-wide sums and maxima (blocks of kThreads threads), and the source
// tile of a backward through the upsample: the outputs that read a tile of
// sources, their tap tables, and the transposed upsample of a shared-memory
// buffer over that rectangle, one axis after the other.

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

// ---- A tile of sources and the outputs that read it -------------------
//
// The backward of a bilinear upsample sums, for each source element, the
// gradients of the outputs whose taps read it. A block that owns a tile of
// sources [lo, lo + n) along each axis finds the outputs that read it, one
// interval [o0, o0 + on) an axis (the tap's i0 grows with the output
// index), evaluates whatever the gradient at those outputs is once, into
// shared memory, and sums it back onto the tile one axis at a time: each
// source element has one owner and a fixed order of summation, so nothing
// is atomic and the result is reproducible.
//
// Sources are addressed relative to base = lo - 1 (the row above the tile,
// which outputs with i0 = lo - 1 also read): tile element k has the local
// index k + 1, the halo 0 and n + 1.
struct TileAxis {
  int lo;    // first source index of the tile
  int n;     // source indices in the tile (fewer at the far edge)
  int o0;    // first output index whose tap reads the tile
  int on;    // outputs that read it (0: none, as under downsampling)
  int hi;    // local index of the last source of the axis: in - lo
};

// The most outputs that can read `tile` sources: those whose source
// position lies in a window of tile + 1 source steps, and some slack for
// the rounding of the positions. Sizes the shared buffers; mirrored by the
// wrappers' planning.
__host__ __device__ inline int tile_reach(int tile, int in, int out) {
  const long long r =
      (static_cast<long long>(tile + 1) * out + in - 1) / in + 3;
  return static_cast<int>(r < out ? r : out);
}

// One thread computes an axis of its block's tile.
__device__ inline TileAxis tile_axis(int index, int tile, int in, int out) {
  TileAxis a;
  a.lo = index * tile;
  a.n = min(tile, in - a.lo);
  a.hi = in - a.lo;
  int o = first_reader(a.lo, in, out);
  while (o < out && tap(o, in, out).i1 < a.lo) ++o;
  a.o0 = o;
  const int last = a.lo + a.n - 1;
  if (last + 1 >= in) {
    o = out;
  } else {
    o = max(first_reader(last + 1, in, out), a.o0);
    while (o < out && tap(o, in, out).i0 <= last) ++o;
  }
  a.on = o - a.o0;
  return a;
}

// The most outputs whose taps can read one source (tile_reach of a tile
// of one): the row length of a tile's weight table.
__host__ __device__ inline int tile_readers(int in, int out) {
  return tile_reach(1, in, out);
}

// Tables of the axis, filled by all `nt` threads of the block. Of the
// outputs: i0[t] the local index of output o0 + t's first source and f[t]
// its fraction (the second source is min(i0 + 1, hi), weight f). Of the
// tile's sources: the readers of element k are the outputs start[k] <= t <
// start[k] + cnt[k], with the weights wt[k * nr + (t - start[k])], nr =
// tile_readers(in, out).
__device__ inline void tile_taps(const TileAxis& a, int in, int out, int* i0,
                                 float* f, int* start, int* cnt, float* wt,
                                 int nr, int tid, int nt) {
  for (int t = tid; t < a.on; t += nt) {
    const Tap p = tap(a.o0 + t, in, out);
    i0[t] = p.i0 - (a.lo - 1);
    f[t] = p.f;
  }
  for (int k = tid; k < a.n; k += nt) {
    const int s = a.lo + k;
    // the first reader with a weight: the outputs whose position is
    // clamped to 0 name source 1 with the weight 0
    int t = max(first_reader(s, in, out) - a.o0, 0);
    while (t < a.on) {
      const Tap p = tap(a.o0 + t, in, out);
      if (p.i0 > s || tap_weight(p, s) != 0.0f) break;
      ++t;
    }
    start[k] = t;
    int c = 0;
    for (; t < a.on; ++t, ++c) {
      const Tap p = tap(a.o0 + t, in, out);
      if (p.i0 > s) break;
      if (c >= nr) __trap();  // the table's row holds every reader
      wt[k * nr + c] = tap_weight(p, s);
    }
    cnt[k] = c;
  }
}

// First half of the transposed upsample, along x: for each of the ny rows
// of g (pitch pg) and each tile column k,
//   tmp[k * pt + y] = sum over the readers t of k of w(t, k) * g[y][t]
// in the order of t. Neighbouring threads take neighbouring y: with odd
// pitches neither g nor tmp has bank conflicts, and a warp shares its
// weights.
__device__ inline void tile_sum_x(const float* g, int pg, int ny,
                                  const TileAxis& ax, const int* start,
                                  const int* cnt, const float* wt, int nr,
                                  float* tmp, int pt, int tid, int nt) {
  if (ny <= 0) return;
  const float inv = 1.0f / static_cast<float>(ny);
  for (int idx = tid; idx < ax.n * ny; idx += nt) {
    int k = static_cast<int>((static_cast<float>(idx) + 0.5f) * inv);
    int y = idx - k * ny;
    if (y < 0) { --k; y += ny; }
    if (y >= ny) { ++k; y -= ny; }
    const float* row = g + y * pg + start[k];
    const float* wk = wt + k * nr;
    const int n = cnt[k];
    float acc = 0.0f;
    for (int t = 0; t < n; ++t) acc += wk[t] * row[t];
    tmp[k * pt + y] = acc;
  }
}

// Second half, along y: store(ky, kx, value) receives, for each source
// element of the tile, the sum over the readers t of row ky of
// w(t, ky) * tmp[kx * pt + t], in the order of t.
template <typename Store>
__device__ inline void tile_sum_y(const float* tmp, int pt, int nx,
                                  const TileAxis& ay, const int* start,
                                  const int* cnt, const float* wt, int nr,
                                  int tid, int nt, Store store) {
  for (int idx = tid; idx < ay.n * nx; idx += nt) {
    const int ky = idx / nx;
    const int kx = idx - ky * nx;
    const float* col = tmp + kx * pt + start[ky];
    const float* wk = wt + ky * nr;
    const int n = cnt[ky];
    float acc = 0.0f;
    for (int t = 0; t < n; ++t) acc += wk[t] * col[t];
    store(ky, kx, acc);
  }
}

}  // namespace segdistill
