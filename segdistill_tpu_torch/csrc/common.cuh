// Helpers shared by the loss kernels (group_kl.cu, seg_ce.cu, pixel_kl.cu):
// dtype conversion, torch's bilinear taps (align_corners=False), the bounds
// of the outputs that read one source index (for the gather backward),
// block-wide sums and maxima (blocks of kThreads threads), and the source
// tile of a backward through the upsample: the outputs that read a tile of
// sources, their tap tables, the transposed upsample of a shared-memory
// buffer over that rectangle, one axis after the other, its plan, and the
// one tile kernel that K4, K6 and K8 instantiate with their own loss. Then
// the output tile of a forward that reduces the upsample: the window of
// sources it reads, its plan, the double-buffered staging of the windows,
// the column walker, the one forward kernel that K3, K5 and K7 instantiate
// with their own loss, and the last-block merge of per-block partials.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace segdistill {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.44269504f;

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

// ---- The tile backward: one kernel, the loss a parameter ---------------
//
// dx of a loss over the bilinear upsample of one or two (B, C, h, w) maps
// (x0, and x1 beside it where the loss reads two), when the gradient at
// each output depends only on the upsampled values of one channel there,
// on per-output constants and on per-channel scalars. A block owns one
// image's tile of tile x tile sources and a chunk of cpc channel positions.
// Once per block: the tile's axes and tap tables, and the loss's per-output
// constants over the rectangle of the tile's readers (kRectMaps maps of
// 32-bit words, e.g. a label and a log-sum-exp). Per position: the tile and
// its one-element halo of every map is in shared memory (the next
// position's loads are in flight while this one computes), every output of
// the rectangle gets its upsampled values and the loss's gradient there
// once, into the buffer g, and tile_sum_x, tile_sum_y sum g back onto the
// tile, scaled by the loss's factor and stored to the position's source
// channel. Each source element has one owner and a fixed order of
// summation: no atomics, the result is bitwise reproducible.
//
// A Loss provides:
//   kSrcMaps, kRectMaps, kResident  maps read per channel (1 or 2), 32-bit
//                                   per-output maps, blocks an SM the
//                                   kernel is compiled for
//   pixel(q, r, stride)             the per-output maps of output q (an
//                                   index into the (B, H, W) grid) into
//                                   r[0], r[stride], ...
//   Channel channel(b, pos)         position pos's scalars; .source is the
//                                   channel of x read and written
//   int source(pos)                 that channel alone
//   float eval(ch, v, r, stride)    the gradient at an output: v its
//                                   upsampled values, r its maps
//   float scale()                   the factor of every stored value
constexpr int kTileThreads = 512;
// shared memory a tile block may take: two blocks fit an SM (228 KB, 1 KB
// of it reserved for each block)
constexpr int kTileBudget = 113 * 1024;

// Bytes of dynamic shared memory of a tile block: rect_maps per-output maps
// and g over the (rh, rw) rectangle with an odd pitch, the x-summed buffer
// (tile, rh) with an odd pitch, two buffers of src_maps (tile + 2)^2 source
// tiles, the tap tables of both axes' outputs, and per tile row and column
// the first reader, the readers' count and their weights (ny, nx a source).
// Mirrored by the wrappers' plan (ops/tile_plan.py).
__host__ __device__ inline int tile_smem_bytes(int tile, int rh, int rw,
                                               int ny, int nx, int rect_maps,
                                               int src_maps) {
  return 4 * ((rect_maps + 1) * rh * (rw | 1) + tile * (rh | 1) +
              2 * src_maps * (tile + 2) * (tile + 2) + 2 * rh + 2 * rw +
              tile * (4 + ny + nx));
}

// The tile edge for these shapes: the largest of 16, 8, 4 whose block fits
// the budget; 0: none does, the loss's gather variant runs.
inline int plan_tile(int h, int w, int H, int W, int rect_maps,
                     int src_maps) {
  for (int tile = 16; tile >= 4; tile /= 2) {
    if (tile_smem_bytes(tile, tile_reach(tile, h, H), tile_reach(tile, w, W),
                        tile_readers(h, H), tile_readers(w, W), rect_maps,
                        src_maps) <= kTileBudget)
      return tile;
  }
  return 0;
}

// Whether a wrapper's plan (tile edge, rectangle, shared bytes, positions
// a block) is this source's for Loss at these shapes; the gather variant
// (tile 0) names no rectangle and no bytes and has a grid of B * C rows.
template <typename Loss>
bool tile_plan_ok(int B, int C, int h, int w, int H, int W, int tile, int rh,
                  int rw, int smem, int cpc) {
  if (tile != plan_tile(h, w, H, W, Loss::kRectMaps, Loss::kSrcMaps) ||
      cpc < 1 || cpc > C)
    return false;
  if (tile == 0)
    return static_cast<long long>(B) * C <= 65535 && !rh && !rw && !smem;
  return rh == tile_reach(tile, h, H) && rw == tile_reach(tile, w, W) &&
         smem == tile_smem_bytes(tile, rh, rw, tile_readers(h, H),
                                 tile_readers(w, W), Loss::kRectMaps,
                                 Loss::kSrcMaps);
}

template <typename T, typename Loss>
__global__ void __launch_bounds__(kTileThreads, Loss::kResident)
    tile_bwd(const Loss loss, const T* __restrict__ x0,
             const T* __restrict__ x1, T* __restrict__ dx, int C, int h,
             int w, int H, int W, int tile, int RH, int RW, int cpc,
             int tiles_y, int tiles_x, int chunks) {
  constexpr int kSrc = Loss::kSrcMaps;
  constexpr int kRect = Loss::kRectMaps;
  extern __shared__ float4 smem_raw[];
  __shared__ TileAxis ay, ax;
  const int tid = threadIdx.x;
  const int PR = RW | 1;
  const int PT = RH | 1;
  const int SW = tile + 2;
  const int SS = SW * SW;
  const int RS = RH * PR;  // words of one rectangle map
  const int NY = tile_readers(h, H), NX = tile_readers(w, W);
  float* rect = reinterpret_cast<float*>(smem_raw);  // kRect maps of RS
  float* g = rect + kRect * RS;
  float* tmp = g + RS;
  float* src = tmp + tile * PT;  // two buffers of kSrc tiles of SS
  int* i0y = reinterpret_cast<int*>(src + 2 * kSrc * SS);
  float* fy = reinterpret_cast<float*>(i0y + RH);
  int* i0x = reinterpret_cast<int*>(fy + RH);
  float* fx = reinterpret_cast<float*>(i0x + RW);
  int* sy = reinterpret_cast<int*>(fx + RW);
  int* cy = sy + tile;
  int* sx = cy + tile;
  int* cx = sx + tile;
  float* wty = reinterpret_cast<float*>(cx + tile);
  float* wtx = wty + tile * NY;

  int t = blockIdx.x;
  const int chunk = t % chunks;
  t /= chunks;
  const int tile_x = t % tiles_x;
  t /= tiles_x;
  const int tile_y = t % tiles_y;
  const int b = t / tiles_y;
  const int c0 = chunk * cpc;
  const int c1 = min(c0 + cpc, C);

  if (tid == 0) ay = tile_axis(tile_y, tile, h, H);
  if (tid == 32) ax = tile_axis(tile_x, tile, w, W);
  __syncthreads();
  // the plan's rectangle holds every reader, or nothing is computed
  if (ay.on > RH || ax.on > RW) __trap();
  tile_taps(ay, h, H, i0y, fy, sy, cy, wty, NY, tid, kTileThreads);
  tile_taps(ax, w, W, i0x, fx, sx, cx, wtx, NX, tid, kTileThreads);

  // A thread keeps one column of the rectangle (its x tap stays in
  // registers) and walks rows ty0, ty0 + rows_step, ...; a rectangle wider
  // than the block is walked in column blocks.
  const int rh = ay.on, rw = ax.on;
  const int cw = max(min(rw, kTileThreads), 1);
  const int rows_step = kTileThreads / cw;
  const int ty0 = tid / cw;
  const int txl = tid - ty0 * cw;
  const bool walker = ty0 < rows_step;

  if (kRect > 0 && walker) {
    const long long img = static_cast<long long>(b) * H * W;
    for (int tx = txl; tx < rw; tx += cw) {
      for (int ty = ty0; ty < rh; ty += rows_step) {
        loss.pixel(img + static_cast<long long>(ay.o0 + ty) * W + ax.o0 + tx,
                   rect + ty * PR + tx, RS);
      }
    }
  }

  // this thread's element of the (tile + 2)^2 sources around the tile
  // (SW * SW <= kTileThreads), 0 outside the map
  const int si = tid / SW, sj = tid - si * SW;
  const int gi = ay.lo - 1 + si, gj = ax.lo - 1 + sj;
  const bool s_in = tid < SS && gi >= 0 && gi < h && gj >= 0 && gj < w;
  const long long plane = static_cast<long long>(h) * w;
  const long long at = static_cast<long long>(b) * C * plane +
                       static_cast<long long>(gi) * w + gj;
  const T* xs[2] = {x0 + at, x1 + at};
  if (tid < SS) {
    const long long o = loss.source(c0) * plane;
#pragma unroll
    for (int m = 0; m < kSrc; ++m)
      src[m * SS + tid] = s_in ? to_f32(xs[m][o]) : 0.0f;
  }
  __syncthreads();

  const float scale = loss.scale();
  for (int c = c0; c < c1; ++c) {
    const float* cur = src + ((c - c0) & 1) * kSrc * SS;
    const typename Loss::Channel ch = loss.channel(b, c);
    float next[kSrc];
#pragma unroll
    for (int m = 0; m < kSrc; ++m) next[m] = 0.0f;
    if (s_in && c + 1 < c1) {
      const long long o = loss.source(c + 1) * plane;
#pragma unroll
      for (int m = 0; m < kSrc; ++m) next[m] = to_f32(xs[m][o]);
    }

    // the loss's gradient at every output of the rectangle
    if (walker) {
      for (int tx = txl; tx < rw; tx += cw) {
        const int b0 = i0x[tx], b1 = min(b0 + 1, ax.hi);
        const float wx = fx[tx], gx = 1.0f - wx;
        for (int ty = ty0; ty < rh; ty += rows_step) {
          const int a0 = i0y[ty];
          const float wy = fy[ty];
          const int r0 = a0 * SW;
          const int r1 = min(a0 + 1, ay.hi) * SW;
          float v[kSrc];
#pragma unroll
          for (int m = 0; m < kSrc; ++m) {
            const float* s = cur + m * SS;
            const float top = gx * s[r0 + b0] + wx * s[r0 + b1];
            const float bot = gx * s[r1 + b0] + wx * s[r1 + b1];
            v[m] = (1.0f - wy) * top + wy * bot;
          }
          const int o = ty * PR + tx;
          g[o] = loss.eval(ch, v, rect + o, RS);
        }
      }
    }
    if (tid < SS) {
      float* nb = src + ((c + 1 - c0) & 1) * kSrc * SS;
#pragma unroll
      for (int m = 0; m < kSrc; ++m) nb[m * SS + tid] = next[m];
    }
    __syncthreads();
    tile_sum_x(g, PR, rh, ax, sx, cx, wtx, NX, tmp, PT, tid, kTileThreads);
    __syncthreads();
    T* out = dx + (static_cast<long long>(b) * C + ch.source) * plane +
             static_cast<long long>(ay.lo) * w + ax.lo;
    tile_sum_y(tmp, PT, ax.n, ay, sy, cy, wty, NY, tid, kTileThreads,
               [&](int ky, int kx, float v) {
                 out[ky * w + kx] = from_f32<T>(v * scale);
               });
  }
}

// Launch tile_bwd<T, Loss> on a plan that tile_plan_ok accepted (tile > 0).
template <typename T, typename Loss>
cudaError_t launch_tile_bwd(const Loss& loss, const void* x0, const void* x1,
                            void* dx, int B, int C, int h, int w, int H,
                            int W, int tile, int cpc, cudaStream_t s) {
  const int rh = tile_reach(tile, h, H), rw = tile_reach(tile, w, W);
  const int smem =
      tile_smem_bytes(tile, rh, rw, tile_readers(h, H), tile_readers(w, W),
                      Loss::kRectMaps, Loss::kSrcMaps);
  const cudaError_t err = cudaFuncSetAttribute(
      tile_bwd<T, Loss>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_y = (h + tile - 1) / tile, tiles_x = (w + tile - 1) / tile;
  const int chunks = (C + cpc - 1) / cpc;
  const long long blocks =
      static_cast<long long>(B) * tiles_y * tiles_x * chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  tile_bwd<T, Loss><<<static_cast<unsigned>(blocks), kTileThreads, smem, s>>>(
      loss, static_cast<const T*>(x0), static_cast<const T*>(x1),
      static_cast<T*>(dx), C, h, w, H, W, tile, rh, rw, cpc, tiles_y,
      tiles_x, chunks);
  return cudaSuccess;
}

// ---- The forward on output tiles: one kernel, the loss a parameter -----
//
// K3, K5 and K7 reduce, and never write, the bilinear upsample of (B, C, h,
// w) maps. A block owns an output tile of kFwdCols columns and oh rows of
// one slice (K3: an image's channel group, K5 and K7: an image) and walks
// its units (K3: the group's positions, two maps each; K5: chunks of
// channels; K7: chunks of channels of both maps). The
// sources that the tile's outputs read form one window an axis, which is
// staged in shared memory for every unit of a step, double-buffered: the
// next step's loads are in flight while this one computes. A thread owns
// one column of the tile (its x tap in registers) and walks kRows rows of
// it; it keeps the x-lerped values of the two source rows it stands
// between and x-lerps a new source row only when the y tap moves on, so an
// upsampled value costs one lerp (two instructions) and whatever the loss
// does with it: no integer division, no tap and no global load per value.
constexpr int kFwdThreads = 256;
constexpr int kFwdCols = 64;  // a tile's columns: a thread each
constexpr int kFwdSegs = kFwdThreads / kFwdCols;  // row segments of a tile

// 2^x in one instruction (denormal results flush to 0).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The sources read by the outputs [o0, o0 + on) of one axis: [lo, lo + n),
// from the first output's first tap to the last output's second one (the
// taps' indices grow with the output index), clamped to the map by tap()
// itself; hi is the local index of the map's last source.
struct FwdAxis {
  int lo;
  int n;
  int hi;
};

__device__ inline FwdAxis fwd_axis(int o0, int on, int in, int out) {
  const Tap first = tap(o0, in, out), last = tap(o0 + on - 1, in, out);
  return {first.i0, last.i1 - first.i0 + 1, in - 1 - first.i0};
}

// The most sources that `on` neighbouring outputs read: their positions
// span (on - 1) * in / out source steps, whose floors differ by at most its
// ceiling, plus the second tap of the last, plus 2 for the float32 rounding
// of either end's position; never more than the map. Sizes the window
// buffers; mirrored by the wrappers' planning (ops/tile_plan.py).
__host__ __device__ inline int fwd_reach(int on, int in, int out) {
  const long long r = (static_cast<long long>(on - 1) * in + out - 1) / out + 4;
  return static_cast<int>(r < in ? r : in);
}

// Bytes of dynamic shared memory of a forward block: two buffers of `units`
// (wy, wx) windows and the tile rows' y taps (source row, fraction).
__host__ __device__ inline int fwd_smem_bytes(int units, int oh, int wy,
                                              int wx) {
  return 4 * (2 * units * wy * wx + 2 * oh);
}

// The tile's rows for a loss whose threads walk `rows` rows each and stage
// `slots` window elements a unit, or 0 where a window is larger than the
// block stages at once (strong downsampling, ratios near 1): the loss's
// gather variant runs.
inline int plan_fwd(int h, int w, int H, int W, int rows, int slots) {
  const int oh = kFwdSegs * rows;
  return fwd_reach(oh, h, H) * fwd_reach(kFwdCols, w, W) <=
                 slots * kFwdThreads
             ? oh
             : 0;
}

// Whether a wrapper's forward plan (tile rows, window, shared bytes) is
// this source's for Loss at these shapes; the gather variant (oh 0) names
// no window and no bytes.
template <typename Loss>
bool fwd_plan_ok(int h, int w, int H, int W, int oh, int wy, int wx,
                 int smem) {
  if (oh != plan_fwd(h, w, H, W, Loss::kRows, Loss::kSlots)) return false;
  if (oh == 0) return !wy && !wx && !smem;
  return wy == fwd_reach(oh, h, H) && wx == fwd_reach(kFwdCols, w, W) &&
         smem == fwd_smem_bytes(Loss::kUnits, oh, wy, wx);
}

// One block's outputs [oy0, oy0 + rows) x [ox0, ox0 + cols) (fewer at the
// map's far edges).
struct FwdTile {
  int oy0, ox0, rows, cols;
};

// The value of a unit past the slice's last (K5: channels past C) in the
// staged windows: finite, so that its lerps stay finite, and below any map's
// value, so that it adds 2^-inf = 0 to a sum and never wins a maximum.
constexpr float kFwdPad = -1e30f;

// A thread's share of one step's windows: element e = tid + j * kFwdThreads
// of every unit's window (row-major, pitch ax.n) is its slot j; sp[j] is
// its offset in a source plane, or -1 past the window. Loaded into
// registers (fetch) while the previous step computes, then stored (store).
template <typename T, int U, int S>
struct FwdStage {
  int sp[S];
  T v[U][S];

  __device__ __forceinline__ void init(const FwdAxis& ay, const FwdAxis& ax,
                                       int w, int tid) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int e = tid + j * kFwdThreads;
      const int ly = e / ax.n;
      sp[j] = e < ay.n * ax.n ? (ay.lo + ly) * w + ax.lo + (e - ly * ax.n)
                              : -1;
    }
  }
  // base(i): the plane of unit i of the step; units past n are not read
  template <typename Base>
  __device__ __forceinline__ void fetch(Base base, int n) {
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (i < n) {
        const T* p = base(i);
#pragma unroll
        for (int j = 0; j < S; ++j)
          if (sp[j] >= 0) v[i][j] = p[sp[j]];
      }
    }
  }
  // units past n get kFwdPad
  __device__ __forceinline__ void store(float* buf, int ws, int n,
                                        int tid) const {
#pragma unroll
    for (int i = 0; i < U; ++i) {
#pragma unroll
      for (int j = 0; j < S; ++j)
        if (sp[j] >= 0)
          buf[i * ws + tid + j * kFwdThreads] =
              i < n ? to_f32(v[i][j]) : kFwdPad;
    }
  }
};

// A thread walking down one output column: top holds, for each of U units,
// the x-lerped value of the window row `at`, and d the x-lerped value of
// row min(at + 1, hi) less top, so that an upsampled value is one FMA. A
// row's y tap (a0, a1 = min(a0 + 1, hi), fy) moves them on only where a0
// changed: by one row, top takes top + d and only row a1 is x-lerped; by
// more, both rows are.
template <int U>
struct ColumnWalker {
  float top[U], d[U];
  int at = -2;

  __device__ __forceinline__ static float xlerp(const float* row, int b0,
                                                int b1, float fx) {
    const float v0 = row[b0];
    return fmaf(fx, row[b1] - v0, v0);
  }
  __device__ __forceinline__ void move_to(int a0, int a1, const float* buf,
                                          int ws, int pitch, int b0, int b1,
                                          float fx) {
    if (a0 == at) return;
    if (a0 == at + 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) top[u] += d[u];
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u)
        top[u] = xlerp(buf + u * ws + a0 * pitch, b0, b1, fx);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      d[u] = xlerp(buf + u * ws + a1 * pitch, b0, b1, fx) - top[u];
    at = a0;
  }
  __device__ __forceinline__ float value(int u, float fy) const {
    return fmaf(fy, d[u], top[u]);
  }
};

// Rows [row0, row0 + nr) of one column at step s: each row's y tap (local
// source row as float bits, fraction) from the block's table, the walk,
// and the loss's sums. kFull: nr == R, no row past the tile's edge.
template <int R, bool kFull, typename Loss>
__device__ __forceinline__ void fwd_walk(
    const Loss& loss, typename Loss::State& st, const float2* ytap, int row0,
    int nr, int hi, const float* cur, int ws, int pitch, int b0, int b1,
    float fx, int s) {
  constexpr int U = Loss::kUnits;
  ColumnWalker<U> walk;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!kFull && r >= nr) break;
    const float2 yt = ytap[row0 + r];
    const int a0 = __float_as_int(yt.x);
    walk.move_to(a0, min(a0 + 1, hi), cur, ws, pitch, b0, b1, fx);
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = walk.value(u, yt.y);
    loss.row(st, r, v, s);
  }
}

// A Loss provides:
//   kUnits, kRows, kSlots, kResident  maps a step reads, rows a thread
//                                     walks, window elements a thread
//                                     stages a unit, blocks an SM
//   State                             a thread's running sums
//   int steps(slice), units(slice, s) the slice's steps, step s's units
//                                     (past them: kFwdPad)
//   const T* base(slice, s, i)        the source plane of unit i of step s
//   begin(st, slice, tile, seg, col, ok)  per-thread set-up (ok: the
//                                     thread's column lies in the map)
//   row(st, r, v, s)                  output row r of the thread's walk at
//                                     step s: v its upsampled values
//   finish(st, slice, tile, seg, col, ok)  the block's result and merge
template <typename T, typename Loss>
__global__ void __launch_bounds__(kFwdThreads, Loss::kResident)
    fwd_tile(const Loss loss, int h, int w, int H, int W, int OH, int WY,
             int WX, int tiles_x) {
  constexpr int U = Loss::kUnits;
  constexpr int R = Loss::kRows;
  extern __shared__ float4 smem_raw[];
  __shared__ FwdAxis sy, sx;
  const int tid = threadIdx.x;
  const int WS = WY * WX;  // floats of one unit's window
  float* buf = reinterpret_cast<float*>(smem_raw);  // two steps of U windows
  float2* ytap = reinterpret_cast<float2*>(buf + 2 * U * WS);

  const int slice = blockIdx.y;
  const int tile_y = blockIdx.x / tiles_x;
  FwdTile t;
  t.oy0 = tile_y * OH;
  t.ox0 = (blockIdx.x - tile_y * tiles_x) * kFwdCols;
  t.rows = min(OH, H - t.oy0);
  t.cols = min(kFwdCols, W - t.ox0);
  if (tid == 0) sy = fwd_axis(t.oy0, t.rows, h, H);
  if (tid == 32) sx = fwd_axis(t.ox0, t.cols, w, W);
  __syncthreads();
  const FwdAxis ay = sy, ax = sx;
  // the plan's window holds every source the tile reads, or nothing runs
  if (ay.n > WY || ax.n > WX) __trap();
  if (tid < t.rows) {
    const Tap p = tap(t.oy0 + tid, h, H);
    ytap[tid] = make_float2(__int_as_float(p.i0 - ay.lo), p.f);
  }
  const int col = tid % kFwdCols;
  const int seg = tid / kFwdCols;  // uniform in a warp
  const bool ok = col < t.cols;
  const int nr = min(max(t.rows - seg * R, 0), R);
  const Tap px = tap(t.ox0 + min(col, t.cols - 1), w, W);
  const int b0 = px.i0 - ax.lo, b1 = px.i1 - ax.lo;
  const float fx = px.f;

  typename Loss::State st;
  loss.begin(st, slice, t, seg, col, ok);
  FwdStage<T, U, Loss::kSlots> stage;
  stage.init(ay, ax, w, tid);
  const int steps = loss.steps(slice);
  stage.fetch([&](int i) { return loss.base(slice, 0, i); },
              loss.units(slice, 0));
  stage.store(buf, WS, loss.units(slice, 0), tid);
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const float* cur = buf + (s & 1) * U * WS;
    const bool more = s + 1 < steps;
    if (more)
      stage.fetch([&](int i) { return loss.base(slice, s + 1, i); },
                  loss.units(slice, s + 1));
    if (ok && nr == R)
      fwd_walk<R, true>(loss, st, ytap, seg * R, nr, ay.hi, cur, WS, ax.n,
                        b0, b1, fx, s);
    else if (ok)
      fwd_walk<R, false>(loss, st, ytap, seg * R, nr, ay.hi, cur, WS, ax.n,
                         b0, b1, fx, s);
    if (more)
      stage.store(buf + ((s + 1) & 1) * U * WS, WS, loss.units(slice, s + 1),
                  tid);
    __syncthreads();
  }
  loss.finish(st, slice, t, seg, col, ok);
}

// Launch fwd_tile<T, Loss> over `slices` on a plan that fwd_plan_ok
// accepted (oh > 0). Its shared memory stays under the 48 KB that needs no
// opt-in: at most 2 * kUnits * kSlots * kFwdThreads floats and the y taps.
template <typename T, typename Loss>
cudaError_t launch_fwd_tile(const Loss& loss, int slices, int h, int w,
                            int H, int W, int oh, cudaStream_t s) {
  const int wy = fwd_reach(oh, h, H), wx = fwd_reach(kFwdCols, w, W);
  const int smem = fwd_smem_bytes(Loss::kUnits, oh, wy, wx);
  const int tiles_x = (W + kFwdCols - 1) / kFwdCols;
  const long long tiles = static_cast<long long>((H + oh - 1) / oh) * tiles_x;
  if (tiles > 0x7fffffffLL || slices > 65535 || smem > 48 * 1024)
    return cudaErrorInvalidValue;
  fwd_tile<T, Loss><<<dim3(static_cast<unsigned>(tiles), slices), kFwdThreads,
                      smem, s>>>(loss, h, w, H, W, oh, wy, wx, tiles_x);
  return cudaSuccess;
}

// The last block to finish, among `count` that each call this once after
// writing their partial result (thread 0 at least), sees true; every
// thread of the block gets the answer. `ticket` counts the arrivals; the
// writes before it are visible to the last block (__threadfence), which
// reads them with __ldcg (past L1).
__device__ inline bool last_to_arrive(int* ticket, int count) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1) == count - 1;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

}  // namespace segdistill
