// K5 and K6: the segmentation head's cross-entropy at label resolution for
// Hopper (sm_90a), forward and backward.
//
// Replaces segdistill_tpu/ops/pallas/seg_ce.py::fused_seg_ce (the
// pallas_calls at seg_ce.py:241, forward, and :293, backward).
//
// Logits z (B, C, h, w) are upsampled bilinearly (torch's
// align_corners=False taps, any ratio) to the labels' (H, W), and at every
// output pixel with a valid label y (y != ignore_index, 0 <= y < classes):
//
//   ce_sum  = sum (log sum_c exp z_c - z_y)
//   correct = #{argmax_c z_c == y}          (first maximum wins)
//   dz      = g * sum over the pixels that tap a source element of
//             w * (softmax(z) - onehot(y))  (g: ce_sum's incoming gradient)
//
// The caller divides both sums by the total pixel count (ignored pixels
// count in the denominator, the reference's mean).
//
// What bounds it: K5 runs one thread per output pixel, an online softmax
// over C channels with the four taps of each (4 C loads from the logits,
// which at the bench shape, 39 MB in bf16, mostly stay in L2), and writes
// the pixel's (max, exp-sum) for K6: 2 x 8 MB at 8 x 512 x 512. The
// (B, C, H, W) upsampled logits, 1.26 GB in fp32 at the bench shape, never
// reach memory. Per-block partial sums are merged by one block in a fixed
// order, so both sums are deterministic.
//
// K6: a block owns one image's tile of 16 x 16 source pixels (8 x 8 or
// 4 x 4 where the ratio is large) and a chunk of the channels. The outputs
// that read the tile form one rectangle (68 x 68 at 128 -> 512). Once per
// block their label and log-sum-exp (max + log exp-sum) go to shared memory
// with the taps of the rectangle's rows and columns and, for each row and
// column of the tile, its readers and their weights. Per channel the tile and its halo
// are loaded (the next channel's while this one computes), every output of
// the rectangle gets its upsampled logit and softmax - onehot once, into a
// shared buffer, and the transposed upsample runs over that buffer one
// axis after the other (common.cuh): ~1.13 evaluations per upsampled value
// and 8 + 8 taps per source element, where a gather per source element
// takes 4 and 64 and reads each pixel's label, max and exp-sum once per
// channel. What bounds it now: the instructions of the evaluation (a
// thread keeps its column's tap in registers; per upsampled value the row's
// tap, four shared loads of the sources, the label and log-sum-exp, an
// expf and a store) and the two barriers a channel, not memory. One owner per source element and a fixed order of summation: no
// atomics, the gradient is bitwise reproducible. Shapes whose rectangle
// fits no tile's shared memory (ratios above ~15) take the gather variant:
// one thread per source element walks the ~(2r)^2 outputs that read it.
// The variant follows from the shapes alone (plan_tile), and the wrapper's
// plan must agree or the launch is refused.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include "common.cuh"

namespace {

using namespace segdistill;

__device__ __forceinline__ bool valid_label(int y, int classes, int ignore) {
  return y != ignore && y >= 0 && y < classes;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_fwd(const T* __restrict__ z, const int* __restrict__ labels, int C,
           int h, int w, int H, int W, int classes, int ignore,
           float* __restrict__ m_out, float* __restrict__ se_out,
           float* __restrict__ part) {
  const int HW = H * W;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  float acc[2] = {0.0f, 0.0f};
  if (p < HW) {
    const int y = p / W;
    const Tap ty = tap(y, h, H);
    const Tap tx = tap(p - y * W, w, W);
    const long long q = static_cast<long long>(b) * HW + p;
    const int label = labels[q];
    const long long plane = static_cast<long long>(h) * w;
    const T* zb = z + static_cast<long long>(b) * C * plane;
    float m = -INFINITY, se = 0.0f, zy = 0.0f;
    int best = 0;
    for (int c = 0; c < C; ++c) {
      const float v = bilerp(zb + c * plane, w, ty, tx);
      if (v > m) {
        se = se * expf(m - v) + 1.0f;
        m = v;
        best = c;
      } else {
        se += expf(v - m);
      }
      if (c == label) zy = v;
    }
    m_out[q] = m;
    se_out[q] = se;
    if (valid_label(label, classes, ignore)) {
      acc[0] = m + logf(se) - zy;
      acc[1] = best == label ? 1.0f : 0.0f;
    }
  }
  block_sum<float, 2>(acc);
  if (threadIdx.x == 0) {
    const int blk = blockIdx.y * gridDim.x + blockIdx.x;
    part[2 * blk] = acc[0];
    part[2 * blk + 1] = acc[1];
  }
}

__global__ void __launch_bounds__(kThreads)
    ce_finalize(const float* __restrict__ part, int n_blocks,
                float* __restrict__ ce_sum, float* __restrict__ correct) {
  double acc[2] = {0.0, 0.0};
  for (int i = threadIdx.x; i < n_blocks; i += kThreads) {
    acc[0] += part[2 * i];
    acc[1] += part[2 * i + 1];
  }
  block_sum<double, 2>(acc);
  if (threadIdx.x == 0) {
    ce_sum[0] = static_cast<float>(acc[0]);
    correct[0] = static_cast<float>(acc[1]);
  }
}

constexpr int kTileThreads = 512;
// shared memory a tile block may take: two blocks fit an SM (228 KB, 1 KB
// of it reserved for each block)
constexpr int kTileBudget = 113 * 1024;

// Bytes of dynamic shared memory of ce_bwd_tile: label, log-sum-exp and g
// over the (rh, rw) rectangle with an odd pitch, the x-summed buffer
// (tile, rh) with an odd pitch, two (tile + 2)^2 source tiles, the tap
// tables of both axes' outputs, and per tile row and column the first
// reader, the readers' count and their weights (ny, nx a source).
// Mirrored by the wrapper's plan.
__host__ __device__ inline int tile_smem_bytes(int tile, int rh, int rw,
                                               int ny, int nx) {
  return 4 * (3 * rh * (rw | 1) + tile * (rh | 1) +
              2 * (tile + 2) * (tile + 2) + 2 * rh + 2 * rw +
              tile * (4 + ny + nx));
}

// The tile edge for these shapes: the largest of 16, 8, 4 whose block fits
// the budget; 0: none does, the gather variant runs.
int plan_tile(int h, int w, int H, int W) {
  for (int tile = 16; tile >= 4; tile /= 2) {
    if (tile_smem_bytes(tile, tile_reach(tile, h, H), tile_reach(tile, w, W),
                        tile_readers(h, H), tile_readers(w, W)) <=
        kTileBudget)
      return tile;
  }
  return 0;
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads, 3)
    ce_bwd_tile(const T* __restrict__ z, const int* __restrict__ labels,
                int C, int h, int w, int H, int W, int classes, int ignore,
                const float* __restrict__ m, const float* __restrict__ se,
                const float* __restrict__ gbar, T* __restrict__ dz, int tile,
                int RH, int RW, int cpc, int tiles_y, int tiles_x,
                int chunks) {
  extern __shared__ float4 smem_raw[];
  __shared__ TileAxis ay, ax;
  const int tid = threadIdx.x;
  const int PR = RW | 1;
  const int PT = RH | 1;
  const int SW = tile + 2;
  const int NY = tile_readers(h, H), NX = tile_readers(w, W);
  int* lab = reinterpret_cast<int*>(smem_raw);
  float* lse = reinterpret_cast<float*>(lab + RH * PR);
  float* g = lse + RH * PR;
  float* tmp = g + RH * PR;
  float* src = tmp + tile * PT;  // two buffers of SW * SW
  int* i0y = reinterpret_cast<int*>(src + 2 * SW * SW);
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

  const long long img = static_cast<long long>(b) * H * W;
  if (walker) {
    for (int tx = txl; tx < rw; tx += cw) {
      for (int ty = ty0; ty < rh; ty += rows_step) {
        const long long q =
            img + static_cast<long long>(ay.o0 + ty) * W + ax.o0 + tx;
        const int label = labels[q];
        const bool ok = valid_label(label, classes, ignore);
        const int o = ty * PR + tx;
        // an ignored pixel: no class matches, and exp(v - inf) = 0
        lab[o] = ok ? label : -1;
        lse[o] = ok ? m[q] + logf(se[q]) : INFINITY;
      }
    }
  }

  // this thread's element of the (tile + 2)^2 sources around the tile
  // (SW * SW <= kTileThreads), 0 outside the map
  const int si = tid / SW, sj = tid - si * SW;
  const int gi = ay.lo - 1 + si, gj = ax.lo - 1 + sj;
  const bool s_in = tid < SW * SW && gi >= 0 && gi < h && gj >= 0 && gj < w;
  const long long plane = static_cast<long long>(h) * w;
  const T* zs = z + static_cast<long long>(b) * C * plane +
                static_cast<long long>(gi) * w + gj;
  if (tid < SW * SW) src[tid] = s_in ? to_f32(zs[c0 * plane]) : 0.0f;
  __syncthreads();

  const float gb = gbar[0];
  for (int c = c0; c < c1; ++c) {
    const float* cur = src + ((c - c0) & 1) * SW * SW;
    float next = 0.0f;
    if (s_in && c + 1 < c1) next = to_f32(zs[(c + 1) * plane]);

    // g = softmax(up(z)) - onehot at every output of the rectangle
    if (walker) {
      for (int tx = txl; tx < rw; tx += cw) {
        const int b0 = i0x[tx], b1 = min(b0 + 1, ax.hi);
        const float wx = fx[tx], gx = 1.0f - wx;
        for (int ty = ty0; ty < rh; ty += rows_step) {
          const int a0 = i0y[ty];
          const float wy = fy[ty];
          const float* r0 = cur + a0 * SW;
          const float* r1 = cur + min(a0 + 1, ay.hi) * SW;
          const float top = gx * r0[b0] + wx * r0[b1];
          const float bot = gx * r1[b0] + wx * r1[b1];
          const float v = (1.0f - wy) * top + wy * bot;
          const int o = ty * PR + tx;
          g[o] = expf(v - lse[o]) - (lab[o] == c ? 1.0f : 0.0f);
        }
      }
    }
    if (tid < SW * SW) src[((c + 1 - c0) & 1) * SW * SW + tid] = next;
    __syncthreads();
    tile_sum_x(g, PR, rh, ax, sx, cx, wtx, NX, tmp, PT, tid, kTileThreads);
    __syncthreads();
    T* out = dz + (static_cast<long long>(b) * C + c) * plane +
             static_cast<long long>(ay.lo) * w + ax.lo;
    tile_sum_y(tmp, PT, ax.n, ay, sy, cy, wty, NY, tid, kTileThreads,
               [&](int ky, int kx, float v) {
                 out[ky * w + kx] = from_f32<T>(v * gb);
               });
  }
}

// The gather variant of K6, for shapes no tile fits.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_bwd(const T* __restrict__ z, const int* __restrict__ labels, int C,
           int h, int w, int H, int W, int classes, int ignore,
           const float* __restrict__ m, const float* __restrict__ se,
           const float* __restrict__ gbar, T* __restrict__ dz) {
  const int hw = h * w;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= hw) return;
  const int b = blockIdx.y / C;
  const int c = blockIdx.y - b * C;
  const long long base = static_cast<long long>(blockIdx.y) * hw;
  const T* zc = z + base;
  const long long img = static_cast<long long>(b) * H * W;
  const int* lab = labels + img;
  const float* mb = m + img;
  const float* seb = se + img;
  const int i = p / w;
  const int j = p - i * w;
  const int x_start = first_reader(j, w, W);
  float acc = 0.0f;
  for (int y = first_reader(i, h, H); y < H; ++y) {
    const Tap ty = tap(y, h, H);
    if (ty.i0 > i) break;
    const float wy = tap_weight(ty, i);
    if (wy == 0.0f) continue;
    for (int x = x_start; x < W; ++x) {
      const Tap tx = tap(x, w, W);
      if (tx.i0 > j) break;
      const float wx = tap_weight(tx, j);
      if (wx == 0.0f) continue;
      const int q = y * W + x;
      const int label = lab[q];
      if (!valid_label(label, classes, ignore)) continue;
      const float prob = expf(bilerp(zc, w, ty, tx) - mb[q]) / seb[q];
      acc += wy * wx * (prob - (label == c ? 1.0f : 0.0f));
    }
  }
  dz[base + p] = from_f32<T>(acc * gbar[0]);
}

bool bad_shape(int B, int C, int h, int w, int H, int W) {
  return B < 1 || B > 65535 || C < 1 || h < 1 || w < 1 || H < 1 || W < 1 ||
         static_cast<long long>(H) * W > 0x7fffffffLL - kThreads ||
         static_cast<long long>(h) * w > 0x7fffffffLL - kThreads;
}

template <typename T>
void launch_fwd(const void* z, const int* labels, int B, int C, int h, int w,
                int H, int W, int classes, int ignore, float* m, float* se,
                float* part, float* ce_sum, float* correct, cudaStream_t s) {
  const dim3 grid((H * W + kThreads - 1) / kThreads, B);
  ce_fwd<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(z), labels, C, h,
                                      w, H, W, classes, ignore, m, se, part);
  ce_finalize<<<1, kThreads, 0, s>>>(part, grid.x * grid.y, ce_sum, correct);
}

template <typename T>
cudaError_t launch_bwd(const void* z, const int* labels, int B, int C, int h,
                       int w, int H, int W, int classes, int ignore,
                       const float* m, const float* se, const float* gbar,
                       void* dz, int tile, int cpc, cudaStream_t s) {
  if (tile == 0) {
    const dim3 grid((h * w + kThreads - 1) / kThreads, B * C);
    ce_bwd<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(z), labels, C,
                                        h, w, H, W, classes, ignore, m, se,
                                        gbar, static_cast<T*>(dz));
    return cudaSuccess;
  }
  const int rh = tile_reach(tile, h, H), rw = tile_reach(tile, w, W);
  const int smem = tile_smem_bytes(tile, rh, rw, tile_readers(h, H),
                                   tile_readers(w, W));
  const cudaError_t err = cudaFuncSetAttribute(
      ce_bwd_tile<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_y = (h + tile - 1) / tile, tiles_x = (w + tile - 1) / tile;
  const int chunks = (C + cpc - 1) / cpc;
  const long long blocks =
      static_cast<long long>(B) * tiles_y * tiles_x * chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ce_bwd_tile<T><<<static_cast<unsigned>(blocks), kTileThreads, smem, s>>>(
      static_cast<const T*>(z), labels, C, h, w, H, W, classes, ignore, m, se,
      gbar, static_cast<T*>(dz), tile, rh, rw, cpc, tiles_y, tiles_x, chunks);
  return cudaSuccess;
}

}  // namespace

// z: (B, C, h, w) contiguous, float32 (dtype 0) or bfloat16 (1); labels:
// int32 (B, H, W). Outputs: m, se (B, H, W) float32, the per-pixel max and
// exp-sum; ce_sum, correct (1) float32. Scratch: part, 2 floats for each of
// the ceil(H*W / 256) * B blocks.
extern "C" int seg_ce_fwd(const void* z, const int* labels, int B, int C,
                          int h, int w, int H, int W, int classes, int ignore,
                          int dtype, float* m, float* se, float* part,
                          float* ce_sum, float* correct, void* stream) {
  if (bad_shape(B, C, h, w, H, W)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_fwd<float>(z, labels, B, C, h, w, H, W, classes, ignore, m, se,
                      part, ce_sum, correct, s);
  } else if (dtype == 1) {
    launch_fwd<__nv_bfloat16>(z, labels, B, C, h, w, H, W, classes, ignore,
                              m, se, part, ce_sum, correct, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// m, se: the forward's; gbar: ce_sum's incoming gradient, float32 (1) on the
// device. dz: (B, C, h, w) in the logits' dtype, every element written.
// The wrapper's plan: tile, the edge of a block's source tile (16, 8 or 4;
// 0 for the gather variant), rh, rw and smem, the rectangle and the shared
// bytes it expects (0 with the gather variant), and cpc, the channels a
// block takes. A plan that differs from this file's is refused.
extern "C" int seg_ce_bwd(const void* z, const int* labels, int B, int C,
                          int h, int w, int H, int W, int classes, int ignore,
                          int dtype, const float* m, const float* se,
                          const float* gbar, void* dz, int tile, int rh,
                          int rw, int smem, int cpc, void* stream) {
  if (bad_shape(B, C, h, w, H, W) || tile != plan_tile(h, w, H, W) ||
      cpc < 1 || cpc > C) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tile == 0 ? (static_cast<long long>(B) * C > 65535 || rh || rw || smem)
                : (rh != tile_reach(tile, h, H) ||
                   rw != tile_reach(tile, w, W) ||
                   smem != tile_smem_bytes(tile, rh, rw, tile_readers(h, H),
                                           tile_readers(w, W)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = launch_bwd<float>(z, labels, B, C, h, w, H, W, classes, ignore, m,
                            se, gbar, dz, tile, cpc, s);
  } else if (dtype == 1) {
    err = launch_bwd<__nv_bfloat16>(z, labels, B, C, h, w, H, W, classes,
                                    ignore, m, se, gbar, dz, tile, cpc, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
