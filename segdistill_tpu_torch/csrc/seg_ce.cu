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
// K5 is the forward tile kernel of common.cuh (fwd_tile) with the loss
// ce_fwd_tile. What bounded the kernel it replaces (one thread per output
// pixel walking all C channels): per channel four scattered tap loads from
// L2 with 64-bit address arithmetic, and an online softmax whose branch on a
// new maximum (an expf on both sides) diverged within warps, a serial chain
// of dependent loads and exps through each pixel; and a second launch to
// merge. Now a block owns one image's output tile of 32 rows x 64 columns
// (1,024 blocks at the bench shape, (8, 150, 128, 128) -> 512^2; two blocks
// an SM, 120 registers a thread) and walks the channels in chunks of 8 whose
// windows of sources (12 x 20 at ratio 4) sit in shared memory, the next
// chunk's in flight; a thread walks 8 rows of one column with its x tap in
// registers and x-lerps a source row only when its y tap moves on. Per
// value: one lerp, a maximum, one ex2 of one FMA, and a select for the
// argmax; per output and chunk one rescale; per pixel the label's logit,
// lerped once at the end. What bounds it now: ~12 instructions a value and 1
// + 1/8 exponentials (the special-function units' floor, 16 a clock an SM,
// is ~0.08 ms at the bench shape), and a barrier a chunk at two blocks an
// SM; it runs at ~2.8x that floor (PERF.md). The per-pixel (max, exp-sum) go
// to memory for K6 (2 x 8 MB at 8 x 512 x 512); the (B, C, H, W) upsampled
// logits, 1.26 GB in fp32 at the bench shape, never do. The blocks' (ce_sum,
// correct) are summed by the last block to finish in block order, so both
// sums are deterministic. Shapes whose window the block does not stage
// (ratios near 1 and below; plan_fwd) take the gather variant, ce_fwd and
// ce_finalize; the variant follows from the shapes alone, and the wrapper's
// plan must agree or the launch is refused.
//
// K6 is the tile kernel of common.cuh (tile_bwd) with the loss ce_tile;
// K4 and K8 instantiate the same kernel with theirs. A block owns one
// image's tile of 16 x 16 source pixels (8 x 8 or 4 x 4 where the ratio is
// large) and a chunk of the channels. The outputs that read the tile form
// one rectangle (68 x 68 at 128 -> 512). Once per block their label and
// log-sum-exp (max + log exp-sum) go to shared memory with the taps of the
// rectangle's rows and columns and, for each row and column of the tile,
// its readers and their weights. Per channel the tile and its halo are
// loaded (the next channel's while this one computes), every output of the
// rectangle gets its upsampled logit and softmax - onehot once, into a
// shared buffer, and the transposed upsample runs over that buffer one
// axis after the other: ~1.13 evaluations per upsampled value and 8 + 8
// taps per source element, where a gather per source element takes 4 and
// 64 and reads each pixel's label, max and exp-sum once per channel. What
// bounds it now: the instructions of the evaluation (a thread keeps its
// column's tap in registers; per upsampled value the row's tap, four
// shared loads of the sources, the label and log-sum-exp, an expf and a
// store) and the two barriers a channel, not memory. One owner per source
// element and a fixed order of summation: no atomics, the gradient is
// bitwise reproducible. Shapes whose rectangle fits no tile's shared
// memory (ratios above ~15) take the gather variant: one thread per source
// element walks the ~(2r)^2 outputs that read it. The variant follows from
// the shapes alone (plan_tile), and the wrapper's plan must agree or the
// launch is refused.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include "common.cuh"

namespace {

using namespace segdistill;

__device__ __forceinline__ bool valid_label(int y, int classes, int ignore) {
  return y != ignore && y >= 0 && y < classes;
}

// K5 on the forward tile of common.cuh (fwd_tile): a block owns one
// image's output tile of 32 rows x 64 columns and walks the channels in
// chunks of 8, each chunk's windows staged in shared memory (the next
// chunk's while this one computes; channels past C staged as kFwdPad). A
// thread walks 8 rows of one column and keeps per output its running
// maximum m, exp-sum se and argmax. Per output and chunk: the chunk's 8
// upsampled values, their maximum, se rescaled once to the new m (no
// data-dependent branch), one ex2 of one FMA per value; the argmax is the
// chunk's first maximum where it beats m strictly (the first maximum over
// all channels wins, as in torch.argmax). At the end every pixel's (m, se)
// go to memory for K6, its label's logit is lerped once from its four taps
// (the walk's arithmetic), and the block's (ce_sum, correct) go to part;
// the last block to finish sums the parts in block order.
template <typename T>
struct ce_fwd_tile {
  static constexpr int kUnits = 8;
  static constexpr int kRows = 8;
  static constexpr int kSlots = 1;
  static constexpr int kResident = 2;
  struct State {
    float m[kRows], se[kRows];
    int best[kRows];
  };
  const T* z;
  const int* labels;
  float* m_out;
  float* se_out;
  float* part;     // 2 floats a block
  int* ticket;     // 0 between launches: the last block sets it back
  float* ce_sum;
  float* correct;
  int C, h, w, H, W, classes, ignore;

  __device__ __forceinline__ int steps(int) const {
    return (C + kUnits - 1) / kUnits;
  }
  __device__ __forceinline__ int units(int, int s) const {
    return min(kUnits, C - s * kUnits);
  }
  __device__ __forceinline__ const T* channel(int b, int c) const {
    return z + (static_cast<long long>(b) * C + c) * h * w;
  }
  __device__ __forceinline__ const T* base(int b, int s, int i) const {
    return channel(b, s * kUnits + i);
  }
  __device__ __forceinline__ void begin(State& st, int, const FwdTile&, int,
                                        int, bool) const {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      st.m[r] = -INFINITY;
      st.se[r] = 0.0f;
      st.best[r] = 0;
    }
  }
  __device__ __forceinline__ void row(State& st, int r,
                                      const float (&v)[kUnits], int s) const {
    float cm = v[0];
#pragma unroll
    for (int u = 1; u < kUnits; ++u) cm = fmaxf(cm, v[u]);
    int first = kUnits - 1;  // the chunk's first maximum, from the back
#pragma unroll
    for (int u = kUnits - 2; u >= 0; --u) first = v[u] == cm ? u : first;
    const float m_old = st.m[r];
    const float m = fmaxf(m_old, cm);
    st.best[r] = cm > m_old ? s * kUnits + first : st.best[r];
    const float mk = m * kLog2e;
    float se = st.se[r] * exp2_ftz((m_old - m) * kLog2e);
#pragma unroll
    for (int u = 0; u < kUnits; ++u) se += exp2_ftz(fmaf(v[u], kLog2e, -mk));
    st.m[r] = m;
    st.se[r] = se;
  }
  __device__ __forceinline__ void finish(State& st, int b, const FwdTile& t,
                                         int seg, int col, bool ok) const {
    float acc[2] = {0.0f, 0.0f};
    const Tap tx = tap(t.ox0 + col, w, W);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = seg * kRows + r;
      if (!ok || row >= t.rows) break;
      const long long q =
          (static_cast<long long>(b) * H + t.oy0 + row) * W + t.ox0 + col;
      m_out[q] = st.m[r];
      se_out[q] = st.se[r];
      const int label = labels[q];
      if (valid_label(label, classes, ignore)) {
        float zy = 0.0f;
        if (label < C) {
          const Tap ty = tap(t.oy0 + row, h, H);
          const T* p = channel(b, label);
          const auto xlerp = [&](int i) {
            const float v0 = to_f32(p[i * w + tx.i0]);
            return fmaf(tx.f, to_f32(p[i * w + tx.i1]) - v0, v0);
          };
          const float top = xlerp(ty.i0);
          zy = fmaf(ty.f, xlerp(ty.i1) - top, top);
        }
        acc[0] += st.m[r] + logf(st.se[r]) - zy;
        acc[1] += st.best[r] == label ? 1.0f : 0.0f;
      }
    }
    block_sum<float, 2>(acc);
    const int blocks = gridDim.x * gridDim.y;
    if (threadIdx.x == 0) {
      const int blk = blockIdx.y * gridDim.x + blockIdx.x;
      part[2 * blk] = acc[0];
      part[2 * blk + 1] = acc[1];
    }
    if (!last_to_arrive(ticket, blocks)) return;
    double sum[2] = {0.0, 0.0};
    for (int i = threadIdx.x; i < blocks; i += kFwdThreads) {
      sum[0] += __ldcg(part + 2 * i);
      sum[1] += __ldcg(part + 2 * i + 1);
    }
    block_sum<double, 2>(sum);
    if (threadIdx.x == 0) {
      ce_sum[0] = static_cast<float>(sum[0]);
      correct[0] = static_cast<float>(sum[1]);
      *ticket = 0;
    }
  }
};

// The gather variant of K5, for shapes whose windows the tile does not
// stage (ratios near 1 and below): one thread per output pixel, an online
// softmax over the channels from four taps each in global memory, then
// ce_finalize.
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

// K6's loss on the tile of common.cuh: per output its label (-1 where it
// is ignored) and log-sum-exp; per channel c, softmax - onehot(c).
struct ce_tile {
  static constexpr int kSrcMaps = 1;
  static constexpr int kRectMaps = 2;
  static constexpr int kResident = 3;  // 40 registers at 512 threads
  struct Channel {
    int source;
  };
  const int* labels;
  const float* m;
  const float* se;
  const float* gbar;
  int classes, ignore;

  __device__ void pixel(long long q, float* r, int stride) const {
    const int label = labels[q];
    const bool ok = valid_label(label, classes, ignore);
    // an ignored pixel: no class matches, and exp(v - inf) = 0
    r[0] = __int_as_float(ok ? label : -1);
    r[stride] = ok ? m[q] + logf(se[q]) : INFINITY;
  }
  __device__ Channel channel(int, int c) const { return {c}; }
  __device__ int source(int c) const { return c; }
  __device__ float eval(const Channel& ch, const float (&v)[1],
                        const float* r, int stride) const {
    return expf(v[0] - r[stride]) -
           (__float_as_int(r[0]) == ch.source ? 1.0f : 0.0f);
  }
  __device__ float scale() const { return gbar[0]; }
};

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
cudaError_t launch_fwd(const void* z, const int* labels, int B, int C, int h,
                       int w, int H, int W, int classes, int ignore, int oh,
                       float* m, float* se, float* part, int* ticket,
                       float* ce_sum, float* correct, cudaStream_t s) {
  const T* zt = static_cast<const T*>(z);
  if (oh == 0) {
    const dim3 grid((H * W + kThreads - 1) / kThreads, B);
    ce_fwd<T><<<grid, kThreads, 0, s>>>(zt, labels, C, h, w, H, W, classes,
                                        ignore, m, se, part);
    ce_finalize<<<1, kThreads, 0, s>>>(part, grid.x * grid.y, ce_sum,
                                       correct);
    return cudaSuccess;
  }
  const ce_fwd_tile<T> fwd{zt, labels, m,    se, part, ticket, ce_sum,
                           correct, C, h, w, H, W, classes, ignore};
  return launch_fwd_tile<T>(fwd, B, h, w, H, W, oh, s);
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
  return launch_tile_bwd<T>(ce_tile{labels, m, se, gbar, classes, ignore}, z,
                            z, dz, B, C, h, w, H, W, tile, cpc, s);
}

}  // namespace

// z: (B, C, h, w) contiguous, float32 (dtype 0) or bfloat16 (1); labels:
// int32 (B, H, W). The wrapper's plan: oh, the rows of an output tile (0:
// the gather variant), wy, wx and smem, the window and the shared bytes it
// expects (0 with the gather variant); a plan that differs from this
// file's is refused. Outputs: m, se (B, H, W) float32, the per-pixel max
// and exp-sum; ce_sum, correct (1) float32. Scratch: part, 2 floats a
// block: B * ceil(H / oh) * ceil(W / 64) blocks of the tile variant, B *
// ceil(H*W / 256) of the gather one; ticket, an int32 on the device that
// is 0 (the tile variant leaves it at 0; null for the gather variant).
extern "C" int seg_ce_fwd(const void* z, const int* labels, int B, int C,
                          int h, int w, int H, int W, int classes, int ignore,
                          int dtype, int oh, int wy, int wx, int smem,
                          float* m, float* se, float* part, int* ticket,
                          float* ce_sum, float* correct, void* stream) {
  if (bad_shape(B, C, h, w, H, W) ||
      !fwd_plan_ok<ce_fwd_tile<float>>(h, w, H, W, oh, wy, wx, smem) ||
      (oh && !ticket)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = launch_fwd<float>(z, labels, B, C, h, w, H, W, classes, ignore, oh,
                            m, se, part, ticket, ce_sum, correct, s);
  } else if (dtype == 1) {
    err = launch_fwd<__nv_bfloat16>(z, labels, B, C, h, w, H, W, classes,
                                    ignore, oh, m, se, part, ticket, ce_sum,
                                    correct, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
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
  if (bad_shape(B, C, h, w, H, W) ||
      !tile_plan_ok<ce_tile>(B, C, h, w, H, W, tile, rh, rw, smem, cpc)) {
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
