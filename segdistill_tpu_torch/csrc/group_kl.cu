// K3 and K4: the channel-group KL distillation loss (CGD, CD) for Hopper
// (sm_90a), forward and backward.
//
// Replaces segdistill_tpu/ops/pallas/group_kl.py::fused_group_kl_shuffled
// (forward and backward, the pallas_calls at group_kl.py:474 and :527) and,
// with the identity permutation, fused_group_kl (:347 and :389).
//
// For student and teacher maps xs, xt of shape (B, C, h, w), a bilinear
// upsample to (H, W) (torch's align_corners=False taps, any ratio), the
// channels taken in `perm` order and cut into K = ceil(C / g) groups of g
// (the last group padded with virtual -1e9 channels), each (b, group) is one
// distribution over its g * H * W values at temperature tau:
//
//   KL(b, k) = W / Z_t - log Z_t + log Z_s,  with m the source maxima,
//   Z = sum exp((r - m) / tau),  W = sum e_t * ((r_t - m_t) - (r_s - m_s)) / tau
//   loss = sum KL / (B * K)
//
// The -1e9 pad channels add exp(-1e9 / tau) = 0 to every sum, so they are
// skipped. The maximum over a group's source values bounds every lerped
// value (a convex combination of sources), so it serves as the softmax
// shift and the partial sums of one group need no rescale when merged.
//
// K3 is the forward tile kernel of common.cuh (fwd_tile) with the loss
// gkl_fwd_tile, after gkl_max. What bounded the kernel it replaces (a flat
// range of each group's values per block): per upsampled value two integer
// divisions, two full taps, eight scattered tap loads from L2 and two expf,
// ~80-100 instructions a pair of values, with neighbouring outputs
// re-deriving the same taps and re-loading the same sources; and a third
// launch to merge. Now a block owns one (image, group)'s output tile of 128
// rows x 64 columns (3,840 blocks at the bench shape, (8, 150, 128, 128) ->
// 512^2, g = 10; four blocks an SM). Per position it stages the window of
// sources that the tile reads (36 x 20 at ratio 4) of both maps in shared
// memory, the next position's while this one computes; a thread walks 32 rows
// of one column with its x tap in registers and x-lerps a source row only
// when its y tap moves on. Per value: one lerp, one FMA and one ex2 per map,
// three sums; no division, no tap and no global load. The group's source
// maximum (gkl_max, one pass over the sources) bounds every lerped value, a
// convex combination of sources, so it is the shift of every block's sums,
// which then merge without a rescale: the group's last block sums its tiles'
// partials in tile order, the last group's block the KLs in group order
// (last_to_arrive: a ticket counter that gkl_max set to 0), so the loss and
// the stats are bitwise reproducible and take two launches, not three. What
// bounds it now: the exponentials, 2 a value on the special-function units
// (16 a clock an SM: a floor of ~0.15 ms for the bench shape's 629 M), with
// ~7 other instructions a value and a barrier a position beside them; it runs
// at ~2.2x that floor (PERF.md). Shapes whose window the block does not stage
// (ratios near 1 and below; plan_fwd) take the gather variant, gkl_sum and
// gkl_finalize below; the variant follows from the shapes alone, and the
// wrapper's plan must agree or the launch is refused.
//
// K4 is the tile kernel of common.cuh (tile_bwd) with the loss gkl_tile, as
// K6 is with its own. What bounded the gather it replaces: one thread per
// source element walked the ~(2r)^2 outputs that read it and evaluated
// both upsampled values there from global memory (8 taps, 2 expf), so each
// upsampled value was evaluated 4 times. Now a block owns one image's tile
// of 16 x 16 source pixels (8 x 8 or 4 x 4 where the ratio is large) and a
// chunk of shuffled positions; per position it reads the source channel
// perm[position] and the stats of its group (scalars, loaded once a
// position, never in the loop over outputs), loads both maps' tiles of
// that channel (the next position's while this one computes), evaluates
// p_s - p_t once at every output of the rectangle that reads the tile
// (71 x 71 at 128 -> 512), sums it back through the transposed upsample
// one axis after the other and writes the result once, to the source
// channel. No per-output map is kept, so a block takes ~32 KB of shared
// memory and registers bound how many fit an SM: three at 40 registers
// (two, with more registers, were slower). What bounds it now: the
// instructions of the evaluation (eight shared loads, two exp2f per
// upsampled value) and the two barriers a position. Each group's (m, Z)
// is folded into one log-sum-exp L = m / tau + log Z, and p = exp2(u *
// log2 e / tau - L * log2 e), which moves a probability by about |L| *
// 2^-23 against exp((u - m) / tau) / Z. Shapes whose rectangle fits no
// tile's shared memory (ratios above ~30) take the gather variant below;
// the variant follows from the shapes alone (plan_tile), and the wrapper's
// plan must agree or the launch is refused. Each source channel has one
// position, so each element one owner: no atomics, the gradient is
// bitwise reproducible.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include "common.cuh"

namespace {

using namespace segdistill;

// Pass 1: partial maxima of one group's source values, student and
// teacher: block (bk, split) takes the split-th slice of each of the
// group's planes in turn.
// It also sets the tile variant's tickets (one a group and one for all,
// `tickets`, or null) to 0 for the launch that follows on its stream.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gkl_max(const T* __restrict__ xs, const T* __restrict__ xt,
            const int* __restrict__ perm, int C, int g, int K, int hw,
            float* __restrict__ pmax, int* __restrict__ tickets) {
  const int bk = blockIdx.x;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  if (tickets && split == 0 && threadIdx.x == 0) {
    tickets[bk] = 0;
    if (bk == 0) tickets[gridDim.x] = 0;
  }
  const int b = bk / K;
  const int k = bk - b * K;
  const int n = min(g, C - k * g);
  const int chunk = (hw + splits - 1) / splits;
  const int lo = split * chunk;
  const int hi = min(hw, lo + chunk);
  float v[2] = {-INFINITY, -INFINITY};
  for (int l = 0; l < n; ++l) {
    const long long off = (static_cast<long long>(b) * C + perm[k * g + l]) *
                          hw;
    const T* s = xs + off;
    const T* t = xt + off;
    for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
      v[0] = fmaxf(v[0], to_f32(s[i]));
      v[1] = fmaxf(v[1], to_f32(t[i]));
    }
  }
  block_max<2>(v);
  if (threadIdx.x == 0) {
    pmax[(bk * splits + split) * 2] = v[0];
    pmax[(bk * splits + split) * 2 + 1] = v[1];
  }
}

__device__ __forceinline__ void group_max(const float* __restrict__ pmax,
                                          int bk, int splits, float& ms,
                                          float& mt) {
  ms = -INFINITY;
  mt = -INFINITY;
  for (int i = 0; i < splits; ++i) {
    ms = fmaxf(ms, pmax[(bk * splits + i) * 2]);
    mt = fmaxf(mt, pmax[(bk * splits + i) * 2 + 1]);
  }
}

// The forward on output tiles (fwd_tile of common.cuh): a block owns one
// (image, group) slice's tile of 128 x 64 outputs and walks the group's
// positions; per position it stages the window of both maps of source
// channel perm[k * g + pos] and sums, at every output of the tile, with
// a, b the upsampled values times log2 e / tau less the group's maxima
// times it (one FMA each),
//   Z_s += 2^a_s,  Z_t += 2^a_t,  W += 2^a_t * (a_t - a_s)
// (W in base 2: ln 2 turns it into the natural one). The block's sums go to
// psum; the group's last block to finish sums its group's partials in tile
// order, writes the stats and the group's KL, and the last group's block
// sums the KLs in group order into the loss: a fixed order, bitwise
// reproducible, no third launch.
template <typename T>
struct gkl_fwd_tile {
  static constexpr int kUnits = 2;
  static constexpr int kRows = 32;
  static constexpr int kSlots = 3;
  static constexpr int kResident = 4;
  struct State {
    float ms, mt;    // the group's source maxima
    float ks, kt;    // the same times log2 e / tau
    float zs, zt, w;
  };
  const T* xs;
  const T* xt;
  const int* perm;
  const float* pmax;
  float* psum;     // (B * K, tiles, 3) partial sums
  float* kl;       // (B * K) the groups' KLs
  int* tickets;    // (B * K + 1), 0 from gkl_max
  float* stats;
  float* loss;
  int C, g, K, max_splits;
  long long plane;
  float k2;        // log2 e / tau

  __device__ __forceinline__ int steps(int bk) const {
    return min(g, C - (bk % K) * g);
  }
  __device__ __forceinline__ int units(int, int) const { return kUnits; }
  __device__ __forceinline__ const T* base(int bk, int pos, int map) const {
    const int b = bk / K;
    return (map ? xt : xs) +
           (static_cast<long long>(b) * C + perm[(bk - b * K) * g + pos]) *
               plane;
  }
  // the group's maxima from gkl_max's partials, each warp on its own
  // (its lanes load them in parallel)
  __device__ __forceinline__ void begin(State& st, int bk, const FwdTile&,
                                        int, int, bool) const {
    st.ms = st.mt = -INFINITY;
    for (int i = threadIdx.x & 31; i < max_splits; i += 32) {
      const float* p = pmax + (static_cast<long long>(bk) * max_splits + i) * 2;
      st.ms = fmaxf(st.ms, p[0]);
      st.mt = fmaxf(st.mt, p[1]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      st.ms = fmaxf(st.ms, __shfl_xor_sync(0xffffffffu, st.ms, off));
      st.mt = fmaxf(st.mt, __shfl_xor_sync(0xffffffffu, st.mt, off));
    }
    st.ks = st.ms * k2;
    st.kt = st.mt * k2;
    st.zs = st.zt = st.w = 0.0f;
  }
  __device__ __forceinline__ void row(State& st, int, const float (&v)[2],
                                      int) const {
    const float as = fmaf(v[0], k2, -st.ks);
    const float at = fmaf(v[1], k2, -st.kt);
    const float et = exp2_ftz(at);
    st.zs += exp2_ftz(as);
    st.zt += et;
    st.w = fmaf(et, at - as, st.w);
  }
  __device__ __forceinline__ void finish(State& st, int bk, const FwdTile&,
                                         int, int, bool) const {
    float acc[3] = {st.zs, st.zt, st.w};
    block_sum<float, 3>(acc);
    const int tiles = gridDim.x;
    const long long first = static_cast<long long>(bk) * tiles;
    if (threadIdx.x == 0) {
      float* p = psum + (first + blockIdx.x) * 3;
      p[0] = acc[0];
      p[1] = acc[1];
      p[2] = acc[2];
    }
    if (!last_to_arrive(tickets + bk, tiles)) return;
    double sum[3] = {0.0, 0.0, 0.0};
    for (int i = threadIdx.x; i < tiles; i += kFwdThreads) {
      const float* p = psum + (first + i) * 3;
      sum[0] += __ldcg(p);
      sum[1] += __ldcg(p + 1);
      sum[2] += __ldcg(p + 2);
    }
    block_sum<double, 3>(sum);
    if (threadIdx.x == 0) {
      const float zs = static_cast<float>(sum[0]);
      const float zt = static_cast<float>(sum[1]);
      const float wsum = static_cast<float>(sum[2] * 0.69314718055994531);
      stats[bk * 4] = st.ms;
      stats[bk * 4 + 1] = st.mt;
      stats[bk * 4 + 2] = zs;
      stats[bk * 4 + 3] = zt;
      kl[bk] = wsum / zt - logf(zt) + logf(zs);
    }
    const int BK = gridDim.y;
    if (!last_to_arrive(tickets + BK, BK)) return;
    double total[1] = {0.0};
    for (int i = threadIdx.x; i < BK; i += kFwdThreads)
      total[0] += __ldcg(kl + i);
    block_sum<double, 1>(total);
    if (threadIdx.x == 0) loss[0] = static_cast<float>(total[0] / BK);
  }
};

// The gather variant of K3's forward, for shapes whose windows the tile
// does not stage (ratios near 1 and below): pass 2, partial (Z_s, Z_t, W)
// over a slice of one group's upsampled values, each from its four taps
// in global memory, then gkl_finalize.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gkl_sum(const T* __restrict__ xs, const T* __restrict__ xt,
            const int* __restrict__ perm, int C, int g, int K, int h, int w,
            int H, int W, float inv_tau, const float* __restrict__ pmax,
            int max_splits, float* __restrict__ psum) {
  const int bk = blockIdx.x;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int b = bk / K;
  const int k = bk - b * K;
  float ms, mt;
  group_max(pmax, bk, max_splits, ms, mt);
  const int HW = H * W;
  const int n = min(g, C - k * g) * HW;
  const int chunk = (n + splits - 1) / splits;
  const int lo = split * chunk;
  const int hi = min(n, lo + chunk);
  const long long plane = static_cast<long long>(h) * w;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int idx = lo + threadIdx.x; idx < hi; idx += kThreads) {
    const int l = idx / HW;
    const int r = idx - l * HW;
    const int y = r / W;
    const Tap ty = tap(y, h, H);
    const Tap tx = tap(r - y * W, w, W);
    const long long base =
        (static_cast<long long>(b) * C + perm[k * g + l]) * plane;
    const float ds = (bilerp(xs + base, w, ty, tx) - ms) * inv_tau;
    const float dt = (bilerp(xt + base, w, ty, tx) - mt) * inv_tau;
    const float et = expf(dt);
    acc[0] += expf(ds);
    acc[1] += et;
    acc[2] += et * (dt - ds);
  }
  block_sum<float, 3>(acc);
  if (threadIdx.x == 0) {
    float* out = psum + (bk * splits + split) * 3;
    out[0] = acc[0];
    out[1] = acc[1];
    out[2] = acc[2];
  }
}

// One block: merge the partials of every group in a fixed order, keep the
// stats (m_s, m_t, Z_s, Z_t) for the backward, and average the KLs.
__global__ void __launch_bounds__(kThreads)
    gkl_finalize(int BK, const float* __restrict__ pmax, int max_splits,
                 const float* __restrict__ psum, int sum_splits,
                 float* __restrict__ stats, float* __restrict__ loss) {
  double total[1] = {0.0};
  for (int bk = threadIdx.x; bk < BK; bk += kThreads) {
    float ms, mt;
    group_max(pmax, bk, max_splits, ms, mt);
    float zs = 0.0f, zt = 0.0f, wsum = 0.0f;
    for (int i = 0; i < sum_splits; ++i) {
      const float* p = psum + (bk * sum_splits + i) * 3;
      zs += p[0];
      zt += p[1];
      wsum += p[2];
    }
    stats[bk * 4] = ms;
    stats[bk * 4 + 1] = mt;
    stats[bk * 4 + 2] = zs;
    stats[bk * 4 + 3] = zt;
    total[0] += static_cast<double>(wsum / zt - logf(zt) + logf(zs));
  }
  block_sum<double, 1>(total);
  if (threadIdx.x == 0) loss[0] = static_cast<float>(total[0] / BK);
}

// K4's loss on the tile of common.cuh: no per-output map; position pos
// reads source channel perm[pos] and the stats of group pos / g, folded
// into the group's log-sum-exps in base 2, and at every output p_s - p_t,
// each p = exp2(u * log2 e / tau - L * log2 e) (one FMA and an exp2f).
struct gkl_tile {
  static constexpr int kSrcMaps = 2;
  static constexpr int kRectMaps = 0;
  static constexpr int kResident = 3;
  struct Channel {
    int source;
    float ls, lt;  // the group's log-sum-exps of u / tau, times log2 e
  };
  const int* perm;
  const float* stats;
  const float* gbar;
  int g, K;
  float inv_tau, inv_bk;

  __device__ void pixel(long long, float*, int) const {}
  __device__ Channel channel(int b, int pos) const {
    const float* st = stats + (b * K + pos / g) * 4;
    return {perm[pos], fmaf(st[0], inv_tau, logf(st[2])) * kLog2e,
            fmaf(st[1], inv_tau, logf(st[3])) * kLog2e};
  }
  __device__ int source(int pos) const { return perm[pos]; }
  __device__ float eval(const Channel& ch, const float (&v)[2], const float*,
                        int) const {
    const float k = inv_tau * kLog2e;
    return exp2f(fmaf(v[0], k, -ch.ls)) - exp2f(fmaf(v[1], k, -ch.lt));
  }
  __device__ float scale() const { return gbar[0] * inv_tau * inv_bk; }
};

// The gather variant of K4, for shapes no tile fits: dL/dxs for one source
// element, written to its source channel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gkl_bwd(const T* __restrict__ xs, const T* __restrict__ xt,
            const int* __restrict__ perm, int C, int g, int K, int h, int w,
            int H, int W, float inv_tau, float inv_bk,
            const float* __restrict__ stats, const float* __restrict__ gbar,
            T* __restrict__ dxs) {
  const int hw = h * w;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= hw) return;
  const int b = blockIdx.y / C;
  const int pos = blockIdx.y - b * C;
  const float* st = stats + (b * K + pos / g) * 4;
  const float ms = st[0];
  const float mt = st[1];
  const float izs = 1.0f / st[2];
  const float izt = 1.0f / st[3];
  const long long base =
      (static_cast<long long>(b) * C + perm[pos]) * static_cast<long long>(hw);
  const T* s = xs + base;
  const T* t = xt + base;
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
      const float ps = expf((bilerp(s, w, ty, tx) - ms) * inv_tau) * izs;
      const float pt = expf((bilerp(t, w, ty, tx) - mt) * inv_tau) * izt;
      acc += wy * wx * (ps - pt);
    }
  }
  dxs[base + p] = from_f32<T>(acc * gbar[0] * inv_tau * inv_bk);
}

bool bad_shape(int B, int C, int h, int w, int H, int W, int g) {
  const long long lim = 0x7fffffffLL;
  return B < 1 || C < 1 || h < 1 || w < 1 || H < 1 || W < 1 || g < 1 ||
         static_cast<long long>(g) * H * W > lim ||
         static_cast<long long>(h) * w > lim ||
         static_cast<long long>(B) * ((C + g - 1) / g) > lim;
}

template <typename T>
cudaError_t launch_fwd(const void* xs, const void* xt, const int* perm,
                       int B, int C, int h, int w, int H, int W, int g,
                       float inv_tau, int oh, int max_splits, int sum_splits,
                       float* pmax, float* psum, float* stats, float* loss,
                       cudaStream_t s) {
  const int K = (C + g - 1) / g;
  const int BK = B * K;
  const T* a = static_cast<const T*>(xs);
  const T* b = static_cast<const T*>(xt);
  if (oh == 0) {
    gkl_max<T><<<dim3(BK, max_splits), kThreads, 0, s>>>(
        a, b, perm, C, g, K, h * w, pmax, nullptr);
    gkl_sum<T><<<dim3(BK, sum_splits), kThreads, 0, s>>>(
        a, b, perm, C, g, K, h, w, H, W, inv_tau, pmax, max_splits, psum);
    gkl_finalize<<<1, kThreads, 0, s>>>(BK, pmax, max_splits, psum,
                                        sum_splits, stats, loss);
    return cudaSuccess;
  }
  const long long tiles = static_cast<long long>((H + oh - 1) / oh) *
                          ((W + kFwdCols - 1) / kFwdCols);
  float* kl = psum + BK * tiles * 3;
  int* tickets = reinterpret_cast<int*>(kl + BK);
  gkl_max<T><<<dim3(BK, max_splits), kThreads, 0, s>>>(
      a, b, perm, C, g, K, h * w, pmax, tickets);
  const gkl_fwd_tile<T> fwd{a, b, perm, pmax, psum, kl, tickets, stats, loss,
                            C, g, K, max_splits,
                            static_cast<long long>(h) * w, inv_tau * kLog2e};
  return launch_fwd_tile<T>(fwd, BK, h, w, H, W, oh, s);
}

template <typename T>
cudaError_t launch_bwd(const void* xs, const void* xt, const int* perm,
                       int B, int C, int h, int w, int H, int W, int g,
                       float inv_tau, const float* stats, const float* gbar,
                       void* dxs, int tile, int cpc, cudaStream_t s) {
  const int K = (C + g - 1) / g;
  const float inv_bk = 1.0f / static_cast<float>(B * K);
  if (tile == 0) {
    const dim3 grid((h * w + kThreads - 1) / kThreads, B * C);
    gkl_bwd<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(xs), static_cast<const T*>(xt), perm, C, g, K,
        h, w, H, W, inv_tau, inv_bk, stats, gbar, static_cast<T*>(dxs));
    return cudaSuccess;
  }
  const gkl_tile loss{perm, stats, gbar, g, K, inv_tau, inv_bk};
  return launch_tile_bwd<T>(loss, xs, xt, dxs, B, C, h, w, H, W, tile, cpc,
                            s);
}

}  // namespace

// xs, xt: (B, C, h, w) contiguous, both float32 (dtype 0) or bfloat16 (1).
// perm: int32 (C,) on the device, shuffled position -> source channel.
// The wrapper's plan: oh, the rows of an output tile (0: the gather
// variant), wy, wx and smem, the window and the shared bytes it expects (0
// with the gather variant); a plan that differs from this file's is
// refused. Scratch from the caller, float32: pmax (B*K*max_splits*2) and
// psum, of B*K*sum_splits*3 floats for the gather variant and, for the
// tile variant, B*K*tiles*3 partials, B*K KLs and B*K + 1 int32 tickets
// (tiles = ceil(H / oh) * ceil(W / 64); sum_splits unused). Outputs:
// stats (B*K*4) float32 and loss (1) float32.
extern "C" int group_kl_fwd(const void* xs, const void* xt, const int* perm,
                            int B, int C, int h, int w, int H, int W, int g,
                            float tau, int dtype, int oh, int wy, int wx,
                            int smem, int max_splits, int sum_splits,
                            float* pmax, float* psum, float* stats,
                            float* loss, void* stream) {
  if (bad_shape(B, C, h, w, H, W, g) || !(tau > 0.0f) || max_splits < 1 ||
      max_splits > 65535 || sum_splits < 1 || sum_splits > 65535 ||
      !fwd_plan_ok<gkl_fwd_tile<float>>(h, w, H, W, oh, wy, wx, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = launch_fwd<float>(xs, xt, perm, B, C, h, w, H, W, g, 1.0f / tau,
                            oh, max_splits, sum_splits, pmax, psum, stats,
                            loss, s);
  } else if (dtype == 1) {
    err = launch_fwd<__nv_bfloat16>(xs, xt, perm, B, C, h, w, H, W, g,
                                    1.0f / tau, oh, max_splits, sum_splits,
                                    pmax, psum, stats, loss, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// stats: the forward's; gbar: the loss's incoming gradient, float32 (1)
// on the device. dxs: (B, C, h, w) in the inputs' dtype, every element
// written. The wrapper's plan: tile, the edge of a block's source tile (16,
// 8 or 4; 0 for the gather variant), rh, rw and smem, the rectangle and the
// shared bytes it expects (0 with the gather variant), and cpc, the
// positions a block takes. A plan that differs from this file's is refused.
extern "C" int group_kl_bwd(const void* xs, const void* xt, const int* perm,
                            int B, int C, int h, int w, int H, int W, int g,
                            float tau, int dtype, const float* stats,
                            const float* gbar, void* dxs, int tile, int rh,
                            int rw, int smem, int cpc, void* stream) {
  if (bad_shape(B, C, h, w, H, W, g) || !(tau > 0.0f) ||
      !tile_plan_ok<gkl_tile>(B, C, h, w, H, W, tile, rh, rw, smem, cpc)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = launch_bwd<float>(xs, xt, perm, B, C, h, w, H, W, g, 1.0f / tau,
                            stats, gbar, dxs, tile, cpc, s);
  } else if (dtype == 1) {
    err = launch_bwd<__nv_bfloat16>(xs, xt, perm, B, C, h, w, H, W, g,
                                    1.0f / tau, stats, gbar, dxs, tile, cpc,
                                    s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
