// K7 and K8: the pixel-wise distillation (PD) loss for Hopper (sm_90a),
// forward and backward.
//
// Replaces segdistill_tpu/ops/pallas/pixel_kl.py::fused_pixel_kl (the
// pallas_calls at pixel_kl.py:169, forward, and :200, backward).
//
// Student and teacher maps xs, xt (B, C, h, w) are upsampled bilinearly
// (torch's align_corners=False taps, any ratio) to (H, W). At every output
// pixel, with u = z / tau, the channel softmaxes p_s, p_t give
//
//   kl_sum = sum over the B*H*W pixels of KL(p_t || p_s)
//          = sum (A / Z_t - (m_t - m_s) + log(Z_s / Z_t)),
//            A = sum_c e_t,c (u_t,c - u_s,c),  e_t,c = exp(u_t,c - m_t)
//   dxs    = g / tau * sum over the pixels that tap a source element of
//            w * (p_s - p_t)                 (g: kl_sum's incoming gradient)
//
// There is no ignore mask: the reference sums over every pixel. The caller
// divides by B*H*W. The teacher gets no gradient.
//
// K7 is the forward tile kernel of common.cuh (fwd_tile) with the loss
// pkl_fwd_tile, as K3 and K5 are with theirs. What bounded the kernel it
// replaces (one thread per output pixel walking all C channels): per
// channel two bilinear values from global memory (8 scattered tap loads,
// 64-bit address arithmetic) and an online softmax of each map whose branch
// on a new maximum, an expf on either side, diverged within warps; ~60-80
// instructions a (channel, pixel) pair; and a second launch to merge. Now a
// block owns one image's output tile of 32 rows x 64 columns (1,024 blocks
// at the bench shape, (8, 150, 128, 128) -> 512^2; two blocks an SM) and
// walks the channels in chunks of 4 of both maps, whose windows of sources
// (12 x 20 at ratio 4) sit in shared memory, the next chunk's in flight; a
// thread walks 8 rows of one column with its x tap in registers and x-lerps a source row only when its
// y tap moves on. Per output it keeps, in base 2, each map's running maximum
// and exp-sum and the cross term A = sum e_t (z_t - z_s); per chunk each map
// takes the chunk's maximum (no per-channel branch) and rescales once. Per
// (channel, pixel): two lerps, two ex2 of one FMA each, three sums. What
// bounds it now: the exponentials, 2 + 2/4 a pair on the special-function
// units (16 a clock an SM: 0.15 ms at the bench shape for 2 a pair), with
// ~11 other instructions a pair and a barrier a chunk beside them. The
// pixel's two log-sum-exps go to memory for K8 (2 x 8 MB at 8 x 512 x 512);
// the plain version's two (B, C, H, W) fp32 upsampled maps, 1.26 GB each at
// the bench shape, never do. The blocks' partial KLs are summed by the last
// block to finish in block order: the loss is deterministic. Shapes whose
// window the block does not stage (ratios near 1 and below; plan_fwd) take
// the gather variant, pkl_fwd and pkl_finalize; the variant follows from the
// shapes alone, and the wrapper's plan must agree or the launch is refused.
//
// A student and a teacher of different sizes (the PSP student at stride 8,
// the B3 teacher at stride 4) are each upsampled at their own ratio, as the
// reference resizes each map to the label size before the KL. Such a pair
// takes the gather variants (pkl_fwd and pkl_finalize forward, pkl_bwd
// backward, instantiated with kTwo), with the teacher's taps and plane its
// own; the tiles' two-geometry form (kTwo in common.cuh), which K3/K4 take,
// is not wired to these losses yet. Same-size pairs keep the plans and
// kernels below unchanged.
//
// K8 is the tile kernel of common.cuh (tile_bwd) with the loss pkl_tile, as
// K6 is with its own. What bounded the gather it replaces: one thread per
// source element walked the ~(2r)^2 outputs that read it and evaluated
// both upsampled logits there from global memory (8 taps, 2 expf), so each
// upsampled value was evaluated 4 times, and it read each pixel's two
// log-sum-exps once per channel (150 x 2 x 8 MB of L2 traffic at the bench
// shape). Now a block owns one image's tile of 16 x 16 source pixels (8 x 8
// or 4 x 4 where the ratio is large) and a chunk of the channels; the
// outputs that read the tile form one rectangle (71 x 71 at 128 -> 512),
// whose two log-sum-exps go to shared memory once per block. Per channel
// the tiles of both maps are loaded (the next channel's while this one
// computes), every output of the rectangle gets both upsampled logits and
// p_s - p_t once, and the transposed upsample runs over that buffer one
// axis after the other. What bounds it now: the instructions of the
// evaluation (per upsampled value eight shared loads of the sources, two
// of the log-sum-exps, two exp2f) and the two barriers a channel, not
// memory. Shapes whose rectangle fits no tile's shared memory (ratios above
// ~15) take the gather variant below; the variant follows from the shapes
// alone (plan_tile), and the wrapper's plan must agree or the launch is
// refused. One owner per source element, a fixed order of summation: no
// atomics, the gradient is bitwise reproducible.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include "common.cuh"

namespace {

using namespace segdistill;

constexpr float kLn2 = 0.69314718f;

// K7 on the forward tile of common.cuh (fwd_tile): a block owns one image's
// output tile of 32 rows x 64 columns and walks the channels in chunks of 4,
// a step's units the pairs (student, teacher) of each channel, staged in
// shared memory (the next chunk's while this one computes; channels past C
// staged as kFwdPad, which add exactly 0: 2^-inf to each exp-sum, and 0 *
// (pad - pad) to A). A thread walks 8 rows of one column and keeps per
// output, with w = z * log2 e / tau, each map's running maximum M of w and
// exp-sum Z = sum 2^(w - M), and A = sum 2^(w_t - M_t) (z_t - z_s). Per
// output and chunk: the chunk's maxima, Z_s, Z_t and A rescaled once to the
// new maxima (A with the teacher's factor), one ex2 of one FMA per value. At
// the end a pixel's log-sum-exps of z / tau, M ln 2 + log Z, go to memory
// for K8 and its KL, A / (tau Z_t) - (M_t - M_s) ln 2 + log(Z_s / Z_t), to
// the block's partial; the last block to finish sums the partials in block
// order. The state is named fields indexed only by the unrolled row, never
// by a runtime value (which would put it in local memory).
template <typename T>
struct pkl_fwd_tile {
  static constexpr int kUnits = 8;  // a step: 4 channels of both maps
  static constexpr int kRows = 8;
  static constexpr int kSlots = 1;
  static constexpr int kResident = 2;  // three spill (tools/sweep_fwd.py)
  static constexpr int kChans = kUnits / 2;
  struct State {
    float ms[kRows], zs[kRows], mt[kRows], zt[kRows], a[kRows];
  };
  const T* xs;
  const T* xt;
  float* lse_s;
  float* lse_t;
  float* part;     // a float a block
  int* ticket;     // 0 between launches: the last block sets it back
  float* kl_sum;
  int C, H, W;
  long long plane;
  float inv_tau;
  float k2;        // log2 e / tau

  __device__ __forceinline__ int steps(int) const {
    return (C + kChans - 1) / kChans;
  }
  // unit 2j is channel j of the chunk in the student's map, 2j + 1 in the
  // teacher's: the chunk's channels fill the first units
  __device__ __forceinline__ int units(int, int s) const {
    return 2 * min(kChans, C - s * kChans);
  }
  __device__ __forceinline__ const T* base(int b, int s, int i) const {
    return ((i & 1) ? xt : xs) +
           (static_cast<long long>(b) * C + s * kChans + (i >> 1)) * plane;
  }
  __device__ __forceinline__ void begin(State& st, int, const FwdTile&, int,
                                        int, bool) const {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      st.ms[r] = st.mt[r] = -INFINITY;
      st.zs[r] = st.zt[r] = st.a[r] = 0.0f;
    }
  }
  __device__ __forceinline__ void row(State& st, int r,
                                      const float (&v)[kUnits], int) const {
    float cs = v[0], ct = v[1];
#pragma unroll
    for (int j = 1; j < kChans; ++j) {
      cs = fmaxf(cs, v[2 * j]);
      ct = fmaxf(ct, v[2 * j + 1]);
    }
    // a chunk holds a channel of C, so both maxima are finite; the first
    // chunk's factors are 2^-inf = 0 on sums of 0
    const float ms = fmaxf(st.ms[r], cs * k2);
    const float mt = fmaxf(st.mt[r], ct * k2);
    const float rt = exp2_ftz(st.mt[r] - mt);
    float zs = st.zs[r] * exp2_ftz(st.ms[r] - ms);
    float zt = st.zt[r] * rt;
    float a = st.a[r] * rt;
#pragma unroll
    for (int j = 0; j < kChans; ++j) {
      zs += exp2_ftz(fmaf(v[2 * j], k2, -ms));
      const float et = exp2_ftz(fmaf(v[2 * j + 1], k2, -mt));
      zt += et;
      a = fmaf(et, v[2 * j + 1] - v[2 * j], a);
    }
    st.ms[r] = ms;
    st.mt[r] = mt;
    st.zs[r] = zs;
    st.zt[r] = zt;
    st.a[r] = a;
  }
  __device__ __forceinline__ void finish(State& st, int b, const FwdTile& t,
                                         int seg, int col, bool ok) const {
    float acc[1] = {0.0f};
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = seg * kRows + r;
      if (!ok || row >= t.rows) break;
      const long long q =
          (static_cast<long long>(b) * H + t.oy0 + row) * W + t.ox0 + col;
      lse_s[q] = fmaf(st.ms[r], kLn2, logf(st.zs[r]));
      lse_t[q] = fmaf(st.mt[r], kLn2, logf(st.zt[r]));
      acc[0] += st.a[r] * inv_tau / st.zt[r] -
                (st.mt[r] - st.ms[r]) * kLn2 + logf(st.zs[r] / st.zt[r]);
    }
    block_sum<float, 1>(acc);
    const int blocks = gridDim.x * gridDim.y;
    if (threadIdx.x == 0) part[blockIdx.y * gridDim.x + blockIdx.x] = acc[0];
    if (!last_to_arrive(ticket, blocks)) return;
    double sum[1] = {0.0};
    for (int i = threadIdx.x; i < blocks; i += kFwdThreads)
      sum[0] += __ldcg(part + i);
    block_sum<double, 1>(sum);
    if (threadIdx.x == 0) {
      kl_sum[0] = static_cast<float>(sum[0]);
      *ticket = 0;
    }
  }
};

// The gather variant of K7, for shapes whose windows the tile does not
// stage (ratios near 1 and below) and for a teacher of another size (kTwo:
// its taps from its own (ht, wt)): one thread per output pixel, an online
// softmax of both maps over the channels from four taps each in global
// memory, then pkl_finalize.
template <typename T, bool kTwo>
__global__ void __launch_bounds__(kThreads)
    pkl_fwd(const T* __restrict__ xs, const T* __restrict__ xt, int C, int h,
            int w, int ht, int wt, int H, int W, float inv_tau,
            float* __restrict__ lse_s, float* __restrict__ lse_t,
            float* __restrict__ part) {
  const int HW = H * W;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  float acc[1] = {0.0f};
  if (p < HW) {
    const int y = p / W;
    const Tap ty = tap(y, h, H);
    const Tap tx = tap(p - y * W, w, W);
    const Tap tyt = kTwo ? tap(y, ht, H) : ty;
    const Tap txt = kTwo ? tap(p - y * W, wt, W) : tx;
    const long long plane = static_cast<long long>(h) * w;
    const long long plane_t = kTwo ? static_cast<long long>(ht) * wt : plane;
    const T* sb = xs + static_cast<long long>(b) * C * plane;
    const T* tb = xt + static_cast<long long>(b) * C * plane_t;
    float ms = -INFINITY, zs = 0.0f;  // student: running max and exp-sum
    float mt = -INFINITY, zt = 0.0f;  // teacher
    float a = 0.0f;                   // sum e_t (u_t - u_s), at shift mt
    for (int c = 0; c < C; ++c) {
      const float us = bilerp(sb + c * plane, w, ty, tx) * inv_tau;
      const float ut =
          bilerp(tb + c * plane_t, kTwo ? wt : w, tyt, txt) * inv_tau;
      if (us > ms) {
        zs = zs * expf(ms - us) + 1.0f;
        ms = us;
      } else {
        zs += expf(us - ms);
      }
      if (ut > mt) {
        const float r = expf(mt - ut);
        zt = zt * r + 1.0f;
        a = a * r + (ut - us);
        mt = ut;
      } else {
        const float e = expf(ut - mt);
        zt += e;
        a = fmaf(e, ut - us, a);
      }
    }
    const long long q = static_cast<long long>(b) * HW + p;
    lse_s[q] = ms + logf(zs);
    lse_t[q] = mt + logf(zt);
    acc[0] = a / zt - (mt - ms) + logf(zs / zt);
  }
  block_sum<float, 1>(acc);
  if (threadIdx.x == 0) part[blockIdx.y * gridDim.x + blockIdx.x] = acc[0];
}

__global__ void __launch_bounds__(kThreads)
    pkl_finalize(const float* __restrict__ part, int n_blocks,
                 float* __restrict__ kl_sum) {
  double acc[1] = {0.0};
  for (int i = threadIdx.x; i < n_blocks; i += kThreads) acc[0] += part[i];
  block_sum<double, 1>(acc);
  if (threadIdx.x == 0) kl_sum[0] = static_cast<float>(acc[0]);
}

// K8's loss on the tile of common.cuh: per output the two log-sum-exps
// of z / tau, in base 2 (times log2 e); at every output p_s - p_t, each
// p = exp2(z * log2 e / tau - lse * log2 e): one FMA and an exp2f, where
// expf would scale its argument itself (7% of K8's time at the bench
// shape on an H100).
struct pkl_tile {
  static constexpr int kSrcMaps = 2;
  static constexpr int kRectMaps = 2;
  static constexpr int kResident = 3;
  struct Channel {
    int source;
  };
  const float* lse_s;
  const float* lse_t;
  const float* gbar;
  float inv_tau;

  __device__ void pixel(long long q, float* r, int stride) const {
    r[0] = lse_s[q] * kLog2e;
    r[stride] = lse_t[q] * kLog2e;
  }
  __device__ Channel channel(int, int c) const { return {c}; }
  __device__ int source(int c) const { return c; }
  __device__ float eval(const Channel&, const float (&v)[2], const float* r,
                        int stride) const {
    const float k = inv_tau * kLog2e;
    return exp2f(fmaf(v[0], k, -r[0])) - exp2f(fmaf(v[1], k, -r[stride]));
  }
  __device__ float scale() const { return gbar[0] * inv_tau; }
};

// The gather variant of K8, for shapes no tile fits and for a teacher of
// another size (kTwo: its taps from its own (ht, wt) at each output).
template <typename T, bool kTwo>
__global__ void __launch_bounds__(kThreads)
    pkl_bwd(const T* __restrict__ xs, const T* __restrict__ xt, int C, int h,
            int w, int ht, int wt, int H, int W, float inv_tau,
            const float* __restrict__ lse_s, const float* __restrict__ lse_t,
            const float* __restrict__ gbar, T* __restrict__ dxs) {
  const int hw = h * w;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= hw) return;
  const int b = blockIdx.y / C;
  const long long base = static_cast<long long>(blockIdx.y) * hw;
  const T* sc = xs + base;
  const T* tc = xt + (kTwo ? static_cast<long long>(blockIdx.y) * ht * wt
                           : base);
  const long long img = static_cast<long long>(b) * H * W;
  const float* lsb = lse_s + img;
  const float* ltb = lse_t + img;
  const int i = p / w;
  const int j = p - i * w;
  const int x_start = first_reader(j, w, W);
  float acc = 0.0f;
  for (int y = first_reader(i, h, H); y < H; ++y) {
    const Tap ty = tap(y, h, H);
    if (ty.i0 > i) break;
    const float wy = tap_weight(ty, i);
    if (wy == 0.0f) continue;
    const Tap tyt = kTwo ? tap(y, ht, H) : ty;
    for (int x = x_start; x < W; ++x) {
      const Tap tx = tap(x, w, W);
      if (tx.i0 > j) break;
      const float wx = tap_weight(tx, j);
      if (wx == 0.0f) continue;
      const int q = y * W + x;
      const float ps = expf(bilerp(sc, w, ty, tx) * inv_tau - lsb[q]);
      const float pt =
          kTwo ? expf(bilerp(tc, wt, tyt, tap(x, wt, W)) * inv_tau - ltb[q])
               : expf(bilerp(tc, w, ty, tx) * inv_tau - ltb[q]);
      acc = fmaf(wy * wx, ps - pt, acc);
    }
  }
  dxs[base + p] = from_f32<T>(acc * (gbar[0] * inv_tau));
}

bool bad_shape(int B, int C, int h, int w, int ht, int wt, int H, int W,
               float tau) {
  return B < 1 || B > 65535 || C < 1 || h < 1 || w < 1 || ht < 1 || wt < 1 ||
         H < 1 || W < 1 || !(tau > 0.0f) ||
         static_cast<long long>(H) * W > 0x7fffffffLL - kThreads ||
         static_cast<long long>(h) * w > 0x7fffffffLL - kThreads ||
         static_cast<long long>(ht) * wt > 0x7fffffffLL - kThreads;
}

template <typename T>
cudaError_t launch_fwd(const void* xs, const void* xt, int B, int C, int h,
                       int w, int ht, int wt, int H, int W, float tau, int oh,
                       float* lse_s, float* lse_t, float* part, int* ticket,
                       float* kl_sum, cudaStream_t s) {
  const T* ps = static_cast<const T*>(xs);
  const T* pt = static_cast<const T*>(xt);
  if (oh == 0) {
    const dim3 grid((H * W + kThreads - 1) / kThreads, B);
    if (ht != h || wt != w) {
      pkl_fwd<T, true><<<grid, kThreads, 0, s>>>(
          ps, pt, C, h, w, ht, wt, H, W, 1.0f / tau, lse_s, lse_t, part);
    } else {
      pkl_fwd<T, false><<<grid, kThreads, 0, s>>>(
          ps, pt, C, h, w, h, w, H, W, 1.0f / tau, lse_s, lse_t, part);
    }
    pkl_finalize<<<1, kThreads, 0, s>>>(part, grid.x * grid.y, kl_sum);
    return cudaSuccess;
  }
  const pkl_fwd_tile<T> fwd{ps,     pt, lse_s, lse_t, part, ticket, kl_sum,
                            C,      H,  W,     static_cast<long long>(h) * w,
                            1.0f / tau, kLog2e / tau};
  return launch_fwd_tile<T>(fwd, B, h, w, H, W, oh, s);
}

template <typename T>
cudaError_t launch_bwd(const void* xs, const void* xt, int B, int C, int h,
                       int w, int ht, int wt, int H, int W, float tau,
                       const float* lse_s, const float* lse_t,
                       const float* gbar, void* dxs, int tile, int cpc,
                       cudaStream_t s) {
  if (tile == 0) {
    const dim3 grid((h * w + kThreads - 1) / kThreads, B * C);
    const T* a = static_cast<const T*>(xs);
    const T* b = static_cast<const T*>(xt);
    if (ht != h || wt != w) {
      pkl_bwd<T, true><<<grid, kThreads, 0, s>>>(
          a, b, C, h, w, ht, wt, H, W, 1.0f / tau, lse_s, lse_t, gbar,
          static_cast<T*>(dxs));
    } else {
      pkl_bwd<T, false><<<grid, kThreads, 0, s>>>(
          a, b, C, h, w, h, w, H, W, 1.0f / tau, lse_s, lse_t, gbar,
          static_cast<T*>(dxs));
    }
    return cudaSuccess;
  }
  return launch_tile_bwd<T>(pkl_tile{lse_s, lse_t, gbar, 1.0f / tau}, xs, xt,
                            dxs, B, C, h, w, H, W, tile, cpc, s);
}

}  // namespace

// xs: (B, C, h, w) and xt: (B, C, ht, wt) contiguous, float32 (dtype 0) or
// bfloat16 (1). The wrapper's plan: oh, the rows of an output tile (0: the
// gather variant, the only one for a teacher of another size), wy, wx and
// smem, the window and the shared bytes it expects (0 with the
// gather variant); a plan that differs from this file's is refused.
// Outputs: lse_s, lse_t (B, H, W) float32, the per-pixel log-sum-exp of
// z / tau for each map; kl_sum (1) float32. Scratch: part, a float a block:
// B * ceil(H / oh) * ceil(W / 64) blocks of the tile variant, B *
// ceil(H*W / 256) of the gather one; ticket, an int32 on the device that is
// 0 (the tile variant leaves it at 0; null for the gather variant).
extern "C" int pixel_kl_fwd(const void* xs, const void* xt, int B, int C,
                            int h, int w, int ht, int wt, int H, int W,
                            float tau, int dtype, int oh, int wy, int wx,
                            int smem, float* lse_s, float* lse_t,
                            float* part, int* ticket, float* kl_sum,
                            void* stream) {
  const bool two = ht != h || wt != w;
  const bool plan_ok =
      two ? !(oh || wy || wx || smem)
          : fwd_plan_ok<pkl_fwd_tile<float>>(h, w, H, W, oh, wy, wx, smem);
  if (bad_shape(B, C, h, w, ht, wt, H, W, tau) || !plan_ok ||
      (oh && !ticket)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = launch_fwd<float>(xs, xt, B, C, h, w, ht, wt, H, W, tau, oh, lse_s,
                            lse_t, part, ticket, kl_sum, s);
  } else if (dtype == 1) {
    err = launch_fwd<__nv_bfloat16>(xs, xt, B, C, h, w, ht, wt, H, W, tau, oh,
                                    lse_s, lse_t, part, ticket, kl_sum, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// lse_s, lse_t: the forward's; gbar: kl_sum's incoming gradient, float32 (1)
// on the device. dxs: (B, C, h, w) in the maps' dtype, every element
// written. The wrapper's plan: tile, the edge of a block's source tile (16,
// 8 or 4; 0 for the gather variant, the only one for a teacher of another
// size), rh, rw and smem, the rectangle and the shared bytes it expects (0
// with the gather variant), and cpc, the channels a block takes. A plan
// that differs from this file's is refused.
extern "C" int pixel_kl_bwd(const void* xs, const void* xt, int B, int C,
                            int h, int w, int ht, int wt, int H, int W,
                            float tau, int dtype, const float* lse_s,
                            const float* lse_t, const float* gbar, void* dxs,
                            int tile, int rh, int rw, int smem, int cpc,
                            void* stream) {
  const bool two = ht != h || wt != w;
  const bool plan_ok =
      two ? gather_plan_ok(B, C, tile, rh, rw, smem, cpc)
          : tile_plan_ok<pkl_tile>(B, C, h, w, H, W, tile, rh, rw, smem, cpc);
  if (bad_shape(B, C, h, w, ht, wt, H, W, tau) || !plan_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = launch_bwd<float>(xs, xt, B, C, h, w, ht, wt, H, W, tau, lse_s,
                            lse_t, gbar, dxs, tile, cpc, s);
  } else if (dtype == 1) {
    err = launch_bwd<__nv_bfloat16>(xs, xt, B, C, h, w, ht, wt, H, W, tau,
                                    lse_s, lse_t, gbar, dxs, tile, cpc, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
