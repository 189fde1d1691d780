// fastaug: native host-side training augmentation core.
//
// Role: the reference's input pipeline leans on external native code
// (OpenCV/mmcv compiled ops) driven per-sample from Python
// (mmseg/datasets/pipelines/transforms.py) — at batch 2/GPU the Python
// dispatch + GIL is the bottleneck (SURVEY §3.1 hot loop (3)). This module
// runs the whole per-sample chain (keep-ratio rescale -> random scale ->
// random crop with the cat_max_ratio rejection loop -> horizontal flip ->
// photometric distortion -> normalize -> pad) in one C++ call per batch,
// OpenMP-parallel across samples, zero Python in the loop.
//
// Exposed through ctypes (segdistill_tpu_torch/native/fastaug.py, which
// builds it with g++ at first use). The same code as the JAX package's
// core: the two give bitwise equal batches for the same inputs and seed.
//
// RNG: splitmix64 per sample (seeded by caller seed + index) — deterministic
// given the seed, intentionally NOT the numpy stream (the Python pipeline
// remains the exact-parity path).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed + 0x9e3779b97f4a7c15ULL) {}
  uint64_t next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  // uniform in [0, 1)
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
  double uniform(double lo, double hi) { return lo + uniform() * (hi - lo); }
  int randint(int n) { return n > 0 ? static_cast<int>(next() % n) : 0; }
  bool coin() { return (next() & 1) != 0; }
};

inline uint8_t clip_u8(float v) {
  return static_cast<uint8_t>(std::min(255.f, std::max(0.f, v)));
}

// bilinear sample (align_corners=False / half-pixel), channel c of an
// H x W x C uint8 buffer
inline float bilerp(const uint8_t* img, int H, int W, int C, float y,
                    float x, int c) {
  y = std::min(std::max(y, 0.f), static_cast<float>(H - 1));
  x = std::min(std::max(x, 0.f), static_cast<float>(W - 1));
  int y0 = static_cast<int>(y), x0 = static_cast<int>(x);
  int y1 = std::min(y0 + 1, H - 1), x1 = std::min(x0 + 1, W - 1);
  float fy = y - y0, fx = x - x0;
  const float v00 = img[(y0 * W + x0) * C + c];
  const float v01 = img[(y0 * W + x1) * C + c];
  const float v10 = img[(y1 * W + x0) * C + c];
  const float v11 = img[(y1 * W + x1) * C + c];
  return (v00 * (1 - fx) + v01 * fx) * (1 - fy)
       + (v10 * (1 - fx) + v11 * fx) * fy;
}

inline uint8_t nearest(const uint8_t* gt, int H, int W, float y, float x) {
  int yi = std::min(std::max(static_cast<int>(y), 0), H - 1);
  int xi = std::min(std::max(static_cast<int>(x), 0), W - 1);
  return gt[yi * W + xi];
}

// ----------------------------------------------------------- photometric
// (op semantics of ref transforms.py:1099-1215 on uint8 RGB)
void rgb_to_hsv(const float r, const float g, const float b, float* h,
                float* s, float* v) {
  float mx = std::max({r, g, b}), mn = std::min({r, g, b});
  float d = mx - mn;
  float hh = 0.f;
  if (d > 0.f) {
    if (mx == r) hh = std::fmod((g - b) / d, 6.f);
    else if (mx == g) hh = (b - r) / d + 2.f;
    else hh = (r - g) / d + 4.f;
    if (hh < 0) hh += 6.f;
  }
  *h = hh * 30.f;  // cv2 uint8 convention: [0, 180)
  *s = mx > 0.f ? d / mx * 255.f : 0.f;
  *v = mx;
}

void hsv_to_rgb(float h, float s, float v, float* r, float* g, float* b) {
  h = std::fmod(h, 180.f) / 30.f;
  if (h < 0) h += 6.f;
  s /= 255.f;
  int i = static_cast<int>(h) % 6;
  float f = h - std::floor(h);
  float p = v * (1 - s), q = v * (1 - s * f), t = v * (1 - s * (1 - f));
  switch (i) {
    case 0: *r = v; *g = t; *b = p; break;
    case 1: *r = q; *g = v; *b = p; break;
    case 2: *r = p; *g = v; *b = t; break;
    case 3: *r = p; *g = q; *b = v; break;
    case 4: *r = t; *g = p; *b = v; break;
    default: *r = v; *g = p; *b = q; break;
  }
}

void photometric(std::vector<uint8_t>& img, int n_px, Rng& rng,
                 float brightness_delta, float c_lo, float c_hi,
                 float s_lo, float s_hi, float hue_delta) {
  auto convert = [&](float alpha, float beta) {
    for (int i = 0; i < n_px * 3; ++i)
      img[i] = clip_u8(img[i] * alpha + beta);
  };
  if (rng.coin())
    convert(1.f, static_cast<float>(
        rng.uniform(-brightness_delta, brightness_delta)));
  bool mode = rng.coin();
  auto contrast = [&]() {
    if (rng.coin())
      convert(static_cast<float>(rng.uniform(c_lo, c_hi)), 0.f);
  };
  if (mode) contrast();
  if (rng.coin()) {  // saturation
    float alpha = static_cast<float>(rng.uniform(s_lo, s_hi));
    for (int i = 0; i < n_px; ++i) {
      float h, s, v, r, g, b;
      rgb_to_hsv(img[i * 3], img[i * 3 + 1], img[i * 3 + 2], &h, &s, &v);
      s = std::min(255.f, std::max(0.f, s * alpha));
      hsv_to_rgb(h, s, v, &r, &g, &b);
      img[i * 3] = clip_u8(r);
      img[i * 3 + 1] = clip_u8(g);
      img[i * 3 + 2] = clip_u8(b);
    }
  }
  if (rng.coin()) {  // hue
    float delta = static_cast<float>(rng.uniform(-hue_delta, hue_delta));
    for (int i = 0; i < n_px; ++i) {
      float h, s, v, r, g, b;
      rgb_to_hsv(img[i * 3], img[i * 3 + 1], img[i * 3 + 2], &h, &s, &v);
      h = std::fmod(h + delta + 180.f, 180.f);
      hsv_to_rgb(h, s, v, &r, &g, &b);
      img[i * 3] = clip_u8(r);
      img[i * 3 + 1] = clip_u8(g);
      img[i * 3 + 2] = clip_u8(b);
    }
  }
  if (!mode) contrast();
}

}  // namespace

extern "C" {

// one fused train-time sample: see module docstring for the chain.
// img: H x W x 3 uint8 RGB; gt: H x W uint8.
// out_img: crop_h x crop_w x 3 float32 (normalized);
// out_gt: crop_h x crop_w int32.
void fastaug_one(const uint8_t* img, const uint8_t* gt, int H, int W,
                 int crop_h, int crop_w, float scale_base_long,
                 float scale_base_short, float ratio_lo, float ratio_hi,
                 float cat_max_ratio, int ignore_index, float flip_prob,
                 float brightness_delta, float contrast_lo,
                 float contrast_hi, float saturation_lo,
                 float saturation_hi, float hue_delta, const float* mean,
                 const float* stddev, uint64_t seed, float* out_img,
                 int32_t* out_gt) {
  Rng rng(seed);

  // random scale: keep-ratio fit into (long, short) * r (ref Resize,
  // transforms.py:236-434 semantics via rescale_size)
  double r = rng.uniform(ratio_lo, ratio_hi);
  double tl = scale_base_long * r, ts = scale_base_short * r;
  double f = std::min(tl / std::max(H, W), ts / std::min(H, W));
  int rh = static_cast<int>(H * f + 0.5), rw = static_cast<int>(W * f + 0.5);
  rh = std::max(rh, 1); rw = std::max(rw, 1);

  // random crop with rejection (ref transforms.py:768-777)
  int margin_h = std::max(rh - crop_h, 0), margin_w = std::max(rw - crop_w, 0);
  int off_h = rng.randint(margin_h + 1), off_w = rng.randint(margin_w + 1);
  if (cat_max_ratio < 1.f) {
    for (int attempt = 0; attempt < 10; ++attempt) {
      // histogram of the candidate gt crop
      int counts[256] = {0};
      int ch_eff = std::min(crop_h, rh), cw_eff = std::min(crop_w, rw);
      for (int y = 0; y < ch_eff; ++y) {
        float sy = (off_h + y + 0.5f) / f - 0.5f;
        for (int x = 0; x < cw_eff; ++x) {
          float sx = (off_w + x + 0.5f) / f - 0.5f;
          ++counts[nearest(gt, H, W, sy, sx)];
        }
      }
      int total = 0, mx = 0, nlab = 0;
      for (int c = 0; c < 256; ++c) {
        if (c == ignore_index) continue;
        total += counts[c];
        mx = std::max(mx, counts[c]);
        if (counts[c] > 0) ++nlab;
      }
      if (nlab > 1 && total > 0 &&
          static_cast<float>(mx) / total < cat_max_ratio)
        break;
      off_h = rng.randint(margin_h + 1);
      off_w = rng.randint(margin_w + 1);
    }
  }

  bool flip = rng.uniform() < flip_prob;

  // fused resample+crop+flip into a uint8 staging buffer (photometric
  // operates on uint8, matching the reference's op order)
  std::vector<uint8_t> stage(crop_h * crop_w * 3);
  std::vector<int32_t> gt_stage(crop_h * crop_w);
  for (int y = 0; y < crop_h; ++y) {
    bool row_in = (off_h + y) < rh;
    float sy = (off_h + y + 0.5f) / f - 0.5f;
    for (int x = 0; x < crop_w; ++x) {
      int xo = flip ? (crop_w - 1 - x) : x;
      bool in = row_in && (off_w + x) < rw;
      int di = (y * crop_w + xo) * 3;
      if (in) {
        float sx = (off_w + x + 0.5f) / f - 0.5f;
        for (int c = 0; c < 3; ++c)
          stage[di + c] = clip_u8(bilerp(img, H, W, 3, sy, sx, c));
        gt_stage[y * crop_w + xo] = nearest(gt, H, W, sy, sx);
      } else {
        stage[di] = stage[di + 1] = stage[di + 2] = 0;  // img pad 0
        gt_stage[y * crop_w + xo] = ignore_index;       // seg pad 255
      }
    }
  }

  photometric(stage, crop_h * crop_w, rng, brightness_delta, contrast_lo,
              contrast_hi, saturation_lo, saturation_hi, hue_delta);

  for (int i = 0; i < crop_h * crop_w; ++i) {
    for (int c = 0; c < 3; ++c)
      out_img[i * 3 + c] = (stage[i * 3 + c] - mean[c]) / stddev[c];
    out_gt[i] = gt_stage[i];
  }
}

// batch entry point: OpenMP across samples.
void fastaug_batch(const uint8_t** imgs, const uint8_t** gts,
                   const int* heights, const int* widths, int batch,
                   int crop_h, int crop_w, float scale_base_long,
                   float scale_base_short, float ratio_lo, float ratio_hi,
                   float cat_max_ratio, int ignore_index, float flip_prob,
                   float brightness_delta, float contrast_lo,
                   float contrast_hi, float saturation_lo,
                   float saturation_hi, float hue_delta, const float* mean,
                   const float* stddev, uint64_t seed, float* out_imgs,
                   int32_t* out_gts) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic)
#endif
  for (int i = 0; i < batch; ++i) {
    fastaug_one(imgs[i], gts[i], heights[i], widths[i], crop_h, crop_w,
                scale_base_long, scale_base_short, ratio_lo, ratio_hi,
                cat_max_ratio, ignore_index, flip_prob, brightness_delta,
                contrast_lo, contrast_hi, saturation_lo, saturation_hi,
                hue_delta, mean, stddev, seed + 1000003ULL * i,
                out_imgs + static_cast<size_t>(i) * crop_h * crop_w * 3,
                out_gts + static_cast<size_t>(i) * crop_h * crop_w);
  }
}

int fastaug_version() { return 1; }

}  // extern "C"
