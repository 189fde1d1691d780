"""Geometric and photometric transforms (counterpart of
``segdistill_tpu/datasets/pipelines/transforms.py``; reference
``mmseg/datasets/pipelines/transforms.py``): Resize with its four scale
modes, AlignedResize, RandomFlip, Pad, Normalize, Rerange, CLAHE,
RandomCrop, CenterCrop, RandomRotate, RGB2Gray, AdjustGamma, MaillaryHack,
SegRescale and PhotoMetricDistortion. Host numpy, no OpenCV (see
``utils/image.py`` for how close its resize, rotation and HSV conversion
come to OpenCV's; CLAHE is exact).

Every random draw comes from the per-sample ``results['rng']`` (an
``np.random.RandomState`` that the loader injects) when present, else from
numpy's global generator, in the JAX pipeline's order: the same seed gives
the same scales, crops, flips, rotations and distortions in both
packages."""

import numpy as np

from ...utils import image as imutil
from ..builder import PIPELINES


def _rng(results):
    """The per-sample RNG if a loader injected one, else numpy's global."""
    return results.get('rng') or np.random


@PIPELINES.register_module()
class Resize:
    """Multiscale resize (ref transforms.py:236-434). The scale is
    ``results['scale']`` where MultiScaleFlipAug set it, else drawn: a
    ratio of ``img_scale`` (``ratio_range``), the single ``img_scale``, a
    size between two (``multiscale_mode='range'``) or one of several
    (``'value'``)."""

    def __init__(self, img_scale=None, multiscale_mode='range',
                 ratio_range=None, keep_ratio=True):
        if img_scale is None:
            self.img_scale = None
        elif isinstance(img_scale, list):
            self.img_scale = [tuple(s) for s in img_scale]
        else:
            self.img_scale = [tuple(img_scale)]
        if ratio_range is not None:
            assert self.img_scale is None or len(self.img_scale) == 1
        else:
            assert multiscale_mode in ('value', 'range')
        self.multiscale_mode = multiscale_mode
        self.ratio_range = ratio_range
        self.keep_ratio = keep_ratio

    @staticmethod
    def random_select(img_scales, rng=np.random):
        scale_idx = rng.randint(len(img_scales))
        return img_scales[scale_idx], scale_idx

    @staticmethod
    def random_sample(img_scales, rng=np.random):
        assert len(img_scales) == 2
        longs = [max(s) for s in img_scales]
        shorts = [min(s) for s in img_scales]
        long_edge = rng.randint(min(longs), max(longs) + 1)
        short_edge = rng.randint(min(shorts), max(shorts) + 1)
        return (long_edge, short_edge), None

    @staticmethod
    def random_sample_ratio(img_scale, ratio_range, rng=np.random):
        min_ratio, max_ratio = ratio_range
        ratio = rng.random_sample() * (max_ratio - min_ratio) + min_ratio
        return (int(img_scale[0] * ratio), int(img_scale[1] * ratio)), None

    def _random_scale(self, results):
        rng = _rng(results)
        if self.ratio_range is not None:
            if self.img_scale is None:
                h, w = results['img'].shape[:2]
                scale, scale_idx = self.random_sample_ratio(
                    (w, h), self.ratio_range, rng)
            else:
                scale, scale_idx = self.random_sample_ratio(
                    self.img_scale[0], self.ratio_range, rng)
        elif len(self.img_scale) == 1:
            scale, scale_idx = self.img_scale[0], 0
        elif self.multiscale_mode == 'range':
            scale, scale_idx = self.random_sample(self.img_scale, rng)
        else:
            scale, scale_idx = self.random_select(self.img_scale, rng)
        results['scale'] = scale
        results['scale_idx'] = scale_idx

    def _resize(self, img, results, interpolation='bilinear'):
        if self.keep_ratio:
            return imutil.imrescale(img, results['scale'],
                                    interpolation=interpolation)
        return imutil.imresize(img, results['scale'],
                               interpolation=interpolation)

    def _resize_img(self, results):
        h, w = results['img'].shape[:2]
        img = self._resize(results['img'], results)
        new_h, new_w = img.shape[:2]
        w_scale, h_scale = new_w / w, new_h / h
        results['img'] = img
        results['img_shape'] = img.shape
        results['pad_shape'] = img.shape
        results['scale_factor'] = np.array(
            [w_scale, h_scale, w_scale, h_scale], dtype=np.float32)
        results['keep_ratio'] = self.keep_ratio

    def _resize_seg(self, results):
        for key in results.get('seg_fields', []):
            results[key] = self._resize(results[key], results,
                                        interpolation='nearest')

    def __call__(self, results):
        if 'scale' not in results:
            self._random_scale(results)
        self._resize_img(results)
        self._resize_seg(results)
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}(img_scale={self.img_scale}, '
                f'multiscale_mode={self.multiscale_mode}, '
                f'ratio_range={self.ratio_range}, '
                f'keep_ratio={self.keep_ratio})')


@PIPELINES.register_module()
class AlignedResize(Resize):
    """Resize, then snap both sides up to a multiple of ``size_divisor``
    (ref transforms.py:9-234)."""

    def __init__(self, img_scale=None, multiscale_mode='range',
                 ratio_range=None, keep_ratio=True, size_divisor=32):
        super().__init__(img_scale, multiscale_mode, ratio_range, keep_ratio)
        self.size_divisor = size_divisor

    def _resize(self, img, results, interpolation='bilinear'):
        img = super()._resize(img, results, interpolation)
        d = self.size_divisor
        h, w = img.shape[:2]
        if not self.keep_ratio:
            if h % d or w % d:
                raise ValueError(f'keep_ratio=False needs a scale divisible '
                                 f'by {d}, got {w}x{h}')
            return img
        align_h = int(np.ceil(h / d)) * d
        align_w = int(np.ceil(w / d)) * d
        return imutil.imresize(img, (align_w, align_h),
                               interpolation=interpolation)


@PIPELINES.register_module()
class RandomFlip:
    """(ref transforms.py:464-517)."""

    def __init__(self, prob=None, flip_ratio=None, direction='horizontal'):
        self.prob = prob if prob is not None else flip_ratio
        self.direction = direction

    def __call__(self, results):
        if 'flip' not in results:
            results['flip'] = self.prob is not None \
                and _rng(results).rand() < self.prob
        if 'flip_direction' not in results:
            results['flip_direction'] = self.direction
        if results['flip']:
            direction = results['flip_direction']
            results['img'] = imutil.imflip(results['img'], direction).copy()
            for key in results.get('seg_fields', []):
                results[key] = imutil.imflip(results[key], direction).copy()
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}(prob={self.prob})'


@PIPELINES.register_module()
class Normalize:
    """(img - mean) / std with optional BGR->RGB (ref transforms.py:590-630).
    """

    def __init__(self, mean, std, to_rgb=True):
        self.mean = np.array(mean, dtype=np.float32)
        self.std = np.array(std, dtype=np.float32)
        self.to_rgb = to_rgb

    def __call__(self, results):
        results['img'] = imutil.imnormalize(results['img'], self.mean,
                                            self.std, self.to_rgb)
        results['img_norm_cfg'] = dict(mean=self.mean, std=self.std,
                                       to_rgb=self.to_rgb)
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}(mean={list(self.mean)}, '
                f'std={list(self.std)}, to_rgb={self.to_rgb})')


@PIPELINES.register_module()
class Pad:
    """Pad to a fixed size or to a multiple, at the bottom and the right:
    the image with ``pad_val``, the label maps with ``seg_pad_val``
    (ref transforms.py:519-588)."""

    def __init__(self, size=None, size_divisor=None, pad_val=0,
                 seg_pad_val=255):
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val
        self.seg_pad_val = seg_pad_val
        assert (size is None) != (size_divisor is None)

    def __call__(self, results):
        if self.size is not None:
            padded = imutil.impad(results['img'], self.size, self.pad_val)
        else:
            padded = imutil.impad_to_multiple(
                results['img'], self.size_divisor, self.pad_val)
        results['img'] = padded
        results['pad_shape'] = padded.shape
        results['pad_fixed_size'] = self.size
        results['pad_size_divisor'] = self.size_divisor
        for key in results.get('seg_fields', []):
            results[key] = imutil.impad(results[key], padded.shape[:2],
                                        self.seg_pad_val)
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}(size={self.size}, '
                f'size_divisor={self.size_divisor}, '
                f'pad_val={self.pad_val})')


@PIPELINES.register_module()
class Rerange:
    """Rescale the image's values linearly onto [min_value, max_value]
    (ref transforms.py:632-676)."""

    def __init__(self, min_value=0, max_value=255):
        self.min_value = min_value
        self.max_value = max_value

    def __call__(self, results):
        img = results['img'].astype(np.float32)
        lo, hi = np.min(img), np.max(img)
        assert hi > lo
        img = (img - lo) / (hi - lo)
        results['img'] = img * (self.max_value - self.min_value) \
            + self.min_value
        return results


@PIPELINES.register_module()
class CLAHE:
    """Contrast-limited adaptive histogram equalisation of each channel
    (``utils/image.py::clahe``; ref transforms.py:678-721)."""

    def __init__(self, clip_limit=40.0, tile_grid_size=(8, 8)):
        self.clip_limit = clip_limit
        self.tile_grid_size = tuple(tile_grid_size)

    def __call__(self, results):
        img = results['img']
        for i in range(img.shape[2]):
            img[:, :, i] = imutil.clahe(img[:, :, i], self.clip_limit,
                                        self.tile_grid_size)
        results['img'] = img
        return results


@PIPELINES.register_module()
class RandomCrop:
    """Random crop; with ``cat_max_ratio`` < 1 up to ten redraws until no
    class covers more than that share of the crop (ref
    transforms.py:723-793)."""

    def __init__(self, crop_size, cat_max_ratio=1.0, ignore_index=255):
        assert crop_size[0] > 0 and crop_size[1] > 0
        self.crop_size = tuple(crop_size)
        self.cat_max_ratio = cat_max_ratio
        self.ignore_index = ignore_index

    def get_crop_bbox(self, img, rng=np.random):
        margin_h = max(img.shape[0] - self.crop_size[0], 0)
        margin_w = max(img.shape[1] - self.crop_size[1], 0)
        offset_h = rng.randint(0, margin_h + 1)
        offset_w = rng.randint(0, margin_w + 1)
        return (offset_h, offset_h + self.crop_size[0],
                offset_w, offset_w + self.crop_size[1])

    @staticmethod
    def crop(img, bbox):
        y1, y2, x1, x2 = bbox
        return img[y1:y2, x1:x2, ...]

    def __call__(self, results):
        img = results['img']
        rng = _rng(results)
        crop_bbox = self.get_crop_bbox(img, rng)
        if self.cat_max_ratio < 1.0:
            for _ in range(10):
                seg_tmp = self.crop(results['gt_semantic_seg'], crop_bbox)
                labels, cnt = np.unique(seg_tmp, return_counts=True)
                cnt = cnt[labels != self.ignore_index]
                if len(cnt) > 1 and np.max(cnt) / np.sum(cnt) \
                        < self.cat_max_ratio:
                    break
                crop_bbox = self.get_crop_bbox(img, rng)
        img = self.crop(img, crop_bbox)
        results['img'] = img
        results['img_shape'] = img.shape
        for key in results.get('seg_fields', []):
            results[key] = self.crop(results[key], crop_bbox)
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}(crop_size={self.crop_size})'


@PIPELINES.register_module()
class CenterCrop:
    """Crop ``crop_size`` (h, w) from the middle of the image and of the
    label maps (ref transforms.py:795-852)."""

    def __init__(self, crop_size):
        self.crop_size = tuple(crop_size)

    def __call__(self, results):
        img = results['img']
        y1 = max(img.shape[0] - self.crop_size[0], 0) // 2
        x1 = max(img.shape[1] - self.crop_size[1], 0) // 2
        bbox = (y1, y1 + self.crop_size[0], x1, x1 + self.crop_size[1])
        results['img'] = RandomCrop.crop(img, bbox)
        results['img_shape'] = results['img'].shape
        for key in results.get('seg_fields', []):
            results[key] = RandomCrop.crop(results[key], bbox)
        return results


@PIPELINES.register_module()
class RandomRotate:
    """Rotate the image (bilinear, ``pad_val``) and the label maps
    (nearest, ``seg_pad_val``) by a degree drawn from ``degree`` with
    probability ``prob`` (ref transforms.py:854-935). Both draws are made
    on every call, as in the JAX package, so that the streams stay
    aligned."""

    def __init__(self, prob, degree, pad_val=0, seg_pad_val=255,
                 center=None, auto_bound=False):
        self.prob = prob
        if isinstance(degree, (float, int)):
            degree = (-degree, degree)
        self.degree = degree
        self.pad_val = pad_val
        self.seg_pad_val = seg_pad_val
        self.center = center
        self.auto_bound = auto_bound

    def __call__(self, results):
        rng = _rng(results)
        rotate = rng.rand() < self.prob
        degree = rng.uniform(min(*self.degree), max(*self.degree))
        if rotate:
            results['img'] = imutil.imrotate(
                results['img'], angle=degree, border_value=self.pad_val,
                center=self.center, auto_bound=self.auto_bound)
            for key in results.get('seg_fields', []):
                results[key] = imutil.imrotate(
                    results[key], angle=degree,
                    border_value=self.seg_pad_val, center=self.center,
                    auto_bound=self.auto_bound, interpolation='nearest')
        return results


@PIPELINES.register_module()
class RGB2Gray:
    """A weighted sum of the channels, repeated to ``out_channels`` (the
    input's count by default; ref transforms.py:937-990)."""

    def __init__(self, out_channels=None, weights=(0.299, 0.587, 0.114)):
        self.out_channels = out_channels
        self.weights = weights

    def __call__(self, results):
        img = results['img']
        weights = np.array(self.weights).reshape((1, 1, -1))
        gray = (img * weights).sum(2, keepdims=True)
        gray = gray.repeat(img.shape[2] if self.out_channels is None
                           else self.out_channels, axis=2)
        results['img'] = gray
        results['img_shape'] = gray.shape
        return results


@PIPELINES.register_module()
class AdjustGamma:
    """A gamma lookup table on uint8 values (ref transforms.py:992-1026)."""

    def __init__(self, gamma=1.0):
        assert gamma > 0
        self.gamma = gamma
        inv_gamma = 1.0 / gamma
        self.table = np.array([(i / 255.0) ** inv_gamma * 255
                               for i in np.arange(256)]).astype('uint8')

    def __call__(self, results):
        results['img'] = self.table[np.asarray(results['img'], np.uint8)]
        return results


@PIPELINES.register_module()
class MaillaryHack:
    """Map Mapillary Vistas' 66 labels onto the 19 Cityscapes classes, the
    rest to 255 (ref transforms.py:1028-1067)."""

    def __init__(self):
        self.map = [[13, 24, 41], [2, 15], [17], [6], [3], [45, 47], [48],
                    [50], [30], [29], [27], [19], [20, 21, 22], [55], [61],
                    [54], [58], [57], [52]]

    def __call__(self, results):
        gt_map = results['gt_semantic_seg']
        out = np.full_like(gt_map, 255)
        for index, map_list in enumerate(self.map):
            for value in map_list:
                out[gt_map == value] = index
        results['gt_semantic_seg'] = out
        return results


@PIPELINES.register_module()
class SegRescale:
    """Rescale the label maps by ``scale_factor``, nearest (ref
    transforms.py:1069-1097)."""

    def __init__(self, scale_factor=1):
        self.scale_factor = scale_factor

    def __call__(self, results):
        for key in results.get('seg_fields', []):
            if self.scale_factor != 1:
                results[key] = imutil.imrescale(
                    results[key], self.scale_factor, interpolation='nearest')
        return results


@PIPELINES.register_module()
class PhotoMetricDistortion:
    """Brightness, contrast, saturation and hue, each applied with
    probability 0.5, contrast before or after the HSV pair at random
    (ref transforms.py:1099-1215)."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast_lower, self.contrast_upper = contrast_range
        self.saturation_lower, self.saturation_upper = saturation_range
        self.hue_delta = hue_delta

    @staticmethod
    def convert(img, alpha=1, beta=0):
        img = img.astype(np.float32) * alpha + beta
        return np.clip(img, 0, 255).astype(np.uint8)

    def brightness(self, img, rng=np.random):
        if rng.randint(2):
            return self.convert(
                img, beta=rng.uniform(-self.brightness_delta,
                                      self.brightness_delta))
        return img

    def contrast(self, img, rng=np.random):
        if rng.randint(2):
            return self.convert(
                img, alpha=rng.uniform(self.contrast_lower,
                                       self.contrast_upper))
        return img

    def saturation(self, img, rng=np.random):
        if rng.randint(2):
            img = imutil.bgr2hsv(img)
            img[:, :, 1] = self.convert(
                img[:, :, 1], alpha=rng.uniform(self.saturation_lower,
                                                self.saturation_upper))
            img = imutil.hsv2bgr(img)
        return img

    def hue(self, img, rng=np.random):
        if rng.randint(2):
            img = imutil.bgr2hsv(img)
            img[:, :, 0] = (img[:, :, 0].astype(int) + rng.randint(
                -self.hue_delta, self.hue_delta)) % 180
            img = imutil.hsv2bgr(img)
        return img

    def __call__(self, results):
        rng = _rng(results)
        img = results['img']
        img = self.brightness(img, rng)
        mode = rng.randint(2)
        if mode == 1:
            img = self.contrast(img, rng)
        img = self.saturation(img, rng)
        img = self.hue(img, rng)
        if mode == 0:
            img = self.contrast(img, rng)
        results['img'] = img
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}'
                f'(brightness_delta={self.brightness_delta})')
