"""Test-time transforms (counterpart of the test-time part of
``segdistill_tpu/datasets/pipelines/transforms.py``; reference
``mmseg/datasets/pipelines/transforms.py``): Resize, AlignedResize,
RandomFlip, Normalize. Host numpy, no OpenCV (see ``utils/image.py``).
Random scale sampling and the other training-time transforms wait for
the training port."""

import numpy as np

from ...utils import image as imutil
from ..builder import PIPELINES


def _rng(results):
    """The per-sample RNG if a loader injected one, else numpy's global."""
    return results.get('rng') or np.random


@PIPELINES.register_module()
class Resize:
    """Resize to ``results['scale']`` (ref transforms.py:236-434), which
    MultiScaleFlipAug sets, or to a single fixed ``img_scale``."""

    def __init__(self, img_scale=None, multiscale_mode='range',
                 ratio_range=None, keep_ratio=True):
        del multiscale_mode  # selects a random scale: training-time
        if img_scale is None:
            self.img_scale = None
        elif isinstance(img_scale, list):
            self.img_scale = [tuple(s) for s in img_scale]
        else:
            self.img_scale = [tuple(img_scale)]
        self.ratio_range = ratio_range
        self.keep_ratio = keep_ratio

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
            # at test time MultiScaleFlipAug sets the scale; a fixed single
            # scale needs no sampling
            if self.ratio_range is not None or self.img_scale is None \
                    or len(self.img_scale) != 1:
                raise NotImplementedError(
                    'random scale sampling is a training-time transform and '
                    'not ported yet')
            results['scale'] = self.img_scale[0]
        self._resize_img(results)
        self._resize_seg(results)
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}(img_scale={self.img_scale}, '
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
