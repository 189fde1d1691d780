"""Formatting transforms (counterpart of
``segdistill_tpu/datasets/pipelines/formatting.py``).

Images stay HWC numpy arrays, as in the JAX pipeline; the inference API
moves them to the device and to NCHW. Metas travel as plain dicts.
"""

import numpy as np

from ..builder import PIPELINES


def to_tensor(data):
    """Coerce to a numpy array; batches move to the device as a whole."""
    if isinstance(data, np.ndarray):
        return data
    if isinstance(data, (list, tuple, int, float)):
        return np.asarray(data)
    raise TypeError(f'type {type(data)} cannot be converted to tensor')


@PIPELINES.register_module()
class ToTensor:

    def __init__(self, keys):
        self.keys = keys

    def __call__(self, results):
        for key in self.keys:
            results[key] = to_tensor(results[key])
        return results


@PIPELINES.register_module()
class Transpose:

    def __init__(self, keys, order):
        self.keys = keys
        self.order = order

    def __call__(self, results):
        for key in self.keys:
            results[key] = results[key].transpose(self.order)
        return results


@PIPELINES.register_module()
class DefaultFormatBundle:
    """img -> float32 HWC array; gt_semantic_seg -> int32 (H, W)
    (ref formating.py:177-215, without the CHW/DataContainer wrapping: the
    runner moves a stacked NHWC batch to the device and to NCHW)."""

    def __call__(self, results):
        if 'img' in results:
            img = results['img']
            if img.ndim < 3:
                img = np.expand_dims(img, -1)
            results['img'] = np.ascontiguousarray(img, dtype=np.float32)
        if 'gt_semantic_seg' in results:
            results['gt_semantic_seg'] = np.ascontiguousarray(
                results['gt_semantic_seg'], dtype=np.int32)
        return results

    def __repr__(self):
        return self.__class__.__name__


@PIPELINES.register_module()
class ImageToTensor:
    """Keeps HWC (the reference transposes to CHW here)."""

    def __init__(self, keys):
        self.keys = keys

    def __call__(self, results):
        for key in self.keys:
            img = np.asarray(results[key])
            if img.ndim < 3:
                img = np.expand_dims(img, -1)
            results[key] = img
        return results


@PIPELINES.register_module()
class Collect:
    """Keep the data keys and gather 'img_metas' (ref formating.py:218-288).
    """

    DEFAULT_META_KEYS = ('filename', 'ori_filename', 'ori_shape',
                         'img_shape', 'pad_shape', 'scale_factor', 'flip',
                         'flip_direction', 'img_norm_cfg')

    def __init__(self, keys, meta_keys=DEFAULT_META_KEYS):
        self.keys = keys
        self.meta_keys = meta_keys

    def __call__(self, results):
        data = {'img_metas': {key: results[key] for key in self.meta_keys
                              if key in results}}
        for key in self.keys:
            data[key] = results[key]
        return data

    def __repr__(self):
        return (f'{self.__class__.__name__}(keys={self.keys}, '
                f'meta_keys={self.meta_keys})')
