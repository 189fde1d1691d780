"""Image and annotation loading (counterpart of
``segdistill_tpu/datasets/pipelines/loading.py``; reference
``mmseg/datasets/pipelines/loading.py:9-153``)."""

import os.path as osp

import numpy as np

from ...utils import image as imutil
from ..builder import PIPELINES


@PIPELINES.register_module()
class LoadImageFromFile:
    """Read ``img_info['filename']`` under ``img_prefix`` as an HWC BGR
    uint8 image. The decode-backend argument of the reference is accepted
    and ignored: PNG files decode with the port's codec, ``.npy`` files
    load with numpy, other encoded files (JPEG) decode with OpenCV.
    """

    def __init__(self, to_float32=False, color_type='color',
                 imdecode_backend='cv2'):
        self.to_float32 = to_float32
        self.color_type = color_type
        self.imdecode_backend = imdecode_backend

    def __call__(self, results):
        if results.get('img_prefix') is not None:
            filename = osp.join(results['img_prefix'],
                                results['img_info']['filename'])
        else:
            filename = results['img_info']['filename']
        img = imutil.imread(filename, flag=self.color_type)
        if self.to_float32:
            img = img.astype(np.float32)

        results['filename'] = filename
        results['ori_filename'] = results['img_info']['filename']
        results['img'] = img
        results['img_shape'] = img.shape
        results['ori_shape'] = img.shape
        results['pad_shape'] = img.shape
        results['scale_factor'] = 1.0
        num_channels = 1 if len(img.shape) < 3 else img.shape[2]
        results['img_norm_cfg'] = dict(
            mean=np.zeros(num_channels, dtype=np.float32),
            std=np.ones(num_channels, dtype=np.float32),
            to_rgb=False)
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}(to_float32={self.to_float32}, '
                f"color_type='{self.color_type}')")


@PIPELINES.register_module()
class LoadAnnotations:
    """Load the label map, apply the ``label_map`` remap and
    ``reduce_zero_label`` (0 -> 255, the others shifted down by one;
    ref :128-141). The map is decoded with ``imdecode_backend``, pillow by
    default as in the reference: a palette PNG (Pascal VOC's
    ``SegmentationClass``) gives its indices. The JAX package reads it
    with OpenCV, which expands the palette, and keeps the blue channel."""

    def __init__(self, reduce_zero_label=False, imdecode_backend='pillow'):
        self.reduce_zero_label = reduce_zero_label
        self.imdecode_backend = imdecode_backend

    def __call__(self, results):
        if results.get('seg_prefix', None) is not None:
            filename = osp.join(results['seg_prefix'],
                                results['ann_info']['seg_map'])
        else:
            filename = results['ann_info']['seg_map']
        gt = imutil.imread(filename, flag='unchanged',
                           backend=self.imdecode_backend)
        if gt.ndim == 3:
            gt = gt[:, :, 0]
        gt = gt.astype(np.uint8)
        if results.get('label_map', None) is not None:
            for old_id, new_id in results['label_map'].items():
                gt[gt == old_id] = new_id
        if self.reduce_zero_label:
            gt[gt == 0] = 255
            gt = gt - 1
            gt[gt == 254] = 255
        results['gt_semantic_seg'] = gt
        results['seg_fields'] = results.get('seg_fields', [])
        results['seg_fields'].append('gt_semantic_seg')
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}'
                f'(reduce_zero_label={self.reduce_zero_label})')
