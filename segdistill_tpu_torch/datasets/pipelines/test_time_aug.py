"""MultiScaleFlipAug: the scale x flip test-time views (counterpart of
``segdistill_tpu/datasets/pipelines/test_time_aug.py``)."""

from ..builder import PIPELINES
from .compose import Compose


@PIPELINES.register_module()
class MultiScaleFlipAug:

    def __init__(self, transforms, img_scale=None, img_ratios=None,
                 flip=False, flip_direction='horizontal'):
        self.transforms = Compose(transforms)
        if img_ratios is not None and not isinstance(img_ratios, list):
            img_ratios = [img_ratios]
        self.img_ratios = None
        if img_scale is None:
            # resize by ratios of the original shape
            self.img_scale = None
            self.img_ratios = img_ratios
        elif isinstance(img_scale, tuple) and img_ratios is not None:
            if len(img_scale) != 2:
                raise ValueError(f'img_scale must be (w, h), got {img_scale}')
            self.img_scale = [(int(img_scale[0] * r), int(img_scale[1] * r))
                              for r in img_ratios]
        else:
            self.img_scale = img_scale if isinstance(img_scale, list) \
                else [img_scale]
        self.flip = flip
        self.flip_direction = flip_direction \
            if isinstance(flip_direction, list) else [flip_direction]

    def __call__(self, results):
        if self.img_scale is None:
            h, w = results['img'].shape[:2]
            img_scale = [(int(w * r), int(h * r)) for r in self.img_ratios]
        else:
            img_scale = self.img_scale
        flip_args = [(False, None)]
        if self.flip:
            flip_args += [(True, d) for d in self.flip_direction]
        aug_data = []
        for scale in img_scale:
            for flip, direction in flip_args:
                _results = dict(results)
                _results['scale'] = scale
                _results['flip'] = flip
                _results['flip_direction'] = direction
                aug_data.append(self.transforms(_results))
        # list[dict] -> dict[list]
        return {key: [d[key] for d in aug_data] for key in aug_data[0]}

    def __repr__(self):
        return (f'{self.__class__.__name__}(transforms={self.transforms}, '
                f'img_scale={self.img_scale}, flip={self.flip})')
