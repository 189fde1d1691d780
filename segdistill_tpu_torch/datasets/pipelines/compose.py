"""Sequential pipeline executor (counterpart of
``segdistill_tpu/datasets/pipelines/compose.py``)."""

from ...registry import build_from_cfg

from ..builder import PIPELINES


@PIPELINES.register_module()
class Compose:

    def __init__(self, transforms):
        self.transforms = []
        for transform in transforms:
            if isinstance(transform, dict):
                self.transforms.append(build_from_cfg(transform, PIPELINES))
            elif callable(transform):
                self.transforms.append(transform)
            else:
                raise TypeError('transform must be callable or a dict, '
                                f'got {type(transform)}')

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
            if data is None:
                return None
        return data

    def __repr__(self):
        lines = [self.__class__.__name__ + '(']
        lines += [f'    {t}' for t in self.transforms]
        lines.append(')')
        return '\n'.join(lines)
