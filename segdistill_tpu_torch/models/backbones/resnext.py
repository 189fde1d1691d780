"""ResNeXt: ResNet with grouped 3x3 bottleneck convs (counterpart of
``segdistill_tpu/models/backbones/resnext.py``; reference
``mmseg/models/backbones/resnext.py:87``). ``groups`` and ``base_width``
set each bottleneck's width (``resnet.py``'s grouped Bottleneck)."""

from ..builder import BACKBONES
from .resnet import ResNet


@BACKBONES.register_module(name='ResNeXt')
def ResNeXt(groups=32, base_width=4, **kwargs):
    kwargs.pop('style', None)
    return ResNet(groups=groups, width_per_group=base_width, **kwargs)
