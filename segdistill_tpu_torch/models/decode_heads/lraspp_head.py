"""LRASPPHead, the Lite R-ASPP head of MobileNetV3 (counterpart of
``segdistill_tpu/models/decode_heads/lraspp_head.py``; reference
``mmseg/models/decode_heads/lraspp_head.py:12-90``).

NCHW, the reference ``.pth`` layout. On the coarsest map: ``aspp_conv``
(1x1 ConvModule) times a gate, ``image_pool.1`` (a bias-free 1x1 conv and
a sigmoid, no norm) over ``image_pool.0``, a 49x49 average pool at stride
(16, 20) without padding, resized back to the map; then the biased 1x1
``conv_up_input``. Then, from the second-coarsest map to the finest: a
resize to that map, concatenated with its bare bias-free 1x1 lateral
(``convs.conv{i}``, ``branch_channels[i]`` wide), and a 1x1 ConvModule
(``conv_ups.conv_up{i}``). The pool's window is clamped to the map's size
where the map is smaller than 49 on a side (the reference raises there;
the two agree from 49 up).
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import resize
from ..builder import HEADS
from ..utils import ConvModule
from ..utils.conv_module import Conv2d, he_normal_
from .decode_head import BaseDecodeHead
from .psp_head import init_conv_modules


class ImagePool(nn.Module):
    """``AvgPool2d(49, stride=(16, 20))`` with its window clamped to the
    input's size, in the input's dtype."""

    KERNEL, STRIDE = 49, (16, 20)

    def forward(self, x):
        window = (min(self.KERNEL, x.shape[2]), min(self.KERNEL, x.shape[3]))
        return F.avg_pool2d(x, window, self.STRIDE)


@HEADS.register_module()
class LRASPPHead(BaseDecodeHead):

    def __init__(self, branch_channels=(32, 64), **kwargs):
        super().__init__(**kwargs)
        if self.input_transform != 'multiple_select':
            raise ValueError("LRASPPHead needs input_transform "
                             "'multiple_select'")
        self.branch_channels = tuple(branch_channels)
        conv = dict(norm_cfg=self.norm_cfg, act_cfg=self.act_cfg)
        self.convs = nn.Sequential()
        self.conv_ups = nn.Sequential()
        for i, c in enumerate(self.branch_channels):
            self.convs.add_module(
                f'conv{i}', Conv2d(self.in_channels[i], c, 1, bias=False))
            self.conv_ups.add_module(f'conv_up{i}', ConvModule(
                self.channels + c, self.channels, 1, bias=False, **conv))
        self.conv_up_input = Conv2d(self.channels, self.channels, 1)
        self.aspp_conv = ConvModule(self.in_channels[-1], self.channels, 1,
                                    bias=False, **conv)
        self.image_pool = nn.Sequential(
            ImagePool(), ConvModule(self.in_channels[-1], self.channels, 1,
                                    bias=False, act_cfg=dict(type='Sigmoid')))

    @torch.no_grad()
    def init_weights(self, generator):
        """ConvModules as mmcv initialises them, the bare convs He-normal,
        the classifier N(0, 0.01)."""
        for conv in (*self.convs, self.conv_up_input):
            he_normal_(conv, generator)
        init_conv_modules(self, generator)
        self.init_cls_seg(generator)

    def forward(self, inputs, generator=None):
        xs = self._transform_inputs(inputs)
        x = xs[-1]
        gate = resize(self.image_pool(x), size=x.shape[2:], mode='bilinear',
                      align_corners=self.align_corners)
        out = self.conv_up_input(self.aspp_conv(x) * gate)
        for i in range(len(self.branch_channels) - 1, -1, -1):
            out = resize(out, size=xs[i].shape[2:], mode='bilinear',
                         align_corners=self.align_corners)
            out = self.conv_ups[i](torch.cat([out, self.convs[i](xs[i])],
                                             dim=1))
        return self.cls_seg(out, generator)
