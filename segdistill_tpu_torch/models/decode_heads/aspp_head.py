"""ASPPHead, DeepLabV3's head (counterpart of
``segdistill_tpu/models/decode_heads/aspp_head.py``; reference
``mmseg/models/decode_heads/aspp_head.py``).

NCHW, the reference ``.pth`` layout: the image-pool branch
``image_pool.1`` (the global mean, a 1x1 ConvModule, a bilinear resize
back to the map's size), one ConvModule a dilation (``aspp_modules.{i}``:
1x1 at dilation 1, else 3x3 padded by the dilation), the 3x3
``bottleneck`` over their concatenation, then the classifier.
"""

import torch
from torch import nn

from ...ops import resize
from ..builder import HEADS
from ..utils import ConvModule, DepthwiseSeparableConvModule
from .decode_head import BaseDecodeHead
from .psp_head import AdaptiveAvgPool2d, init_conv_modules


class ASPPModule(nn.ModuleList):
    """One ConvModule a dilation (ref aspp_head.py:10-52)."""

    def __init__(self, dilations, in_channels, channels, norm_cfg, act_cfg,
                 separable=False):
        super().__init__(
            DepthwiseSeparableConvModule(
                in_channels, channels, 3, padding=d, dilation=d,
                norm_cfg=norm_cfg, act_cfg=act_cfg)
            if separable and d > 1 else
            ConvModule(in_channels, channels, 1 if d == 1 else 3,
                       padding=0 if d == 1 else d, dilation=d,
                       norm_cfg=norm_cfg, act_cfg=act_cfg)
            for d in dilations)

    def forward(self, x):
        return [m(x) for m in self]


@HEADS.register_module()
class ASPPHead(BaseDecodeHead):

    SEPARABLE = False

    def __init__(self, dilations=(1, 6, 12, 18), **kwargs):
        super().__init__(**kwargs)
        conv = dict(norm_cfg=self.norm_cfg, act_cfg=self.act_cfg)
        self.image_pool = nn.Sequential(
            AdaptiveAvgPool2d(1),
            ConvModule(self.in_channels, self.channels, 1, **conv))
        self.aspp_modules = ASPPModule(dilations, self.in_channels,
                                       self.channels, separable=self.SEPARABLE,
                                       **conv)
        self.bottleneck = ConvModule((len(dilations) + 1) * self.channels,
                                     self.channels, 3, padding=1, **conv)

    @torch.no_grad()
    def init_weights(self, generator):
        init_conv_modules(self, generator)
        self.init_cls_seg(generator)

    def aspp(self, x):
        """The bottleneck over the image-pool and dilated branches."""
        pooled = resize(self.image_pool(x), size=x.shape[2:],
                        mode='bilinear', align_corners=self.align_corners)
        return self.bottleneck(torch.cat([pooled] + self.aspp_modules(x),
                                         dim=1))

    def forward(self, inputs, generator=None):
        return self.cls_seg(self.aspp(self._transform_inputs(inputs)),
                            generator)
