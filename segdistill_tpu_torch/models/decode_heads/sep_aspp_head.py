"""DepthwiseSeparableASPPHead, DeepLabV3+'s head (counterpart of
``segdistill_tpu/models/decode_heads/sep_aspp_head.py``; reference
``mmseg/models/decode_heads/sep_aspp_head.py``).

The ASPP head with its dilated branches depthwise-separable
(``aspp_modules.{i}.{depthwise,pointwise}_conv``); its bottleneck output
is resized to the low-level map ``inputs[0]`` and concatenated with that
map's 1x1 ConvModule (``c1_bottleneck``, where ``c1_in_channels`` > 0),
then two 3x3 separable ConvModules (``sep_bottleneck.{0,1}``) and the
classifier.
"""

import torch
from torch import nn

from ...ops import resize
from ..builder import HEADS
from ..utils import ConvModule, DepthwiseSeparableConvModule
from .aspp_head import ASPPHead


@HEADS.register_module()
class DepthwiseSeparableASPPHead(ASPPHead):

    SEPARABLE = True

    def __init__(self, c1_in_channels, c1_channels, **kwargs):
        super().__init__(**kwargs)
        conv = dict(norm_cfg=self.norm_cfg, act_cfg=self.act_cfg)
        self.c1_bottleneck = ConvModule(c1_in_channels, c1_channels, 1,
                                        **conv) if c1_in_channels > 0 else None
        width = self.channels + (c1_channels if c1_in_channels > 0 else 0)
        self.sep_bottleneck = nn.Sequential(
            DepthwiseSeparableConvModule(width, self.channels, 3, padding=1,
                                         **conv),
            DepthwiseSeparableConvModule(self.channels, self.channels, 3,
                                         padding=1, **conv))

    def forward(self, inputs, generator=None):
        out = self.aspp(self._transform_inputs(inputs))
        if self.c1_bottleneck is not None:
            c1 = self.c1_bottleneck(inputs[0])
            out = torch.cat([resize(out, size=c1.shape[2:], mode='bilinear',
                                    align_corners=self.align_corners), c1],
                            dim=1)
        return self.cls_seg(self.sep_bottleneck(out), generator)
