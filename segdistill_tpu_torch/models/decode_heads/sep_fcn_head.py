"""DepthwiseSeparableFCNHead, Fast-SCNN's head (counterpart of
``segdistill_tpu/models/decode_heads/sep_fcn_head.py``; reference
``mmseg/models/decode_heads/sep_fcn_head.py``).

FCNHead with every 3x3 ConvModule depthwise-separable: ``convs.{i}`` and,
with ``concat_input``, ``conv_cat`` over the input and their output, each a
``depthwise_conv`` and a ``pointwise_conv`` under the head's norm and
activation, as the JAX package builds them.
"""

import torch
from torch import nn

from ..builder import HEADS
from ..utils import DepthwiseSeparableConvModule
from .decode_head import BaseDecodeHead
from .psp_head import init_conv_modules


@HEADS.register_module()
class DepthwiseSeparableFCNHead(BaseDecodeHead):

    def __init__(self, num_convs=2, concat_input=True, **kwargs):
        super().__init__(**kwargs)
        conv = dict(norm_cfg=self.norm_cfg, act_cfg=self.act_cfg)
        self.convs = nn.Sequential(*[
            DepthwiseSeparableConvModule(
                self.in_channels if i == 0 else self.channels, self.channels,
                3, padding=1, **conv) for i in range(num_convs)])
        self.conv_cat = DepthwiseSeparableConvModule(
            self.in_channels + self.channels, self.channels, 3, padding=1,
            **conv) if concat_input else None

    @torch.no_grad()
    def init_weights(self, generator):
        init_conv_modules(self, generator)
        self.init_cls_seg(generator)

    def forward(self, inputs, generator=None):
        x = self._transform_inputs(inputs)
        out = self.convs(x)
        if self.conv_cat is not None:
            out = self.conv_cat(torch.cat([x, out], dim=1))
        return self.cls_seg(out, generator)
