"""FPNHead, the Panoptic-FPN head PointRend's first stage uses (counterpart
of ``segdistill_tpu/models/decode_heads/fpn_head.py``; reference
``mmseg/models/decode_heads/fpn_head.py``).

NCHW. Level i of stride s gets max(1, log2(s / s_0)) 3x3 ConvModules, each
followed by a x2 bilinear upsample where s is not the first stride; the
levels are summed at the first one's size and classified (the ``conv_seg``
tap). ``scale_heads.{i}`` is the reference's Sequential, so the convs sit
at slots 0, 2, 4 between the parameter-free upsamples. Its loss is the
base head's: softmax CE through K5/K6 on CUDA.
"""

import math

import torch
from torch import nn

from ...ops import Upsample, resize
from ..builder import HEADS
from ..utils import ConvModule
from .decode_head import BaseDecodeHead
from .psp_head import init_conv_modules


@HEADS.register_module()
class FPNHead(BaseDecodeHead):

    def __init__(self, feature_strides, **kwargs):
        kwargs.setdefault('input_transform', 'multiple_select')
        super().__init__(**kwargs)
        if len(feature_strides) != len(self.in_channels):
            raise ValueError('one feature stride per input')
        conv = dict(conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg,
                    act_cfg=self.act_cfg)
        self.feature_strides = tuple(feature_strides)
        self.scale_heads = nn.ModuleList()
        for i, stride in enumerate(self.feature_strides):
            head_len = max(1, int(math.log2(stride)
                                  - math.log2(self.feature_strides[0])))
            layers = []
            for k in range(head_len):
                layers.append(ConvModule(
                    self.in_channels[i] if k == 0 else self.channels,
                    self.channels, 3, padding=1, **conv))
                if stride != self.feature_strides[0]:
                    layers.append(Upsample(scale_factor=2, mode='bilinear',
                                           align_corners=self.align_corners))
            self.scale_heads.append(nn.Sequential(*layers))

    @torch.no_grad()
    def init_weights(self, generator):
        init_conv_modules(self, generator)
        self.init_cls_seg(generator)

    def forward(self, inputs, generator=None):
        x = self._transform_inputs(inputs)
        out = self.scale_heads[0](x[0])
        for i in range(1, len(self.feature_strides)):
            out = out + resize(self.scale_heads[i](x[i]),
                               size=out.shape[2:], mode='bilinear',
                               align_corners=self.align_corners)
        return self.cls_seg(out, generator)
