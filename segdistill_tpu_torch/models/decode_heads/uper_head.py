"""UPerHead: a PPM on the coarsest map and an FPN over the others (counterpart
of ``segdistill_tpu/models/decode_heads/uper_head.py``; reference
``mmseg/models/decode_heads/uper_head.py:11-126``), Swin's decode head.

NCHW. Module names are the reference's: ``psp_modules``, ``bottleneck`` (the
PPM's fuse conv; the JAX package calls it ``psp_bottleneck``),
``lateral_convs.{i}``, ``fpn_convs.{i}``, ``fpn_bottleneck``. The
classifier output is the ``decode_head.conv_seg`` tap.
"""

import torch
from torch import nn

from ...ops import resize
from ..builder import HEADS
from ..utils import ConvModule
from .decode_head import BaseDecodeHead
from .psp_head import PPM, init_conv_modules


@HEADS.register_module()
class UPerHead(BaseDecodeHead):

    def __init__(self, pool_scales=(1, 2, 3, 6), **kwargs):
        kwargs.setdefault('input_transform', 'multiple_select')  # ref :28
        super().__init__(**kwargs)
        conv = dict(conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg,
                    act_cfg=self.act_cfg)
        ch = self.channels
        self.psp_modules = PPM(pool_scales, self.in_channels[-1], ch,
                               align_corners=self.align_corners, **conv)
        self.bottleneck = ConvModule(
            self.in_channels[-1] + len(pool_scales) * ch, ch, 3, padding=1,
            **conv)
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, ch, 1, **conv) for c in self.in_channels[:-1])
        self.fpn_convs = nn.ModuleList(
            ConvModule(ch, ch, 3, padding=1, **conv)
            for _ in self.in_channels[:-1])
        self.fpn_bottleneck = ConvModule(len(self.in_channels) * ch, ch, 3,
                                         padding=1, **conv)

    @torch.no_grad()
    def init_weights(self, generator):
        init_conv_modules(self, generator)
        self.init_cls_seg(generator)

    def _up(self, x, like):
        return resize(x, size=like.shape[2:], mode='bilinear',
                      align_corners=self.align_corners)

    def forward(self, inputs, generator=None):
        inputs = self._transform_inputs(inputs)
        x = inputs[-1]
        laterals = [conv(f) for conv, f in zip(self.lateral_convs, inputs)]
        laterals.append(self.bottleneck(torch.cat([x] + self.psp_modules(x),
                                                  dim=1)))
        for i in range(len(laterals) - 1, 0, -1):  # top-down
            laterals[i - 1] = laterals[i - 1] + self._up(laterals[i],
                                                         laterals[i - 1])
        outs = [conv(lat) for conv, lat in zip(self.fpn_convs, laterals)]
        outs.append(laterals[-1])
        outs = [outs[0]] + [self._up(o, outs[0]) for o in outs[1:]]
        return self.cls_seg(self.fpn_bottleneck(torch.cat(outs, dim=1)),
                            generator)
