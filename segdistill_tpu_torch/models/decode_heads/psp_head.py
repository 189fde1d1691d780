"""PSPHead with its Pyramid Pooling Module (counterpart of
``segdistill_tpu/models/decode_heads/psp_head.py``; reference
``mmseg/models/decode_heads/psp_head.py:10-101``).

NCHW. Each pyramid branch is the reference's ``Sequential(AdaptiveAvgPool2d,
ConvModule)``, so its conv sits at ``psp_modules.{i}.1.conv`` as in the
reference ``.pth``. ``F.adaptive_avg_pool2d`` has the floor/ceil bin edges
that the JAX package spells as an averaging matrix; the pooling runs in
float32 and returns the input's dtype, as there. The classifier output is
the ``decode_head.conv_seg`` tap.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import resize
from ..builder import HEADS
from ..utils import ConvModule
from .decode_head import BaseDecodeHead


class AdaptiveAvgPool2d(nn.Module):
    """``nn.AdaptiveAvgPool2d`` in float32, returning the input's dtype."""

    def __init__(self, output_size):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool2d(x.float(), self.output_size).to(x.dtype)


class PPM(nn.ModuleList):
    """Pyramid pooling (ref psp_head.py:10-63): per scale, pool, a 1x1
    ConvModule, and a bilinear resize back to the input's size."""

    def __init__(self, pool_scales, in_channels, channels, conv_cfg=None,
                 norm_cfg=None, act_cfg='default', align_corners=False):
        super().__init__([
            nn.Sequential(AdaptiveAvgPool2d(scale),
                          ConvModule(in_channels, channels, 1,
                                     conv_cfg=conv_cfg, norm_cfg=norm_cfg,
                                     act_cfg=act_cfg))
            for scale in pool_scales])
        self.align_corners = align_corners

    def forward(self, x):
        return [resize(branch(x), size=x.shape[2:], mode='bilinear',
                       align_corners=self.align_corners) for branch in self]


def init_conv_modules(module, generator):
    """Each ConvModule under ``module`` as mmcv initialises it."""
    for m in module.modules():
        if isinstance(m, ConvModule):
            m.init_weights(generator)


@HEADS.register_module()
class PSPHead(BaseDecodeHead):

    def __init__(self, pool_scales=(1, 2, 3, 6), **kwargs):
        super().__init__(**kwargs)
        self.psp_modules = PPM(pool_scales, self.in_channels, self.channels,
                               conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg,
                               act_cfg=self.act_cfg,
                               align_corners=self.align_corners)
        self.bottleneck = ConvModule(
            self.in_channels + len(pool_scales) * self.channels,
            self.channels, 3, padding=1, conv_cfg=self.conv_cfg,
            norm_cfg=self.norm_cfg, act_cfg=self.act_cfg)

    @torch.no_grad()
    def init_weights(self, generator):
        init_conv_modules(self, generator)
        self.init_cls_seg(generator)

    def forward(self, inputs, generator=None):
        x = self._transform_inputs(inputs)
        out = self.bottleneck(torch.cat([x] + self.psp_modules(x), dim=1))
        return self.cls_seg(out, generator)
