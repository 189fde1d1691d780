"""MobileNetV2 (counterpart of
``segdistill_tpu/models/backbones/mobilenet_v2.py``; reference
``mmseg/models/backbones/mobilenet_v2.py``).

NCHW, the reference ``.pth`` layout: the stem ConvModule ``conv1`` (3x3,
stride 2, ReLU6) and seven stages ``layer1`` ... ``layer7`` of
:class:`InvertedResidual` blocks (expand ratio, width, blocks: the table
below, widths times ``widen_factor`` rounded to a multiple of 8); a
stage's first block takes its ``strides`` entry, every block its
``dilations`` entry. Returns the maps of the stages in ``out_indices``
(0-based). ``dtype`` is the compute type; parameters stay float32. Frozen
stages are not ported.
"""

import torch
from torch import nn

from ..builder import BACKBONES
from ..utils import ConvModule, InvertedResidual, make_divisible
from ..utils.conv_module import init_conv_norm
from ..utils.norm import NormEvalModule
from .mix_transformer import _torch_dtype


@BACKBONES.register_module()
class MobileNetV2(NormEvalModule):

    # expand ratio, width, blocks of each stage
    arch_settings = [[1, 16, 1], [6, 24, 2], [6, 32, 3], [6, 64, 4],
                     [6, 96, 3], [6, 160, 3], [6, 320, 1]]

    def __init__(self, widen_factor=1.0, strides=(1, 2, 2, 2, 1, 2, 1),
                 dilations=(1, 1, 1, 1, 1, 1, 1), out_indices=(1, 2, 4, 6),
                 frozen_stages=-1, norm_cfg=None, norm_eval=False,
                 with_cp=False, pretrained=None, style=None, dtype=None):
        super().__init__()
        del with_cp, pretrained, style  # no effect on the result
        if frozen_stages != -1:
            raise NotImplementedError('frozen stages are not ported')
        norm_cfg = norm_cfg or dict(type='BN')
        act_cfg = dict(type='ReLU6')
        self.out_indices = tuple(out_indices)
        self.norm_eval = norm_eval
        self.dtype = _torch_dtype(dtype)
        in_ch = make_divisible(32 * widen_factor, 8)
        self.conv1 = ConvModule(3, in_ch, 3, stride=2, padding=1,
                                norm_cfg=norm_cfg, act_cfg=act_cfg)
        self.layers = []
        for i, (ratio, width, blocks) in enumerate(self.arch_settings):
            out_ch = make_divisible(width * widen_factor, 8)
            layer = []
            for j in range(blocks):
                layer.append(InvertedResidual(
                    in_ch, out_ch, strides[i] if j == 0 else 1, ratio,
                    dilation=dilations[i], norm_cfg=norm_cfg,
                    act_cfg=act_cfg))
                in_ch = out_ch
            self.add_module(f'layer{i + 1}', nn.Sequential(*layer))
            self.layers.append(f'layer{i + 1}')

    @torch.no_grad()
    def init_weights(self, generator):
        init_conv_norm(self, generator)

    def forward(self, x, generator=None):
        del generator  # nothing random
        x = self.conv1(x.to(self.dtype))
        outs = []
        for i, name in enumerate(self.layers):
            x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
