"""Feature Pyramid Network neck (counterpart of
``segdistill_tpu/models/necks/fpn.py``; reference
``mmseg/models/necks/fpn.py:9``).

NCHW. A 1x1 lateral conv per used backbone level, summed top-down through a
*nearest* resize to the finer level's size, then a 3x3 conv per level;
extra levels (``num_outs`` above the used levels) are max-pooled from the
last output with a 1x1 window at stride 2. ``act_cfg`` is None (no
activation) unless set, as in the reference. Module names are the
reference's: ``lateral_convs.{i}``, ``fpn_convs.{i}``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import resize
from ..builder import NECKS
from ..decode_heads.psp_head import init_conv_modules
from ..utils import ConvModule


@NECKS.register_module()
class FPN(nn.Module):

    def __init__(self, in_channels, out_channels=256, num_outs=4,
                 start_level=0, end_level=-1, add_extra_convs=False,
                 extra_convs_on_inputs=True, relu_before_extra_convs=False,
                 no_norm_on_lateral=False, conv_cfg=None, norm_cfg=None,
                 act_cfg=None):
        super().__init__()
        del extra_convs_on_inputs, relu_before_extra_convs  # extra convs
        if add_extra_convs:
            raise NotImplementedError('FPN extra convs are not ported: the '
                                      'extra levels are max-pooled')
        end_level = len(in_channels) if end_level == -1 else end_level
        self.start_level = start_level
        self.num_outs = num_outs
        used = range(start_level, end_level)
        self.lateral_convs = nn.ModuleList(
            ConvModule(in_channels[i], out_channels, 1, conv_cfg=conv_cfg,
                       norm_cfg=None if no_norm_on_lateral else norm_cfg,
                       act_cfg=act_cfg) for i in used)
        self.fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, padding=1,
                       conv_cfg=conv_cfg, norm_cfg=norm_cfg, act_cfg=act_cfg)
            for _ in used)

    @torch.no_grad()
    def init_weights(self, generator):
        init_conv_modules(self, generator)

    def forward(self, inputs):
        laterals = [conv(inputs[i + self.start_level])
                    for i, conv in enumerate(self.lateral_convs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize(
                laterals[i], size=laterals[i - 1].shape[2:], mode='nearest')
        outs = [conv(lat) for conv, lat in zip(self.fpn_convs, laterals)]
        while len(outs) < self.num_outs:
            outs.append(F.max_pool2d(outs[-1], 1, stride=2))
        return tuple(outs)
