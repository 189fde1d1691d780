"""CGNet backbone (counterpart of ``segdistill_tpu/models/backbones/
cgnet.py``; reference ``mmseg/models/backbones/cgnet.py:13-365``).

NCHW, the reference ``.pth`` layout: ``stem.{0,1,2}`` (3x3 ConvModules,
stride 2, 1, 1, with PReLU), ``norm_prelu_{0,1,2}`` (a BN at slot 0 and a
PReLU at slot 1), ``level1.{j}`` and ``level2.{j}`` Context Guided blocks
(``conv1x1``, the depthwise ``f_loc`` and dilated ``f_sur``, ``bn``,
``activate``, with a downsampling first block's bias-free 1x1
``bottleneck``, and the global context gate ``f_glo.fc.{0,2}``, two
``nn.Linear``). Every PReLU starts at 0 (the reference's
``init_weights``). The input is injected through chained 3x3 stride-2
average pools that count the padding (one for 1/2, two for 1/4). The
stages concatenate ``[h, inp_2x]``, ``[h, down1, inp_4x]`` and then
``[down2, h]``, ``down`` being a stage's first block's output (ref
forward :313-334). Returns the three stages' maps.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..builder import BACKBONES
from ..utils import ConvModule, build_norm_layer
from ..utils.activation import PReLU
from ..utils.conv_module import Conv2d, Linear, he_normal_, init_conv_norm
from .mix_transformer import _torch_dtype

PRELU0 = dict(type='PReLU', init=0.0)


def _inject(x, times):
    """``times`` chained AvgPool2d(3, 2, 1), counting the padding (ref
    InputInjection :170-182)."""
    for _ in range(times):
        x = F.avg_pool2d(x, 3, 2, 1)
    return x


class GlobalContextExtractor(nn.Module):
    """The squeeze-excite gate: the channel means through ``fc`` (Linear,
    ReLU, Linear, Sigmoid) scale the channels (ref :13-50)."""

    def __init__(self, channels, reduction=16):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.fc = nn.Sequential(Linear(channels, hidden), nn.ReLU(),
                                Linear(hidden, channels), nn.Sigmoid())

    def forward(self, x):
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class ContextGuidedBlock(nn.Module):
    """ref :53-167."""

    def __init__(self, in_channels, out_channels, dilation=2, reduction=16,
                 downsample=False, norm_cfg=None):
        super().__init__()
        channels = out_channels if downsample else out_channels // 2
        ksize = 3 if downsample else 1
        self.downsample = downsample
        self.conv1x1 = ConvModule(in_channels, channels, ksize,
                                  stride=2 if downsample else 1,
                                  padding=(ksize - 1) // 2,
                                  norm_cfg=norm_cfg, act_cfg=PRELU0)
        self.f_loc = Conv2d(channels, channels, 3, padding=1,
                            groups=channels, bias=False)
        self.f_sur = Conv2d(channels, channels, 3, padding=dilation,
                            dilation=dilation, groups=channels, bias=False)
        self.bn = build_norm_layer(norm_cfg, 2 * channels)[1]
        self.activate = PReLU(2 * channels, init=0.0)
        if downsample:
            self.bottleneck = Conv2d(2 * channels, out_channels, 1,
                                     bias=False)
        self.f_glo = GlobalContextExtractor(out_channels, reduction)

    def forward(self, x):
        h = self.conv1x1(x)
        joi = self.activate(self.bn(torch.cat([self.f_loc(h), self.f_sur(h)],
                                              dim=1)))
        if self.downsample:
            return self.f_glo(self.bottleneck(joi))
        return x + self.f_glo(joi)


def _norm_prelu(norm_cfg, channels):
    return nn.Sequential(build_norm_layer(norm_cfg, channels)[1],
                         PReLU(channels, init=0.0))


@BACKBONES.register_module()
class CGNet(nn.Module):

    def __init__(self, in_channels=3, num_channels=(32, 64, 128),
                 num_blocks=(3, 21), dilations=(2, 4), reductions=(8, 16),
                 norm_cfg=None, pretrained=None, style=None, dtype=None):
        super().__init__()
        del pretrained, style
        norm_cfg = norm_cfg or dict(type='BN')
        self.dtype = _torch_dtype(dtype)
        c0, c1, c2 = num_channels
        self.stem = nn.ModuleList(
            ConvModule(in_channels if i == 0 else c0, c0, 3,
                       stride=2 if i == 0 else 1, padding=1,
                       norm_cfg=norm_cfg, act_cfg=PRELU0)
            for i in range(3))
        cur = c0 + in_channels
        self.norm_prelu_0 = _norm_prelu(norm_cfg, cur)
        self.level1 = nn.ModuleList(
            ContextGuidedBlock(cur if j == 0 else c1, c1, dilations[0],
                               reductions[0], downsample=j == 0,
                               norm_cfg=norm_cfg)
            for j in range(num_blocks[0]))
        cur = 2 * c1 + in_channels
        self.norm_prelu_1 = _norm_prelu(norm_cfg, cur)
        self.level2 = nn.ModuleList(
            ContextGuidedBlock(cur if j == 0 else c2, c2, dilations[1],
                               reductions[1], downsample=j == 0,
                               norm_cfg=norm_cfg)
            for j in range(num_blocks[1]))
        self.norm_prelu_2 = _norm_prelu(norm_cfg, 2 * c2)

    @torch.no_grad()
    def init_weights(self, generator):
        """The reference's: He-normal convs and linears, unit norms, every
        PReLU slope 0."""
        init_conv_norm(self, generator)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                he_normal_(m, generator)
            elif isinstance(m, PReLU):
                nn.init.zeros_(m.weight)

    def forward(self, x, generator=None):
        del generator  # nothing random
        x = x.to(self.dtype)
        inp2, inp4 = _inject(x, 1), _inject(x, 2)
        h = x
        for conv in self.stem:
            h = conv(h)
        h = self.norm_prelu_0(torch.cat([h, inp2], dim=1))
        outs = [h]
        for j, block in enumerate(self.level1):
            h = block(h)
            if j == 0:
                down1 = h
        h = self.norm_prelu_1(torch.cat([h, down1, inp4], dim=1))
        outs.append(h)
        for j, block in enumerate(self.level2):
            h = block(h)
            if j == 0:
                down2 = h
        outs.append(self.norm_prelu_2(torch.cat([down2, h], dim=1)))
        return tuple(outs)
