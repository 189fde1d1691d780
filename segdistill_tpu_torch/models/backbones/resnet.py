"""ResNet, ResNetV1c and ResNetV1d backbones (counterpart of
``segdistill_tpu/models/backbones/resnet.py``; reference
``mmseg/models/backbones/resnet.py:308-688``).

NCHW. Module names follow the reference ``.pth``: the deep stem
``stem.{0,1,3,4,6,7}`` (conv, BN, ReLU three times) or ``conv1``/``bn1``,
``layer{s}.{i}.{conv1,bn1,conv2,bn2,conv3,bn3}`` and the shortcut
``downsample.{0,1}`` (conv, BN), or with ``avg_down`` ``downsample.{1,2}``
behind an average pool. 'pytorch' style: the stride sits on the 3x3 conv.
The d8 variants set per-stage ``strides`` and ``dilations``; with
``contract_dilation`` the first block of a dilated stage takes half the
dilation; with ``multi_grid`` block i of the last stage takes the stage's
dilation times ``multi_grid[i]`` as its first dilation (in place of
``contract_dilation`` there, as in JAX). ``norm_eval`` keeps every BN in
eval mode while training; ``zero_init_residual`` zeroes each block's last
BN weight at initialisation. With ``groups`` above 1 (ResNeXt,
``resnext.py``) a bottleneck's 3x3 conv is grouped: ``groups`` groups, width ``planes *
width_per_group // base_channels * groups`` (the floor taken before the
product, ref resnext.py:27-31); at one group the width is ``planes`` (the
reference's Bottleneck). A BasicBlock depth refuses groups. Frozen
stages are not ported (no config sets them). BN
and SyncBN are one BN here (one device). ``dtype`` is the compute type, as in the port's MiT:
parameters stay float32 and each conv casts them to its input's dtype.

Every residual block's output is a tap under its module name
(``backbone.layer4.2``), as the JAX package sows it.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..builder import BACKBONES
from ..utils import build_norm_layer, tap
from ..utils.conv_module import Conv2d, init_conv_norm
from ..utils.norm import NormEvalModule
from .mix_transformer import _torch_dtype


def _norm(norm_cfg, features):
    return build_norm_layer(norm_cfg, features)[1]


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 first_dilation=1, downsample=None, norm_cfg=None):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, first_dilation,
                            first_dilation, bias=False)
        self.bn1 = _norm(norm_cfg, planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, dilation, dilation,
                            bias=False)
        self.bn2 = _norm(norm_cfg, planes)
        self.downsample = downsample

    def last_norm(self):
        return self.bn2

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return tap(self, '', F.relu(out + identity))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 first_dilation=1, downsample=None, norm_cfg=None, groups=1,
                 width_per_group=4, base_channels=64):
        super().__init__()
        del dilation  # the 3x3 conv takes first_dilation, as in JAX
        width = planes if groups == 1 \
            else planes * width_per_group // base_channels * groups
        self.conv1 = Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = _norm(norm_cfg, width)
        self.conv2 = Conv2d(width, width, 3, stride, first_dilation,
                            first_dilation, groups=groups, bias=False)
        self.bn2 = _norm(norm_cfg, width)
        self.conv3 = Conv2d(width, planes * self.expansion, 1, bias=False)
        self.bn3 = _norm(norm_cfg, planes * self.expansion)
        self.downsample = downsample

    def last_norm(self):
        return self.bn3

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return tap(self, '', F.relu(out + identity))


def _downsample(inplanes, features, stride, avg_down, norm_cfg):
    """The shortcut: Sequential(conv, BN), or with ``avg_down`` and a
    stride Sequential(AvgPool, conv, BN) (ref res_layer.py:44-62)."""
    if avg_down and stride != 1:
        return nn.Sequential(
            nn.AvgPool2d(stride, stride, ceil_mode=True,
                         count_include_pad=False),
            Conv2d(inplanes, features, 1, bias=False),
            _norm(norm_cfg, features))
    return nn.Sequential(Conv2d(inplanes, features, 1, stride, bias=False),
                         _norm(norm_cfg, features))


@BACKBONES.register_module()
class ResNet(NormEvalModule):
    """Returns the stage maps of ``out_indices`` (NCHW)."""

    arch_settings = {
        18: (BasicBlock, (2, 2, 2, 2)),
        34: (BasicBlock, (3, 4, 6, 3)),
        50: (Bottleneck, (3, 4, 6, 3)),
        101: (Bottleneck, (3, 4, 23, 3)),
        152: (Bottleneck, (3, 8, 36, 3)),
    }

    def __init__(self, depth=50, in_channels=3, stem_channels=64,
                 base_channels=64, num_stages=4, strides=(1, 2, 2, 2),
                 dilations=(1, 1, 1, 1), out_indices=(0, 1, 2, 3),
                 style='pytorch', deep_stem=False, avg_down=False,
                 frozen_stages=-1, norm_cfg=None, norm_eval=False,
                 contract_dilation=False, with_cp=False,
                 zero_init_residual=True, dcn=None,
                 stage_with_dcn=(False, False, False, False),
                 pretrained=None, dtype=None, groups=1, width_per_group=4,
                 multi_grid=None):
        super().__init__()
        del with_cp, stage_with_dcn, pretrained  # no effect on the result
        if style != 'pytorch':
            raise NotImplementedError("only style='pytorch' is ported")
        if dcn is not None or frozen_stages != -1:
            raise NotImplementedError('deformable convs and frozen stages '
                                      'are not ported')
        if depth not in self.arch_settings:
            raise KeyError(f'invalid depth {depth} for resnet')
        block, stage_blocks = self.arch_settings[depth]
        if block is Bottleneck:
            grouped = dict(groups=groups, width_per_group=width_per_group,
                           base_channels=base_channels)
        elif groups != 1:
            raise NotImplementedError(
                f'groups={groups} needs a Bottleneck depth (50, 101, 152)')
        else:
            grouped = {}
        stage_blocks = stage_blocks[:num_stages]
        self.out_indices = tuple(out_indices)
        self.deep_stem = deep_stem
        self.norm_eval = norm_eval
        self.zero_init_residual = zero_init_residual
        self.dtype = _torch_dtype(dtype)
        if deep_stem:
            half = stem_channels // 2
            self.stem = nn.Sequential(
                Conv2d(in_channels, half, 3, 2, 1, bias=False),
                _norm(norm_cfg, half), nn.ReLU(),
                Conv2d(half, half, 3, 1, 1, bias=False),
                _norm(norm_cfg, half), nn.ReLU(),
                Conv2d(half, stem_channels, 3, 1, 1, bias=False),
                _norm(norm_cfg, stem_channels), nn.ReLU())
        else:
            self.conv1 = Conv2d(in_channels, stem_channels, 7, 2, 3,
                                bias=False)
            self.bn1 = _norm(norm_cfg, stem_channels)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        planes, inplanes = base_channels, stem_channels
        self.res_layers = []
        for s, n in enumerate(stage_blocks):
            stride, dilation = strides[s], dilations[s]
            features = planes * block.expansion
            blocks = []
            for i in range(n):
                blk_stride = stride if i == 0 else 1
                if multi_grid is not None and s == len(stage_blocks) - 1:
                    first = dilation * multi_grid[i]
                elif i == 0 and dilation > 1 and contract_dilation:
                    first = dilation // 2
                else:
                    first = dilation
                ds = None
                if i == 0 and (blk_stride != 1 or inplanes != features):
                    ds = _downsample(inplanes, features, blk_stride,
                                     avg_down, norm_cfg)
                blocks.append(block(inplanes, planes, blk_stride, dilation,
                                    first, ds, norm_cfg, **grouped))
                inplanes = features
            name = f'layer{s + 1}'
            self.add_module(name, nn.Sequential(*blocks))
            self.res_layers.append(name)
            planes *= 2

    @torch.no_grad()
    def init_weights(self, generator):
        """He-normal convs (fan_out, ReLU gain) and unit BN, as the
        reference initialises without a checkpoint; with
        ``zero_init_residual`` each block's last BN weight is 0."""
        init_conv_norm(self, generator)
        if self.zero_init_residual:
            for m in self.modules():
                if hasattr(m, 'last_norm'):
                    nn.init.zeros_(m.last_norm().weight)

    def forward(self, x, generator=None):
        del generator  # nothing random
        x = x.to(self.dtype)
        if self.deep_stem:
            x = self.stem(x)
        else:
            x = F.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        outs = []
        for i, name in enumerate(self.res_layers):
            x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


@BACKBONES.register_module(name='ResNetV1c')
def ResNetV1c(**kwargs):
    """ResNet with the deep 3x3 stem (ref resnet.py:662-676)."""
    kwargs.pop('style', None)
    return ResNet(deep_stem=True, avg_down=False, **kwargs)


@BACKBONES.register_module(name='ResNetV1d')
def ResNetV1d(**kwargs):
    """The deep stem and average-pool shortcuts (ref resnet.py:678-688)."""
    kwargs.pop('style', None)
    return ResNet(deep_stem=True, avg_down=True, **kwargs)
