"""ResNeSt: ResNetV1d with split attention in each bottleneck's 3x3 conv
(counterpart of ``segdistill_tpu/models/backbones/resnest.py``; reference
``mmseg/models/backbones/resnest.py:14-314``).

NCHW, the reference ``.pth`` layout: a bottleneck holds ``conv1``/``bn1``,
the split-attention ``conv2`` (``conv``, ``bn0``, ``fc1``, ``bn1``,
``fc2``), the stride as a 3x3 average pool after it (``avd_layer``, which
counts the padding), ``conv3``/``bn3`` and the average-pool shortcut of
ResNetV1d; the stem is deep. Only the reference defaults are built (radix
2, reduction factor 4, ``avg_down_stride``, one group of base width 4), as
in the JAX package, which refuses the others with the same message.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..builder import BACKBONES
from ..utils import tap
from ..utils.conv_module import Conv2d
from .resnet import ResNet, _norm


class SplitAttentionConv(nn.Module):
    """The 3x3 conv of ``channels * radix`` maps in ``groups * radix``
    groups, BN and ReLU; the radix splits summed and pooled to 1x1, two
    1x1 grouped convs with bias (``fc1`` to ``max(in * radix //
    reduction_factor, 32)`` channels, BN, ReLU; ``fc2`` back), a softmax
    over the radix (a sigmoid at radix 1), and the splits' weighted sum
    (ref resnest.py:14-101)."""

    def __init__(self, in_channels, channels, stride=1, dilation=1,
                 groups=1, radix=2, reduction_factor=4, norm_cfg=None):
        super().__init__()
        inter = max(in_channels * radix // reduction_factor, 32)
        self.radix = radix
        self.channels = channels
        self.conv = Conv2d(in_channels, channels * radix, 3, stride,
                           dilation, dilation, groups=groups * radix,
                           bias=False)
        self.bn0 = _norm(norm_cfg, channels * radix)
        self.fc1 = Conv2d(channels, inter, 1, groups=groups)
        self.bn1 = _norm(norm_cfg, inter)
        self.fc2 = Conv2d(inter, channels * radix, 1, groups=groups)

    def forward(self, x):
        x = F.relu(self.bn0(self.conv(x)))
        b = x.shape[0]
        splits = x.view(b, self.radix, self.channels, *x.shape[2:])
        gap = splits.sum(dim=1).mean(dim=(2, 3), keepdim=True)
        gap = F.relu(self.bn1(self.fc1(gap)))
        atten = self.fc2(gap).view(b, self.radix, self.channels)
        atten = atten.softmax(dim=1) if self.radix > 1 \
            else torch.sigmoid(atten)
        return (splits * atten[..., None, None]).sum(dim=1)


class SABottleneck(nn.Module):
    """A bottleneck whose 3x3 conv is split attention; the stride moves to
    a 3x3 average pool after it (ref resnest.py:104-213)."""

    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 first_dilation=1, downsample=None, norm_cfg=None):
        super().__init__()
        del dilation  # the 3x3 conv takes first_dilation, as in JAX
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = _norm(norm_cfg, planes)
        self.conv2 = SplitAttentionConv(planes, planes,
                                        dilation=first_dilation,
                                        norm_cfg=norm_cfg)
        self.avd_layer = nn.AvgPool2d(3, stride, padding=1) \
            if stride > 1 else None
        self.conv3 = Conv2d(planes, planes * self.expansion, 1, bias=False)
        self.bn3 = _norm(norm_cfg, planes * self.expansion)
        self.downsample = downsample

    def last_norm(self):
        return self.bn3

    def forward(self, x):
        out = self.conv2(F.relu(self.bn1(self.conv1(x))))
        if self.avd_layer is not None:
            out = self.avd_layer(out)
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return tap(self, '', F.relu(out + identity))


@BACKBONES.register_module()
class ResNeSt(ResNet):
    """ResNetV1d (deep stem, average-pool shortcuts) of split-attention
    bottlenecks."""

    arch_settings = {
        50: (SABottleneck, (3, 4, 6, 3)),
        101: (SABottleneck, (3, 4, 23, 3)),
        152: (SABottleneck, (3, 8, 36, 3)),
        200: (SABottleneck, (3, 24, 36, 3)),
    }

    def __init__(self, depth=50, radix=2, reduction_factor=4,
                 avg_down_stride=True, groups=1, base_width=4, **kwargs):
        if (radix, reduction_factor, avg_down_stride, groups,
                base_width) != (2, 4, True, 1, 4):
            raise NotImplementedError(
                'ResNeSt supports the reference defaults radix=2, '
                'reduction_factor=4, avg_down_stride=True, groups=1, '
                'base_width=4 (ref resnest.py:289-300)')
        kwargs.pop('style', None)
        super().__init__(depth=depth, deep_stem=True, avg_down=True,
                         **kwargs)
