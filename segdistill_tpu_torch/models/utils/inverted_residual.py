"""Inverted residual blocks of MobileNetV2 and V3 (counterpart of
``segdistill_tpu/models/utils/inverted_residual.py``; reference
``mmseg/models/utils/inverted_residual.py``).

NCHW, the reference ``.pth`` layout. :class:`InvertedResidual` (V2) is the
Sequential ``conv``: a 1x1 expansion (absent at ``expand_ratio`` 1), the
3x3 depthwise conv (dilated, padding = dilation) and the linear 1x1
projection, each a ConvModule (ReLU6, none on the last); the input is
added where the stride is 1 and the widths agree.
:class:`InvertedResidualV3` names its parts ``expand_conv`` (where the
input's width is not ``mid_channels``), ``depthwise_conv``, ``se`` and
``linear_conv``; a stride-2 depthwise conv pads as TF's SAME does
(mmcv's ``Conv2dAdaptivePadding``: the odd pixel at the bottom and the
right), others by dilation * (k - 1) / 2.
"""

import torch.nn.functional as F
from torch import nn

from .conv_module import ConvModule
from .se_layer import SELayer


def same_pad(size, kernel, stride, dilation=1):
    """TF-SAME total padding along one axis (mmcv
    ``Conv2dAdaptivePadding``)."""
    return max((-(-size // stride) - 1) * stride
               + (kernel - 1) * dilation + 1 - size, 0)


def pad_same(x, kernel, stride, dilation=1):
    """``x`` padded as a TF-SAME conv of ``kernel`` at ``stride`` would be:
    half of each axis' padding before, the rest after."""
    ph = same_pad(x.shape[2], kernel, stride, dilation)
    pw = same_pad(x.shape[3], kernel, stride, dilation)
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))


class InvertedResidual(nn.Module):

    def __init__(self, in_channels, out_channels, stride, expand_ratio,
                 dilation=1, norm_cfg=None, act_cfg=None):
        super().__init__()
        hidden = int(round(in_channels * expand_ratio))
        act_cfg = act_cfg or dict(type='ReLU6')
        self.use_res_connect = stride == 1 and in_channels == out_channels
        layers = []
        if expand_ratio != 1:
            layers.append(ConvModule(in_channels, hidden, 1,
                                     norm_cfg=norm_cfg, act_cfg=act_cfg))
        layers += [
            ConvModule(hidden, hidden, 3, stride=stride, padding=dilation,
                       dilation=dilation, groups=hidden, norm_cfg=norm_cfg,
                       act_cfg=act_cfg),
            ConvModule(hidden, out_channels, 1, norm_cfg=norm_cfg,
                       act_cfg=None)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res_connect else out


class InvertedResidualV3(nn.Module):

    def __init__(self, in_channels, out_channels, mid_channels,
                 kernel_size=3, stride=1, dilation=1, se_cfg=None,
                 with_expand_conv=True, norm_cfg=None, act_cfg=None):
        super().__init__()
        act_cfg = act_cfg or dict(type='ReLU')
        self.use_res_connect = stride == 1 and in_channels == out_channels
        self.kernel_size, self.stride = kernel_size, stride
        self.dilation = dilation
        self.expand_conv = ConvModule(
            in_channels, mid_channels, 1, norm_cfg=norm_cfg,
            act_cfg=act_cfg) if with_expand_conv else None
        self.depthwise_conv = ConvModule(
            mid_channels, mid_channels, kernel_size, stride=stride,
            padding=0 if stride == 2 else dilation * (kernel_size - 1) // 2,
            dilation=dilation, groups=mid_channels, norm_cfg=norm_cfg,
            act_cfg=act_cfg)
        self.se = SELayer(**se_cfg) if se_cfg is not None else None
        self.linear_conv = ConvModule(mid_channels, out_channels, 1,
                                      norm_cfg=norm_cfg, act_cfg=None)

    def forward(self, x):
        out = x if self.expand_conv is None else self.expand_conv(x)
        if self.stride == 2:
            out = pad_same(out, self.kernel_size, 2, self.dilation)
        out = self.depthwise_conv(out)
        if self.se is not None:
            out = self.se(out)
        out = self.linear_conv(out)
        return x + out if self.use_res_connect else out
