"""ConvModule: conv -> norm -> activation (counterpart of
``segdistill_tpu/models/utils/conv_module.py``; reference
``mmcv.cnn.ConvModule``).

NCHW. The children sit under the reference names: ``conv``, then the norm
under the name :func:`build_norm_layer` gives it (``bn``, ``gn``, ``ln``),
so the reference ``.pth`` layout (``...conv.weight``, ``...bn.running_mean``)
and the paramwise ``norm`` rules hold, then the activation (``activate``,
:func:`build_activation`: a PReLU's ``activate.weight``). ``bias='auto'``
drops the conv bias where a norm follows. ``act_cfg``: unset is ReLU,
``None`` no activation, as mmcv has it. A depthwise conv is
``nn.Conv2d(groups=C)``.
``conv_cfg=dict(type='Conv1d')`` makes the conv an ``nn.Conv1d`` over (B,
C, L) (PointHead's point MLP, which has no norm). The conv computes in its
input's dtype (float32 parameters cast to it, as flax
layers with ``dtype`` do); the norm keeps float32 statistics and returns
the input's dtype.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from .activation import build_activation
from .norm import build_norm_layer


def to_2tuple(x):
    """(x, x) for a scalar, a tuple of a sequence."""
    if isinstance(x, (tuple, list)):
        return tuple(x)
    return (x, x)


@torch.no_grad()
def he_normal_(conv, generator):
    """mmcv's ``kaiming_init``: N(0, 2 / fan_out) weights (the ReLU gain)
    and a zero bias, drawn from ``generator``."""
    w = conv.weight
    fan_out = w[0, 0].numel() * w.shape[0]
    w.normal_(0, math.sqrt(2.0 / fan_out), generator=generator)
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)


@torch.no_grad()
def torch_default_(layer, generator):
    """PyTorch's own initialisation of a conv or linear layer (weight and
    bias U(-1/sqrt(fan_in), 1/sqrt(fan_in))), drawn from ``generator``:
    the reference's bare convs and linear layers, which mmseg leaves so."""
    bound = layer.weight[0].numel() ** -0.5
    layer.weight.uniform_(-bound, bound, generator=generator)
    if layer.bias is not None:
        layer.bias.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def init_conv_norm(module, generator):
    """Every conv under ``module`` He-normal (:func:`he_normal_`), every BN
    and GN weight 1 and bias 0: mmcv's initialisation of a backbone
    without a checkpoint."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            he_normal_(m, generator)
        elif isinstance(m, (nn.modules.batchnorm._BatchNorm, nn.GroupNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in its input's dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` computing in its input's dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Linear(nn.Linear):
    """``nn.Linear`` computing in its input's dtype."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class ConvModule(nn.Module):
    """conv -> norm -> act (ref: mmcv ConvModule)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias='auto', conv_cfg=None,
                 norm_cfg=None, act_cfg='default'):
        super().__init__()
        conv_type = (conv_cfg or {}).get('type', 'Conv2d')
        if conv_type not in ('Conv', 'Conv2d', 'Conv1d'):
            raise NotImplementedError(f'conv type {conv_type} is not ported')
        self.with_norm = norm_cfg is not None
        use_bias = (not self.with_norm) if bias == 'auto' else bool(bias)
        if conv_type == 'Conv1d':
            if self.with_norm:
                raise NotImplementedError('a norm after a Conv1d is not '
                                          'ported')
            self.conv = Conv1d(in_channels, out_channels, kernel_size,
                               stride, padding, dilation, groups,
                               bias=use_bias)
        else:
            self.conv = Conv2d(in_channels, out_channels,
                               to_2tuple(kernel_size), to_2tuple(stride),
                               to_2tuple(padding), to_2tuple(dilation),
                               groups, bias=use_bias)
        self.norm_name = None
        if self.with_norm:
            self.norm_name, norm = build_norm_layer(norm_cfg, out_channels)
            self.add_module(self.norm_name, norm)
        act_cfg = dict(type='ReLU') if act_cfg == 'default' else act_cfg
        self.with_act = act_cfg is not None
        if self.with_act:
            self.activate = build_activation(act_cfg, out_channels)

    @property
    def norm(self):
        return getattr(self, self.norm_name) if self.norm_name else None

    @torch.no_grad()
    def init_weights(self, generator):
        """mmcv's: a He-normal conv (fan_out, ReLU gain), zero bias, unit
        norm; drawn from ``generator``."""
        he_normal_(self.conv, generator)
        if self.with_norm:
            nn.init.ones_(self.norm.weight)
            nn.init.zeros_(self.norm.bias)

    def forward(self, x):
        x = self.conv(x)
        if self.with_norm:
            x = self.norm(x)
        return self.activate(x) if self.with_act else x


class DepthwiseSeparableConvModule(nn.Module):
    """A depthwise ConvModule (``depthwise_conv``, groups = in_channels)
    and a 1x1 pointwise one (``pointwise_conv``) (ref: mmcv
    DepthwiseSeparableConvModule). ``dw_*`` and ``pw_*`` override
    ``norm_cfg`` / ``act_cfg`` for either; ``'default'`` takes them."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=0, dilation=1, norm_cfg=None, act_cfg='default',
                 dw_norm_cfg='default', dw_act_cfg='default',
                 pw_norm_cfg='default', pw_act_cfg='default'):
        super().__init__()

        def pick(override, base):
            return base if override == 'default' else override
        self.depthwise_conv = ConvModule(
            in_channels, in_channels, kernel_size, stride=stride,
            padding=padding, dilation=dilation, groups=in_channels,
            norm_cfg=pick(dw_norm_cfg, norm_cfg),
            act_cfg=pick(dw_act_cfg, act_cfg))
        self.pointwise_conv = ConvModule(
            in_channels, out_channels, 1,
            norm_cfg=pick(pw_norm_cfg, norm_cfg),
            act_cfg=pick(pw_act_cfg, act_cfg))

    def forward(self, x):
        return self.pointwise_conv(self.depthwise_conv(x))
