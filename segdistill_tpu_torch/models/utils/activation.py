"""Activations by mmcv-style ``act_cfg`` (counterpart of
``segdistill_tpu/models/utils/activation.py``; reference mmcv 1.2.2's
``build_activation_layer``).

Each activation is a module that computes in its input's dtype. HSigmoid
takes mmcv 1.2.2's defaults, ``clamp((x + 1) / 2, 0, 1)``; ``SELayer``
passes ``bias=3, divisor=6``. GELU is the exact (erf) form, as torch's
``nn.GELU``. PReLU keeps one learnable slope a channel (``weight``, dim 1 of
an NCHW map), initialised to ``init``.
"""

import torch
import torch.nn.functional as F
from torch import nn


class _Fn(nn.Module):
    """A parameter-free activation."""

    def __init__(self, fn, name):
        super().__init__()
        self.fn = fn
        self.name = name

    def forward(self, x):
        return self.fn(x)

    def extra_repr(self):
        return self.name


class HSigmoid(nn.Module):
    """``clamp((x + bias) / divisor, 0, 1)`` (mmcv 1.2.2)."""

    def __init__(self, bias=1.0, divisor=2.0):
        super().__init__()
        self.bias = bias
        self.divisor = divisor

    def forward(self, x):
        return ((x + self.bias) / self.divisor).clamp(0.0, 1.0)

    def extra_repr(self):
        return f'bias={self.bias}, divisor={self.divisor}'


class PReLU(nn.Module):
    """A learnable leaky slope a channel (torch ``nn.PReLU``), stored as
    ``weight`` (C,) in float32 and applied in the input's dtype."""

    def __init__(self, channels, init=0.25):
        super().__init__()
        self.init = init
        self.weight = nn.Parameter(torch.full((channels,), float(init)))

    def forward(self, x):
        w = self.weight.to(x.dtype).view(1, -1, *([1] * (x.ndim - 2)))
        return torch.where(x >= 0, x, w * x)


def build_activation(act_cfg, channels=None):
    """-> the module for ``act_cfg`` (``None``: the identity). PReLU needs
    ``channels``."""
    if act_cfg is None:
        return nn.Identity()
    cfg = dict(act_cfg)
    act_type = cfg.pop('type')
    cfg.pop('inplace', None)
    if act_type == 'ReLU':
        return _Fn(F.relu, 'ReLU')
    if act_type == 'ReLU6':
        return _Fn(F.relu6, 'ReLU6')
    if act_type == 'GELU':
        return _Fn(F.gelu, 'GELU')
    if act_type == 'LeakyReLU':
        slope = cfg.pop('negative_slope', 0.01)
        return _Fn(lambda x: F.leaky_relu(x, slope),
                   f'LeakyReLU({slope})')
    if act_type == 'Sigmoid':
        return _Fn(torch.sigmoid, 'Sigmoid')
    if act_type == 'HSigmoid':
        return HSigmoid(cfg.pop('bias', 1.0), cfg.pop('divisor', 2.0))
    if act_type in ('HSwish', 'Hardswish'):
        return _Fn(F.hardswish, 'HSwish')
    if act_type == 'Swish':
        return _Fn(F.silu, 'Swish')
    if act_type == 'Tanh':
        return _Fn(torch.tanh, 'Tanh')
    if act_type == 'PReLU':
        if channels is None:
            raise ValueError('PReLU needs the channel count')
        return PReLU(channels, cfg.pop('init', 0.25))
    raise KeyError(f'unsupported activation type {act_type}')
