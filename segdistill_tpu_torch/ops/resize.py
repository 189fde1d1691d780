"""``resize``: the model's interpolation, as torch ``F.interpolate``.

Counterpart of ``segdistill_tpu/ops/resize.py::resize`` (which rebuilds
``F.interpolate`` from interpolation matrices for the TPU). Layout is NCHW,
or ``(B, H, W)`` for maps without channels. Bilinear and nearest, no
antialiasing, with the ``align_corners`` contract of ``F.interpolate``.
:class:`Upsample` is the module form (counterpart of
``segdistill_tpu/ops/wrappers.py::Upsample``).
"""

import math

import torch.nn.functional as F
from torch import nn


def out_size(hw, size=None, scale_factor=None):
    if size is not None:
        if isinstance(size, int):
            return (size, size)
        return tuple(int(s) for s in size)
    if scale_factor is None:
        raise ValueError('either size or scale_factor must be given')
    if isinstance(scale_factor, (int, float)):
        scale_factor = (scale_factor, scale_factor)
    # torch floors the scaled size; the taps then follow in/out as for size
    return tuple(int(math.floor(s * f)) for s, f in zip(hw, scale_factor))


def resize(x, size=None, scale_factor=None, mode='bilinear',
           align_corners=False, warning=False):
    """Resize an NCHW (or ``(B, H, W)``) tensor."""
    del warning
    squeeze = x.ndim == 3
    if squeeze:
        x = x.unsqueeze(1)
    if x.ndim != 4:
        raise ValueError(f'expected a 4D NCHW input, got shape '
                         f'{tuple(x.shape)}')
    hw = out_size(x.shape[2:], size, scale_factor)
    if mode == 'nearest':
        if align_corners:
            raise ValueError('align_corners not supported for nearest')
        out = F.interpolate(x, size=hw, mode='nearest')
    elif mode in ('bilinear', 'linear'):
        out = F.interpolate(x, size=hw, mode='bilinear',
                            align_corners=bool(align_corners))
    else:
        raise ValueError(f'unsupported resize mode: {mode}')
    return out.squeeze(1) if squeeze else out


class Upsample(nn.Module):
    """:func:`resize` as a parameter-free module (the reference's
    ``mmseg.ops.Upsample``, a slot of FPNHead's scale heads)."""

    def __init__(self, size=None, scale_factor=None, mode='nearest',
                 align_corners=False):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners

    def forward(self, x):
        return resize(x, self.size, self.scale_factor, self.mode,
                      self.align_corners)
