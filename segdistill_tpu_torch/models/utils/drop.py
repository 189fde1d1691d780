"""Stochastic depth and dropout drawing from an explicit ``torch.Generator``
(counterpart of ``segdistill_tpu/models/utils/drop.py``, whose masks come
from the 'dropout' PRNG stream the train step threads through; the
reference uses timm's DropPath and torch's global RNG).

In training mode with a non-zero rate the masks are drawn from the
``generator`` passed to ``forward``, which must be on the input's device;
without one they raise. In eval mode, or at rate 0, they are the identity.
"""

import torch
from torch import nn


def _drop(x, p, shape, generator):
    if generator is None:
        raise ValueError('dropout in training mode draws from an explicit '
                         'torch.Generator; pass generator=...')
    keep = 1.0 - p
    mask = torch.empty(shape, dtype=x.dtype, device=x.device)
    return x * mask.bernoulli_(keep, generator=generator) / keep


class DropPath(nn.Module):
    """Drops whole samples of a residual branch."""

    def __init__(self, drop_prob=0.0):
        super().__init__()
        self.drop_prob = float(drop_prob)

    def forward(self, x, generator=None):
        if self.drop_prob == 0.0 or not self.training:
            return x
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        return _drop(x, self.drop_prob, shape, generator)


class Dropout(nn.Module):
    """``nn.Dropout``, or with ``channels=True`` ``nn.Dropout2d`` (whole
    channels of an NCHW map)."""

    def __init__(self, p=0.0, channels=False):
        super().__init__()
        self.p = float(p)
        self.channels = channels

    def forward(self, x, generator=None):
        if self.p == 0.0 or not self.training:
            return x
        shape = tuple(x.shape[:2]) + (1,) * (x.ndim - 2) if self.channels \
            else x.shape
        return _drop(x, self.p, shape, generator)
