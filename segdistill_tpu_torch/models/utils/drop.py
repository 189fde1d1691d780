"""Stochastic depth (counterpart of ``segdistill_tpu/models/utils/drop.py``;
the reference uses timm's DropPath)."""

import torch
from torch import nn


class DropPath(nn.Module):
    """Drops whole samples of a residual branch in training; identity in
    eval or at ``drop_prob == 0``."""

    def __init__(self, drop_prob=0.0):
        super().__init__()
        self.drop_prob = float(drop_prob)

    def forward(self, x):
        if self.drop_prob == 0.0 or not self.training:
            return x
        keep = 1.0 - self.drop_prob
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.empty(shape, dtype=x.dtype, device=x.device)
        return x * mask.bernoulli_(keep) / keep
