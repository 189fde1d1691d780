"""Config-dispatched norm layers for NCHW maps (counterpart of
``segdistill_tpu/models/utils/norm.py``).

Statistics and the affine run in float32 and the output returns to the
input's dtype, as the JAX ``NormLayer`` does. BN and SyncBN are one
``BatchNorm2d`` here (one device): eval mode uses the running statistics,
train mode the batch's and updates the running ones in place. Torch, like
the reference, updates ``running_var`` with the unbiased batch variance;
flax uses the biased one, so after a train step the two differ by the
factor N/(N-1) on the batch term. Parameter and buffer names are torch's,
so the reference ``.pth`` layout (``linear_fuse.bn.running_mean``, ...)
holds.

:class:`FusedLayerNorm` is the token LayerNorm of the transformer
backbones, through the hand-written kernels of ``ops/layer_norm.py``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.layer_norm import fused_layer_norm


class BatchNorm2d(nn.BatchNorm2d):
    """In training, a batch of one value a channel (the 1x1 pyramid branch
    of a PSP head at batch 1) normalises to the bias and moves the running
    variance toward 0, as flax's BatchNorm does; torch's would raise, and
    its unbiased variance is undefined there."""

    def forward(self, x):
        if self.training and x.numel() == x.shape[1]:
            return self._single(x.float()).to(x.dtype)
        return super().forward(x.float()).to(x.dtype)

    def _single(self, x):
        dims = (0, 2, 3)
        mean = x.mean(dim=dims, keepdim=True)
        var = (x - mean).square().mean(dim=dims, keepdim=True)
        if self.track_running_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean.flatten())
                self.running_var.mul_(1 - m).add_(m * var.flatten())
                self.num_batches_tracked += 1
        y = (x - mean) * torch.rsqrt(var + self.eps)
        if self.affine:
            y = y * self.weight[:, None, None] + self.bias[:, None, None]
        return y


class GroupNorm(nn.GroupNorm):

    def forward(self, x):
        return super().forward(x.float()).to(x.dtype)


class FusedLayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis of (..., C) tokens through
    :func:`fused_layer_norm` (counterpart of the JAX ``FusedLayerNorm``): on
    a CUDA tensor K10, and K11 under autograd, with no gate on the width or
    the row count; on a CPU tensor the plain version. Statistics are
    float32 and the output has the input's dtype; ``weight`` and ``bias``
    stay float32 and are read as stored, under torch's parameter names, so
    the reference ``.pth`` layout holds."""

    def forward(self, x):
        return fused_layer_norm(x, self.weight, self.bias, self.eps)


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW map."""

    def forward(self, x):
        y = F.layer_norm(x.float().permute(0, 2, 3, 1), self.normalized_shape,
                         self.weight, self.bias, self.eps)
        return y.permute(0, 3, 1, 2).to(x.dtype)


class NormEvalModule(nn.Module):
    """A backbone whose ``norm_eval`` keeps every BN in eval mode while the
    rest trains (the reference backbones' ``train`` override)."""

    norm_eval = False

    def train(self, mode=True):
        super().train(mode)
        if mode and self.norm_eval:
            for m in self.modules():
                if isinstance(m, nn.modules.batchnorm._BatchNorm):
                    m.eval()
        return self


def build_norm_layer(norm_cfg, num_features):
    """-> (name, layer), as mmcv's ``build_norm_layer``: the name ('bn',
    'gn', 'ln') is the attribute the layer sits under in the reference."""
    cfg = dict(norm_cfg or dict(type='BN'))
    norm_type = cfg.pop('type')
    cfg.pop('requires_grad', None)
    eps = cfg.pop('eps', 1e-5)
    if norm_type in ('BN', 'SyncBN', 'BN2d'):
        return 'bn', BatchNorm2d(num_features, eps=eps,
                                 momentum=cfg.pop('momentum', 0.1))
    if norm_type == 'GN':
        return 'gn', GroupNorm(cfg.pop('num_groups'), num_features, eps=eps)
    if norm_type == 'LN':
        return 'ln', LayerNorm2d(num_features, eps=eps)
    raise KeyError(f'unsupported norm type {norm_type}')
