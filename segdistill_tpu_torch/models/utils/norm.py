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
"""

import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):

    def forward(self, x):
        return super().forward(x.float()).to(x.dtype)


class GroupNorm(nn.GroupNorm):

    def forward(self, x):
        return super().forward(x.float()).to(x.dtype)


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW map."""

    def forward(self, x):
        y = F.layer_norm(x.float().permute(0, 2, 3, 1), self.normalized_shape,
                         self.weight, self.bias, self.eps)
        return y.permute(0, 3, 1, 2).to(x.dtype)


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
