"""SegFormer all-MLP decode head (counterpart of
``segdistill_tpu/models/decode_heads/segformer_head.py``; reference
``mmseg/models/decode_heads/segformer_head.py:37-98``).

The reference computes ``linear_fuse(concat[resize_1/4(linear_cX(c_X))])``.
As in the JAX head, the per-stage embedding and that stage's slice of the
1x1 fuse conv are both pointwise channel mixes, and bilinear resize is
linear per channel, so they commute: each stage runs ONE composed GEMM
``c_X @ (E_X @ W_X) + b_X @ W_X`` at its own resolution, and the
sub-resolution results are upsampled and summed in one pass by
:func:`fused_resize_sum` (kernel K1 on CUDA). BN (eval, unfolded) and ReLU
follow; in training BN normalises with the batch statistics and updates
its running ones in place (never folded). The parameter layout is the
reference's (``linear_cX.proj``, ``linear_fuse.conv`` without bias,
``linear_fuse.bn``, ``linear_pred``); the classifier output is the
``decode_head.linear_pred`` tap.

The loss is the reference's override, CE with ``reduction='none'``, whose
mean in ``parse_losses`` is the mean over all pixels (ref :45-50).
"""

import torch
from torch import nn

from ...ops.resize_sum import fused_resize_sum
from ..builder import HEADS
from ..utils import ConvModule
from .decode_head import BaseDecodeHead


class MLP(nn.Module):
    """Linear embedding (ref segformer_head.py:21-31)."""

    def __init__(self, input_dim, embed_dim):
        super().__init__()
        self.proj = nn.Linear(input_dim, embed_dim)


@HEADS.register_module()
class SegFormerHead(BaseDecodeHead):
    CLS_LAYER = 'linear_pred'
    DEFAULT_LOSS = dict(type='CrossEntropyLoss', use_sigmoid=False,
                        loss_weight=1.0, reduction='none')

    def __init__(self, feature_strides=(4, 8, 16, 32), **kwargs):
        del feature_strides  # the maps' own sizes say the same
        kwargs.setdefault('input_transform', 'multiple_select')  # ref :43
        super().__init__(**kwargs)
        embed_dim = (self.decoder_params or {}).get('embed_dim', 256)
        self.embed_dim = embed_dim
        c1, c2, c3, c4 = self.in_channels
        self.linear_c4 = MLP(c4, embed_dim)
        self.linear_c3 = MLP(c3, embed_dim)
        self.linear_c2 = MLP(c2, embed_dim)
        self.linear_c1 = MLP(c1, embed_dim)
        # ConvModule(4E, E, 1): bias-free ``conv`` + norm; the ReLU runs
        # after the stage sum (forward)
        self.linear_fuse = ConvModule(4 * embed_dim, embed_dim, 1,
                                      norm_cfg=self.norm_cfg
                                      or dict(type='SyncBN'), act_cfg=None)
        self.linear_pred = nn.Conv2d(embed_dim, self.num_classes, 1)

    @torch.no_grad()
    def init_weights(self, generator):
        """trunc-normal embeddings, He-normal fuse conv, N(0, 0.01)
        classifier (the JAX head's initialisers), unit BN."""
        for mlp in (self.linear_c1, self.linear_c2, self.linear_c3,
                    self.linear_c4):
            nn.init.trunc_normal_(mlp.proj.weight, std=0.02,
                                  generator=generator)
            nn.init.zeros_(mlp.proj.bias)
        fan_in = self.linear_fuse.conv.weight.shape[1]
        self.linear_fuse.conv.weight.normal_(0, fan_in ** -0.5,
                                             generator=generator)
        norm = self.linear_fuse.norm
        nn.init.ones_(norm.weight)
        nn.init.zeros_(norm.bias)
        self.linear_pred.weight.normal_(0, 0.01, generator=generator)
        nn.init.zeros_(self.linear_pred.bias)

    def _loss_cfg(self):
        return dict(self.DEFAULT_LOSS)  # the override wins (ref :50)

    def forward(self, inputs, generator=None):
        c1, c2, c3, c4 = self._transform_inputs(inputs)
        E = self.embed_dim
        out_hw = tuple(c1.shape[2:])
        fuse_w = self.linear_fuse.conv.weight[:, :, 0, 0].float()  # (E, 4E)
        acc = None
        ups = []
        for idx, (c, mlp) in enumerate(((c4, self.linear_c4),
                                        (c3, self.linear_c3),
                                        (c2, self.linear_c2),
                                        (c1, self.linear_c1))):
            w_x = fuse_w[:, idx * E:(idx + 1) * E].t()           # (E, E)
            k = mlp.proj.weight.float().t() @ w_x                # (C_x, E)
            cb = mlp.proj.bias.float() @ w_x                     # (E,)
            nhwc = c.permute(0, 2, 3, 1)
            part = torch.matmul(nhwc, k.to(c.dtype)) + cb.to(c.dtype)
            if tuple(c.shape[2:]) != out_hw:
                ups.append(part.contiguous())
            else:
                acc = part if acc is None else acc + part
        if ups:
            s = fused_resize_sum(ups, out_hw)
            acc = s if acc is None else acc + s
        x = self.linear_fuse.norm(acc.permute(0, 3, 1, 2)).relu()
        return self.cls_seg(x, generator)
