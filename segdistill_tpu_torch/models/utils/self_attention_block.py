"""The general self-attention block (counterpart of
``segdistill_tpu/models/utils/self_attention_block.py``; reference
``mmseg/models/utils/self_attention_block.py``), the core of the OCR head
and, later, of the NL and ANN heads.

NCHW. Query, key and value projections of 1x1 convs (``*_project``: with
``key_query_norm`` / ``value_out_norm`` ConvModules with norm and
activation, otherwise bare biased convs; a Sequential where there are
several, the reference ``.pth`` layout), attention over the flattened
positions with the similarity scaled by ``channels ** -0.5`` where
``matmul_norm``, and with ``with_out`` an output projection, which is zero
at initialisation where it is bare (the attention starts as nothing).
``share_key_query`` runs the key projection on both inputs (the state
holds ``key_project`` alone, as the JAX package's does; the reference
``.pth`` also repeats it under ``query_project``). ``key_pool_scales``
(ANN) pools the projected key and value to those pyramid sizes and
attends over the pooled positions. The similarity, its softmax and the
weighted sum run in float32 and the result returns to the query's dtype.
The reference's query and key downsampling is not ported: the JAX package
ignores it.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .conv_module import Conv2d, ConvModule, he_normal_


def _project(in_channels, channels, num_convs, use_norm, norm_cfg, act_cfg):
    if use_norm:
        convs = [ConvModule(in_channels if i == 0 else channels, channels, 1,
                            norm_cfg=norm_cfg, act_cfg=act_cfg)
                 for i in range(num_convs)]
    else:
        convs = [Conv2d(in_channels if i == 0 else channels, channels, 1)
                 for i in range(num_convs)]
    return nn.Sequential(*convs) if len(convs) > 1 else convs[0]


class SelfAttentionBlock(nn.Module):

    def __init__(self, key_in_channels, query_in_channels, channels,
                 out_channels, share_key_query=False, query_downsample=None,
                 key_downsample=None, key_query_num_convs=1,
                 value_out_num_convs=1, key_query_norm=False,
                 value_out_norm=False, matmul_norm=True, with_out=True,
                 key_pool_scales=None, norm_cfg=None, act_cfg=None):
        super().__init__()
        if query_downsample not in (None, 1) \
                or key_downsample not in (None, 1):
            raise NotImplementedError('query/key downsampling is not ported')
        if share_key_query and key_in_channels != query_in_channels:
            raise ValueError('a shared key/query projection needs one input '
                             'width')
        self.channels = channels
        self.matmul_norm = matmul_norm
        self.share_key_query = share_key_query
        self.key_pool_scales = key_pool_scales
        self.value_out_norm = value_out_norm
        self.key_project = _project(key_in_channels, channels,
                                    key_query_num_convs, key_query_norm,
                                    norm_cfg, act_cfg)
        self.query_project = None if share_key_query else _project(
            query_in_channels, channels, key_query_num_convs, key_query_norm,
            norm_cfg, act_cfg)
        self.value_project = _project(
            key_in_channels, channels if with_out else out_channels,
            value_out_num_convs, value_out_norm, norm_cfg, act_cfg)
        self.out_project = _project(
            channels, out_channels, value_out_num_convs, value_out_norm,
            norm_cfg, act_cfg) if with_out else None

    @torch.no_grad()
    def init_weights(self, generator):
        """ConvModules as mmcv initialises them, bare convs He-normal
        (fan_out) with zero bias; a bare output projection zero."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                he_normal_(m, generator)
        for m in self.modules():
            if isinstance(m, ConvModule):
                m.init_weights(generator)
        if self.out_project is not None and not self.value_out_norm:
            for m in self.out_project.modules():
                if isinstance(m, nn.Conv2d):
                    nn.init.zeros_(m.weight)
                    nn.init.zeros_(m.bias)

    def _pyramid(self, x):
        """(B, C, H, W) -> (B, C, sum of scale^2, 1): each pyramid size's
        average pool, flattened and concatenated."""
        return torch.cat([F.adaptive_avg_pool2d(x.float(), s).to(x.dtype)
                          .flatten(2) for s in self.key_pool_scales],
                         dim=2)[..., None]

    def forward(self, query_feats, key_feats):
        query_project = self.key_project if self.share_key_query \
            else self.query_project
        q = query_project(query_feats)
        k = self.key_project(key_feats)
        v = self.value_project(key_feats)
        if self.key_pool_scales is not None:
            k, v = self._pyramid(k), self._pyramid(v)
        b, _, hq, wq = q.shape
        sim = torch.matmul(q.flatten(2).transpose(1, 2).float(),
                           k.flatten(2).float())
        if self.matmul_norm:
            sim = sim * self.channels ** -0.5
        sim = sim.softmax(dim=-1)
        ctx = torch.matmul(sim, v.flatten(2).transpose(1, 2).float())
        ctx = ctx.to(query_feats.dtype).transpose(1, 2).reshape(b, -1, hq,
                                                                 wq)
        return ctx if self.out_project is None else self.out_project(ctx)
