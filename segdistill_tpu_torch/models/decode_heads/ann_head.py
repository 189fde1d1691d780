"""ANNHead (counterpart of ``segdistill_tpu/models/decode_heads/
ann_head.py``; reference ``mmseg/models/decode_heads/ann_head.py``).

NCHW, the reference ``.pth`` layout. Two inputs (``multiple_select``: the
low and the high level). :class:`AFNB` (``fusion``): a
:class:`SelfAttentionBlock` from the high level to the low one
(``stages.0``: normed 1x1 key and query ConvModules, bare value and
output convs, the similarity scaled, the projected key and value pooled
to the ``key_pool_scales`` pyramid), then a 1x1 act-free ``bottleneck``
on cat[context, high]. The head's dropout, a 3x3 ``bottleneck``, then
:class:`APNB` (``context``): self attention with one key/query
projection, and a 1x1 ``bottleneck`` with its activation on cat[context,
feats]; then the classifier. A query scale other than 1 is refused, as
the JAX package refuses it.
"""

import torch
from torch import nn

from ..builder import HEADS
from ..utils import ConvModule, SelfAttentionBlock
from ..utils.conv_module import torch_default_
from .decode_head import BaseDecodeHead
from .psp_head import init_conv_modules


def _stages(query_scales, key_in, query_in, channels, out_channels, share,
            key_pool_scales, norm_cfg, act_cfg):
    if tuple(query_scales) != (1,):
        raise NotImplementedError(
            f'query_scales {tuple(query_scales)}: a query scale other than '
            f'1 is not ported (the JAX package refuses it too)')
    return nn.ModuleList([SelfAttentionBlock(
        key_in, query_in, channels, out_channels, share_key_query=share,
        key_query_num_convs=1, key_query_norm=True, value_out_num_convs=1,
        value_out_norm=False, matmul_norm=True, with_out=True,
        key_pool_scales=tuple(key_pool_scales), norm_cfg=norm_cfg,
        act_cfg=act_cfg)])


class AFNB(nn.Module):

    def __init__(self, low_in_channels, high_in_channels, channels,
                 out_channels, query_scales, key_pool_scales, conv_cfg=None,
                 norm_cfg=None, act_cfg='default'):
        super().__init__()
        self.stages = _stages(query_scales, low_in_channels,
                              high_in_channels, channels, out_channels, False,
                              key_pool_scales, norm_cfg, act_cfg)
        self.bottleneck = ConvModule(out_channels + high_in_channels,
                                     out_channels, 1, conv_cfg=conv_cfg,
                                     norm_cfg=norm_cfg, act_cfg=None)

    def forward(self, low, high):
        ctx = sum(stage(high, low) for stage in self.stages)
        return self.bottleneck(torch.cat([ctx, high], dim=1))


class APNB(nn.Module):

    def __init__(self, in_channels, channels, out_channels, query_scales,
                 key_pool_scales, conv_cfg=None, norm_cfg=None,
                 act_cfg='default'):
        super().__init__()
        self.stages = _stages(query_scales, in_channels, in_channels,
                              channels, out_channels, True, key_pool_scales,
                              norm_cfg, act_cfg)
        self.bottleneck = ConvModule(2 * in_channels, out_channels, 1,
                                     conv_cfg=conv_cfg, norm_cfg=norm_cfg,
                                     act_cfg=act_cfg)

    def forward(self, feats):
        ctx = sum(stage(feats, feats) for stage in self.stages)
        return self.bottleneck(torch.cat([ctx, feats], dim=1))


@HEADS.register_module()
class ANNHead(BaseDecodeHead):

    def __init__(self, project_channels, query_scales=(1,),
                 key_pool_scales=(1, 3, 6, 8), **kwargs):
        kwargs.setdefault('input_transform', 'multiple_select')
        super().__init__(**kwargs)
        if len(self.in_channels) != 2:
            raise ValueError('ANNHead takes two inputs (low, high)')
        low_in, high_in = self.in_channels
        cfg = dict(conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg,
                   act_cfg=self.act_cfg)
        self.fusion = AFNB(low_in, high_in, project_channels, high_in,
                           query_scales, key_pool_scales, **cfg)
        self.bottleneck = ConvModule(high_in, self.channels, 3, padding=1,
                                     **cfg)
        self.context = APNB(self.channels, project_channels, self.channels,
                            query_scales, key_pool_scales, **cfg)

    @torch.no_grad()
    def init_weights(self, generator):
        init_conv_modules(self, generator)
        for block in (self.fusion, self.context):
            for stage in block.stages:
                stage.init_weights(generator)
                # the reference's bare value projection: PyTorch's
                torch_default_(stage.value_project, generator)
        self.init_cls_seg(generator)

    def forward(self, inputs, generator=None):
        low, high = self._transform_inputs(inputs)
        out = self.fusion(low, high)
        if self.dropout is not None:
            out = self.dropout(out, generator)
        out = self.context(self.bottleneck(out))
        return self.cls_seg(out, generator)


__all__ = ['AFNB', 'ANNHead', 'APNB']
