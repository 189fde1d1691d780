"""The cascade heads' base and OCRHead (counterpart of
``segdistill_tpu/models/decode_heads/ocr_head.py``; reference
``mmseg/models/decode_heads/ocr_head.py`` and ``cascade_decode_head.py``).

OCRHead, NCHW, the reference ``.pth`` layout: a 3x3 ConvModule
(``bottleneck``) gives the pixel features; the previous stage's logits,
softmaxed over the pixels of each class (times ``scale``), weigh them into
one context vector a class (the spatial gather, in float32: softmax and
weighted sum, returned in the features' dtype); the object attention
block (``object_context_block``: a :class:`SelfAttentionBlock` from the
pixels to the class contexts, two normed 1x1 ConvModules a key and query
projection, ``ocr_channels`` wide, one for the value and the output) and
its ``bottleneck`` (1x1 ConvModule over the attention's output
concatenated with the features), then the classifier.
"""

import torch
from torch import nn

from ..builder import HEADS
from ..utils import ConvModule
from ..utils.self_attention_block import SelfAttentionBlock
from .decode_head import BaseDecodeHead
from .psp_head import init_conv_modules


class BaseCascadeDecodeHead(BaseDecodeHead):
    """A head that also takes the previous stage's logits:
    ``forward(inputs, prev_output, generator=None, points=None)``, where
    ``points`` (a point head's) overrides the head's own draw of its
    training points."""


class ObjectAttentionBlock(SelfAttentionBlock):
    """The pixels attend to the class contexts; the result, concatenated
    with the pixels, goes through a 1x1 ConvModule (``bottleneck``)."""

    def __init__(self, in_channels, channels, norm_cfg, act_cfg):
        super().__init__(
            in_channels, in_channels, channels, in_channels,
            key_query_num_convs=2, key_query_norm=True,
            value_out_num_convs=1, value_out_norm=True, matmul_norm=True,
            with_out=True, norm_cfg=norm_cfg, act_cfg=act_cfg)
        self.bottleneck = ConvModule(in_channels * 2, in_channels, 1,
                                     norm_cfg=norm_cfg, act_cfg=act_cfg)

    def forward(self, query_feats, key_feats):
        context = super().forward(query_feats, key_feats)
        return self.bottleneck(torch.cat([context, query_feats], dim=1))


@HEADS.register_module()
class OCRHead(BaseCascadeDecodeHead):

    def __init__(self, ocr_channels, scale=1, **kwargs):
        super().__init__(**kwargs)
        self.scale = scale
        self.bottleneck = ConvModule(self.in_channels, self.channels, 3,
                                     padding=1, norm_cfg=self.norm_cfg,
                                     act_cfg=self.act_cfg)
        self.object_context_block = ObjectAttentionBlock(
            self.channels, ocr_channels, self.norm_cfg, self.act_cfg)

    @torch.no_grad()
    def init_weights(self, generator):
        init_conv_modules(self, generator)
        self.init_cls_seg(generator)

    def spatial_gather(self, feats, prev_output):
        """(B, C, H, W) features, (B, K, H, W) logits -> (B, C, 1, K): each
        class's softmax over the pixels weighing the features, in
        float32."""
        probs = (self.scale * prev_output.flatten(2).float()).softmax(dim=2)
        ctx = torch.matmul(probs, feats.flatten(2).transpose(1, 2).float())
        return ctx.transpose(1, 2).unsqueeze(2).to(feats.dtype)

    def forward(self, inputs, prev_output, generator=None, points=None):
        del points  # no training points
        feats = self.bottleneck(self._transform_inputs(inputs))
        out = self.object_context_block(
            feats, self.spatial_gather(feats, prev_output))
        return self.cls_seg(out, generator)
