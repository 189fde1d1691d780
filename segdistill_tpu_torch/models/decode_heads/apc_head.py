"""APCHead and DMHead (counterpart of
``segdistill_tpu/models/decode_heads/apc_head.py``; reference
``mmseg/models/decode_heads/{apc_head,dm_head}.py``).

NCHW, the reference ``.pth`` layout. APCHead: one :class:`ACM` a pool
scale (``acm_modules.{i}``): the input pooled to s x s (``pooled_redu_conv``)
and reduced (``input_redu_conv``), a sigmoid affinity of each position to
the s^2 pooled vectors from a bare 1x1 ``gla`` over the reduced input
plus its global average (``global_info``), the affinity-weighted sum of
the pooled vectors (float32) through ``residual_conv`` added to the
reduced input, and with ``fusion`` a ``fusion_conv``. DMHead: one
:class:`DCM` a filter size (``dcm_modules.{i}``): a bare 1x1
``filter_gen_conv`` makes each image its own s x s depthwise filters from
the input pooled to s x s; the reduced input is correlated with them (one
grouped conv over (1, B * C, H, W), padded (p + 1, p) where s - 1 is odd),
then ``norm``, the activation and with ``fusion`` a ``fusion_conv``. Both
heads concatenate the input with every module's output into
``bottleneck``. The adaptive pools are ``F.adaptive_avg_pool2d``'s
floor/ceil bins in float32, as the JAX package's averaging matrices.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..builder import HEADS
from ..utils import ConvModule, build_activation, build_norm_layer
from ..utils.conv_module import Conv2d
from .da_head import init_bare
from .decode_head import BaseDecodeHead
from .psp_head import AdaptiveAvgPool2d


class ACM(nn.Module):

    def __init__(self, pool_scale, fusion, in_channels, channels,
                 conv_cfg=None, norm_cfg=None, act_cfg='default'):
        super().__init__()
        self.pool_scale = pool_scale
        conv = dict(conv_cfg=conv_cfg, norm_cfg=norm_cfg, act_cfg=act_cfg)
        self.pool = AdaptiveAvgPool2d(pool_scale)
        self.pooled_redu_conv = ConvModule(in_channels, channels, 1, **conv)
        self.input_redu_conv = ConvModule(in_channels, channels, 1, **conv)
        self.global_info = ConvModule(channels, channels, 1, **conv)
        self.gla = Conv2d(channels, pool_scale ** 2, 1)
        self.residual_conv = ConvModule(channels, channels, 1, **conv)
        self.fusion_conv = ConvModule(channels, channels, 1, **conv) \
            if fusion else None

    def forward(self, x):
        pooled = self.pooled_redu_conv(self.pool(x))  # (B, C, s, s)
        xr = self.input_redu_conv(x)
        b, c, h, w = xr.shape
        gi = self.global_info(xr.mean(dim=(2, 3), keepdim=True))
        affinity = torch.sigmoid(
            self.gla(xr + gi).flatten(2).transpose(1, 2).float())
        z = torch.matmul(affinity, pooled.flatten(2).transpose(1, 2).float())
        z = z.transpose(1, 2).reshape(b, c, h, w).to(x.dtype)
        z = F.relu(self.residual_conv(z) + xr)
        return z if self.fusion_conv is None else self.fusion_conv(z)


class DCM(nn.Module):

    def __init__(self, filter_size, fusion, in_channels, channels,
                 conv_cfg=None, norm_cfg=None, act_cfg='default'):
        super().__init__()
        self.filter_size = filter_size
        conv = dict(conv_cfg=conv_cfg, norm_cfg=norm_cfg, act_cfg=act_cfg)
        self.pool = AdaptiveAvgPool2d(filter_size)
        self.filter_gen_conv = Conv2d(in_channels, channels, 1)
        self.input_redu_conv = ConvModule(in_channels, channels, 1, **conv)
        self.norm = build_norm_layer(norm_cfg, channels)[1] \
            if norm_cfg is not None else None
        self.activate = build_activation(
            dict(type='ReLU') if act_cfg == 'default' else act_cfg, channels)
        self.fusion_conv = ConvModule(channels, channels, 1, **conv) \
            if fusion else None

    def forward(self, x):
        s = self.filter_size
        filters = self.filter_gen_conv(self.pool(x))  # (B, C, s, s)
        feat = self.input_redu_conv(x)
        b, c, h, w = feat.shape
        pad = (s - 1) // 2
        lo = pad if (s - 1) % 2 == 0 else pad + 1
        feat = F.pad(feat, (lo, pad, lo, pad)).reshape(1, b * c, h + lo + pad,
                                                       w + lo + pad)
        out = F.conv2d(feat, filters.reshape(b * c, 1, s, s),
                       groups=b * c).view(b, c, h, w)
        if self.norm is not None:
            out = self.norm(out)
        out = self.activate(out)
        return out if self.fusion_conv is None else self.fusion_conv(out)


class _PyramidHead(BaseDecodeHead):
    """The input concatenated with one module's output a scale, into a 3x3
    ``bottleneck``, then the classifier."""

    def _build(self, modules):
        self.bottleneck = ConvModule(
            self.in_channels + len(modules) * self.channels, self.channels,
            3, padding=1, conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg,
            act_cfg=self.act_cfg)
        return nn.ModuleList(modules)

    def _branches(self):
        raise NotImplementedError

    @torch.no_grad()
    def init_weights(self, generator):
        init_bare(self, generator)
        for m in self.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        self.init_cls_seg(generator)

    def forward(self, inputs, generator=None):
        x = self._transform_inputs(inputs)
        branches = [m(x) for m in self._branches()]
        out = self.bottleneck(torch.cat([x] + branches, dim=1))
        return self.cls_seg(out, generator)


@HEADS.register_module()
class APCHead(_PyramidHead):

    def __init__(self, pool_scales=(1, 2, 3, 6), fusion=True, **kwargs):
        super().__init__(**kwargs)
        self.acm_modules = self._build([
            ACM(s, fusion, self.in_channels, self.channels, self.conv_cfg,
                self.norm_cfg, self.act_cfg) for s in pool_scales])

    def _branches(self):
        return self.acm_modules


@HEADS.register_module()
class DMHead(_PyramidHead):

    def __init__(self, filter_sizes=(1, 3, 5, 7), fusion=False, **kwargs):
        super().__init__(**kwargs)
        self.dcm_modules = self._build([
            DCM(s, fusion, self.in_channels, self.channels, self.conv_cfg,
                self.norm_cfg, self.act_cfg) for s in filter_sizes])

    def _branches(self):
        return self.dcm_modules


__all__ = ['ACM', 'APCHead', 'DCM', 'DMHead']
