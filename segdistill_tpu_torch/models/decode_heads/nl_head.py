"""NLHead, GCHead and DNLHead (counterpart of
``segdistill_tpu/models/decode_heads/nl_head.py``; reference
``mmseg/models/decode_heads/{nl_head,gc_head,dnl_head}.py`` with mmcv's
``NonLocal2d`` and ``ContextBlock``).

NCHW, the reference ``.pth`` layout. Each head is FCNHead(num_convs=2)
with its block between the two convs: ``convs.0`` -> block -> ``convs.1``
-> ``conv_cat`` on cat[x, out] -> classifier (ref nl_head.py:41-49); the
block sits at ``nl_block``, ``gc_block`` or ``dnl_block``.

:class:`NonLocal2d` (modes 'embedded_gaussian' and 'dot_product'): bare
1x1 projections ``g``, ``theta``, ``phi`` (ConvModules without norm or
activation), the pairwise weights over the flattened positions, and a
normed act-free ``conv_out`` added to the block's input. The similarity,
its softmax and the aggregation run in float32 (the JAX package's island)
and return the input's dtype; the similarity is scaled in place, so the
block holds two (B, N, N) float32 maps at most (4 GiB each at a 1024x2048
request's stride-8 map). :class:`DisentangledNonLocal2d` centres theta and
phi over the positions, divides the pairwise logits by the temperature
and adds the unary context (a softmax over the positions of a bare 1x1
``conv_mask``, pooling ``g``) before ``conv_out``; it takes the
'embedded_gaussian' mode alone. :class:`ContextBlock`: attention pooling
(``conv_mask``, a softmax over the positions, float32) or the average, then
``channel_mul_conv`` / ``channel_add_conv`` (Sequential conv, LayerNorm
over the [planes, 1, 1] context, ReLU, conv) fusion. Its LayerNorm's eps
is :data:`LN_EPS`, mmcv's 1e-5; the JAX package's flax LayerNorm has 1e-6,
which moves the logits visibly (ROADMAP, deliberate divergences).
"""

import torch
from torch import nn

from ..builder import HEADS
from ..utils import ConvModule
from ..utils.conv_module import Conv2d, he_normal_, torch_default_
from .fcn_head import FCNHead

# ContextBlock's LayerNorm eps: mmcv's nn.LayerNorm([planes, 1, 1]), read
# when a block is built
LN_EPS = 1e-5


class NonLocal2d(nn.Module):

    MODES = ('embedded_gaussian', 'dot_product')

    def __init__(self, in_channels, reduction=2, use_scale=True,
                 mode='embedded_gaussian', conv_cfg=None, norm_cfg=None):
        super().__init__()
        if mode not in self.MODES:
            raise ValueError(f'{type(self).__name__} takes mode '
                             f'{self.MODES}, not {mode!r}')
        self.inter_channels = max(in_channels // reduction, 1)
        self.use_scale = use_scale
        self.mode = mode
        inter = self.inter_channels
        for name in ('g', 'theta', 'phi'):
            self.add_module(name, ConvModule(in_channels, inter, 1,
                                             conv_cfg=conv_cfg, act_cfg=None))
        self.conv_out = ConvModule(inter, in_channels, 1, conv_cfg=conv_cfg,
                                   norm_cfg=norm_cfg, act_cfg=None)

    @torch.no_grad()
    def init_weights(self, generator):
        """mmcv's: the projections N(0, 0.01), zero biases, and
        ``conv_out``'s norm (its conv without one) zero, so the block
        starts as the identity."""
        for m in (self.g, self.theta, self.phi):
            m.conv.weight.normal_(0, 0.01, generator=generator)
            nn.init.zeros_(m.conv.bias)
        he_normal_(self.conv_out.conv, generator)
        last = self.conv_out.norm if self.conv_out.with_norm \
            else self.conv_out.conv
        nn.init.zeros_(last.weight)
        nn.init.zeros_(last.bias)

    def _projections(self, x):
        """-> g (B, N, C'), theta (B, N, C'), phi (B, C', N)."""
        return (self.g(x).flatten(2).transpose(1, 2),
                self.theta(x).flatten(2).transpose(1, 2),
                self.phi(x).flatten(2))

    def _pairwise(self, theta, phi):
        sim = torch.matmul(theta.float(), phi.float())
        if self.mode == 'dot_product':
            return sim.div_(sim.shape[-1])
        if self.use_scale:
            sim.div_(self.inter_channels ** 0.5)
        return sim.softmax(dim=-1)

    def _out(self, x, y):
        """x + conv_out(y), y (B, N, C') in float32."""
        b, _, h, w = x.shape
        y = y.to(x.dtype).transpose(1, 2).reshape(b, -1, h, w)
        return x + self.conv_out(y)

    def forward(self, x):
        g, theta, phi = self._projections(x)
        return self._out(x, torch.matmul(self._pairwise(theta, phi),
                                         g.float()))


class DisentangledNonLocal2d(NonLocal2d):

    MODES = ('embedded_gaussian',)

    def __init__(self, in_channels, temperature=0.05, **kwargs):
        super().__init__(in_channels, **kwargs)
        self.temperature = temperature
        self.conv_mask = Conv2d(in_channels, 1, 1)

    @torch.no_grad()
    def init_weights(self, generator):
        super().init_weights(generator)
        torch_default_(self.conv_mask, generator)

    def forward(self, x):
        g, theta, phi = self._projections(x)
        theta = theta - theta.mean(dim=1, keepdim=True)
        phi = phi - phi.mean(dim=2, keepdim=True)
        sim = torch.matmul(theta.float(), phi.float())
        if self.use_scale:
            sim.div_(self.inter_channels ** 0.5)
        y = torch.matmul(sim.div_(self.temperature).softmax(dim=-1),
                         g.float())
        unary = self.conv_mask(x).flatten(2).float().softmax(dim=-1)
        return self._out(x, y + torch.matmul(unary, g.float()))


class _LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` in float32, returning the input's dtype."""

    def forward(self, x):
        return super().forward(x.float()).to(x.dtype)


class ContextBlock(nn.Module):

    def __init__(self, in_channels, ratio=0.25, pooling_type='att',
                 fusion_types=('channel_add',)):
        super().__init__()
        if pooling_type not in ('att', 'avg'):
            raise ValueError(f'pooling_type {pooling_type!r}')
        if not fusion_types or not set(fusion_types) <= {'channel_add',
                                                         'channel_mul'}:
            raise ValueError(f'fusion_types {fusion_types!r}')
        planes = max(int(in_channels * ratio), 1)
        self.conv_mask = Conv2d(in_channels, 1, 1) \
            if pooling_type == 'att' else None

        def transform():
            return nn.Sequential(Conv2d(in_channels, planes, 1),
                                 _LayerNorm([planes, 1, 1], eps=LN_EPS),
                                 nn.ReLU(),
                                 Conv2d(planes, in_channels, 1))
        self.channel_add_conv = transform() \
            if 'channel_add' in fusion_types else None
        self.channel_mul_conv = transform() \
            if 'channel_mul' in fusion_types else None

    @torch.no_grad()
    def init_weights(self, generator):
        """mmcv's: ``conv_mask`` He-normal over its fan-in, each transform's
        first conv as PyTorch initialises it, a unit LayerNorm, and its
        last conv zero."""
        if self.conv_mask is not None:
            w = self.conv_mask.weight
            w.normal_(0, (2.0 / w[0].numel()) ** 0.5, generator=generator)
            nn.init.zeros_(self.conv_mask.bias)
        for t in (self.channel_add_conv, self.channel_mul_conv):
            if t is not None:
                torch_default_(t[0], generator)
                nn.init.ones_(t[1].weight)
                nn.init.zeros_(t[1].bias)
                nn.init.zeros_(t[-1].weight)
                nn.init.zeros_(t[-1].bias)

    def _context(self, x):
        if self.conv_mask is None:
            return x.mean(dim=(2, 3), keepdim=True)
        b, c = x.shape[:2]
        mask = self.conv_mask(x).flatten(2).float().softmax(dim=-1)
        ctx = torch.matmul(x.flatten(2).float(), mask.transpose(1, 2))
        return ctx.view(b, c, 1, 1).to(x.dtype)

    def forward(self, x):
        ctx = self._context(x)
        out = x
        if self.channel_mul_conv is not None:
            out = out * torch.sigmoid(self.channel_mul_conv(ctx))
        if self.channel_add_conv is not None:
            out = out + self.channel_add_conv(ctx)
        return out


class FCNBlockHead(FCNHead):
    """FCNHead(num_convs=2) with a block between its two convs, held under
    ``BLOCK`` (the NL, GC, DNL and CC heads)."""

    BLOCK = None

    def __init__(self, **kwargs):
        super().__init__(num_convs=2, **kwargs)

    @property
    def block(self):
        return getattr(self, self.BLOCK)

    @torch.no_grad()
    def init_weights(self, generator):
        super().init_weights(generator)
        self.block.init_weights(generator)

    def _block(self, x):
        return self.block(x)

    def forward(self, inputs, generator=None):
        x = self._transform_inputs(inputs)
        out = self.convs[1](self._block(self.convs[0](x)))
        if self.conv_cat is not None:
            out = self.conv_cat(torch.cat([x, out], dim=1))
        return self.cls_seg(out, generator)


@HEADS.register_module()
class NLHead(FCNBlockHead):

    BLOCK = 'nl_block'

    def __init__(self, reduction=2, use_scale=True, mode='embedded_gaussian',
                 **kwargs):
        super().__init__(**kwargs)
        self.nl_block = NonLocal2d(self.channels, reduction, use_scale, mode,
                                   conv_cfg=self.conv_cfg,
                                   norm_cfg=self.norm_cfg)


@HEADS.register_module()
class GCHead(FCNBlockHead):

    BLOCK = 'gc_block'

    def __init__(self, ratio=0.25, pooling_type='att',
                 fusion_types=('channel_add',), **kwargs):
        super().__init__(**kwargs)
        self.gc_block = ContextBlock(self.channels, ratio, pooling_type,
                                     tuple(fusion_types))


@HEADS.register_module()
class DNLHead(FCNBlockHead):

    BLOCK = 'dnl_block'

    def __init__(self, reduction=2, use_scale=True, mode='embedded_gaussian',
                 temperature=0.05, **kwargs):
        super().__init__(**kwargs)
        self.dnl_block = DisentangledNonLocal2d(
            self.channels, temperature, reduction=reduction,
            use_scale=use_scale, mode=mode, conv_cfg=self.conv_cfg,
            norm_cfg=self.norm_cfg)


__all__ = ['ContextBlock', 'DisentangledNonLocal2d', 'DNLHead',
           'FCNBlockHead', 'GCHead', 'NLHead', 'NonLocal2d']
