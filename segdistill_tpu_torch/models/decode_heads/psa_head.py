"""PSAHead, point-wise spatial attention (counterpart of
``segdistill_tpu/models/decode_heads/psa_head.py``; reference
``mmseg/models/decode_heads/psa_head.py:18-196``).

NCHW. The reference scatters each position's (mask_h x mask_w) window of
attention logits into an (H*W, H*W) map with mmcv's compiled ``PSAMask``;
here that is one ``torch.gather`` through an index table built once per
(h, w, mask, device) and cached, zeros outside the window (no kernel: the
JAX package has no Pallas kernel here either). Kept exactly:

* the softmax (``psa_softmax``) runs over the whole H*W source axis of the
  scattered map, the zeros outside the window taking part, in float32;
* 'collect' and 'distribute' gather the same table, 'distribute'
  transposed; compact mode skips the table and transposes only on the
  single 'collect' path and the bi-direction 'distribute' branch;
* ``proj`` is a 1x1 ConvModule with padding 1: it pads the output by one
  pixel before the resize back;
* the shrink flips ``align_corners`` where both sides are odd.

Module names are the reference's: ``reduce``, ``attention.{0,1}``
(ConvModule, bare mask conv), ``reduce_p``, ``attention_p.{0,1}``,
``proj``, ``bottleneck``.
"""

import math

import numpy as np
import torch
from torch import nn

from ...ops import resize
from ..builder import HEADS
from ..utils import ConvModule
from ..utils.conv_module import Conv2d
from .decode_head import BaseDecodeHead
from .psp_head import init_conv_modules

_INDEX_TABLES = {}


def psa_index(h, w, mask_h, mask_w, device):
    """-> (rel, valid), (h*w, h*w) each: for source s = (i, j) and target
    t = (y, x), ``rel[s, t]`` is the window slot (i - y + half_h) * mask_w
    + (j - x + half_w) clipped into range and ``valid[s, t]`` whether it
    lies in the window (half = (mask - 1) // 2, the psamask op's); cached
    on ``device``."""
    key = (h, w, mask_h, mask_w, str(device))
    if key not in _INDEX_TABLES:
        half_h, half_w = (mask_h - 1) // 2, (mask_w - 1) // 2
        rel_h = np.arange(h)[:, None] - np.arange(h)[None] + half_h
        rel_w = np.arange(w)[:, None] - np.arange(w)[None] + half_w
        ok_h = (rel_h >= 0) & (rel_h < mask_h)
        ok_w = (rel_w >= 0) & (rel_w < mask_w)
        # (i, y) x (j, x) -> (i, j, y, x) -> (s, t)
        rel = (np.clip(rel_h, 0, mask_h - 1)[:, None, :, None] * mask_w
               + np.clip(rel_w, 0, mask_w - 1)[None, :, None, :])
        valid = ok_h[:, None, :, None] & ok_w[None, :, None, :]
        _INDEX_TABLES[key] = (
            torch.from_numpy(rel.reshape(h * w, h * w)).to(device),
            torch.from_numpy(valid.reshape(h * w, h * w)).to(device))
    return _INDEX_TABLES[key]


def psa_mask(y, mask_size, psa_type):
    """(N, mask_h*mask_w, H, W) window logits -> (N, H*W, H*W) map, zeros
    outside the window. 'collect': out[n, s, t] = y[n, rel(s, t), t];
    'distribute': its transpose."""
    mask_h, mask_w = mask_size
    n, _, h, w = y.shape
    rel, valid = psa_index(h, w, mask_h, mask_w, y.device)
    out = y.reshape(n, mask_h * mask_w, h * w).gather(
        1, rel.expand(n, -1, -1)) * valid.to(y.dtype)
    return out.transpose(1, 2) if psa_type == 'distribute' else out


def _aggregate(feat, weights, normalization_factor):
    """out[:, c, p] = sum_q feat[:, c, q] * weights[:, q, p] (the
    reference's bmm), summed in float32, in the features' dtype."""
    n, c, h, w = feat.shape
    out = torch.bmm(feat.reshape(n, c, h * w), weights)
    return (out / normalization_factor).reshape(n, c, h, w)


class _Attention(nn.Sequential):
    """The reference's ``Sequential(ConvModule, Conv2d)``: a 1x1 ConvModule
    and a bare 1x1 conv to the mask_h*mask_w window logits."""

    def __init__(self, channels, mask_hw, **conv):
        super().__init__(ConvModule(channels, channels, 1, **conv),
                         Conv2d(channels, mask_hw, 1, bias=False))


@HEADS.register_module()
class PSAHead(BaseDecodeHead):

    def __init__(self, mask_size, psa_type='bi-direction', compact=False,
                 shrink_factor=2, normalization_factor=1.0, psa_softmax=True,
                 **kwargs):
        super().__init__(**kwargs)
        if psa_type not in ('collect', 'distribute', 'bi-direction'):
            raise ValueError(f'psa_type {psa_type!r}')
        self.mask_size = tuple(mask_size)
        self.psa_type = psa_type
        self.compact = compact
        self.shrink_factor = shrink_factor
        self.normalization_factor = normalization_factor
        self.psa_softmax = psa_softmax
        conv = dict(conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg,
                    act_cfg=self.act_cfg)
        mask_hw = self.mask_size[0] * self.mask_size[1]
        bi = psa_type == 'bi-direction'
        self.reduce = ConvModule(self.in_channels, self.channels, 1, **conv)
        self.attention = _Attention(self.channels, mask_hw, **conv)
        if bi:
            self.reduce_p = ConvModule(self.in_channels, self.channels, 1,
                                       **conv)
            self.attention_p = _Attention(self.channels, mask_hw, **conv)
        self.proj = ConvModule(self.channels * (2 if bi else 1),
                               self.in_channels, 1, padding=1, **conv)
        self.bottleneck = ConvModule(self.in_channels * 2, self.channels, 3,
                                     padding=1, **conv)

    @torch.no_grad()
    def init_weights(self, generator):
        """ConvModules as mmcv's, the bare mask convs as torch's default
        (uniform within 1/sqrt(fan_in)), the classifier N(0, 0.01)."""
        init_conv_modules(self, generator)
        for att in (self.attention, getattr(self, 'attention_p', None)):
            if att is not None:
                w = att[1].weight
                bound = 1.0 / math.sqrt(w[0].numel())
                w.uniform_(-bound, bound, generator=generator)
        self.init_cls_seg(generator)

    def _shrunk(self, x, align_corners):
        """Resize by 1/shrink_factor (ref :122-135): where both sides are
        odd, to (n - 1) // f + 1 with align_corners, else n // f
        without."""
        f = self.shrink_factor
        if f == 1:
            return x, align_corners
        h, w = x.shape[2:]
        if h % f and w % f:
            size, align_corners = ((h - 1) // f + 1, (w - 1) // f + 1), True
        else:
            size, align_corners = (h // f, w // f), False
        return resize(x, size=size, mode='bilinear',
                      align_corners=align_corners), align_corners

    def _weights(self, y, psa_type, compact_transpose):
        """Window logits (n, mask_h*mask_w, h, w) -> (n, q, p) weights,
        softmax over q."""
        n, _, h, w = y.shape
        if self.compact:
            y = y.reshape(n, h * w, h * w)
            if compact_transpose:
                y = y.transpose(1, 2)
        else:
            y = psa_mask(y, self.mask_size, psa_type)
        if self.psa_softmax:
            y = y.float().softmax(dim=1).to(y.dtype)
        return y

    def forward(self, inputs, generator=None):
        x = self._transform_inputs(inputs)
        nf = self.normalization_factor
        if self.psa_type != 'bi-direction':
            out, align_corners = self._shrunk(self.reduce(x),
                                              self.align_corners)
            weights = self._weights(self.attention(out), self.psa_type,
                                    self.psa_type == 'collect')
            out = _aggregate(out, weights, nf)
        else:
            x_col, align_corners = self._shrunk(self.reduce(x),
                                                self.align_corners)
            x_dis, _ = self._shrunk(self.reduce_p(x), self.align_corners)
            col = self._weights(self.attention(x_col), 'collect', False)
            dis = self._weights(self.attention_p(x_dis), 'distribute', True)
            out = torch.cat([_aggregate(x_col, col, nf),
                             _aggregate(x_dis, dis, nf)], dim=1)
        out = resize(self.proj(out), size=x.shape[2:], mode='bilinear',
                     align_corners=align_corners)
        out = self.bottleneck(torch.cat([x, out], dim=1))
        return self.cls_seg(out, generator)
