"""MixVisionTransformer, the SegFormer encoder (counterpart of
``segdistill_tpu/models/backbones/mix_transformer.py``; reference
``mmseg/models/backbones/mix_transformer.py:221-442``).

Module names follow the reference ``.pth`` layout: ``patch_embed{s}.{proj,
norm}``, ``block{s}.{i}.{norm1,attn.{q,kv,sr,norm,proj},norm2,mlp.{fc1,
dwconv.dwconv,fc2}}``, ``norm{s}``. Tokens are ``(B, N, C)`` with N
row-major over (H, W); stage outputs are NCHW views of channels-last
memory, so the head reads them as NHWC without a copy.

Knobs carried from the JAX config: ``gelu_approximate`` (tanh GELU, the JAX
default; the reference uses erf), ``fused_attention`` (route SRA attention
through the hand-written kernels, per stage: ``True`` forward only, ``'train'``
with its backward), ``drop_path_rate``
and ``dtype``, the compute type: parameters stay float32 and each layer casts
them to its input's dtype, as flax layers with ``dtype`` do (the LayerNorms
read theirs as stored). ``with_cp`` recomputes each block's activations in
the backward (:func:`..utils.recompute.recomputed`, the JAX
``nn.remat(Block)``) where a gradient is taken; the patch embeddings and
stage norms stay outside, and the frozen teacher's and serving's forwards
are unchanged. ``dwconv_backend`` and ``ln_stats`` choose TPU
lowerings and are accepted and ignored. Every LayerNorm (patch-embed norm,
``norm1``, ``norm2``, the SRA ``attn.norm``, the stage norms) is a
:class:`FusedLayerNorm`: the hand-written kernels K10/K11 on CUDA tensors.

Taps (:func:`..utils.tap`): ``attn.Q``/``K``/``V`` (B, heads, N, d),
``attn.ATTN`` (the scaled scores, unfused path only) and each block's ``FEA``
(B, N, C), as the JAX backbone sows them. Dropout and stochastic depth draw
from the ``generator`` passed to ``forward``.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.sra_attn import fused_sra_attention, sra_attention_train
from ..builder import BACKBONES
from ..utils import DropPath, Dropout, FusedLayerNorm, tap
from ..utils.recompute import recomputed


def _cast(param, x):
    return None if param is None else param.to(x.dtype)


class Linear(nn.Linear):
    """``nn.Linear`` computing in its input's dtype."""

    def forward(self, x):
        return F.linear(x, _cast(self.weight, x), _cast(self.bias, x))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in its input's dtype."""

    def forward(self, x):
        return self._conv_forward(x, _cast(self.weight, x),
                                  _cast(self.bias, x))


def _channels_first(x, H, W):
    """(B, H*W, C) tokens -> NCHW view of the same channels-last memory."""
    B, _, C = x.shape
    return x.reshape(B, H, W, C).permute(0, 3, 1, 2)


def _tokens(x):
    """NCHW (channels-last memory) -> (B, H*W, C)."""
    B, C = x.shape[:2]
    return x.permute(0, 2, 3, 1).reshape(B, -1, C)


class DWConv(nn.Module):
    """3x3 depthwise conv inside the Mix-FFN (ref :376-387)."""

    def __init__(self, dim):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, 1, 1, bias=True, groups=dim)

    def forward(self, x, H, W):
        return _tokens(self.dwconv(_channels_first(x, H, W)))


class Mlp(nn.Module):

    def __init__(self, in_features, hidden_features, drop=0.0,
                 gelu_approximate=True):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features)
        self.dwconv = DWConv(hidden_features)
        self.act = nn.GELU(approximate='tanh' if gelu_approximate
                           else 'none')
        self.fc2 = Linear(hidden_features, in_features)
        self.drop = Dropout(drop)

    def forward(self, x, H, W, generator=None):
        x = self.drop(self.act(self.dwconv(self.fc1(x), H, W)), generator)
        return self.drop(self.fc2(x), generator)


class Attention(nn.Module):
    """Spatial-reduction attention (ref :63-133).

    ``fused_attention`` truthy and ``attn_drop == 0`` route the
    softmax(q k^T) v core through the hand-written kernels, as the JAX
    package does: ``'train'`` through :func:`sra_attention_train` (K2 with
    its backward K9), which carries gradients to q, k and v; ``True``
    through :func:`fused_sra_attention`, the forward-only K2 (the JAX
    kernel for frozen teachers), which runs where no gradient is needed
    (under ``torch.no_grad()``, or with frozen weights) and raises
    otherwise. Neither sows the ``ATTN`` tap. ``token_stride`` is the
    stage's cumulative stride, for the error on a token grid too small for
    the spatial reduction.
    """

    def __init__(self, dim, num_heads=8, qkv_bias=False, qk_scale=None,
                 attn_drop=0.0, proj_drop=0.0, sr_ratio=1,
                 fused_attention=False, token_stride=1):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f'dim {dim} is not a multiple of num_heads '
                             f'{num_heads}')
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.q = Linear(dim, dim, bias=qkv_bias)
        self.kv = Linear(dim, dim * 2, bias=qkv_bias)
        self.attn_drop = Dropout(attn_drop)
        self.proj = Linear(dim, dim)
        self.proj_drop = Dropout(proj_drop)
        self.sr_ratio = sr_ratio
        self.fused_attention = fused_attention
        self.token_stride = token_stride
        if sr_ratio > 1:
            self.sr = Conv2d(dim, dim, sr_ratio, sr_ratio)
            # ref :89 -- a plain nn.LayerNorm, torch's default eps 1e-5
            self.norm = FusedLayerNorm(dim, eps=1e-5)

    def forward(self, x, H, W, generator=None):
        B, N, C = x.shape
        nh = self.num_heads
        hd = C // nh
        q = self.q(x).reshape(B, N, nh, hd).permute(0, 2, 1, 3)
        tap(self, 'Q', q)
        if self.sr_ratio > 1:
            sr = self.sr_ratio
            if H < sr or W < sr:
                # the stage grid is ceil(side / token_stride) per side
                raise ValueError(
                    f'SRA stage needs a token grid of at least {sr}x{sr}, '
                    f'got {H}x{W}: input sides must be at least '
                    f'{self.token_stride * (sr - 1) + 1}px')
            x_ = _tokens(self.sr(_channels_first(x, H, W)))
            x_ = self.norm(x_)
        else:
            x_ = x
        kv = self.kv(x_).reshape(B, -1, 2, nh, hd).permute(2, 0, 3, 1, 4)
        k, v = tap(self, 'K', kv[0]), tap(self, 'V', kv[1])
        if self.fused_attention == 'train' and self.attn_drop.p == 0.0:
            out = sra_attention_train(q, k, v, self.scale)
        elif self.fused_attention and self.attn_drop.p == 0.0:
            if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                            or v.requires_grad):
                raise NotImplementedError(
                    'fused_attention=True runs the forward-only SRA kernel, '
                    'which has no backward: q, k and v would get no '
                    'gradient. Run it under torch.no_grad() or with frozen '
                    "weights, or set fused_attention='train' to train "
                    'through the kernel with its backward')
            out = fused_sra_attention(q, k, v, self.scale)
        else:
            attn = tap(self, 'ATTN',
                       torch.matmul(q, k.transpose(-2, -1)) * self.scale)
            attn = self.attn_drop(attn.float().softmax(dim=-1).to(q.dtype),
                                  generator)
            out = torch.matmul(attn, v)
        out = out.transpose(1, 2).reshape(B, N, C)
        return self.proj_drop(self.proj(out), generator)


class Block(nn.Module):

    def __init__(self, dim, num_heads, mlp_ratio=4.0, qkv_bias=False,
                 qk_scale=None, drop=0.0, attn_drop=0.0, drop_path=0.0,
                 sr_ratio=1, gelu_approximate=True, fused_attention=False,
                 token_stride=1):
        super().__init__()
        self.norm1 = FusedLayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads=num_heads, qkv_bias=qkv_bias,
                              qk_scale=qk_scale, attn_drop=attn_drop,
                              proj_drop=drop, sr_ratio=sr_ratio,
                              fused_attention=fused_attention,
                              token_stride=token_stride)
        self.drop_path = DropPath(drop_path)
        self.norm2 = FusedLayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop=drop,
                       gelu_approximate=gelu_approximate)

    def forward(self, x, H, W, generator=None):
        x = x + self.drop_path(self.attn(self.norm1(x), H, W, generator),
                               generator)
        x = x + self.drop_path(self.mlp(self.norm2(x), H, W, generator),
                               generator)
        return tap(self, 'FEA', x)


class OverlapPatchEmbed(nn.Module):

    def __init__(self, patch_size=7, stride=4, in_chans=3, embed_dim=768):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch_size, stride,
                           patch_size // 2)
        # ref :194 -- torch's default eps 1e-5
        self.norm = FusedLayerNorm(embed_dim, eps=1e-5)

    def forward(self, x):
        x = self.proj(x)
        H, W = x.shape[2:]
        return self.norm(_tokens(x)), H, W


def _torch_dtype(dtype):
    if dtype is None:
        return torch.float32
    if isinstance(dtype, str):
        return getattr(torch, dtype)
    return dtype


@BACKBONES.register_module()
class MixVisionTransformer(nn.Module):
    """Four stages of overlapping patch embedding + SRA blocks; returns the
    four stage maps (NCHW, strides 4, 8, 16, 32).

    ``dtype`` is the compute type: the input is cast to it on entry and
    every layer casts its float32 parameters to it (bfloat16 on the bench
    path), so an optimizer updates float32 master weights. LayerNorm
    statistics stay float32 inside the LayerNorm kernels either way.
    """

    def __init__(self, embed_dims=(64, 128, 256, 512), num_heads=(1, 2, 4, 8),
                 mlp_ratios=(4, 4, 4, 4), qkv_bias=False, qk_scale=None,
                 drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.0,
                 depths=(3, 4, 6, 3), sr_ratios=(8, 4, 2, 1),
                 gelu_approximate=True, fused_attention=False,
                 with_cp=False, dwconv_backend='auto', ln_stats='native',
                 dtype=None):
        super().__init__()
        del dwconv_backend, ln_stats  # TPU lowerings; nothing to choose here
        fa = fused_attention
        fa_stages = tuple(fa) if isinstance(fa, (list, tuple)) else (fa,) * 4
        # stochastic depth decay rule (ref :241)
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        patch_cfg = [(7, 4), (3, 2), (3, 2), (3, 2)]
        cur = 0
        stride = 1
        for s in range(4):
            ps, st = patch_cfg[s]
            stride *= st
            setattr(self, f'patch_embed{s + 1}', OverlapPatchEmbed(
                ps, st, 3 if s == 0 else embed_dims[s - 1],
                embed_dims[s]))
            setattr(self, f'block{s + 1}', nn.ModuleList([
                Block(embed_dims[s], num_heads[s], mlp_ratios[s], qkv_bias,
                      qk_scale, drop_rate, attn_drop_rate, dpr[cur + i],
                      sr_ratios[s], gelu_approximate, fa_stages[s], stride)
                for i in range(depths[s])]))
            setattr(self, f'norm{s + 1}',
                    FusedLayerNorm(embed_dims[s], eps=1e-6))
            cur += depths[s]
        self.dtype = _torch_dtype(dtype)
        self.with_cp = with_cp

    @torch.no_grad()
    def init_weights(self, generator):
        """The reference's ``_init_weights`` (ref :256-270), drawn from
        ``generator``."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Conv2d):
                fan_out = (m.kernel_size[0] * m.kernel_size[1]
                           * m.out_channels // m.groups)
                m.weight.normal_(0, math.sqrt(2.0 / fan_out),
                                 generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)

    def forward(self, x, generator=None):
        x = x.to(self.dtype)
        recompute = self.with_cp and self.training and torch.is_grad_enabled()
        outs = []
        for s in range(1, 5):
            x, H, W = getattr(self, f'patch_embed{s}')(x)
            for blk in getattr(self, f'block{s}'):
                x = recomputed(blk, x, H, W, generator=generator) \
                    if recompute else blk(x, H, W, generator)
            x = _channels_first(getattr(self, f'norm{s}')(x), H, W)
            outs.append(x)
        return tuple(outs)


def _mit(embed_dims, depths, **kwargs):
    kwargs.pop('style', None)
    kwargs.pop('pretrained', None)
    kwargs.setdefault('drop_rate', 0.0)
    kwargs.setdefault('drop_path_rate', 0.1)
    return MixVisionTransformer(
        embed_dims=tuple(embed_dims), num_heads=(1, 2, 5, 8),
        mlp_ratios=(4, 4, 4, 4), qkv_bias=True, depths=tuple(depths),
        sr_ratios=(8, 4, 2, 1), **kwargs)


# ref variant table: mix_transformer.py:391-442
@BACKBONES.register_module(name='mit_b0')
def mit_b0(**kwargs):
    return _mit([32, 64, 160, 256], [2, 2, 2, 2], **kwargs)


@BACKBONES.register_module(name='mit_b1')
def mit_b1(**kwargs):
    return _mit([64, 128, 320, 512], [2, 2, 2, 2], **kwargs)


@BACKBONES.register_module(name='mit_b2')
def mit_b2(**kwargs):
    return _mit([64, 128, 320, 512], [3, 4, 6, 3], **kwargs)


@BACKBONES.register_module(name='mit_b3')
def mit_b3(**kwargs):
    return _mit([64, 128, 320, 512], [3, 4, 18, 3], **kwargs)


@BACKBONES.register_module(name='mit_b4')
def mit_b4(**kwargs):
    return _mit([64, 128, 320, 512], [3, 8, 27, 3], **kwargs)


@BACKBONES.register_module(name='mit_b5')
def mit_b5(**kwargs):
    return _mit([64, 128, 320, 512], [3, 6, 40, 3], **kwargs)
