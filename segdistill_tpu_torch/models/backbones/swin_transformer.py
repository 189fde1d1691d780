"""Swin Transformer backbone (counterpart of
``segdistill_tpu/models/backbones/swin_transformer.py``; reference
``mmseg/models/backbones/swin_transformer.py:72-618``), the Tab5 Swin-T
student's.

Windowed multi-head attention with a relative position bias, shifted
windows under the -100 attention mask, maps zero-padded to a multiple of
the window (a 128 x 128 stage grid at a 512 crop runs at 133 x 133), patch
merging, and a LayerNorm per output stage. Module names follow the
reference ``.pth``: ``patch_embed.{proj,norm}``,
``layers.{i}.blocks.{j}.{norm1,attn.{relative_position_bias_table,qkv,
proj},norm2,mlp.{fc1,fc2}}``, ``layers.{i}.downsample.{reduction,norm}``,
``norm{i}``; ``attn.relative_position_index`` is a buffer of the state
dict, as in the reference file.

Every LayerNorm (patch embedding, ``norm1``, ``norm2``, the PatchMerging
norm over 4C channels, C = 1536 in the last one of Swin-T, and the output
norms) is a :class:`FusedLayerNorm`: the hand-written kernels K10/K11 on
CUDA tensors. The window attention has no kernel in the JAX package
(``softmax_lastdim`` there): scores in float32, the bias and mask added,
a float32 softmax, probabilities in the compute type. Knobs as in the
port's MiT: ``dtype`` is the compute type (float32 parameters cast to it),
``gelu_approximate`` (tanh GELU, the JAX default; the reference uses erf);
stochastic depth rises linearly to ``drop_path_rate`` over the blocks and,
like dropout, draws from the ``generator`` passed to ``forward``. Each
block's output is a tap under its module name
(``backbone.layers.0.blocks.1``), as the JAX package sows it.

With ``ape`` the absolute position embedding ``absolute_pos_embed``, a
float32 parameter of shape (1, (pretrain_img_size // patch_size)^2, C),
the JAX package's layout, is resized bilinearly (align_corners=False) to
the token grid and added after the patch norm, before the dropout.
Frozen stages are not ported (no Tab5 config sets them).
"""

import functools
import math

import numpy as np
import torch
from torch import nn

from ..builder import BACKBONES
from ..utils import DropPath, Dropout, FusedLayerNorm, tap
from .mix_transformer import Conv2d, Linear, _torch_dtype


def window_partition(x, ws):
    """(B, H, W, C) -> (B * windows, ws * ws, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def window_reverse(windows, ws, H, W):
    """(B * windows, ws * ws, C) -> (B, H, W, C)."""
    C = windows.shape[-1]
    x = windows.reshape(-1, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, H, W, C)


def relative_position_index(ws):
    """(ws^2, ws^2) index into the bias table (ref swin:92-104)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing='ij')).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return torch.from_numpy(rel.sum(-1).astype(np.int64))


@functools.lru_cache(maxsize=32)
def _attn_mask(Hp, Wp, ws, shift, device=None):
    """The shifted windows' (windows, ws^2, ws^2) mask on ``device``: -100
    between positions of different regions (ref swin:209-227). Kept for
    each device, so a step reads it there with no copy from the host (a
    copy a CUDA graph's capture refuses)."""
    img = np.zeros((1, Hp, Wp, 1), np.float32)
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, h, w, :] = cnt
            cnt += 1
    win = window_partition(torch.from_numpy(img), ws)[..., 0]
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0).to(device)


class WindowAttention(nn.Module):

    def __init__(self, dim, window_size, num_heads, qkv_bias=True,
                 qk_scale=None, attn_drop=0.0, proj_drop=0.0):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f'dim {dim} is not a multiple of num_heads '
                             f'{num_heads}')
        self.window_size = window_size
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer('relative_position_index',
                             relative_position_index(window_size))
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias)
        self.attn_drop = Dropout(attn_drop)
        self.proj = Linear(dim, dim)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x, mask=None, generator=None):
        B_, N, C = x.shape
        nh = self.num_heads
        qkv = self.qkv(x).reshape(B_, N, 3, nh, C // nh).permute(2, 0, 3, 1,
                                                                  4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.matmul(q, k.transpose(-2, -1)).float() * self.scale
        bias = self.relative_position_bias_table[
            self.relative_position_index.reshape(-1)].reshape(N, N, nh)
        attn = attn + bias.permute(2, 0, 1).float()
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.reshape(B_ // nW, nW, nh, N, N) + mask[None, :, None]
            attn = attn.reshape(B_, nh, N, N)
        attn = self.attn_drop(attn.softmax(dim=-1).to(x.dtype), generator)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B_, N, C)
        return self.proj_drop(self.proj(out), generator)


class Mlp(nn.Module):

    def __init__(self, dim, hidden, drop=0.0, gelu_approximate=True):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.act = nn.GELU(approximate='tanh' if gelu_approximate
                           else 'none')
        self.fc2 = Linear(hidden, dim)
        self.drop = Dropout(drop)

    def forward(self, x, generator=None):
        x = self.drop(self.act(self.fc1(x)), generator)
        return self.drop(self.fc2(x), generator)


class SwinTransformerBlock(nn.Module):

    def __init__(self, dim, num_heads, window_size=7, shift_size=0,
                 mlp_ratio=4.0, qkv_bias=True, qk_scale=None, drop=0.0,
                 attn_drop=0.0, drop_path=0.0, gelu_approximate=True):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = FusedLayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window_size, num_heads, qkv_bias,
                                    qk_scale, attn_drop, drop)
        self.drop_path = DropPath(drop_path)
        self.norm2 = FusedLayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop, gelu_approximate)

    def forward(self, x, H, W, generator=None):
        B, L, C = x.shape
        ws, shift = self.window_size, self.shift_size
        shortcut = x
        x = self.norm1(x).reshape(B, H, W, C)
        # the window is fixed: pad up to a multiple (ref swin:200-249)
        pad_b, pad_r = (ws - H % ws) % ws, (ws - W % ws) % ws
        if pad_b or pad_r:
            x = nn.functional.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        mask = None
        if shift > 0:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
            mask = _attn_mask(Hp, Wp, ws, shift, x.device)
        x = self.attn(window_partition(x, ws), mask, generator)
        x = window_reverse(x, ws, Hp, Wp)
        if shift > 0:
            x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
        x = x[:, :H, :W].reshape(B, H * W, C)
        x = shortcut + self.drop_path(x, generator)
        x = x + self.drop_path(self.mlp(self.norm2(x), generator), generator)
        return tap(self, '', x)


class PatchMerging(nn.Module):
    """2x2 neighbours -> 4C channels -> LayerNorm -> 2C (ref swin:190-221)."""

    def __init__(self, dim):
        super().__init__()
        self.norm = FusedLayerNorm(4 * dim, eps=1e-5)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, H, W):
        B, _, C = x.shape
        x = x.reshape(B, H, W, C)
        if H % 2 or W % 2:
            x = nn.functional.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1).reshape(B, -1, 4 * C)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    """One stage: its blocks (shifted every other one) and the merging into
    the next stage's grid."""

    def __init__(self, dim, depth, num_heads, window_size, drop_paths,
                 downsample, **block_kw):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, num_heads, window_size,
                                 0 if i % 2 == 0 else window_size // 2,
                                 drop_path=drop_paths[i], **block_kw)
            for i in range(depth)])
        self.downsample = PatchMerging(dim) if downsample else None


class PatchEmbed(nn.Module):

    def __init__(self, patch_size, in_chans, embed_dim, patch_norm):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Conv2d(in_chans, embed_dim, patch_size, patch_size)
        self.norm = FusedLayerNorm(embed_dim, eps=1e-5) if patch_norm \
            else None

    def forward(self, x):
        ps = self.patch_size
        H0, W0 = x.shape[2:]
        x = nn.functional.pad(x, (0, (ps - W0 % ps) % ps,
                                  0, (ps - H0 % ps) % ps))
        x = self.proj(x)
        H, W = x.shape[2:]
        x = x.flatten(2).transpose(1, 2)
        return (x if self.norm is None else self.norm(x)), H, W


@BACKBONES.register_module()
class SwinTransformer(nn.Module):
    """Returns the stage maps of ``out_indices`` (NCHW, strides 4 to 32)."""

    def __init__(self, pretrain_img_size=224, patch_size=4, in_chans=3,
                 embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
                 window_size=7, mlp_ratio=4.0, qkv_bias=True, qk_scale=None,
                 drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.2,
                 gelu_approximate=True, ape=False, patch_norm=True,
                 out_indices=(0, 1, 2, 3), frozen_stages=-1,
                 use_checkpoint=False, pretrained=None, style=None,
                 dtype=None):
        super().__init__()
        # no effect on the result
        del use_checkpoint, pretrained, style
        if frozen_stages != -1:
            raise NotImplementedError('frozen stages are not ported')
        self.out_indices = tuple(out_indices)
        self.dtype = _torch_dtype(dtype)
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim,
                                      patch_norm)
        self.absolute_pos_embed = None
        if ape:
            side = pretrain_img_size // patch_size
            self.absolute_pos_embed = nn.Parameter(
                torch.zeros(1, side * side, embed_dim))
        self.pos_drop = Dropout(drop_rate)
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        self.layers = nn.ModuleList()
        cur = 0
        for i, depth in enumerate(depths):
            self.layers.append(BasicLayer(
                embed_dim * 2 ** i, depth, num_heads[i], window_size,
                dpr[cur:cur + depth], i < len(depths) - 1,
                mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, qk_scale=qk_scale,
                drop=drop_rate, attn_drop=attn_drop_rate,
                gelu_approximate=gelu_approximate))
            cur += depth
        for i in self.out_indices:
            self.add_module(f'norm{i}',
                            FusedLayerNorm(embed_dim * 2 ** i, eps=1e-5))

    @torch.no_grad()
    def init_weights(self, generator):
        """trunc-normal (std 0.02) linears and bias tables, unit
        LayerNorms (ref swin:527-546), a He-normal patch conv; drawn from
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
                fan_out = m.kernel_size[0] * m.kernel_size[1] * m.out_channels
                m.weight.normal_(0, math.sqrt(2.0 / fan_out),
                                 generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, WindowAttention):
                nn.init.trunc_normal_(m.relative_position_bias_table,
                                      std=0.02, generator=generator)
        if self.absolute_pos_embed is not None:
            nn.init.trunc_normal_(self.absolute_pos_embed, std=0.02,
                                  generator=generator)

    def _pos_embed(self, H, W):
        """The absolute position embedding on the (H, W) token grid ->
        (1, H * W, C) float32."""
        ape = self.absolute_pos_embed
        side = math.isqrt(ape.shape[1])
        grid = ape.reshape(1, side, side, -1).permute(0, 3, 1, 2)
        grid = nn.functional.interpolate(grid, size=(H, W), mode='bilinear',
                                         align_corners=False)
        return grid.flatten(2).transpose(1, 2)

    def forward(self, x, generator=None):
        x, H, W = self.patch_embed(x.to(self.dtype))
        if self.absolute_pos_embed is not None:
            x = x + self._pos_embed(H, W).to(x.dtype)
        x = self.pos_drop(x, generator)
        outs = []
        for i, layer in enumerate(self.layers):
            for blk in layer.blocks:
                x = blk(x, H, W, generator)
            if i in self.out_indices:
                out = getattr(self, f'norm{i}')(x)
                B, _, C = out.shape
                outs.append(out.reshape(B, H, W, C).permute(0, 3, 1, 2))
            if layer.downsample is not None:
                x = layer.downsample(x, H, W)
                H, W = (H + 1) // 2, (W + 1) // 2
        return tuple(outs)
