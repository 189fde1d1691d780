"""DAHead, CCHead, EMAHead and EncHead (counterpart of
``segdistill_tpu/models/decode_heads/da_head.py``; reference
``mmseg/models/decode_heads/{da_head,cc_head,ema_head,enc_head}.py``).

NCHW, the reference ``.pth`` layout. Each keeps the JAX package's float32
islands and returns the features' dtype.

DAHead: a position branch (``pam_in_conv`` -> :class:`PAM`, a
:class:`SelfAttentionBlock` of bare projections to ``pam_channels`` with
no similarity scaling, its value at the head's width, and a ``gamma``
:class:`Scale` on the residual -> ``pam_out_conv``) and a channel branch
(``cam_in_conv`` -> :class:`CAM`, the channel affinity ``max - energy``
softmaxed -> ``cam_out_conv``). Three outputs, each with its own
classifier: ``conv_seg`` on their sum (the primary logits, the
``decode_head.conv_seg`` tap), ``pam_conv_seg`` and ``cam_conv_seg``;
three CE losses under 'pam_cam.', 'pam.' and 'cam.'.

CCHead: the FCNHead(num_convs=2) skeleton with ONE
:class:`CrissCrossAttention` (``cca``) applied ``recurrence`` times, so its
weights are shared. Each position attends over its row and its column in
one softmax and counts itself once: the column branch's diagonal is -1e9
(the JAX package's value). ``gamma`` is a bare (1,) parameter (the
reference's mmcv layout).

EMAHead: ``ema_in_conv``, a frozen 1x1 ``ema_mid_conv`` (its parameters do
not require grad, so no optimizer moves them), the EM iterations against
the (1, C, K) ``ema_module.bases`` buffer and the reconstruction from the
last bases and attention, all without gradient, then ``ema_out_conv``, the
residual, ``bottleneck`` and ``conv_cat``. The buffer stays float32 (or
float64 in a float64 model) whatever the features' dtype; in training mode
each forward moves it toward the batch's mean bases by ``momentum``. One
process: the reference's mean across processes is not ported.

EncHead: ``bottleneck`` on the last input (with ``add_lateral``, the
earlier inputs' 1x1 ``lateral_convs`` resized to it and ``fusion``), then
:class:`EncModule`: ``encoding_project``, ``encoding`` (Sequential
:class:`Encoding`, BatchNorm1d over the codes, ReLU), the mean over the
codes (the ``decode_head.enc`` tap), a sigmoid ``fc`` gate, relu(x + x *
gamma). With ``use_se_loss`` the head also returns ``se_layer``'s logits,
and its losses add 'loss_se': the binary CE against the classes present in
each label map (ignored pixels excluded), times ``loss_se_decode``'s
weight. :class:`Encoding` expands the squared distances as |x|^2 - 2 x.c +
|c|^2 and the aggregation as A^T x - (sum A) c, so no (B, N, K, C) residual
is made (1 GiB in training at 512x1024, 2 GiB at a 1024x2048 request).
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...core.utils import add_prefix
from ...ops import resize
from ..builder import HEADS
from ..utils import ConvModule, SelfAttentionBlock, tap
from ..utils.conv_module import Conv2d, Linear, torch_default_
from .decode_head import BaseDecodeHead
from .nl_head import FCNBlockHead
from .psp_head import init_conv_modules


def init_bare(module, generator):
    """Each ConvModule under ``module`` as mmcv initialises it, every other
    conv and linear layer as PyTorch does (the reference leaves them so)."""
    in_modules = {id(m.conv) for m in module.modules()
                  if isinstance(m, ConvModule)}
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)) and id(m) not in in_modules:
            torch_default_(m, generator)
    init_conv_modules(module, generator)


class Scale(nn.Module):
    """mmcv's ``Scale``: a learnable scalar ``scale``."""

    def __init__(self, scale=0.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(scale)))

    def forward(self, x):
        return x * self.scale.to(x.dtype)


class PAM(SelfAttentionBlock):

    def __init__(self, in_channels, channels):
        super().__init__(in_channels, in_channels, channels, in_channels,
                         matmul_norm=False, with_out=False)
        self.gamma = Scale(0.0)

    @torch.no_grad()
    def init_weights(self, generator):
        """The reference's: PyTorch's bare projections, ``gamma`` 0."""
        for conv in (self.key_project, self.query_project,
                     self.value_project):
            torch_default_(conv, generator)
        nn.init.zeros_(self.gamma.scale)

    def forward(self, x):
        return self.gamma(super().forward(x, x)) + x


class CAM(nn.Module):

    def __init__(self):
        super().__init__()
        self.gamma = Scale(0.0)

    def forward(self, x):
        b, c, h, w = x.shape
        f = x.flatten(2).float()
        energy = torch.bmm(f, f.transpose(1, 2))
        energy = energy.max(dim=-1, keepdim=True)[0] - energy
        out = torch.bmm(energy.softmax(dim=-1), f)
        return self.gamma(out.view(b, c, h, w).to(x.dtype)) + x


@HEADS.register_module()
class DAHead(BaseDecodeHead):

    BRANCHES = ('pam_cam', 'pam', 'cam')

    def __init__(self, pam_channels, **kwargs):
        super().__init__(**kwargs)
        conv = dict(conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg,
                    act_cfg=self.act_cfg)
        c = self.channels
        self.pam_in_conv = ConvModule(self.in_channels, c, 3, padding=1,
                                      **conv)
        self.pam = PAM(c, pam_channels)
        self.pam_out_conv = ConvModule(c, c, 3, padding=1, **conv)
        self.pam_conv_seg = nn.Conv2d(c, self.num_classes, 1)
        self.cam_in_conv = ConvModule(self.in_channels, c, 3, padding=1,
                                      **conv)
        self.cam = CAM()
        self.cam_out_conv = ConvModule(c, c, 3, padding=1, **conv)
        self.cam_conv_seg = nn.Conv2d(c, self.num_classes, 1)

    @torch.no_grad()
    def init_weights(self, generator):
        init_conv_modules(self, generator)
        self.pam.init_weights(generator)
        nn.init.zeros_(self.cam.gamma.scale)
        for conv in (self.pam_conv_seg, self.cam_conv_seg):
            conv.weight.normal_(0, 0.01, generator=generator)
            nn.init.zeros_(conv.bias)
        self.init_cls_seg(generator)

    def _branch_cls_seg(self, feat, conv, generator):
        """A branch's own classifier behind the shared dropout (ref
        pam_cls_seg / cam_cls_seg)."""
        if self.dropout is not None:
            feat = self.dropout(feat, generator)
        return F.conv2d(feat, conv.weight.to(feat.dtype),
                        conv.bias.to(feat.dtype))

    def forward(self, inputs, generator=None):
        """-> (pam_cam, pam, cam) logits."""
        x = self._transform_inputs(inputs)
        pam = self.pam_out_conv(self.pam(self.pam_in_conv(x)))
        cam = self.cam_out_conv(self.cam(self.cam_in_conv(x)))
        return (self.cls_seg(pam + cam, generator),
                self._branch_cls_seg(pam, self.pam_conv_seg, generator),
                self._branch_cls_seg(cam, self.cam_conv_seg, generator))

    def losses(self, seg_logit, seg_label, seg_weight=None):
        losses = {}
        for prefix, logit in zip(self.BRANCHES, seg_logit):
            losses.update(add_prefix(
                super().losses(logit, seg_label, seg_weight), prefix))
        return losses


class CrissCrossAttention(nn.Module):

    def __init__(self, in_channels):
        super().__init__()
        inter = max(in_channels // 8, 1)
        self.query_conv = Conv2d(in_channels, inter, 1)
        self.key_conv = Conv2d(in_channels, inter, 1)
        self.value_conv = Conv2d(in_channels, in_channels, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    @torch.no_grad()
    def init_weights(self, generator):
        """The reference's: PyTorch's convs, ``gamma`` 0."""
        for conv in (self.query_conv, self.key_conv, self.value_conv):
            torch_default_(conv, generator)
        nn.init.zeros_(self.gamma)

    def forward(self, x):
        h = x.shape[2]
        q = self.query_conv(x).float()
        k = self.key_conv(x).float()
        v = self.value_conv(x).float()
        # (b, h, w, w'): each position against its row; (b, h, w, h'):
        # against its column, itself masked there
        rows = torch.einsum('bcyx,bcyk->byxk', q, k)
        cols = torch.einsum('bcyx,bckx->byxk', q, k)
        cols = cols.masked_fill(torch.eye(h, dtype=torch.bool,
                                          device=x.device)[:, None], -1e9)
        attn = torch.cat([cols, rows], dim=-1).softmax(dim=-1)
        out = torch.einsum('byxk,bckx->bcyx', attn[..., :h], v) \
            + torch.einsum('byxk,bcyk->bcyx', attn[..., h:], v)
        return x + self.gamma.to(x.dtype) * out.to(x.dtype)


@HEADS.register_module()
class CCHead(FCNBlockHead):

    BLOCK = 'cca'

    def __init__(self, recurrence=2, **kwargs):
        super().__init__(**kwargs)
        self.recurrence = recurrence
        self.cca = CrissCrossAttention(self.channels)

    def _block(self, x):
        for _ in range(self.recurrence):
            x = self.cca(x)
        return x


class EMAModule(nn.Module):

    def __init__(self, channels, num_bases, num_stages, momentum):
        super().__init__()
        self.num_bases = num_bases
        self.num_stages = num_stages
        self.momentum = momentum
        self.register_buffer('bases', torch.zeros(1, channels, num_bases))

    @torch.no_grad()
    def init_weights(self, generator):
        """The reference's: N(0, 2 / K), each base of unit length."""
        self.bases.normal_(0, (2.0 / self.num_bases) ** 0.5,
                           generator=generator)
        self.bases.copy_(_unit(self.bases))

    @torch.no_grad()
    def forward(self, feats):
        """-> the reconstruction of ``feats`` (B, C, H, W), no gradient."""
        b, c, h, w = feats.shape
        f = feats.flatten(2).float()
        bases = self.bases.float().expand(b, -1, -1)
        for _ in range(self.num_stages):
            attn = torch.bmm(f.transpose(1, 2), bases).softmax(dim=2)
            l1 = attn / attn.sum(dim=1, keepdim=True).clamp_min(1e-12)
            bases = _unit(torch.bmm(f, l1))
        recon = torch.bmm(bases, attn.transpose(1, 2))
        if self.training:
            new = _unit(bases.mean(dim=0, keepdim=True))
            self.bases.copy_((1 - self.momentum) * self.bases
                             + self.momentum * new)
        return recon.view(b, c, h, w).to(feats.dtype)


def _unit(bases):
    """Each base (a column of (B, C, K)) divided by its length."""
    return bases / bases.norm(dim=1, keepdim=True).clamp_min(1e-12)


@HEADS.register_module()
class EMAHead(BaseDecodeHead):

    def __init__(self, ema_channels, num_bases, num_stages,
                 concat_input=True, momentum=0.1, **kwargs):
        super().__init__(**kwargs)
        conv = dict(conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg,
                    act_cfg=self.act_cfg)
        self.ema_in_conv = ConvModule(self.in_channels, ema_channels, 3,
                                      padding=1, **conv)
        self.ema_mid_conv = ConvModule(ema_channels, ema_channels, 1,
                                       conv_cfg=self.conv_cfg, act_cfg=None)
        for p in self.ema_mid_conv.parameters():
            p.requires_grad = False
        self.ema_module = EMAModule(ema_channels, num_bases, num_stages,
                                    momentum)
        self.ema_out_conv = ConvModule(ema_channels, ema_channels, 1,
                                       conv_cfg=self.conv_cfg,
                                       norm_cfg=self.norm_cfg, act_cfg=None)
        self.bottleneck = ConvModule(ema_channels, self.channels, 3,
                                     padding=1, **conv)
        self.conv_cat = ConvModule(
            self.in_channels + self.channels, self.channels, 3, padding=1,
            **conv) if concat_input else None

    @torch.no_grad()
    def init_weights(self, generator):
        init_conv_modules(self, generator)
        self.ema_module.init_weights(generator)
        self.init_cls_seg(generator)

    def forward(self, inputs, generator=None):
        x = self._transform_inputs(inputs)
        feats = self.ema_in_conv(x)
        with torch.no_grad():
            recon = self.ema_module(self.ema_mid_conv(feats))
        recon = self.ema_out_conv(F.relu(recon))
        out = self.bottleneck(F.relu(feats + recon))
        if self.conv_cat is not None:
            out = self.conv_cat(torch.cat([x, out], dim=1))
        return self.cls_seg(out, generator)


class Encoding(nn.Module):
    """mmseg's ``ops/encoding.py``: (B, C, H, W) -> (B, K, C), the
    residuals to the ``codewords`` weighted by a softmax over the codes of
    ``scale`` times the squared distances (``scale`` is negative)."""

    def __init__(self, channels, num_codes):
        super().__init__()
        self.channels, self.num_codes = channels, num_codes
        self.codewords = nn.Parameter(torch.empty(num_codes, channels))
        self.scale = nn.Parameter(torch.empty(num_codes))

    @torch.no_grad()
    def init_weights(self, generator):
        std = (self.num_codes * self.channels) ** -0.5
        self.codewords.uniform_(-std, std, generator=generator)
        self.scale.uniform_(-1, 0, generator=generator)

    def forward(self, x):
        xf = x.flatten(2).transpose(1, 2).float()  # (B, N, C)
        cw = self.codewords.float()
        dist = xf.square().sum(dim=-1, keepdim=True) \
            - 2 * torch.matmul(xf, cw.t()) + cw.square().sum(dim=-1)
        assign = (self.scale.float() * dist).softmax(dim=2)  # (B, N, K)
        enc = torch.matmul(assign.transpose(1, 2), xf) \
            - assign.sum(dim=1)[..., None] * cw
        return enc.to(x.dtype)


class _BatchNorm1d(nn.BatchNorm1d):
    """BatchNorm1d over (B, K, C) in float32, returning the input's
    dtype."""

    def forward(self, x):
        return super().forward(x.float()).to(x.dtype)


class EncModule(nn.Module):

    def __init__(self, in_channels, num_codes, conv_cfg=None, norm_cfg=None,
                 act_cfg='default'):
        super().__init__()
        self.encoding_project = ConvModule(in_channels, in_channels, 1,
                                           conv_cfg=conv_cfg,
                                           norm_cfg=norm_cfg, act_cfg=act_cfg)
        self.encoding = nn.Sequential(Encoding(in_channels, num_codes),
                                      _BatchNorm1d(num_codes), nn.ReLU())
        self.fc = nn.Sequential(Linear(in_channels, in_channels),
                                nn.Sigmoid())

    def forward(self, x):
        """-> (the codes' mean (B, C), relu(x + x * gate))."""
        enc = self.encoding(self.encoding_project(x)).mean(dim=1)
        gamma = self.fc(enc).to(x.dtype)
        return enc, F.relu(x + x * gamma[:, :, None, None])


@HEADS.register_module()
class EncHead(BaseDecodeHead):

    def __init__(self, num_codes=32, use_se_loss=True, add_lateral=False,
                 loss_se_decode=None, **kwargs):
        kwargs.setdefault('input_transform', 'multiple_select')
        super().__init__(**kwargs)
        conv = dict(conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg,
                    act_cfg=self.act_cfg)
        c = self.channels
        self.use_se_loss = use_se_loss
        self.add_lateral = add_lateral
        self.loss_se_decode = dict(
            loss_se_decode or dict(type='CrossEntropyLoss', use_sigmoid=True,
                                   loss_weight=0.2))
        self.bottleneck = ConvModule(self.in_channels[-1], c, 3, padding=1,
                                     **conv)
        if add_lateral:
            self.lateral_convs = nn.ModuleList(
                ConvModule(n, c, 1, **conv) for n in self.in_channels[:-1])
            self.fusion = ConvModule(len(self.in_channels) * c, c, 3,
                                     padding=1, **conv)
        self.enc_module = EncModule(c, num_codes, **conv)
        if use_se_loss:
            self.se_layer = nn.Linear(c, self.num_classes)

    @torch.no_grad()
    def init_weights(self, generator):
        init_bare(self, generator)
        self.enc_module.encoding[0].init_weights(generator)
        bn = self.enc_module.encoding[1]
        nn.init.ones_(bn.weight)
        nn.init.zeros_(bn.bias)
        self.init_cls_seg(generator)

    def forward(self, inputs, generator=None):
        """-> logits, or (logits, se logits (B, classes)) with
        ``use_se_loss``."""
        inputs = self._transform_inputs(inputs)
        feat = self.bottleneck(inputs[-1])
        if self.add_lateral:
            laterals = [resize(conv(x), size=feat.shape[2:], mode='bilinear',
                               align_corners=self.align_corners)
                        for conv, x in zip(self.lateral_convs, inputs)]
            feat = self.fusion(torch.cat([feat] + laterals, dim=1))
        enc, out = self.enc_module(feat)
        tap(self, 'enc', enc)
        out = self.cls_seg(out, generator)
        if self.use_se_loss:
            return out, self.se_layer(enc.float())
        return out

    def losses(self, seg_logit, seg_label, seg_weight=None):
        if not isinstance(seg_logit, tuple):
            return super().losses(seg_logit, seg_label, seg_weight)
        seg_logit, se_logit = seg_logit
        losses = super().losses(seg_logit, seg_label, seg_weight)
        label = seg_label[:, 0] if seg_label.ndim == 4 else seg_label
        c = self.num_classes
        # each map's classes, ignored and out-of-range pixels in bin c
        bins = torch.where((label >= 0) & (label < c), label,
                           torch.full_like(label, c)).flatten(1)
        counts = torch.zeros(label.shape[0], c + 1,
                             device=label.device).scatter_add_(
            1, bins, torch.ones_like(bins, dtype=torch.float32))
        present = (counts[:, :c] > 0).to(se_logit.dtype)
        losses['loss_se'] = self.loss_se_decode.get('loss_weight', 0.2) \
            * F.binary_cross_entropy_with_logits(se_logit, present)
        return losses


__all__ = ['CAM', 'CCHead', 'CrissCrossAttention', 'DAHead', 'EMAHead',
           'EMAModule', 'EncHead', 'EncModule', 'Encoding', 'PAM', 'Scale']
