"""HRNet (counterpart of ``segdistill_tpu/models/backbones/hrnet.py``;
reference ``mmseg/models/backbones/hrnet.py:212-555``).

NCHW, the reference ``.pth`` layout: the stem ``conv1``/``bn1``,
``conv2``/``bn2`` (two bare stride-2 3x3 convs, BN and ReLU: stride 4),
``layer1`` (stage 1: one branch of blocks), then per stage 2-4
``transition{s-1}.{i}`` and ``stage{s}.{m}`` modules of
``branches.{i}.{k}`` blocks and ``fuse_layers.{i}.{j}``. Sizes come from
the config's ``extra`` dict (stage1..stage4: num_modules, num_branches,
block 'BASIC' or 'BOTTLENECK', num_blocks, num_channels); the blocks are
the port's ResNet blocks.

A transition adapts an existing branch whose width changes (3x3 conv, BN,
ReLU: ``transition.{i}.{0,1}``) or adds a branch by a chain of stride-2
3x3 conv, BN, ReLU steps (``transition.{i}.{k}.{0,1}``; only the last
changes the width); as in the reference, every transition is fed the
previous stage's LAST branch. A fuse layer sums into each output branch i
every branch j: j > i through a 1x1 conv and BN (``fuse_layers.{i}.{j}.
{0,1}``) and one bilinear resize (align_corners False) to branch i's size;
j < i through i - j stride-2 3x3 conv and BN steps, ReLU between them
(``fuse_layers.{i}.{j}.{k}.{0,1}``); then a ReLU. The reference upsamples
by 2^(j-i) and resizes that to the target's size; on inputs whose branch
sizes are exact multiples (any /32-divisible image) the two agree, and the
port follows the JAX package's single resize (ROADMAP, known faults on
the reference side). Returns every branch of the last stage.
``dtype`` is the compute type; parameters stay float32.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import resize
from ..builder import BACKBONES
from ..utils.conv_module import Conv2d, init_conv_norm
from ..utils.norm import NormEvalModule
from .mix_transformer import _torch_dtype
from .resnet import BasicBlock, Bottleneck, _downsample, _norm

BLOCKS = {'BASIC': BasicBlock, 'BOTTLENECK': Bottleneck}


def _conv_bn(in_ch, out_ch, kernel, stride, norm_cfg, relu):
    """Sequential(conv, BN[, ReLU]), the reference's unnamed slots."""
    layers = [Conv2d(in_ch, out_ch, kernel, stride, kernel // 2, bias=False),
              _norm(norm_cfg, out_ch)]
    return nn.Sequential(*layers, nn.ReLU()) if relu else \
        nn.Sequential(*layers)


def _blocks(block, in_ch, planes, n, norm_cfg):
    """``n`` blocks of ``planes``; the first with a 1x1 shortcut where the
    width changes."""
    out_ch = planes * block.expansion
    ds = _downsample(in_ch, out_ch, 1, False, norm_cfg) \
        if in_ch != out_ch else None
    return nn.Sequential(
        block(in_ch, planes, downsample=ds, norm_cfg=norm_cfg),
        *[block(out_ch, planes, norm_cfg=norm_cfg) for _ in range(n - 1)])


class HRModule(nn.Module):
    """One module of a stage: a run of blocks on each branch, then the
    fuse layers."""

    def __init__(self, block, num_blocks, in_channels, num_channels,
                 norm_cfg):
        super().__init__()
        nb = len(num_channels)
        self.branches = nn.ModuleList(
            _blocks(block, in_channels[i], num_channels[i], num_blocks[i],
                    norm_cfg) for i in range(nb))
        ch = [c * block.expansion for c in num_channels]
        self.fuse_layers = nn.ModuleList()
        for i in range(nb):
            fuse = []
            for j in range(nb):
                if j > i:
                    fuse.append(_conv_bn(ch[j], ch[i], 1, 1, norm_cfg, False))
                elif j == i:
                    fuse.append(None)
                else:
                    fuse.append(nn.Sequential(*[
                        _conv_bn(ch[j], ch[i] if k == i - j - 1 else ch[j], 3,
                                 2, norm_cfg, k < i - j - 1)
                        for k in range(i - j)]))
            self.fuse_layers.append(nn.ModuleList(fuse))

    def forward(self, xs):
        xs = [branch(x) for branch, x in zip(self.branches, xs)]
        outs = []
        for i, fuse in enumerate(self.fuse_layers):
            acc = None
            for j, layer in enumerate(fuse):
                y = xs[j]
                if j > i:
                    y = resize(layer(y), size=xs[i].shape[2:],
                               mode='bilinear', align_corners=False)
                elif j < i:
                    y = layer(y)
                acc = y if acc is None else acc + y
            outs.append(F.relu(acc))
        return outs


@BACKBONES.register_module()
class HRNet(NormEvalModule):

    def __init__(self, extra, in_channels=3, norm_cfg=None, norm_eval=False,
                 with_cp=False, zero_init_residual=False, pretrained=None,
                 style=None, dtype=None):
        super().__init__()
        del with_cp, pretrained, style  # no effect on the result
        norm_cfg = norm_cfg or dict(type='BN')
        self.norm_eval = norm_eval
        self.zero_init_residual = zero_init_residual
        self.dtype = _torch_dtype(dtype)
        self.conv1 = Conv2d(in_channels, 64, 3, 2, 1, bias=False)
        self.bn1 = _norm(norm_cfg, 64)
        self.conv2 = Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = _norm(norm_cfg, 64)
        s1 = extra['stage1']
        block = BLOCKS[s1['block']]
        self.layer1 = _blocks(block, 64, s1['num_channels'][0],
                              s1['num_blocks'][0], norm_cfg)
        pre = [s1['num_channels'][0] * block.expansion]
        for s in (2, 3, 4):
            cfg = extra[f'stage{s}']
            block = BLOCKS[cfg['block']]
            cur = [c * block.expansion for c in cfg['num_channels']]
            self.add_module(f'transition{s - 1}',
                            self._transition(pre, cur, norm_cfg))
            modules = []
            for _ in range(cfg['num_modules']):
                modules.append(HRModule(block, cfg['num_blocks'], cur,
                                        cfg['num_channels'], norm_cfg))
            self.add_module(f'stage{s}', nn.Sequential(*modules))
            pre = cur

    @staticmethod
    def _transition(pre, cur, norm_cfg):
        layers = []
        for i, c in enumerate(cur):
            if i < len(pre):
                layers.append(None if pre[i] == c else
                              _conv_bn(pre[i], c, 3, 1, norm_cfg, True))
            else:
                steps = i + 1 - len(pre)
                layers.append(nn.Sequential(*[
                    _conv_bn(pre[-1], c if k == steps - 1 else pre[-1], 3, 2,
                             norm_cfg, True) for k in range(steps)]))
        return nn.ModuleList(layers)

    @torch.no_grad()
    def init_weights(self, generator):
        """He-normal convs and unit BN; with ``zero_init_residual`` each
        block's last BN weight 0."""
        init_conv_norm(self, generator)
        if self.zero_init_residual:
            for m in self.modules():
                if isinstance(m, (BasicBlock, Bottleneck)):
                    nn.init.zeros_(m.last_norm().weight)

    def forward(self, x, generator=None):
        del generator  # nothing random
        x = F.relu(self.bn1(self.conv1(x.to(self.dtype))))
        x = F.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for s in (2, 3, 4):
            transition = getattr(self, f'transition{s - 1}')
            xs = [xs[i] if t is None else t(xs[-1])
                  for i, t in enumerate(transition)]
            for module in getattr(self, f'stage{s}'):
                xs = module(xs)
        return tuple(xs)
