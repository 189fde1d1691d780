"""UNet backbone (counterpart of ``segdistill_tpu/models/backbones/
unet.py``; reference ``mmseg/models/backbones/unet.py:13-428`` and
``models/utils/up_conv_block.py``).

NCHW, the reference ``.pth`` layout: ``encoder.{i}`` is a Sequential of a
2x2 max pool (where ``strides[i] == 1 and downsamples[i - 1]``) and a
conv block, so the block sits at ``encoder.{i}.1`` behind a pool and at
``encoder.{i}.0`` otherwise; a conv block's ``convs.{k}`` are 3x3
ConvModules, the first at the stage's stride with dilation 1, the others
at the stage's dilation. ``decoder.{i}`` joins the skip of encoder stage
i: ``upsample`` (an InterpConv, whose 1x1 ConvModule is
``interp_upsample.1``, where stage i + 1 strided or pooled; else a plain
1x1 ConvModule) and ``conv_block`` over the concat ``[skip, d]``. The
InterpConv resizes bilinearly to the skip's size, as the JAX package
does (the reference's scale-2 upsample gives the same size wherever the
sides are even). ``norm_eval`` keeps every BN in eval mode in training.
Returns ``[bottleneck, decoder stages coarse -> fine]``.
"""

import torch
from torch import nn

from ...ops import resize
from ..builder import BACKBONES
from ..utils import ConvModule
from ..utils.conv_module import init_conv_norm
from ..utils.norm import NormEvalModule
from .mix_transformer import _torch_dtype


class BasicConvBlock(nn.Module):
    """``num_convs`` 3x3 ConvModules (ref unet.py:20-80)."""

    def __init__(self, in_channels, out_channels, num_convs=2, stride=1,
                 dilation=1, norm_cfg=None, act_cfg=None):
        super().__init__()
        self.convs = nn.Sequential(*[
            ConvModule(in_channels if k == 0 else out_channels, out_channels,
                       3, stride=stride if k == 0 else 1,
                       dilation=1 if k == 0 else dilation,
                       padding=1 if k == 0 else dilation, norm_cfg=norm_cfg,
                       act_cfg=act_cfg)
            for k in range(num_convs)])

    def forward(self, x):
        return self.convs(x)


class InterpConv(nn.Module):
    """A bilinear resize and a 1x1 ConvModule; slot 0 of
    ``interp_upsample`` is the reference's parameter-free Upsample."""

    def __init__(self, in_channels, out_channels, norm_cfg=None,
                 act_cfg=None):
        super().__init__()
        self.interp_upsample = nn.Sequential(
            nn.Identity(), ConvModule(in_channels, out_channels, 1,
                                      norm_cfg=norm_cfg, act_cfg=act_cfg))

    def forward(self, x, size):
        return self.interp_upsample[1](resize(x, size=size, mode='bilinear',
                                              align_corners=False))


class UpConvBlock(nn.Module):
    """ref up_conv_block.py: the deeper map to the skip's width (and size),
    concatenated after the skip, through a conv block."""

    def __init__(self, in_channels, skip_channels, num_convs, dilation,
                 upsample, norm_cfg=None, act_cfg=None):
        super().__init__()
        self.conv_block = BasicConvBlock(2 * skip_channels, skip_channels,
                                         num_convs, dilation=dilation,
                                         norm_cfg=norm_cfg, act_cfg=act_cfg)
        self.upsample = InterpConv(in_channels, skip_channels, norm_cfg,
                                   act_cfg) if upsample else ConvModule(
            in_channels, skip_channels, 1, norm_cfg=norm_cfg,
            act_cfg=act_cfg)

    def forward(self, skip, x):
        x = self.upsample(x, skip.shape[2:]) \
            if isinstance(self.upsample, InterpConv) else self.upsample(x)
        return self.conv_block(torch.cat([skip, x], dim=1))


@BACKBONES.register_module()
class UNet(NormEvalModule):

    def __init__(self, in_channels=3, base_channels=64, num_stages=5,
                 strides=(1, 1, 1, 1, 1), enc_num_convs=(2, 2, 2, 2, 2),
                 dec_num_convs=(2, 2, 2, 2), downsamples=(True, True, True,
                                                          True),
                 enc_dilations=(1, 1, 1, 1, 1), dec_dilations=(1, 1, 1, 1),
                 norm_cfg=None, act_cfg=None, upsample_cfg=None,
                 norm_eval=False, pretrained=None, style=None,
                 conv_cfg=None, with_cp=False, dtype=None):
        super().__init__()
        del upsample_cfg, pretrained, style, with_cp  # InterpConv only
        if conv_cfg is not None:
            raise NotImplementedError('UNet takes the plain conv only')
        norm_cfg = norm_cfg or dict(type='BN')
        act_cfg = act_cfg or dict(type='ReLU')
        self.norm_eval = norm_eval
        self.dtype = _torch_dtype(dtype)
        self.encoder = nn.ModuleList()
        self.decoder = nn.ModuleList()
        for i in range(num_stages):
            layers = []
            if i > 0:
                if strides[i] == 1 and downsamples[i - 1]:
                    layers.append(nn.MaxPool2d(2))
                self.decoder.append(UpConvBlock(
                    base_channels * 2 ** i, base_channels * 2 ** (i - 1),
                    dec_num_convs[i - 1], dec_dilations[i - 1],
                    strides[i] != 1 or downsamples[i - 1], norm_cfg,
                    act_cfg))
            layers.append(BasicConvBlock(
                in_channels, base_channels * 2 ** i, enc_num_convs[i],
                strides[i], enc_dilations[i], norm_cfg, act_cfg))
            self.encoder.append(nn.Sequential(*layers))
            in_channels = base_channels * 2 ** i

    @torch.no_grad()
    def init_weights(self, generator):
        """He-normal convs and unit norms, as the reference initialises
        without a checkpoint."""
        init_conv_norm(self, generator)

    def forward(self, x, generator=None):
        del generator  # nothing random
        x = x.to(self.dtype)
        skips = []
        for stage in self.encoder:
            x = stage(x)
            skips.append(x)
        outs = [x]
        for i in reversed(range(len(self.decoder))):
            x = self.decoder[i](skips[i], x)
            outs.append(x)
        return tuple(outs)
