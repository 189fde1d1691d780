"""Fast-SCNN backbone (counterpart of
``segdistill_tpu/models/backbones/fast_scnn.py``; reference
``mmseg/models/backbones/fast_scnn.py:13-375``).

NCHW, the reference ``.pth`` layout:

* ``learning_to_downsample``: ``conv``, a 3x3 stride-2 ConvModule with
  mmcv's default padding 0 (odd sizes are part of the contract), then two
  3x3 stride-2 depthwise-separable ConvModules ``dsconv1``, ``dsconv2``:
  the 'higher' map at 1/8;
* ``global_feature_extractor``: three groups ``bottleneck{1,2,3}`` of
  three MobileNetV2 inverted residuals (ReLU6, expand ratio 6, the
  group's stride on its first), the pyramid pooling ``ppm`` of PSPHead
  (scales 1, 2, 3, 6), the concat and a 1x1 ConvModule ``out``: 'lower';
* ``feature_fusion``: 'lower' resized to 'higher''s size, ``dwconv`` (a
  plain 1x1 ConvModule, whatever its name), ``conv_lower_res`` and
  ``conv_higher_res`` (1x1, no activation), the ReLU of their sum.

Returns the maps of ``out_indices`` of ``[higher, lower, fusion]``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import resize
from ..builder import BACKBONES
from ..decode_heads.psp_head import PPM, init_conv_modules
from ..utils import ConvModule, DepthwiseSeparableConvModule, InvertedResidual
from .mix_transformer import _torch_dtype


@BACKBONES.register_module()
class FastSCNN(nn.Module):

    def __init__(self, in_channels=3, downsample_dw_channels=(32, 48),
                 global_in_channels=64, global_block_channels=(64, 96, 128),
                 global_block_strides=(2, 2, 1), global_out_channels=128,
                 higher_in_channels=64, lower_in_channels=128,
                 fusion_out_channels=128, out_indices=(0, 1, 2),
                 norm_cfg=None, act_cfg=None, align_corners=False,
                 pretrained=None, style=None, dtype=None):
        super().__init__()
        del pretrained, style, higher_in_channels, lower_in_channels
        norm_cfg = norm_cfg or dict(type='BN')
        act_cfg = act_cfg or dict(type='ReLU')
        self.out_indices = tuple(out_indices)
        self.align_corners = align_corners
        self.dtype = _torch_dtype(dtype)
        dw1, dw2 = downsample_dw_channels
        ld = self.learning_to_downsample = nn.Module()
        ld.conv = ConvModule(in_channels, dw1, 3, stride=2,
                             norm_cfg=norm_cfg, act_cfg=act_cfg)
        ld.dsconv1 = DepthwiseSeparableConvModule(dw1, dw2, 3, stride=2,
                                                  padding=1,
                                                  norm_cfg=norm_cfg)
        ld.dsconv2 = DepthwiseSeparableConvModule(
            dw2, global_in_channels, 3, stride=2, padding=1,
            norm_cfg=norm_cfg)
        gfe = self.global_feature_extractor = nn.Module()
        inplanes = global_in_channels
        for b, (ch, stride) in enumerate(zip(global_block_channels,
                                             global_block_strides)):
            blocks = []
            for j in range(3):
                blocks.append(InvertedResidual(
                    inplanes, ch, stride if j == 0 else 1, 6,
                    norm_cfg=norm_cfg))
                inplanes = ch
            setattr(gfe, f'bottleneck{b + 1}', nn.Sequential(*blocks))
        pooled = global_block_channels[2] // 4
        gfe.ppm = PPM((1, 2, 3, 6), inplanes, pooled, norm_cfg=norm_cfg,
                      act_cfg=act_cfg, align_corners=align_corners)
        gfe.out = ConvModule(inplanes + 4 * pooled, global_out_channels, 1,
                             norm_cfg=norm_cfg, act_cfg=act_cfg)
        ff = self.feature_fusion = nn.Module()
        ff.dwconv = ConvModule(global_out_channels, fusion_out_channels, 1,
                               norm_cfg=norm_cfg, act_cfg=act_cfg)
        ff.conv_lower_res = ConvModule(fusion_out_channels,
                                       fusion_out_channels, 1,
                                       norm_cfg=norm_cfg, act_cfg=None)
        ff.conv_higher_res = ConvModule(global_in_channels,
                                        fusion_out_channels, 1,
                                        norm_cfg=norm_cfg, act_cfg=None)

    @torch.no_grad()
    def init_weights(self, generator):
        """mmcv's initialisation of each ConvModule (He-normal conv, unit
        norm)."""
        init_conv_modules(self, generator)

    def forward(self, x, generator=None):
        del generator  # nothing random
        x = x.to(self.dtype)
        ld, gfe, ff = (self.learning_to_downsample,
                       self.global_feature_extractor, self.feature_fusion)
        higher = ld.dsconv2(ld.dsconv1(ld.conv(x)))
        g = gfe.bottleneck3(gfe.bottleneck2(gfe.bottleneck1(higher)))
        lower = gfe.out(torch.cat([g] + gfe.ppm(g), dim=1))
        up = resize(lower, size=higher.shape[2:], mode='bilinear',
                    align_corners=self.align_corners)
        up = ff.conv_lower_res(ff.dwconv(up))
        fusion = F.relu(ff.conv_higher_res(higher) + up)
        outs = [higher, lower, fusion]
        return tuple(outs[i] for i in self.out_indices)
