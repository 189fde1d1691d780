"""MobileNetV3 (counterpart of
``segdistill_tpu/models/backbones/mobilenet_v3.py``; reference
``mmseg/models/backbones/mobilenet_v3.py``).

NCHW, the reference ``.pth`` layout: ``layer0``, a 3x3 stride-2
ConvModule (HSwish) behind a TF-SAME pad (the odd pixel at the bottom and
the right, mmcv's ``Conv2dAdaptivePadding``), ``layer1`` ...
``layer{n}``, :class:`InvertedResidualV3` blocks by the arch table, and a
last 1x1 ConvModule (HSwish) to 576 (small) or 960 (large) channels. The
segmentation conversion of the reference is built in: the small arch's
layers 4 and 9 and the large arch's 7 and 13 keep stride 1, and the
depthwise convs of the next layers are dilated by 2, then by 4 (the
``_SEG`` table), so the output stride is 8. ``reduction_factor`` divides
the widths of the last blocks (small from layer 9, large from layer 13).
Returns the maps of the layers in ``out_indices`` (0 is ``layer0``).
``dtype`` is the compute type; parameters stay float32. Frozen stages are
not ported.
"""

import torch
from torch import nn

from ..builder import BACKBONES
from ..utils import ConvModule, InvertedResidualV3
from ..utils.conv_module import init_conv_norm
from ..utils.norm import NormEvalModule
from ..utils.inverted_residual import pad_same
from .mix_transformer import _torch_dtype

# (kernel, mid channels, out channels, SE, activation, stride)
_ARCH = {
    'small': [(3, 16, 16, True, 'ReLU', 2), (3, 72, 24, False, 'ReLU', 2),
              (3, 88, 24, False, 'ReLU', 1), (5, 96, 40, True, 'HSwish', 2),
              (5, 240, 40, True, 'HSwish', 1),
              (5, 240, 40, True, 'HSwish', 1),
              (5, 120, 48, True, 'HSwish', 1),
              (5, 144, 48, True, 'HSwish', 1),
              (5, 288, 96, True, 'HSwish', 2),
              (5, 576, 96, True, 'HSwish', 1),
              (5, 576, 96, True, 'HSwish', 1)],
    'large': [(3, 16, 16, False, 'ReLU', 1), (3, 64, 24, False, 'ReLU', 2),
              (3, 72, 24, False, 'ReLU', 1), (5, 72, 40, True, 'ReLU', 2),
              (5, 120, 40, True, 'ReLU', 1), (5, 120, 40, True, 'ReLU', 1),
              (3, 240, 80, False, 'HSwish', 2),
              (3, 200, 80, False, 'HSwish', 1),
              (3, 184, 80, False, 'HSwish', 1),
              (3, 184, 80, False, 'HSwish', 1),
              (3, 480, 112, True, 'HSwish', 1),
              (3, 672, 112, True, 'HSwish', 1),
              (5, 672, 160, True, 'HSwish', 2),
              (5, 960, 160, True, 'HSwish', 1),
              (5, 960, 160, True, 'HSwish', 1)],
}
# the segmentation conversion, by layer number: stride 1 there, dilation 2
# and 4 over these ranges
_SEG = {
    'small': dict(stride1={4, 9}, dil2=range(4, 9), dil4=range(9, 13)),
    'large': dict(stride1={7, 13}, dil2=range(7, 13), dil4=range(13, 17)),
}


@BACKBONES.register_module()
class MobileNetV3(NormEvalModule):

    def __init__(self, arch='small', out_indices=(0, 1, 12),
                 frozen_stages=-1, norm_cfg=None, norm_eval=False,
                 reduction_factor=1, with_cp=False, pretrained=None,
                 style=None, dtype=None):
        super().__init__()
        del with_cp, pretrained, style  # no effect on the result
        if frozen_stages != -1:
            raise NotImplementedError('frozen stages are not ported')
        if arch not in _ARCH:
            raise KeyError(f'unknown MobileNetV3 arch {arch}')
        norm_cfg = norm_cfg or dict(type='BN')
        self.out_indices = tuple(out_indices)
        self.norm_eval = norm_eval
        self.dtype = _torch_dtype(dtype)
        seg = _SEG[arch]
        self.layer0 = ConvModule(3, 16, 3, stride=2, norm_cfg=norm_cfg,
                                 act_cfg=dict(type='HSwish'))
        self.layers = ['layer0']
        in_ch = 16
        late = 8 if arch == 'small' else 12
        for i, (k, mid, out_ch, se, act, stride) in enumerate(_ARCH[arch]):
            n = i + 1
            if i >= late:
                mid //= reduction_factor
                out_ch //= reduction_factor
            self.add_module(f'layer{n}', InvertedResidualV3(
                in_ch, out_ch, mid, kernel_size=k,
                stride=1 if n in seg['stride1'] else stride,
                dilation=2 if n in seg['dil2'] else
                4 if n in seg['dil4'] else 1,
                se_cfg=dict(channels=mid, ratio=4) if se else None,
                with_expand_conv=in_ch != mid, norm_cfg=norm_cfg,
                act_cfg=dict(type=act)))
            self.layers.append(f'layer{n}')
            in_ch = out_ch
        n = len(_ARCH[arch]) + 1
        self.add_module(f'layer{n}', ConvModule(
            in_ch, 576 if arch == 'small' else 960, 1, norm_cfg=norm_cfg,
            act_cfg=dict(type='HSwish')))
        self.layers.append(f'layer{n}')

    @torch.no_grad()
    def init_weights(self, generator):
        init_conv_norm(self, generator)

    def forward(self, x, generator=None):
        del generator  # nothing random
        x = pad_same(x.to(self.dtype), 3, 2)
        outs = []
        for i, name in enumerate(self.layers):
            x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
