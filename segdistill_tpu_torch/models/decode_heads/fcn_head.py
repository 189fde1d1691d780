"""FCNHead, also the auxiliary head of the ResNet configs (counterpart of
``segdistill_tpu/models/decode_heads/fcn_head.py``; reference
``mmseg/models/decode_heads/fcn_head.py``).

NCHW. ``num_convs`` ConvModules (``convs.{i}``), then with
``concat_input`` one more over the input and their output concatenated
(``conv_cat``), then the classifier, whose output is the ``conv_seg`` tap.
Its loss is the base head's: softmax CE through K5/K6 on CUDA.
"""

import torch
from torch import nn

from ..builder import HEADS
from ..utils import ConvModule
from .decode_head import BaseDecodeHead
from .psp_head import init_conv_modules


@HEADS.register_module()
class FCNHead(BaseDecodeHead):

    def __init__(self, num_convs=2, kernel_size=3, concat_input=True,
                 **kwargs):
        super().__init__(**kwargs)
        if num_convs == 0 and self.in_channels != self.channels:
            raise ValueError('num_convs=0 needs in_channels == channels')
        conv = dict(conv_cfg=self.conv_cfg, norm_cfg=self.norm_cfg,
                    act_cfg=self.act_cfg)
        pad = kernel_size // 2
        self.convs = nn.Sequential(*[
            ConvModule(self.in_channels if i == 0 else self.channels,
                       self.channels, kernel_size, padding=pad, **conv)
            for i in range(num_convs)])
        self.conv_cat = ConvModule(
            self.in_channels + self.channels, self.channels, kernel_size,
            padding=pad, **conv) if concat_input else None

    @torch.no_grad()
    def init_weights(self, generator):
        init_conv_modules(self, generator)
        self.init_cls_seg(generator)

    def forward(self, inputs, generator=None):
        x = self._transform_inputs(inputs)
        out = self.convs(x)
        if self.conv_cat is not None:
            out = self.conv_cat(torch.cat([x, out], dim=1))
        return self.cls_seg(out, generator)
