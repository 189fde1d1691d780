"""Squeeze-and-excitation (counterpart of
``segdistill_tpu/models/utils/se_layer.py``; reference
``mmseg/models/utils/se_layer.py``).

NCHW. The spatial mean, a 1x1 ConvModule to ``make_divisible(channels //
ratio, 8)`` channels (``conv1``, ReLU) and one back (``conv2``, HSigmoid at
bias 3, divisor 6), both biased and without norm, scale the input.
"""

from torch import nn

from .conv_module import ConvModule
from .misc import make_divisible


class SELayer(nn.Module):

    def __init__(self, channels, ratio=16,
                 act_cfg=(dict(type='ReLU'),
                          dict(type='HSigmoid', bias=3.0, divisor=6.0))):
        super().__init__()
        mid = make_divisible(channels // ratio, 8)
        self.conv1 = ConvModule(channels, mid, 1, act_cfg=act_cfg[0])
        self.conv2 = ConvModule(mid, channels, 1, act_cfg=act_cfg[1])

    def forward(self, x):
        return x * self.conv2(self.conv1(x.mean(dim=(2, 3), keepdim=True)))
