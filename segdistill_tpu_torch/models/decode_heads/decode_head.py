"""BaseDecodeHead, inference side (counterpart of
``segdistill_tpu/models/decode_heads/decode_head.py``; reference
``mmseg/models/decode_heads/decode_head.py:14-237``).

Inputs and logits are NCHW. The loss side waits for the training port.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import resize


class BaseDecodeHead(nn.Module):
    """Holds the config surface shared by heads, the input selection and
    the per-pixel classifier.

    ``CLS_LAYER`` names the classifier conv: the reference's ``conv_seg``,
    which this class creates, or a head's own (SegFormerHead's
    ``linear_pred``), which the head creates.
    """

    CLS_LAYER = 'conv_seg'

    def __init__(self, in_channels=None, channels=None, num_classes=19,
                 dropout_ratio=0.1, conv_cfg=None, norm_cfg=None,
                 act_cfg='default', in_index=-1, input_transform=None,
                 loss_decode=None, decoder_params=None, ignore_index=255,
                 sampler=None, align_corners=False):
        super().__init__()
        # loss-side settings, used by the training port
        del conv_cfg, act_cfg, loss_decode, ignore_index, sampler
        self.in_channels = in_channels
        self.channels = channels
        self.num_classes = num_classes
        self.norm_cfg = norm_cfg
        self.in_index = in_index
        self.input_transform = input_transform
        self.decoder_params = decoder_params
        self.align_corners = align_corners
        # the reference's nn.Dropout2d: drops whole channels in training
        self.dropout = nn.Dropout2d(dropout_ratio) \
            if dropout_ratio > 0 else None
        if self.CLS_LAYER == 'conv_seg':
            self.conv_seg = nn.Conv2d(channels, num_classes, kernel_size=1)

    def _transform_inputs(self, inputs):
        """resize_concat / multiple_select / single index (ref :139-164)."""
        if self.input_transform == 'resize_concat':
            sel = [inputs[i] for i in self.in_index]
            ups = [resize(x, size=sel[0].shape[2:], mode='bilinear',
                          align_corners=self.align_corners) for x in sel]
            return torch.cat(ups, dim=1)
        if self.input_transform == 'multiple_select':
            return [inputs[i] for i in self.in_index]
        return inputs[self.in_index]

    def cls_seg(self, feat):
        """Per-pixel classifier (ref :210-215), in the features' dtype."""
        if self.dropout is not None:
            feat = self.dropout(feat)
        conv = getattr(self, self.CLS_LAYER)
        bias = None if conv.bias is None else conv.bias.to(feat.dtype)
        return F.conv2d(feat, conv.weight.to(feat.dtype), bias)
