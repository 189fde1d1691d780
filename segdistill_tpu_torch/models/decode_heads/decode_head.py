"""BaseDecodeHead (counterpart of
``segdistill_tpu/models/decode_heads/decode_head.py``; reference
``mmseg/models/decode_heads/decode_head.py:14-237``).

Inputs and logits are NCHW. The classifier output is exposed as a tap
under the classifier's name (``decode_head.conv_seg``, or SegFormerHead's
``decode_head.linear_pred``), the layer the distillation configs hook.

Loss semantics are the reference's: logits resized to the label size, CE
per pixel with 0 at ignored pixels, averaged over all pixels; ``acc_seg``
in percent over all pixels. Softmax CE without class weights or a pixel
sampler, at ``align_corners=False``, goes through :func:`fused_seg_ce`
(kernels K5/K6 on CUDA), which never materialises the label-size logits;
every other loss config takes the plain resize -> loss -> accuracy path,
where a pixel sampler (OHEM) weighs the pixels (ref :222-226).
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...core.seg import build_pixel_sampler
from ...ops import resize
from ...ops.seg_ce import fused_seg_ce
from ..builder import build_loss
from ..losses import accuracy
from ..utils import Dropout, tap


class BaseDecodeHead(nn.Module):
    """Holds the config surface shared by heads, the input selection, the
    per-pixel classifier and the losses.

    ``CLS_LAYER`` names the classifier conv: the reference's ``conv_seg``,
    which this class creates, or a head's own (SegFormerHead's
    ``linear_pred``), which the head creates.
    """

    CLS_LAYER = 'conv_seg'
    # default loss; SegFormerHead overrides it (reduction='none')
    DEFAULT_LOSS = dict(type='CrossEntropyLoss', use_sigmoid=False,
                        loss_weight=1.0)

    def __init__(self, in_channels=None, channels=None, num_classes=19,
                 dropout_ratio=0.1, conv_cfg=None, norm_cfg=None,
                 act_cfg='default', in_index=-1, input_transform=None,
                 loss_decode=None, decoder_params=None, ignore_index=255,
                 sampler=None, align_corners=False):
        super().__init__()
        self.in_channels = in_channels
        self.channels = channels
        self.num_classes = num_classes
        self.norm_cfg = norm_cfg
        self.conv_cfg = conv_cfg
        self.act_cfg = act_cfg  # 'default': ReLU (ref :71)
        self.in_index = in_index
        self.input_transform = input_transform
        self.loss_decode = loss_decode
        self.decoder_params = decoder_params
        self.ignore_index = ignore_index
        self.align_corners = align_corners
        self.sampler = None if sampler is None else build_pixel_sampler(
            dict(sampler), context=self)
        # the reference's nn.Dropout2d: drops whole channels in training
        self.dropout = Dropout(dropout_ratio, channels=True) \
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

    @torch.no_grad()
    def init_cls_seg(self, generator):
        """The classifier's N(0, 0.01) weight and zero bias (ref :104-106),
        drawn from ``generator``."""
        conv = getattr(self, self.CLS_LAYER)
        conv.weight.normal_(0, 0.01, generator=generator)
        nn.init.zeros_(conv.bias)

    def cls_seg(self, feat, generator=None):
        """Per-pixel classifier (ref :210-215), in the features' dtype."""
        if self.dropout is not None:
            feat = self.dropout(feat, generator)
        conv = getattr(self, self.CLS_LAYER)
        bias = None if conv.bias is None else conv.bias.to(feat.dtype)
        out = F.conv2d(feat, conv.weight.to(feat.dtype), bias)
        return tap(self, self.CLS_LAYER, out)

    def _loss_cfg(self):
        return dict(self.loss_decode or self.DEFAULT_LOSS)

    def _fused_ce_eligible(self, loss_cfg, seg_weight):
        return (loss_cfg.get('type') == 'CrossEntropyLoss'
                and not loss_cfg.get('use_sigmoid', False)
                and loss_cfg.get('class_weight') is None
                and seg_weight is None and self.sampler is None
                and not self.align_corners)

    def losses(self, seg_logit, seg_label, seg_weight=None):
        """(logits (B, C, h, w), labels (B, H, W) or (B, 1, H, W)) ->
        {'loss_seg', 'acc_seg'} (ref :217-237)."""
        if seg_label.ndim == 4:
            seg_label = seg_label[:, 0]
        loss_cfg = self._loss_cfg()
        if self._fused_ce_eligible(loss_cfg, seg_weight):
            ce_sum, correct = fused_seg_ce(
                seg_logit, seg_label, seg_label.shape[1:], self.num_classes,
                self.ignore_index)
            total = seg_label.numel()
            return {'loss_seg': loss_cfg.get('loss_weight', 1.0) * ce_sum
                    / total,
                    'acc_seg': correct * (100.0 / total)}
        seg_logit = resize(seg_logit.float(), size=seg_label.shape[1:],
                           mode='bilinear', align_corners=self.align_corners)
        if self.sampler is not None and seg_weight is None:
            seg_weight = self.sampler.sample(seg_logit, seg_label)
        loss_fn = build_loss(loss_cfg)
        return {'loss_seg': loss_fn(seg_logit, seg_label, weight=seg_weight,
                                    ignore_index=self.ignore_index),
                'acc_seg': accuracy(seg_logit, seg_label)}
