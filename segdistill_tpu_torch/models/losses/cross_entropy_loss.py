"""Softmax cross-entropy for segmentation (counterpart of
``segdistill_tpu/models/losses/cross_entropy_loss.py``; reference
``mmseg/models/losses/cross_entropy_loss.py:9-198``).

NCHW logits (class axis 1), integer labels with an ignore index. The
per-pixel loss runs in float32 (the reference heads' ``@force_fp32``) and
is 0 at pixels whose label is the ignore index or outside [0, C). The
sigmoid and mask forms wait for the heads that use them.
"""

import torch

from ..builder import LOSSES
from .utils import weight_reduce_loss


def _per_pixel_ce(pred, label, class_weight=None, ignore_index=-100):
    pred = pred.float()
    valid = (label != ignore_index) & (label >= 0) & (label < pred.shape[1])
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    loss = torch.logsumexp(pred, dim=1) \
        - pred.gather(1, safe.unsqueeze(1)).squeeze(1)
    if class_weight is not None:
        loss = loss * torch.as_tensor(class_weight, dtype=loss.dtype,
                                      device=loss.device)[safe]
    return torch.where(valid, loss, torch.zeros_like(loss))


def cross_entropy(pred, label, weight=None, class_weight=None,
                  reduction='mean', avg_factor=None, ignore_index=-100):
    loss = _per_pixel_ce(pred, label, class_weight, ignore_index)
    if weight is not None:
        weight = weight.float()
    return weight_reduce_loss(loss, weight=weight, reduction=reduction,
                              avg_factor=avg_factor)


@LOSSES.register_module()
class CrossEntropyLoss:

    def __init__(self, use_sigmoid=False, use_mask=False, reduction='mean',
                 class_weight=None, loss_weight=1.0):
        if use_sigmoid or use_mask:
            raise NotImplementedError(
                'the sigmoid and mask cross-entropy forms are not ported '
                'yet; the ported heads use the softmax form')
        self.reduction = reduction
        self.class_weight = class_weight
        self.loss_weight = loss_weight

    def __call__(self, cls_score, label, weight=None, avg_factor=None,
                 reduction_override=None, **kwargs):
        reduction = reduction_override or self.reduction
        return self.loss_weight * cross_entropy(
            cls_score, label, weight, class_weight=self.class_weight,
            reduction=reduction, avg_factor=avg_factor, **kwargs)
