"""Cross-entropy losses for segmentation (counterpart of
``segdistill_tpu/models/losses/cross_entropy_loss.py``; reference
``mmseg/models/losses/cross_entropy_loss.py:9-198``).

NCHW logits (class axis 1), integer labels with an ignore index. The
per-pixel loss runs in float32 (the reference heads' ``@force_fp32``) and
is 0 at pixels whose label is the ignore index or outside [0, C).
``use_sigmoid``: binary CE with logits against the one-hot labels, the
ignored pixels folded into the weights; a ``class_weight`` there weighs
the positive term (``BCEWithLogits``' ``pos_weight``), as in the JAX
package. ``use_mask``: per-ROI binary CE on the channel each ROI's label
picks, mean-reduced.
"""

import torch
import torch.nn.functional as F

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


def _bce_with_logits(pred, label):
    return pred.clamp_min(0) - pred * label + torch.log1p(
        torch.exp(-pred.abs()))


def binary_cross_entropy(pred, label, weight=None, reduction='mean',
                         avg_factor=None, class_weight=None,
                         ignore_index=255):
    """Binary CE with logits (``use_sigmoid``). ``pred`` (N, C, H, W);
    ``label`` (N, H, W) integers become one-hot over C, the ignored pixels
    (and labels outside [0, C)) weighted 0; a label of ``pred``'s rank is
    taken as the targets (ref :36-103)."""
    pred = pred.float()
    if pred.ndim != label.ndim:
        num_classes = pred.shape[1]
        valid = (label >= 0) & (label != ignore_index) & (label < num_classes)
        safe = torch.where(valid, label, 0).long()
        valid_w = valid.unsqueeze(1).to(pred.dtype)
        label = F.one_hot(safe, num_classes).movedim(-1, 1).to(pred.dtype) \
            * valid_w
        weight = valid_w if weight is None \
            else weight.unsqueeze(1).to(pred.dtype) * valid_w
        weight = weight.expand(pred.shape)
    label = label.to(pred.dtype)
    if class_weight is None:
        loss = _bce_with_logits(pred, label)
    else:  # BCEWithLogits' pos_weight over the class axis
        cw = torch.as_tensor(class_weight, dtype=pred.dtype,
                             device=pred.device)
        cw = cw.view((1, -1) + (1,) * (pred.ndim - 2))
        loss = -(cw * label * F.logsigmoid(pred)
                 + (1 - label) * F.logsigmoid(-pred))
    return weight_reduce_loss(loss, weight, reduction=reduction,
                              avg_factor=avg_factor)


def mask_cross_entropy(pred, target, label, reduction='mean',
                       avg_factor=None, class_weight=None, ignore_index=None):
    """Per-ROI binary CE with logits (``use_mask``; ref :100-136): ``pred``
    (N, C, *mask), ``label`` (N,) picks each ROI's channel, against
    ``target`` (N, *mask); the mean, with a leading axis of one."""
    if ignore_index is not None:
        raise ValueError('the mask cross-entropy takes no ignore_index')
    if reduction != 'mean' or avg_factor is not None:
        raise ValueError('the mask cross-entropy is mean-reduced')
    index = label.long().view((-1,) + (1,) * (pred.ndim - 1))
    pred_slice = pred.float().gather(
        1, index.expand((-1, 1) + tuple(pred.shape[2:])))[:, 0]
    loss = _bce_with_logits(pred_slice, target.float())
    if class_weight is not None:
        loss = loss * torch.as_tensor(class_weight, dtype=loss.dtype,
                                      device=loss.device)
    return loss.mean().unsqueeze(0)


@LOSSES.register_module()
class CrossEntropyLoss:

    def __init__(self, use_sigmoid=False, use_mask=False, reduction='mean',
                 class_weight=None, loss_weight=1.0):
        if use_sigmoid and use_mask:
            raise ValueError('use_sigmoid and use_mask exclude each other')
        self.use_sigmoid = use_sigmoid
        self.reduction = reduction
        self.class_weight = class_weight
        self.loss_weight = loss_weight
        self.criterion = mask_cross_entropy if use_mask else \
            binary_cross_entropy if use_sigmoid else cross_entropy

    def __call__(self, cls_score, label, weight=None, avg_factor=None,
                 reduction_override=None, **kwargs):
        reduction = reduction_override or self.reduction
        return self.loss_weight * self.criterion(
            cls_score, label, weight, class_weight=self.class_weight,
            reduction=reduction, avg_factor=avg_factor, **kwargs)
