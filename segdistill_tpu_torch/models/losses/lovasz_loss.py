"""Lovasz losses (counterpart of
``segdistill_tpu/models/losses/lovasz_loss.py``; reference
``mmseg/models/losses/lovasz_loss.py``): the Lovasz-Softmax ('multi_class')
and the binary Lovasz hinge, over the batch or ``per_image``.

NCHW scores. As in the JAX package, ignored pixels are not filtered out:
their softmax error is 0, or their hinge error -1e9 with ground truth 0,
so they sort to the end of the descending sort and add nothing; the sort
is stable. ``classes='present'`` averages over the classes the labels
hold, anything else over all classes.
"""

import torch

from ..builder import LOSSES
from .utils import weight_reduce_loss


def _lovasz_grad(gt_sorted):
    """The Lovasz extension's gradient along axis 0 of sorted 0/1 ground
    truth (ref :17-30)."""
    gts = gt_sorted.sum(0)
    intersection = gts - gt_sorted.cumsum(0)
    union = gts + (1.0 - gt_sorted).cumsum(0)
    jaccard = 1.0 - intersection / union.clamp_min(1e-12)
    return torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])


def _lovasz_softmax_flat(probs, labels, valid, classes='present',
                         class_weight=None):
    """probs (P, C) softmax probabilities, labels (P,), valid (P,)."""
    C = probs.shape[1]
    labels = torch.where(valid, labels, -1)
    fg = (labels.unsqueeze(1) == torch.arange(C, device=probs.device)).to(
        probs.dtype)
    errors = (fg - probs).abs() * valid.unsqueeze(1).to(probs.dtype)
    errors, order = errors.sort(dim=0, descending=True, stable=True)
    losses = (errors * _lovasz_grad(fg.gather(0, order))).sum(0)
    if class_weight is not None:
        losses = losses * torch.as_tensor(class_weight, dtype=losses.dtype,
                                          device=losses.device)
    if classes == 'present':
        present = (fg.sum(0) > 0).to(losses.dtype)
        return (losses * present).sum() / present.sum().clamp_min(1.0)
    return losses.mean()


def _lovasz_hinge_flat(logits, labels, valid):
    """The binary Lovasz hinge on flat logits (ref :58-79)."""
    gt = torch.where(valid, labels, 0).to(logits.dtype)
    errors = torch.where(valid, 1.0 - logits * (2.0 * gt - 1.0), -1e9)
    errors, order = errors.sort(descending=True, stable=True)
    return torch.dot(errors.clamp_min(0.0), _lovasz_grad(gt[order]))


def lovasz_hinge(logits, labels, classes=None, per_image=False,
                 class_weight=None, reduction='mean', avg_factor=None,
                 ignore_index=255):
    """``logits`` (N, H, W), ``labels`` (N, H, W) in {0, 1} or the ignore
    index (ref :82-125); ``classes`` and ``class_weight`` are taken and
    unused, as in the reference."""
    del classes, class_weight
    valid = labels != ignore_index
    if per_image:
        loss = torch.stack([
            _lovasz_hinge_flat(lg.flatten(), lb.flatten(), v.flatten())
            for lg, lb, v in zip(logits, labels, valid)])
        return weight_reduce_loss(loss, None, reduction, avg_factor)
    return _lovasz_hinge_flat(logits.flatten(), labels.flatten(),
                              valid.flatten())


def lovasz_softmax(probs, labels, classes='present', per_image=False,
                   class_weight=None, reduction='mean', avg_factor=None,
                   ignore_index=255):
    """``probs`` (N, C, H, W), already softmaxed; ``labels`` (N, H, W)."""
    valid = labels != ignore_index

    def flat(p, lb, v):
        return _lovasz_softmax_flat(p.flatten(1).t(), lb.flatten(),
                                    v.flatten(), classes, class_weight)
    if per_image:
        loss = torch.stack([flat(p, lb, v)
                            for p, lb, v in zip(probs, labels, valid)])
        return weight_reduce_loss(loss, None, reduction, avg_factor)
    return flat(probs.movedim(1, 0), labels, valid)


@LOSSES.register_module()
class LovaszLoss:

    def __init__(self, loss_type='multi_class', classes='present',
                 per_image=False, reduction='mean', class_weight=None,
                 loss_weight=1.0):
        if loss_type not in ('multi_class', 'binary'):
            raise ValueError(f'loss_type {loss_type!r}')
        self.loss_type = loss_type
        self.classes = classes
        self.per_image = per_image
        self.reduction = reduction
        self.class_weight = class_weight
        self.loss_weight = loss_weight

    def __call__(self, cls_score, label, weight=None, avg_factor=None,
                 reduction_override=None, ignore_index=255, **kwargs):
        del weight, kwargs
        reduction = reduction_override or self.reduction
        if self.loss_type == 'binary':
            logits = cls_score.float()
            if logits.ndim == 4 and logits.shape[1] == 1:
                logits = logits[:, 0]  # an (N, 1, H, W) map
            loss = lovasz_hinge(logits, label, per_image=self.per_image,
                                reduction=reduction, avg_factor=avg_factor,
                                ignore_index=ignore_index)
        else:
            loss = lovasz_softmax(cls_score.float().softmax(dim=1), label,
                                  classes=self.classes,
                                  per_image=self.per_image,
                                  class_weight=self.class_weight,
                                  reduction=reduction, avg_factor=avg_factor,
                                  ignore_index=ignore_index)
        return self.loss_weight * loss
