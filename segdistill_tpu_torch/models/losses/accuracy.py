"""Pixel accuracy (counterpart of ``segdistill_tpu/models/losses/
accuracy.py``; reference ``mmseg/models/losses/accuracy.py:4-50``).

The denominator is every pixel: ignored pixels count as incorrect, since
no class id equals the ignore index. Scaled to percent. Logits are NCHW
(class axis 1).
"""

import torch


def accuracy(pred, target, topk=1, thresh=None):
    """pred: (N, C, ...) logits; target: (N, ...) int labels."""
    single = isinstance(topk, int)
    topk = (topk,) if single else tuple(topk)
    if max(topk) == 1:  # argmax: the first of tied maxima, as in JAX
        pred_value, pred_label = pred.max(dim=1, keepdim=True)
    else:
        pred_value, pred_label = pred.topk(max(topk), dim=1)
    correct = pred_label == target.unsqueeze(1)
    if thresh is not None:
        correct = correct & (pred_value > thresh)
    res = [correct[:, :k].sum().to(torch.float32) * (100.0 / target.numel())
           for k in topk]
    return res[0] if single else res


class Accuracy:
    """:func:`accuracy` with its ``topk`` and ``thresh`` bound (ref
    :38-50)."""

    def __init__(self, topk=(1,), thresh=None):
        self.topk = topk
        self.thresh = thresh

    def __call__(self, pred, target):
        return accuracy(pred, target, self.topk, self.thresh)
