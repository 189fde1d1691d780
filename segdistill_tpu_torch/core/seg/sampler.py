"""Pixel samplers (counterpart of ``segdistill_tpu/core/seg/sampler.py``;
reference ``mmseg/core/seg/sampler/ohem_pixel_sampler.py:8-76``).

OHEM keeps the hardest pixels as a 0/1 weight map. Its threshold is the
k-th value of a sort over the whole batch, as the JAX package takes it
with ``top_k``: the pixels kept are the same set.
"""

import torch

from .builder import PIXEL_SAMPLERS


class BasePixelSampler:

    def sample(self, seg_logit, seg_label):
        raise NotImplementedError


@PIXEL_SAMPLERS.register_module()
class OHEMPixelSampler(BasePixelSampler):
    """``sample(seg_logit (B, C, H, W), seg_label (B, H, W))`` -> float32
    weights (B, H, W), 1 on the pixels kept."""

    def __init__(self, context=None, thresh=None, min_kept=100000,
                 ignore_index=255):
        if min_kept <= 1:
            raise ValueError(f'min_kept must be > 1, got {min_kept}')
        self.context = context
        self.thresh = thresh
        self.min_kept = min_kept
        self.ignore_index = ignore_index

    @torch.no_grad()
    def sample(self, seg_logit, seg_label):
        valid = seg_label != self.ignore_index
        min_kept = min(self.min_kept * seg_logit.shape[0], valid.numel())
        logit = seg_logit.float()
        safe = torch.where(valid, seg_label, 0).long().unsqueeze(1)
        if self.thresh is not None:
            gt_prob = logit.softmax(dim=1).gather(1, safe).squeeze(1)
            # ignored pixels at 2, so they sort to the easy end
            gt_prob = torch.where(valid, gt_prob, 2.0).flatten()
            # the reference reads sort_prob[min_kept], 0-based
            k = min(min_kept + 1, gt_prob.numel())
            kth = gt_prob.kthvalue(k).values
            threshold = torch.clamp(kth, min=self.thresh)
            keep = (gt_prob < threshold) & valid.flatten()
        else:  # the min_kept largest CE losses
            loss = torch.logsumexp(logit, dim=1) \
                - logit.gather(1, safe).squeeze(1)
            loss = torch.where(valid, loss, -torch.inf).flatten()
            kth = loss.topk(min_kept).values[-1]
            keep = (loss >= kth) & valid.flatten()
        return keep.view(seg_label.shape).float()
