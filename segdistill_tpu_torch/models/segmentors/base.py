"""Segmentor base (counterpart of ``segdistill_tpu/models/segmentors/base.py``;
reference ``mmseg/models/segmentors/base.py``): loss parsing and the
painting of a result over its image. Feature taps are in
``models/utils/taps.py``, ``add_prefix`` in ``core/utils/misc.py``."""

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ...core.utils import add_prefix  # noqa: F401 (the segmentors' import)
from ...parallel import get_dist_info


def parse_losses(losses):
    """(loss dict) -> (total loss, log_vars). Tensors are averaged (the
    reference's ``.mean()``), lists summed; every key holding 'loss' adds
    into the total (ref base.py:174-199). Across processes the log vars
    are averaged over the ranks, all in one all-reduce (ref
    base.py:202-207), while the total is the rank's own, for its
    backward."""
    log_vars = {}
    for name, value in losses.items():
        if isinstance(value, (list, tuple)):
            log_vars[name] = sum(v.mean() for v in value)
        else:
            log_vars[name] = value.mean()
    total = sum(v for k, v in log_vars.items() if 'loss' in k)
    log_vars['loss'] = total
    return total, _mean_over_ranks(log_vars)


def _mean_over_ranks(log_vars):
    """The log vars averaged over the ranks (float32), or as they are in
    one process."""
    world = get_dist_info()[1]
    if world == 1:
        return log_vars
    values = torch.stack([v.detach().float() for v in log_vars.values()])
    dist.all_reduce(values)
    return dict(zip(log_vars, values.div_(world)))


class BaseSegmentor(nn.Module):
    """Common base of the segmentors: an ``nn.Module`` that knows its
    class count and its heads' ``align_corners``."""

    num_classes = None
    align_corners = False

    def show_result(self, img, result, palette=None, classes=None,
                    opacity=0.5):
        """Paint the label map ``result`` over the HWC BGR image ``img``:
        each class its ``palette`` colour (RGB; seeded colours by
        default, one a class), blended at ``opacity`` -> uint8 BGR (ref
        base.py:211-273, the JAX package's blend)."""
        seg = np.asarray(result)
        if palette is None:
            n = int(seg.max()) + 1 if self.num_classes is None \
                else self.num_classes
            palette = np.random.RandomState(42).randint(0, 255, size=(n, 3))
        color_seg = np.asarray(palette, dtype=np.uint8)[seg]
        img = np.asarray(img).astype(np.float32)
        out = img * (1 - opacity) + color_seg[..., ::-1] * opacity
        return out.astype(np.uint8)
