"""Segmentor base (counterpart of ``segdistill_tpu/models/segmentors/base.py``;
reference ``mmseg/models/segmentors/base.py``): loss parsing and the loss-key
prefix. Feature taps are in ``models/utils/taps.py``."""

from torch import nn


def add_prefix(inputs, prefix):
    """{'loss_seg': ...} -> {'<prefix>.loss_seg': ...}."""
    return {f'{prefix}.{k}': v for k, v in inputs.items()}


def parse_losses(losses):
    """(loss dict) -> (total loss, log_vars). Tensors are averaged (the
    reference's ``.mean()``), lists summed; every key holding 'loss' adds
    into the total (ref base.py:174-199)."""
    log_vars = {}
    for name, value in losses.items():
        if isinstance(value, (list, tuple)):
            log_vars[name] = sum(v.mean() for v in value)
        else:
            log_vars[name] = value.mean()
    total = sum(v for k, v in log_vars.items() if 'loss' in k)
    log_vars['loss'] = total
    return total, log_vars


class BaseSegmentor(nn.Module):
    """Common base of the segmentors: an ``nn.Module`` that knows its
    class count and its heads' ``align_corners``."""

    num_classes = None
    align_corners = False
