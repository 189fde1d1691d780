"""Segmentor base (counterpart of ``segdistill_tpu/models/segmentors/base.py``;
reference ``mmseg/models/segmentors/base.py``). Loss parsing, feature taps
and result drawing wait for the training port."""

from torch import nn


class BaseSegmentor(nn.Module):
    """Common base of the segmentors: an ``nn.Module`` that knows its
    class count and its heads' ``align_corners``."""

    num_classes = None
    align_corners = False
