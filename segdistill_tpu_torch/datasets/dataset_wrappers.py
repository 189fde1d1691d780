"""Concat and Repeat wrappers (counterpart of
``segdistill_tpu/datasets/dataset_wrappers.py``; reference
``mmseg/datasets/dataset_wrappers.py:6-50``)."""

import bisect

from .builder import DATASETS, getitem_with_rng


@DATASETS.register_module()
class ConcatDataset:

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.CLASSES = self.datasets[0].CLASSES
        self.PALETTE = self.datasets[0].PALETTE
        self.cumulative_sizes = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cumulative_sizes.append(total)

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx, rng=None):
        if idx < 0:
            idx = len(self) + idx
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        sample_idx = idx if ds_idx == 0 \
            else idx - self.cumulative_sizes[ds_idx - 1]
        return getitem_with_rng(self.datasets[ds_idx], sample_idx, rng)


@DATASETS.register_module()
class RepeatDataset:

    def __init__(self, dataset, times):
        self.dataset = dataset
        self.times = times
        self.CLASSES = dataset.CLASSES
        self.PALETTE = dataset.PALETTE
        self._ori_len = len(dataset)

    def __getitem__(self, idx, rng=None):
        return getitem_with_rng(self.dataset, idx % self._ori_len, rng)

    def __len__(self):
        return self.times * self._ori_len

    def evaluate(self, *args, **kwargs):
        return self.dataset.evaluate(*args, **kwargs)
