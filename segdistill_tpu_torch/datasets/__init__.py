from .builder import (DATASETS, PIPELINES, DataLoader, build_dataloader,
                      build_dataset, default_collate)
from . import pipelines  # noqa: F401 (registers the transforms)
from .ade import ADE20KDataset
from .cityscapes import CityscapesDataset
from .custom import CustomDataset
from .dataset_wrappers import ConcatDataset, RepeatDataset

__all__ = ['DATASETS', 'PIPELINES', 'DataLoader', 'build_dataloader',
           'build_dataset', 'default_collate', 'ADE20KDataset',
           'CityscapesDataset', 'CustomDataset', 'ConcatDataset',
           'RepeatDataset']
