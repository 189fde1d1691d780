from .builder import (DATASETS, LOADER_BACKENDS, PIPELINES, DataLoader,
                      DeviceAugDataLoader, NativeAugDataLoader,
                      build_dataloader, build_dataset, default_collate)
from . import pipelines  # noqa: F401 (registers the transforms)
from .ade import ADE20KDataset
from .cityscapes import CityscapesDataset
from .custom import CustomDataset
from .dataset_wrappers import ConcatDataset, RepeatDataset
from .medical import (ChaseDB1Dataset, DRIVEDataset, HRFDataset,
                      STAREDataset)

__all__ = ['DATASETS', 'LOADER_BACKENDS', 'PIPELINES', 'DataLoader',
           'DeviceAugDataLoader', 'NativeAugDataLoader', 'build_dataloader',
           'build_dataset', 'default_collate', 'ADE20KDataset',
           'ChaseDB1Dataset', 'CityscapesDataset', 'CustomDataset',
           'ConcatDataset', 'DRIVEDataset', 'HRFDataset', 'RepeatDataset',
           'STAREDataset']
