from .builder import (DATASETS, LOADER_BACKENDS, PIPELINES, DataLoader,
                      DeviceAugDataLoader, NativeAugDataLoader,
                      build_dataloader, build_dataset, default_collate)
from . import pipelines  # noqa: F401 (registers the transforms)
from .ade import ADE20KDataset
from .cityscapes import CityscapesDataset
from .coco_stuff import CocoStuffDataset, MapillaryDataset
from .custom import CustomDataset
from .dataset_wrappers import ConcatDataset, RepeatDataset
from .medical import (ChaseDB1Dataset, DRIVEDataset, HRFDataset,
                      STAREDataset)
from .pascal_context import PascalContextDataset
from .voc import PascalVOCDataset

__all__ = ['DATASETS', 'LOADER_BACKENDS', 'PIPELINES', 'DataLoader',
           'DeviceAugDataLoader', 'NativeAugDataLoader', 'build_dataloader',
           'build_dataset', 'default_collate', 'ADE20KDataset',
           'ChaseDB1Dataset', 'CityscapesDataset', 'CocoStuffDataset',
           'CustomDataset', 'ConcatDataset', 'DRIVEDataset', 'HRFDataset',
           'MapillaryDataset', 'PascalContextDataset', 'PascalVOCDataset',
           'RepeatDataset', 'STAREDataset']
