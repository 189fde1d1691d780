"""Pascal VOC 2012 (counterpart of ``segdistill_tpu/datasets/voc.py``;
reference ``mmseg/datasets/voc.py``): 21 classes, ``JPEGImages/*.jpg``
beside ``SegmentationClass/*.png`` (palette PNGs, read as their indices)
or the SBD labels converted into ``SegmentationClassAug`` (gray PNGs), one
split file of names. The augmented set (``datasets/pascal_voc12_aug.py``)
lists two ``ann_dir`` and two ``split``: ``build_dataset`` makes a
ConcatDataset of the pairs."""

from ..core.evaluation import get_classes, get_palette
from .builder import DATASETS
from .custom import CustomDataset


@DATASETS.register_module()
class PascalVOCDataset(CustomDataset):

    CLASSES = tuple(get_classes('voc'))
    PALETTE = get_palette('voc')

    def __init__(self, split, **kwargs):
        super().__init__(img_suffix='.jpg', seg_map_suffix='.png',
                         split=split, **kwargs)
        assert self.split is not None
