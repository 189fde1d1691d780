"""COCO-Stuff 10k and Mapillary Vistas (counterpart of
``segdistill_tpu/datasets/coco_stuff.py``; reference
``mmseg/datasets/{coco_stuff.py, mapillary.py}``)."""

from ..core.evaluation import get_classes, get_palette
from .builder import DATASETS
from .custom import CustomDataset


@DATASETS.register_module()
class CocoStuffDataset(CustomDataset):
    """171 classes: the converted ``*_labelTrainIds.png`` hold 0 for
    unlabeled and the classes from 1, shifted down by
    ``reduce_zero_label``."""

    CLASSES = tuple(f'class_{i}' for i in range(171))
    PALETTE = [[(37 * i) % 255, (91 * i) % 255, (173 * i) % 255]
               for i in range(171)]

    def __init__(self, **kwargs):
        super().__init__(img_suffix='.jpg',
                         seg_map_suffix='_labelTrainIds.png',
                         reduce_zero_label=True, **kwargs)


@DATASETS.register_module()
class MapillaryDataset(CustomDataset):
    """Mapillary Vistas under the 19 Cityscapes classes: its 66 labels are
    mapped onto them by the ``MaillaryHack`` transform, which the
    pipeline must name after ``LoadAnnotations``."""

    CLASSES = tuple(get_classes('cityscapes'))
    PALETTE = get_palette('cityscapes')

    def __init__(self, **kwargs):
        super().__init__(img_suffix='.jpg', seg_map_suffix='.png',
                         reduce_zero_label=False, **kwargs)
