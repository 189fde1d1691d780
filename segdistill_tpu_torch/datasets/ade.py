"""ADE20K dataset (counterpart of ``segdistill_tpu/datasets/ade.py``;
reference ``mmseg/datasets/ade.py:6``)."""

from ..core.evaluation import get_classes, get_palette
from .builder import DATASETS
from .custom import CustomDataset


@DATASETS.register_module()
class ADE20KDataset(CustomDataset):
    """150 classes; annotation index 0 is 'other' -> reduce_zero_label."""

    CLASSES = tuple(get_classes('ade'))
    PALETTE = get_palette('ade')

    def __init__(self, **kwargs):
        super().__init__(img_suffix='.jpg', seg_map_suffix='.png',
                         reduce_zero_label=True, **kwargs)
