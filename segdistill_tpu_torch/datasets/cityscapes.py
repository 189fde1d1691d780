"""Cityscapes dataset (counterpart of
``segdistill_tpu/datasets/cityscapes.py``; reference
``mmseg/datasets/cityscapes.py:15-91``): 19 classes, images
``*_leftImg8bit.png`` beside ``*_gtFine_labelTrainIds.png`` label maps
(train ids, 255 ignored), one folder per city. Writing submission files
(``results2img``, ``format_results``) needs an image writer, which the
port's ``utils/image.py`` does not have yet.
"""

import numpy as np

from ..core.evaluation import get_classes, get_palette
from .builder import DATASETS
from .custom import CustomDataset

# train id -> Cityscapes label id (the official submission's ids)
TRAIN_TO_LABEL_ID = {0: 7, 1: 8, 2: 11, 3: 12, 4: 13, 5: 17, 6: 19, 7: 20,
                     8: 21, 9: 22, 10: 23, 11: 24, 12: 25, 13: 26, 14: 27,
                     15: 28, 16: 31, 17: 32, 18: 33}


@DATASETS.register_module()
class CityscapesDataset(CustomDataset):

    CLASSES = tuple(get_classes('cityscapes'))
    PALETTE = get_palette('cityscapes')

    def __init__(self, **kwargs):
        super().__init__(img_suffix='_leftImg8bit.png',
                         seg_map_suffix='_gtFine_labelTrainIds.png',
                         **kwargs)

    @staticmethod
    def _convert_to_label_id(result):
        """Train ids -> label ids (ref :33-47); other values stay."""
        result = np.asarray(result)
        out = result.copy()
        for train_id, label_id in TRAIN_TO_LABEL_ID.items():
            out[result == train_id] = label_id
        return out
