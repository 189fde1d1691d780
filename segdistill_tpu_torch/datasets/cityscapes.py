"""Cityscapes dataset (counterpart of
``segdistill_tpu/datasets/cityscapes.py``; reference
``mmseg/datasets/cityscapes.py:15-91``): 19 classes, images
``*_leftImg8bit.png`` beside ``*_gtFine_labelTrainIds.png`` label maps
(train ids, 255 ignored), one folder per city. :meth:`format_results`
writes the official submission's label-id PNGs (``utils/image.py``'s
encoder, no OpenCV).
"""

import os
import os.path as osp
import tempfile

import numpy as np

from ..core.evaluation import get_classes, get_palette
from ..utils import image as imutil
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

    def results2img(self, results, imgfile_prefix, to_label_id=True):
        """Write each result as ``<imgfile_prefix>/<image name>.png``
        (uint8; label ids with ``to_label_id``) -> the paths (ref
        :50-89)."""
        os.makedirs(imgfile_prefix, exist_ok=True)
        result_files = []
        for result, img_info in zip(results, self.img_infos):
            if to_label_id:
                result = self._convert_to_label_id(result)
            basename = osp.splitext(osp.basename(img_info['filename']))[0]
            png_path = osp.join(imgfile_prefix, f'{basename}.png')
            imutil.imwrite(np.asarray(result).astype(np.uint8), png_path)
            result_files.append(png_path)
        return result_files

    def format_results(self, results, imgfile_prefix=None, to_label_id=True):
        """-> (the written files, the temporary directory that holds them
        where no ``imgfile_prefix`` is given, else None) (ref :91-128)."""
        tmp_dir = None
        if imgfile_prefix is None:
            tmp_dir = tempfile.TemporaryDirectory()
            imgfile_prefix = tmp_dir.name
        return self.results2img(results, imgfile_prefix, to_label_id), \
            tmp_dir
