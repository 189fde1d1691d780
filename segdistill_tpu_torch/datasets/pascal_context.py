"""Pascal Context, 60 classes (counterpart of
``segdistill_tpu/datasets/pascal_context.py``; reference
``mmseg/datasets/pascal_context.py``): ``JPEGImages/*.jpg`` beside the
converted ``SegmentationClassContext/*.png`` (class indices, 0 the
background), one split file of names."""

from .builder import DATASETS
from .custom import CustomDataset


@DATASETS.register_module()
class PascalContextDataset(CustomDataset):

    CLASSES = (
        'background', 'aeroplane', 'bag', 'bed', 'bedclothes', 'bench',
        'bicycle', 'bird', 'boat', 'book', 'bottle', 'building', 'bus',
        'cabinet', 'car', 'cat', 'ceiling', 'chair', 'cloth',
        'computer', 'cow', 'cup', 'curtain', 'dog', 'door', 'fence',
        'floor', 'flower', 'food', 'grass', 'ground', 'horse', 'keyboard',
        'light', 'motorbike', 'mountain', 'mouse', 'person', 'plate',
        'platform', 'pottedplant', 'road', 'rock', 'sheep', 'shelves',
        'sidewalk', 'sign', 'sky', 'snow', 'sofa', 'table', 'track',
        'train', 'tree', 'truck', 'tvmonitor', 'wall', 'water', 'window',
        'wood')

    # the JAX package's gray placeholder palette, kept so that painted
    # results agree
    PALETTE = [[i, i, i] for i in range(60)]

    def __init__(self, split, **kwargs):
        super().__init__(img_suffix='.jpg', seg_map_suffix='.png',
                         split=split, reduce_zero_label=False, **kwargs)
