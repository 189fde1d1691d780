from .compose import Compose
from .formatting import Collect, ImageToTensor
from .test_time_aug import MultiScaleFlipAug
from .transforms import AlignedResize, Normalize, RandomFlip, Resize

__all__ = ['Compose', 'Collect', 'ImageToTensor', 'MultiScaleFlipAug',
           'AlignedResize', 'Normalize', 'RandomFlip', 'Resize']
