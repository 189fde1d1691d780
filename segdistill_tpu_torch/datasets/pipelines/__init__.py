from .compose import Compose
from .formatting import (Collect, DefaultFormatBundle, ImageToTensor,
                         ToTensor, Transpose)
from .loading import LoadAnnotations, LoadImageFromFile
from .test_time_aug import MultiScaleFlipAug
from .transforms import (AlignedResize, Normalize, Pad,
                         PhotoMetricDistortion, RandomCrop, RandomFlip,
                         Resize)

__all__ = ['Compose', 'Collect', 'DefaultFormatBundle', 'ImageToTensor',
           'ToTensor', 'Transpose', 'LoadAnnotations', 'LoadImageFromFile',
           'MultiScaleFlipAug', 'AlignedResize', 'Normalize', 'Pad',
           'PhotoMetricDistortion', 'RandomCrop', 'RandomFlip', 'Resize']
