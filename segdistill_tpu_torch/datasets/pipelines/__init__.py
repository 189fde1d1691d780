from .compose import Compose
from .formatting import (Collect, DefaultFormatBundle, ImageToTensor,
                         ToTensor, Transpose)
from .loading import LoadAnnotations, LoadImageFromFile
from .test_time_aug import MultiScaleFlipAug
from .transforms import (CLAHE, AdjustGamma, AlignedResize, CenterCrop,
                         MaillaryHack, Normalize, Pad, PhotoMetricDistortion,
                         RandomCrop, RandomFlip, RandomRotate, Rerange,
                         Resize, RGB2Gray, SegRescale)

__all__ = ['Compose', 'Collect', 'DefaultFormatBundle', 'ImageToTensor',
           'ToTensor', 'Transpose', 'LoadAnnotations', 'LoadImageFromFile',
           'MultiScaleFlipAug', 'AdjustGamma', 'AlignedResize', 'CLAHE',
           'CenterCrop', 'MaillaryHack', 'Normalize', 'Pad',
           'PhotoMetricDistortion', 'RandomCrop', 'RandomFlip',
           'RandomRotate', 'Rerange', 'Resize', 'RGB2Gray', 'SegRescale']
