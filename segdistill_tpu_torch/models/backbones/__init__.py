from .mix_transformer import (MixVisionTransformer, mit_b0, mit_b1, mit_b2,
                              mit_b3, mit_b4, mit_b5)
from .resnet import ResNet, ResNetV1c, ResNetV1d
from .swin_transformer import SwinTransformer

__all__ = ['MixVisionTransformer', 'mit_b0', 'mit_b1', 'mit_b2', 'mit_b3',
           'mit_b4', 'mit_b5', 'ResNet', 'ResNetV1c', 'ResNetV1d',
           'SwinTransformer']
