from .cgnet import CGNet
from .fast_scnn import FastSCNN
from .hrnet import HRNet
from .mix_transformer import (MixVisionTransformer, mit_b0, mit_b1, mit_b2,
                              mit_b3, mit_b4, mit_b5)
from .mobilenet_v2 import MobileNetV2
from .mobilenet_v3 import MobileNetV3
from .resnest import ResNeSt
from .resnet import ResNet, ResNetV1c, ResNetV1d
from .resnext import ResNeXt
from .swin_transformer import SwinTransformer
from .unet import UNet

__all__ = ['CGNet', 'FastSCNN', 'HRNet', 'MixVisionTransformer', 'mit_b0',
           'mit_b1', 'mit_b2', 'mit_b3', 'mit_b4', 'mit_b5', 'MobileNetV2',
           'MobileNetV3', 'ResNeSt', 'ResNet', 'ResNetV1c', 'ResNetV1d',
           'ResNeXt', 'SwinTransformer', 'UNet']
