from .conv_module import ConvModule
from .drop import DropPath, Dropout
from .norm import (BatchNorm2d, FusedLayerNorm, GroupNorm, LayerNorm2d,
                   build_norm_layer)
from .taps import capture_taps, tap

__all__ = ['ConvModule', 'DropPath', 'Dropout', 'BatchNorm2d',
           'FusedLayerNorm', 'GroupNorm', 'LayerNorm2d', 'build_norm_layer',
           'capture_taps', 'tap']
