from .drop import DropPath, Dropout
from .norm import BatchNorm2d, GroupNorm, LayerNorm2d, build_norm_layer
from .taps import capture_taps, tap

__all__ = ['DropPath', 'Dropout', 'BatchNorm2d', 'GroupNorm', 'LayerNorm2d',
           'build_norm_layer', 'capture_taps', 'tap']
