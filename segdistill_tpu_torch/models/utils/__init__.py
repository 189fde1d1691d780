from .drop import DropPath
from .norm import BatchNorm2d, GroupNorm, LayerNorm2d, build_norm_layer

__all__ = ['DropPath', 'BatchNorm2d', 'GroupNorm', 'LayerNorm2d',
           'build_norm_layer']
