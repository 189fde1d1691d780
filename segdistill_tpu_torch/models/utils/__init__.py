from .activation import build_activation
from .conv_module import ConvModule, DepthwiseSeparableConvModule
from .drop import DropPath, Dropout
from .inverted_residual import InvertedResidual, InvertedResidualV3
from .misc import make_divisible
from .norm import (BatchNorm2d, FusedLayerNorm, GroupNorm, LayerNorm2d,
                   build_norm_layer)
from .se_layer import SELayer
from .self_attention_block import SelfAttentionBlock
from .taps import capture_taps, tap

__all__ = ['build_activation', 'ConvModule', 'DepthwiseSeparableConvModule',
           'DropPath', 'Dropout', 'InvertedResidual', 'InvertedResidualV3',
           'make_divisible', 'BatchNorm2d', 'FusedLayerNorm', 'GroupNorm',
           'LayerNorm2d', 'build_norm_layer', 'SELayer', 'SelfAttentionBlock',
           'capture_taps', 'tap']
