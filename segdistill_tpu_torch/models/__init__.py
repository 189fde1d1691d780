from .builder import (BACKBONES, HEADS, SEGMENTORS, build_backbone,
                      build_head, build_segmentor)
from . import backbones, decode_heads, segmentors  # noqa: F401 (registers)

__all__ = ['BACKBONES', 'HEADS', 'SEGMENTORS', 'build_backbone',
           'build_head', 'build_segmentor']
