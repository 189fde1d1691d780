from .builder import (BACKBONES, HEADS, LOSSES, SEGMENTORS, build_backbone,
                      build_head, build_loss, build_segmentor)
from . import backbones, decode_heads, losses, segmentors  # noqa: F401

__all__ = ['BACKBONES', 'HEADS', 'LOSSES', 'SEGMENTORS', 'build_backbone',
           'build_head', 'build_loss', 'build_segmentor']
