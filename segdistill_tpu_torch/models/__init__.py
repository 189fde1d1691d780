from .builder import (BACKBONES, HEADS, LOSSES, NECKS, SEGMENTORS,
                      build_backbone, build_head, build_loss, build_neck,
                      build_segmentor)
from . import backbones, decode_heads, losses, necks, segmentors  # noqa: F401

__all__ = ['BACKBONES', 'HEADS', 'LOSSES', 'NECKS', 'SEGMENTORS',
           'build_backbone', 'build_head', 'build_loss', 'build_neck',
           'build_segmentor']
