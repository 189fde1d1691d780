from .decode_head import BaseDecodeHead
from .segformer_head import SegFormerHead

__all__ = ['BaseDecodeHead', 'SegFormerHead']
