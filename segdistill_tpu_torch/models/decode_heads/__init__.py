from .decode_head import BaseDecodeHead
from .psp_head import PPM, PSPHead
from .segformer_head import SegFormerHead
from .uper_head import UPerHead

__all__ = ['BaseDecodeHead', 'PPM', 'PSPHead', 'SegFormerHead', 'UPerHead']
