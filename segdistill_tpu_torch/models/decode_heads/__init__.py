from .decode_head import BaseDecodeHead
from .fcn_head import FCNHead
from .fpn_head import FPNHead
from .ocr_head import BaseCascadeDecodeHead
from .point_head import PointHead
from .psa_head import PSAHead
from .psp_head import PPM, PSPHead
from .segformer_head import SegFormerHead
from .uper_head import UPerHead

__all__ = ['BaseCascadeDecodeHead', 'BaseDecodeHead', 'FCNHead', 'FPNHead',
           'PointHead', 'PPM', 'PSAHead', 'PSPHead', 'SegFormerHead',
           'UPerHead']
