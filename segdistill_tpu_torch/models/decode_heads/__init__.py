from .aspp_head import ASPPHead
from .decode_head import BaseDecodeHead
from .fcn_head import FCNHead
from .fpn_head import FPNHead
from .lraspp_head import LRASPPHead
from .ocr_head import BaseCascadeDecodeHead, OCRHead
from .point_head import PointHead
from .psa_head import PSAHead
from .psp_head import PPM, PSPHead
from .segformer_head import SegFormerHead
from .sep_aspp_head import DepthwiseSeparableASPPHead
from .sep_fcn_head import DepthwiseSeparableFCNHead
from .uper_head import UPerHead

__all__ = ['ASPPHead', 'BaseCascadeDecodeHead', 'BaseDecodeHead',
           'DepthwiseSeparableASPPHead', 'DepthwiseSeparableFCNHead',
           'FCNHead', 'FPNHead', 'LRASPPHead', 'OCRHead', 'PointHead', 'PPM', 'PSAHead', 'PSPHead',
           'SegFormerHead', 'UPerHead']
