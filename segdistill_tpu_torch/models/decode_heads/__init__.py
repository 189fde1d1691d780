from .ann_head import ANNHead
from .apc_head import APCHead, DMHead
from .aspp_head import ASPPHead
from .da_head import CCHead, DAHead, EMAHead, EncHead
from .decode_head import BaseDecodeHead
from .fcn_head import FCNHead
from .fpn_head import FPNHead
from .lraspp_head import LRASPPHead
from .nl_head import DNLHead, GCHead, NLHead
from .ocr_head import BaseCascadeDecodeHead, OCRHead
from .point_head import PointHead
from .psa_head import PSAHead
from .psp_head import PPM, PSPHead
from .segformer_head import SegFormerHead
from .sep_aspp_head import DepthwiseSeparableASPPHead
from .sep_fcn_head import DepthwiseSeparableFCNHead
from .uper_head import UPerHead

__all__ = ['ANNHead', 'APCHead', 'ASPPHead', 'BaseCascadeDecodeHead',
           'BaseDecodeHead', 'CCHead', 'DAHead', 'DepthwiseSeparableASPPHead',
           'DepthwiseSeparableFCNHead', 'DMHead', 'DNLHead', 'EMAHead',
           'EncHead', 'FCNHead', 'FPNHead', 'GCHead', 'LRASPPHead', 'NLHead',
           'OCRHead', 'PointHead', 'PPM', 'PSAHead', 'PSPHead',
           'SegFormerHead', 'UPerHead']
