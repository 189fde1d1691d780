from .group_kl import fused_group_kl, fused_group_kl_shuffled, group_kl_plain
from .layer_norm import fused_layer_norm, layer_norm_plain
from .pixel_kl import fused_pixel_kl, pixel_kl_plain
from .resize import Upsample, resize
from .resize_sum import fused_resize_sum, resize_sum_plain
from .seg_ce import fused_seg_ce, seg_ce_plain
from .sra_attn import (fused_sra_attention, sra_attention_plain,
                       sra_attention_train)

__all__ = ['Upsample', 'resize', 'fused_group_kl', 'fused_group_kl_shuffled',
           'group_kl_plain', 'fused_layer_norm', 'layer_norm_plain',
           'fused_pixel_kl', 'pixel_kl_plain',
           'fused_resize_sum', 'resize_sum_plain', 'fused_seg_ce',
           'seg_ce_plain', 'fused_sra_attention', 'sra_attention_plain',
           'sra_attention_train']
