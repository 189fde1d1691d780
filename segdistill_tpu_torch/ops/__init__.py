from .resize import resize
from .resize_sum import fused_resize_sum, resize_sum_plain
from .sra_attn import fused_sra_attention, sra_attention_plain

__all__ = ['resize', 'fused_resize_sum', 'resize_sum_plain',
           'fused_sra_attention', 'sra_attention_plain']
