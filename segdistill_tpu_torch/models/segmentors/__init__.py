from .base import BaseSegmentor, add_prefix, parse_losses
from .cascade_encoder_decoder import CascadeEncoderDecoder
from .encoder_decoder import EncoderDecoder
from .sd_module import SDModule, SDModuleMT, draw_teacher_index

__all__ = ['BaseSegmentor', 'CascadeEncoderDecoder', 'EncoderDecoder',
           'SDModule', 'SDModuleMT', 'add_prefix', 'draw_teacher_index',
           'parse_losses']
