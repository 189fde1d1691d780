from .base import BaseSegmentor, add_prefix, parse_losses
from .cascade_encoder_decoder import CascadeEncoderDecoder
from .encoder_decoder import EncoderDecoder
from .sd_module import SDModule

__all__ = ['BaseSegmentor', 'CascadeEncoderDecoder', 'EncoderDecoder',
           'SDModule', 'add_prefix', 'parse_losses']
