from .base import BaseSegmentor, add_prefix, parse_losses
from .encoder_decoder import EncoderDecoder
from .sd_module import SDModule

__all__ = ['BaseSegmentor', 'EncoderDecoder', 'SDModule', 'add_prefix',
           'parse_losses']
