from .base import BaseSegmentor
from .encoder_decoder import EncoderDecoder

__all__ = ['BaseSegmentor', 'EncoderDecoder']
