from .builder import PIXEL_SAMPLERS, build_pixel_sampler
from .sampler import BasePixelSampler, OHEMPixelSampler

__all__ = ['PIXEL_SAMPLERS', 'build_pixel_sampler', 'BasePixelSampler',
           'OHEMPixelSampler']
