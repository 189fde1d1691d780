from .mix_transformer import (MixVisionTransformer, mit_b0, mit_b1, mit_b2,
                              mit_b3, mit_b4, mit_b5)

__all__ = ['MixVisionTransformer', 'mit_b0', 'mit_b1', 'mit_b2', 'mit_b3',
           'mit_b4', 'mit_b5']
