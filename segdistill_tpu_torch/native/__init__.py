from .fastaug import (FastAugBatch, fastaug_available, fastaug_built,
                      load_fastaug)

__all__ = ['FastAugBatch', 'fastaug_available', 'fastaug_built',
           'load_fastaug']
