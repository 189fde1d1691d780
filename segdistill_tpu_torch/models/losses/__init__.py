from .accuracy import Accuracy, accuracy
from .cross_entropy_loss import (CrossEntropyLoss, binary_cross_entropy,
                                 cross_entropy, mask_cross_entropy)
from .lovasz_loss import LovaszLoss
from .utils import reduce_loss, weight_reduce_loss, weighted_loss

__all__ = ['Accuracy', 'accuracy', 'CrossEntropyLoss', 'binary_cross_entropy',
           'cross_entropy', 'mask_cross_entropy', 'LovaszLoss',
           'reduce_loss', 'weight_reduce_loss', 'weighted_loss']
