from .accuracy import accuracy
from .cross_entropy_loss import CrossEntropyLoss, cross_entropy
from .utils import reduce_loss, weight_reduce_loss

__all__ = ['accuracy', 'CrossEntropyLoss', 'cross_entropy', 'reduce_loss',
           'weight_reduce_loss']
