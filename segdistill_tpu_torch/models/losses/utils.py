"""Loss reduction helpers (counterpart of
``segdistill_tpu/models/losses/utils.py``; reference
``mmseg/models/losses/utils.py``).

With ``reduction='mean'`` and no ``avg_factor`` the mean runs over every
element: ignored pixels add zeros to the numerator and still count in the
denominator, the loss scale the reference recipes were tuned with.
"""

import functools


def reduce_loss(loss, reduction):
    if reduction == 'none':
        return loss
    if reduction == 'mean':
        return loss.mean()
    if reduction == 'sum':
        return loss.sum()
    raise ValueError(f'invalid reduction: {reduction}')


def weight_reduce_loss(loss, weight=None, reduction='mean', avg_factor=None):
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        return reduce_loss(loss, reduction)
    if reduction == 'mean':
        return loss.sum() / avg_factor
    if reduction != 'none':
        raise ValueError('avg_factor can only be used with reduction="mean"')
    return loss


def weighted_loss(loss_func):
    """Decorate an elementwise ``loss_func(pred, target, **kwargs)`` into
    ``fn(pred, target, weight=None, reduction='mean', avg_factor=None,
    **kwargs)``, weighted and reduced by :func:`weight_reduce_loss`."""

    @functools.wraps(loss_func)
    def wrapper(pred, target, weight=None, reduction='mean', avg_factor=None,
                **kwargs):
        loss = loss_func(pred, target, **kwargs)
        return weight_reduce_loss(loss, weight, reduction, avg_factor)

    return wrapper
