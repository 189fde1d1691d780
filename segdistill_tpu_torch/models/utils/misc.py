"""``make_divisible`` (counterpart of
``segdistill_tpu/models/utils/misc.py``; reference
``mmseg/models/utils/make_divisible.py``)."""


def make_divisible(value, divisor, min_value=None, min_ratio=0.9):
    """``value`` rounded to the nearest multiple of ``divisor``, at least
    ``min_value`` (default ``divisor``) and not below ``min_ratio`` of
    ``value``."""
    if min_value is None:
        min_value = divisor
    new_value = max(min_value, int(value + divisor / 2) // divisor * divisor)
    if new_value < min_ratio * value:
        new_value += divisor
    return new_value
