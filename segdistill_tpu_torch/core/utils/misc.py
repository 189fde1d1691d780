"""Loss-dict helpers (counterpart of ``segdistill_tpu/core/utils/misc.py``;
reference ``mmseg/core/utils/misc.py:1-17``)."""


def add_prefix(inputs, prefix):
    """Namespace a loss dict: {'loss_seg': x} -> {'decode.loss_seg': x}."""
    return {f'{prefix}.{name}': value for name, value in inputs.items()}
