"""Feature taps: intermediate tensors captured under the reference's dotted
layer names ('decode_head.linear_pred', 'backbone.block1.0.attn.Q', ...),
the port's counterpart of the JAX package's sown 'feats' collection and
its ``flatten_feats`` (``segdistill_tpu/models/segmentors/base.py:56-76``).

A module calls :func:`tap` on a value it exposes. Only inside
:func:`capture_taps` is anything kept: the value is stored under the
module's path in the captured model plus the tap's name, when that name was
asked for. Taps are explicit calls, so they fire where a forward hook would
not (the heads apply their classifier weights with ``F.conv2d``).
"""

import contextlib
import functools


def tap(module, name, value):
    """Expose ``value`` as ``<module path>.<name>``; returns ``value``."""
    sink = module.__dict__.get('_tap_sink')
    if sink is not None:
        sink(name, value)
    return value


class Taps(dict):
    """The captured taps; ``seen`` holds the name of every tap that fired,
    kept or not."""

    def __init__(self):
        super().__init__()
        self.seen = set()


def _record(store, prefix, names, name, value):
    key = f'{prefix}.{name}' if prefix else name
    store.seen.add(key)
    if names is None or key in names:
        store[key] = value


@contextlib.contextmanager
def capture_taps(model, names=None):
    """Yield a :class:`Taps` dict that fills, during the block, with the
    taps of ``model``'s modules whose dotted names are in ``names`` (every
    tap if None)."""
    store = Taps()
    names = None if names is None else set(names)
    modules = list(model.named_modules())
    for prefix, m in modules:
        m.__dict__['_tap_sink'] = functools.partial(_record, store, prefix,
                                                    names)
    try:
        yield store
    finally:
        for _, m in modules:
            m.__dict__.pop('_tap_sink', None)
