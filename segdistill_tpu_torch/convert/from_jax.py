"""JAX variables -> this package's state dict, for the MiT and
SegFormerHead families.

The inverse of ``segdistill_tpu/convert/torch_loader.py``'s rules: conv
kernels HWIO -> OIHW, Dense kernels (I, O) -> (O, I), norm ``scale`` ->
``weight``, ``batch_stats`` ``mean``/``var`` -> ``running_mean``/
``running_var``, Flax list names ``block1_0`` -> ``block1.0``, the head's
Dense params ``linear_c4`` -> ``linear_c4.proj`` and the NormLayer nesting
``linear_fuse.bn.bn`` -> ``linear_fuse.bn``. Takes the ``{'params',
'batch_stats'}`` tree as numpy arrays (or anything ``np.asarray`` reads);
imports no JAX.
"""

import re
from collections.abc import Mapping

import numpy as np
import torch

_MODULE_RULES = [
    (re.compile(r'\bblock(\d+)_(\d+)\b'), r'block\1.\2'),
    (re.compile(r'\blinear_c(\d)$'), r'linear_c\1.proj'),
    (re.compile(r'\blinear_fuse\.bn\.bn$'), 'linear_fuse.bn'),
]
_STATS = {'mean': 'running_mean', 'var': 'running_var'}


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _module_name(path):
    name = '.'.join(path)
    for pat, repl in _MODULE_RULES:
        name = pat.sub(repl, name)
    return name


def state_dict_from_jax(variables):
    """-> {reference-layout key: tensor} for ``load_state_dict``."""
    out = {}
    for col in ('params', 'batch_stats'):
        for (*path, leaf), value in _flatten(variables.get(col, {})):
            arr = np.asarray(value)
            module = _module_name(path)
            if col == 'batch_stats':
                if leaf not in _STATS:
                    raise KeyError(f'unknown batch_stats leaf {path}/{leaf}')
                leaf = _STATS[leaf]
                out[f'{module}.num_batches_tracked'] = torch.tensor(0)
            elif leaf == 'kernel':
                if arr.ndim == 4:
                    arr = arr.transpose(3, 2, 0, 1)
                elif arr.ndim == 2:
                    arr = arr.T
                else:
                    raise ValueError(f'{module}: unexpected kernel shape '
                                     f'{arr.shape}')
                leaf = 'weight'
            elif leaf == 'scale':
                leaf = 'weight'
            elif leaf != 'bias':
                raise KeyError(f'unknown parameter {"/".join(path)}/{leaf}')
            out[f'{module}.{leaf}'] = torch.from_numpy(
                np.ascontiguousarray(arr, dtype=np.float32))
    return out
