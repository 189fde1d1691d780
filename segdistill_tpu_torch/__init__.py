"""SegDistill on PyTorch and CUDA: serving, the distillation train steps
and the train/test command lines of ``segdistill_tpu``.

A port of the JAX package beside it, module for module: the same config
corpus and registry type names, the reference ``.pth`` state-dict layout,
and hand-written CUDA kernels for Hopper (``csrc/``) where the JAX package
has Pallas kernels. It imports nothing of JAX and nothing of the JAX
package: the config system, the registry and the configs' model recipes
(``config.py``, ``registry.py``, ``zoo.py``) are its own copies.
"""

import importlib

__version__ = '0.1.0'

# imported at first use, so that ``import segdistill_tpu_torch.ops`` (all a
# process needs to run an exported program) loads the kernels alone
_LAZY = {'Config': 'config', 'DictAction': 'config', 'Registry': 'registry',
         'build_from_cfg': 'registry'}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f'.{_LAZY[name]}', __name__),
                       name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')

__all__ = ['Config', 'DictAction', 'Registry', 'build_from_cfg',
           '__version__']
