"""SegDistill on PyTorch and CUDA: serving, the distillation train steps
and the train/test command lines of ``segdistill_tpu``.

A port of the JAX package beside it, module for module: the same config
corpus and registry type names, the reference ``.pth`` state-dict layout,
and hand-written CUDA kernels for Hopper (``csrc/``) where the JAX package
has Pallas kernels. It imports nothing of JAX and nothing of the JAX
package: the config system, the registry and the configs' model recipes
(``config.py``, ``registry.py``, ``zoo.py``) are its own copies.
"""

from .config import Config, DictAction
from .registry import Registry, build_from_cfg

__version__ = '0.1.0'

__all__ = ['Config', 'DictAction', 'Registry', 'build_from_cfg',
           '__version__']
