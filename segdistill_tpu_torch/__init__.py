"""SegDistill on PyTorch and CUDA: the serving path of ``segdistill_tpu``.

A port of the JAX package beside it, module for module: the same config
corpus and registry type names, the reference ``.pth`` state-dict layout,
and hand-written CUDA kernels for Hopper (``csrc/``) where the JAX package
has Pallas kernels. It never imports JAX; the config system
(``segdistill_tpu.config``) and the registry (``segdistill_tpu.registry``)
are the JAX package's framework-free host modules, used as they are.
"""
