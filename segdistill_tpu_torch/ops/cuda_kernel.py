"""Build, load and count the hand-written CUDA kernels under ``csrc/``.

Each kernel is an entry point with a plain C interface in a ``.cu`` file
(a forward and its backward may share one). At its first launch the file
is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``build/segdistill_tpu_torch/`` at the root of the checkout, named by
a hash of its source and the shared headers, and loaded with ``ctypes``.
Importing this module, or a module that declares a kernel, builds nothing
and needs no ``nvcc``: the CPU tests import every module.

The serving kernels (K1, K2's forward, K10) are also custom operators of
``torch.library`` in the :data:`OP_NAMESPACE` namespace
(:func:`custom_op`): the dispatcher picks the plain version for a CPU
tensor and the launch for a CUDA one, and a fake implementation gives the
output's shape, dtype and strides, so ``torch.export`` keeps each call as
one node of the exported graph.
"""

import contextlib
import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / \
    'segdistill_tpu_torch'
# -split-compile=0: the device code optimised in parallel on every core,
# which shortens the build of a source of many template instances (K1's
# 16); each kernel gets the same registers
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
              '-split-compile=0')

# the kernels take float32 and bfloat16; code passed to the C interface
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _raw_stream(index):
    """The current stream of device ``index`` as a pointer argument (a bare
    integer past the end of ``argtypes`` would be cut to 32 bits).
    ``torch._C._cuda_getCurrentRawStream`` is private to torch (its
    inductor calls it the same way): it builds no Stream object per launch.
    Should a torch version drop it, this raises, and
    ``torch.cuda.current_stream(index).cuda_stream`` is the public form."""
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(index))


@functools.lru_cache(maxsize=None)
def sm_count(index):
    """Streaming multiprocessors of CUDA device ``index`` (the wrappers size
    their grids by it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_sm_count(device):
    """:func:`sm_count` of a CUDA ``torch.device`` (no index: the current
    device)."""
    return sm_count(torch.cuda.current_device() if device.index is None
                    else device.index)


# The forward tile kernels' ticket counters (K5, K7: the last block to
# finish merges the partials), one int32 for each (device index, stream):
# zeroed when it is made; a launch that runs to its end leaves it at 0, one
# that raised gives it up (:func:`ticket`). Launches on one stream run in
# order, so K5 and K7 share it.
TICKETS = {}


@contextlib.contextmanager
def ticket(device, needed=True):
    """The address of the ticket of ``device``'s current stream for one
    launch (None where the launch takes none); if the launch raises, the
    ticket is dropped, since it may not be at 0, and the next launch gets
    a fresh one."""
    if not needed:
        yield None
        return
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    key = (index, torch._C._cuda_getCurrentRawStream(index))
    t = TICKETS.get(key)
    if t is None:
        t = TICKETS[key] = torch.zeros(1, dtype=torch.int32,
                                       device=torch.device('cuda', index))
    try:
        yield t.data_ptr()
    except BaseException:
        TICKETS.pop(key, None)
        raise


OP_NAMESPACE = 'segdistill'
# the operators' registrations live as long as this object
LIBRARY = torch.library.Library(OP_NAMESPACE, 'DEF')


def custom_op(schema, plain, launch, fake):
    """Define ``segdistill::<schema>``: ``plain`` its CPU kernel, ``launch``
    its CUDA kernel, ``fake`` its implementation for tracing (shapes,
    dtypes and strides only: no ``data_ptr``, no launch). No other device
    and no autograd formula: the wrappers call the operator where no
    input needs a gradient and the call is traced or on a CPU tensor.
    Defined through ``torch.library.Library`` rather than
    ``torch.library.custom_op``, whose Python autograd layer adds host
    time to every call.
    -> the operator's default overload."""
    name = schema.split('(')[0]
    LIBRARY.define(schema)
    LIBRARY.impl(name, plain, 'CPU')
    LIBRARY.impl(name, launch, 'CUDA')
    torch.library.register_fake(f'{OP_NAMESPACE}::{name}', fake,
                                lib=LIBRARY)
    return getattr(getattr(torch.ops, OP_NAMESPACE), name).default


def nvcc_path():
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError('no CUDA toolkit found (set CUDA_HOME): the '
                           'kernels under csrc/ are built with nvcc')
    return str(Path(CUDA_HOME) / 'bin' / 'nvcc')


class CudaKernel:
    """One kernel: its source, its C entry point and its launch count.

    ``launches`` is a plain integer that the wrapper raises by one each
    time it launches the kernel, and nowhere else.
    """

    def __init__(self, name, symbol, argtypes, replaces, source=None):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces
        self.source = CSRC_DIR / f'{source or name}.cu'
        self.launches = 0
        self.build_seconds = None
        self.build_log = ''  # nvcc's output: registers, spills per kernel
        self._fn = None
        self._lock = threading.Lock()

    @property
    def loaded(self):
        return self._fn is not None

    def _build(self):
        src = self.source.read_bytes()
        headers = b''.join(p.read_bytes()
                           for p in sorted(CSRC_DIR.glob('*.cuh')))
        tag = hashlib.sha1(src + headers
                           + ' '.join(NVCC_FLAGS).encode()).hexdigest()
        lib = BUILD_DIR / f'lib{self.source.stem}-{tag[:12]}.so'
        if lib.exists():
            return lib
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build to a private name, then rename: a concurrent build of the
        # same source never sees a half-written library
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, '-o', tmp, str(self.source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f'nvcc failed for {self.source}:\n'
                               f'{res.stdout}{res.stderr}')
        self.build_log = res.stdout + res.stderr
        os.replace(tmp, lib)
        return lib

    def function(self):
        """The C entry point, built and loaded on first use."""
        with self._lock:
            if self._fn is None:
                t0 = time.perf_counter()
                fn = getattr(ctypes.CDLL(str(self._build())), self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self.build_seconds = time.perf_counter() - t0
                self._fn = fn
            return self._fn

    def launch(self, device, *args):
        """Launch on ``device``'s current stream, passed as the last
        argument; raise if CUDA refused the launch. The common case (the
        tensors lie on the current device) takes no device guard and no
        Stream object: a train step makes hundreds of these calls."""
        fn = self._fn or self.function()
        current = torch.cuda.current_device()
        index = current if device.index is None else device.index
        if index == current:
            err = fn(*args, _raw_stream(index))
        else:
            with torch.cuda.device(index):
                err = fn(*args, _raw_stream(index))
        if err != 0:
            raise RuntimeError(f'{self.name} kernel launch failed: CUDA '
                               f'error {err}')
        self.launches += 1


def build_all(kernels):
    """Build and load ``kernels``: one ``nvcc`` for each source file, all
    started together."""
    first = {}
    for k in kernels:
        first.setdefault(k.source, k)
    with ThreadPoolExecutor(len(first)) as pool:
        list(pool.map(CudaKernel.function, first.values()))
    for k in kernels:
        k.function()


def check_cuda_inputs(name, tensors):
    """Device, dtype and layout checks shared by the kernel wrappers."""
    dtype = tensors[0].dtype
    if dtype not in DTYPE_CODES:
        raise TypeError(f'{name}: the CUDA kernel takes float32 or bfloat16, '
                        f'got {dtype}')
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f'{name}: inputs must share one device and '
                             f'dtype, got {t.device}/{t.dtype} and '
                             f'{dev}/{dtype}')
    return DTYPE_CODES[dtype]
