"""ctypes binding of the native augmentation core ``fastaug.cpp``
(counterpart of ``segdistill_tpu/native/fastaug.py``).

The core runs the whole train-time chain of a batch (keep-ratio rescale,
random scale, the random crop with the ``cat_max_ratio`` rejection loop,
flip, photometric distortion, normalisation, padding) in one call,
OpenMP-parallel across samples. ``ctypes.CDLL`` releases the GIL for the
length of the call, so the loader's Python threads run meanwhile.

The library is built at first use with ``g++ -O3 -march=native -shared
-fPIC -fopenmp`` into the checkout's ``build/segdistill_tpu_torch/``,
under a name keyed by a hash of the source, the flags and the target the
compiler takes for ``-march=native`` (a checkout moved to another CPU
builds its own). A failed build raises with g++'s output.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / 'fastaug.cpp'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / \
    'segdistill_tpu_torch'
GXX_FLAGS = ['-O3', '-march=native', '-shared', '-fPIC', '-fopenmp']
VERSION = 1  # fastaug_version() of the source

_lock = threading.Lock()
_lib = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_intp = ctypes.POINTER(ctypes.c_int)
_f32p = ctypes.POINTER(ctypes.c_float)
_f = ctypes.c_float
# fastaug_batch(imgs, gts, heights, widths, batch, crop_h, crop_w, five
# scale/crop floats, ignore_index, seven flip/photometric floats, mean,
# std, seed, out_imgs, out_gts)
_BATCH_ARGTYPES = (
    [ctypes.POINTER(_u8p), ctypes.POINTER(_u8p), _intp, _intp]
    + [ctypes.c_int] * 3 + [_f] * 5 + [ctypes.c_int] + [_f] * 7
    + [_f32p, _f32p, ctypes.c_uint64, _f32p,
       ctypes.POINTER(ctypes.c_int32)])


def _run(cmd, what):
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f'{what}: g++ not found ({e})') from e
    if res.returncode != 0:
        raise RuntimeError(f'{what} failed:\n{res.stdout}{res.stderr}')
    return res.stdout + res.stderr


def _target():
    """What ``-march=native`` means on this machine: the compiler's
    predefined macros (the instruction sets it enables)."""
    return _run(['g++', '-march=native', '-dM', '-E', '-x', 'c++',
                 os.devnull], 'g++ -march=native -dM -E')


def _library_path():
    """Where this machine's build of the core lies (built or not)."""
    tag = hashlib.sha1(SOURCE.read_bytes() + ' '.join(GXX_FLAGS).encode()
                       + _target().encode()).hexdigest()
    return BUILD_DIR / f'libfastaug-{tag[:12]}.so'


def _build():
    lib = _library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: a concurrent build never sees
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        _run(['g++', *GXX_FLAGS, '-o', tmp, str(SOURCE)],
             f'g++ build of {SOURCE}')
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load_fastaug(rebuild=False):
    """The loaded library, built at first use; raises if g++ fails."""
    global _lib
    with _lock:
        if _lib is not None and not rebuild:
            return _lib
        if rebuild:
            _library_path().unlink(missing_ok=True)
        lib = ctypes.CDLL(str(_build()))
        lib.fastaug_version.restype = ctypes.c_int
        lib.fastaug_version.argtypes = []
        if lib.fastaug_version() != VERSION:
            raise RuntimeError(f'fastaug version {lib.fastaug_version()}, '
                               f'expected {VERSION}')
        lib.fastaug_batch.restype = None
        lib.fastaug_batch.argtypes = _BATCH_ARGTYPES
        _lib = lib
        return lib


def fastaug_available():
    """Whether the core builds and loads here (building it if need be)."""
    try:
        load_fastaug()
    except (RuntimeError, OSError):
        return False
    return True


def fastaug_built():
    """This machine's build of the core if it is already built, else None
    (also without g++). Builds nothing."""
    try:
        lib = _library_path()
    except RuntimeError:
        return None
    return lib if lib.exists() else None


class FastAugBatch:
    """Native batch augmenter: a list of (img HxWx3 uint8 RGB, gt HxW
    uint8) -> (imgs (B, ch, cw, 3) float32 normalised, gts (B, ch, cw)
    int32), the JAX package's ``FastAugBatch`` (same arguments, same
    core, bitwise equal output).

    The op semantics are the host pipeline's Resize/RandomCrop/RandomFlip/
    PhotoMetricDistortion/Normalize/Pad chain; the random stream is the
    core's own (splitmix64 a sample, seeded by ``seed`` and its index).
    """

    def __init__(self, crop_size=(512, 512), img_scale=(2048, 512),
                 ratio_range=(0.5, 2.0), cat_max_ratio=0.75,
                 ignore_index=255, flip_prob=0.5, brightness_delta=32,
                 contrast_range=(0.5, 1.5), saturation_range=(0.5, 1.5),
                 hue_delta=18, mean=(123.675, 116.28, 103.53),
                 std=(58.395, 57.12, 57.375)):
        self.lib = load_fastaug()
        self.crop_size = tuple(crop_size)
        self.img_scale = tuple(img_scale)
        self.ratio_range = tuple(ratio_range)
        self.cat_max_ratio = float(cat_max_ratio)
        self.ignore_index = int(ignore_index)
        self.flip_prob = float(flip_prob)
        self.brightness_delta = float(brightness_delta)
        self.contrast_range = tuple(contrast_range)
        self.saturation_range = tuple(saturation_range)
        self.hue_delta = float(hue_delta)
        self.mean = np.ascontiguousarray(mean, np.float32)
        self.std = np.ascontiguousarray(std, np.float32)

    def __call__(self, samples, seed=0, out=None):
        """``out``: optional (imgs, gts) C-contiguous float32 / int32
        arrays of the output shapes to write into (a pinned buffer)."""
        b = len(samples)
        ch, cw = self.crop_size
        imgs = [np.ascontiguousarray(s[0], np.uint8) for s in samples]
        gts = [np.ascontiguousarray(s[1], np.uint8) for s in samples]
        for im, g in zip(imgs, gts):
            if im.ndim != 3 or im.shape[2] != 3 or g.shape != im.shape[:2]:
                raise ValueError(f'fastaug takes (H, W, 3) images with (H, '
                                 f'W) labels, got {im.shape} and {g.shape}')
        if out is None:
            out = (np.empty((b, ch, cw, 3), np.float32),
                   np.empty((b, ch, cw), np.int32))
        out_imgs, out_gts = out
        if out_imgs.shape != (b, ch, cw, 3) or out_imgs.dtype != np.float32 \
                or out_gts.shape != (b, ch, cw) or out_gts.dtype != np.int32 \
                or not (out_imgs.flags.c_contiguous
                        and out_gts.flags.c_contiguous):
            raise ValueError('fastaug: out must be C-contiguous float32 '
                             f'{(b, ch, cw, 3)} and int32 {(b, ch, cw)}')
        heights = np.array([im.shape[0] for im in imgs], np.int32)
        widths = np.array([im.shape[1] for im in imgs], np.int32)
        img_ptrs = (_u8p * b)(*[im.ctypes.data_as(_u8p) for im in imgs])
        gt_ptrs = (_u8p * b)(*[g.ctypes.data_as(_u8p) for g in gts])
        self.lib.fastaug_batch(
            img_ptrs, gt_ptrs, heights.ctypes.data_as(_intp),
            widths.ctypes.data_as(_intp), b, ch, cw,
            max(self.img_scale), min(self.img_scale),
            self.ratio_range[0], self.ratio_range[1], self.cat_max_ratio,
            self.ignore_index, self.flip_prob, self.brightness_delta,
            self.contrast_range[0], self.contrast_range[1],
            self.saturation_range[0], self.saturation_range[1],
            self.hue_delta, self.mean.ctypes.data_as(_f32p),
            self.std.ctypes.data_as(_f32p), int(seed),
            out_imgs.ctypes.data_as(_f32p),
            out_gts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out_imgs, out_gts
