"""K10/K11: LayerNorm over the last axis, forward and backward.

Replaces ``segdistill_tpu/ops/pallas/layer_norm.py::fused_layer_norm`` (the
Pallas calls at ``layer_norm.py:113``, forward, and ``:144``, backward). The
kernels are ``csrc/layer_norm.cu``: a row is held by a group of lanes of one
warp, loaded once as 16-byte vectors and kept in registers through the mean
and the centred variance (fp32 statistics whatever the storage type). K11
recomputes the statistics from ``x``, as the TPU kernel does, so the forward
saves nothing but its inputs; it writes ``dx`` and one fp32 partial of
``dweight`` and ``dbias`` per block, which a second small kernel of the
same call sums in block order (deterministic, no atomics). The TPU kernel's gates (row tiles,
``C <= 64``) are not carried over: any row count, any ``C`` that is a
multiple of 8 up to :data:`MAX_C`.

:func:`fused_layer_norm` is a ``torch.autograd.Function`` on every device:
on a CPU tensor the forward is :func:`layer_norm_plain` and the backward its
autograd gradient; on a CUDA tensor the forward launches K10 and the
backward K11, or they raise.
"""

import ctypes

import torch

from .cuda_kernel import DTYPE_CODES, CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

MAX_C = 1024      # 32 lanes x 32 values in registers
_THREADS = 256    # kThreads in csrc/layer_norm.cu
_MAX_BWD_BLOCKS = 528  # kMaxBwdBlocks there

FWD_KERNEL = CudaKernel(
    'layer_norm_fwd', 'layer_norm_fwd', source='layer_norm',
    argtypes=[_P, _L, _P, _P, _I, _I, _F, _I, _P, _P],
    replaces='segdistill_tpu/ops/pallas/layer_norm.py:113')
BWD_KERNEL = CudaKernel(
    'layer_norm_bwd', 'layer_norm_bwd', source='layer_norm',
    argtypes=[_P, _L, _P, _L, _P, _I, _I, _F, _I, _P, _P, _I, _P, _P],
    replaces='segdistill_tpu/ops/pallas/layer_norm.py:144')


def layer_norm_plain(x, weight, bias, eps=1e-6):
    """The plain version: fp32 mean and biased variance of the centred
    values, ``(x - mu) * rsqrt(var + eps) * weight + bias``, output in
    ``x``'s dtype (the JAX module's fallback, ``models/utils/norm.py``)."""
    xf = x.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    var = xc.square().mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype)


def _lanes(C):
    """Lanes of a warp that hold one row (``lanes_for`` in the source)."""
    for g in (4, 8, 16):
        if C <= 16 * g:
            return g
    return 32


def _aligned(t):
    """Every row of the (rows, C) tensor starts on a 16-byte boundary."""
    return t.data_ptr() % 16 == 0 and (t.stride(0) * t.element_size()) % 16 == 0


def _rows(name, t, C, copy=False):
    """-> a (rows, C) tensor over ``t``'s memory with a unit last stride and
    16-byte aligned rows. A tensor that has neither raises, or with
    ``copy`` is copied (a fresh allocation is aligned)."""
    if t.stride(-1) == 1:
        t2 = t.reshape(-1, C)  # a view where the leading axes fold
        if t2.shape[0] == 1:   # one row: its stride is free
            t2 = t2.as_strided((1, C), (C, 1))
        if _aligned(t2):
            return t2
        if not copy:
            raise ValueError(
                f'fused_layer_norm: every row of {name} must start on a '
                f'16-byte boundary (data_ptr {t2.data_ptr()}, row stride '
                f'{t2.stride(0)} elements)')
    elif not copy:
        raise ValueError(f'fused_layer_norm: the last axis of {name} must be '
                         f'contiguous, got strides {t.stride()}')
    return t.clone(memory_format=torch.contiguous_format).view(-1, C)


def _refuse(x, weight, bias):
    """Say why the kernels do not take these arguments."""
    C = x.shape[-1]
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f'fused_layer_norm: the CUDA kernel takes float32 or '
                        f'bfloat16, got {x.dtype}')
    if C % 8 or not 0 < C <= MAX_C:
        raise ValueError(f'fused_layer_norm: the CUDA kernel takes a last '
                         f'axis that is a multiple of 8 up to {MAX_C}, got '
                         f'{C}')
    for name, p in (('weight', weight), ('bias', bias)):
        if not _param_ok(p, x, C):
            raise ValueError(f'fused_layer_norm: {name} must be a contiguous '
                             f'float32 ({C},) tensor on {x.device}, got '
                             f'{p.dtype} {tuple(p.shape)} on {p.device}')
    raise ValueError('fused_layer_norm: empty input')


def _param_ok(p, x, C):
    return p.dtype is torch.float32 and p.ndim == 1 and p.shape[0] == C \
        and p.stride(0) == 1 and p.device == x.device \
        and p.data_ptr() % 16 == 0


def _rows_of(name, t, C, copy=False):
    """-> (pointer, row stride, rows, the tensor that owns the memory):
    without a view for a contiguous aligned tensor, the common case."""
    if t.is_contiguous():
        ptr = t.data_ptr()
        if ptr % 16 == 0:
            return ptr, C, t.numel() // C, t
    t2 = _rows(name, t, C, copy)
    return t2.data_ptr(), t2.stride(0), t2.shape[0], t2


def _launch_fwd(x, weight, bias, eps):
    C = x.shape[-1]
    code = DTYPE_CODES.get(x.dtype)
    if code is None or C % 8 or C > MAX_C or x.numel() == 0 \
            or not (_param_ok(weight, x, C) and _param_ok(bias, x, C)):
        _refuse(x, weight, bias)
    ptr, stride, rows, _keep = _rows_of('x', x, C)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    FWD_KERNEL.launch(x.device, ptr, stride, weight.data_ptr(),
                      bias.data_ptr(), rows, C, eps, code, y.data_ptr())
    return y


def _launch_bwd(x, weight, dy, eps):
    C = x.shape[-1]
    code = DTYPE_CODES.get(x.dtype)
    if code is None or C % 8 or C > MAX_C or x.numel() == 0 \
            or not _param_ok(weight, x, C):
        _refuse(x, weight, weight)
    if dy.dtype != x.dtype or dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f'fused_layer_norm: the incoming gradient is '
                         f'{dy.dtype} {tuple(dy.shape)}, the input '
                         f'{x.dtype} {tuple(x.shape)}')
    ptr, stride, rows, _keep = _rows_of('x', x, C)
    # a gradient whose last axis is strided (it was produced in another
    # layout, e.g. NCHW) or misaligned is copied; a row stride is passed on
    dptr, dstride, _, _dkeep = _rows_of('dy', dy, C, copy=True)
    blocks = min(-(-rows // (_THREADS // _lanes(C))), _MAX_BWD_BLOCKS)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    part = torch.empty((2, blocks, C), dtype=torch.float32, device=x.device)
    dwdb = torch.empty((2, C), dtype=torch.float32, device=x.device)
    BWD_KERNEL.launch(x.device, ptr, stride, dptr, dstride,
                      weight.data_ptr(), rows, C, eps, code, dx.data_ptr(),
                      part.data_ptr(), blocks, dwdb.data_ptr())
    return dx, dwdb[0], dwdb[1]


class _LayerNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, weight, bias)
        if x.device.type == 'cpu':
            return layer_norm_plain(x, weight, bias, eps)
        return _launch_fwd(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias = ctx.saved_tensors
        if x.device.type == 'cpu':
            with torch.enable_grad():
                args = [t.detach().requires_grad_() for t in (x, weight, bias)]
                y = layer_norm_plain(*args, ctx.eps)
                dx, dw, db = torch.autograd.grad(y, args, dy)
        else:
            dx, dw, db = _launch_bwd(x, weight, dy, ctx.eps)
        return dx, dw, db, None


def fused_layer_norm(x, weight, bias, eps=1e-6):
    """LayerNorm over the last axis. ``x`` (..., C) in float32 or bfloat16;
    ``weight``/``bias`` (C,) float32, used as stored (no cast copy). ->
    ``x``'s shape and dtype, contiguous. Differentiable in all three.

    The kernels read rows whose last axis is contiguous (leading axes may
    be strided). An ``x`` with a strided last axis (the token view of an
    NCHW convolution output, as MiT's first patch embedding gives) is
    copied to contiguous memory first, by one ``contiguous()`` here, and
    so is such an incoming gradient in the backward."""
    if x.is_cuda:
        if x.stride(-1) != 1:
            x = x.contiguous()
        if not (torch.is_grad_enabled() and (
                x.requires_grad or weight.requires_grad
                or bias.requires_grad)):
            # nothing to differentiate (a frozen teacher, serving): the
            # same launch without the autograd node
            return _launch_fwd(x, weight, bias, float(eps))
    elif x.device.type != 'cpu':
        raise ValueError(f'fused_layer_norm: unsupported device {x.device}')
    return _LayerNorm.apply(x, weight, bias, float(eps))
