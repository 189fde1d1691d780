"""K10/K11: LayerNorm over the last axis, forward and backward.

Replaces ``segdistill_tpu/ops/pallas/layer_norm.py::fused_layer_norm`` (the
Pallas calls at ``layer_norm.py:113``, forward, and ``:144``, backward). The
kernels are ``csrc/layer_norm.cu``: a row is held by a group of lanes of one
warp, loaded once as 16-byte vectors and kept in registers through the mean
and the centred variance (fp32 statistics whatever the storage type). K10
launches on the plan of ``ops/ln_plan.py`` (lanes a row, vectors a lane,
rows in flight, block and grid), which the source checks. K11
recomputes the statistics from ``x``, as the TPU kernel does, so the forward
saves nothing but ``x`` and ``weight``. K11 is one launch: it writes ``dx``
and one fp32 partial of ``dweight`` and ``dbias`` per block into a workspace
that is kept per (device, stream, C); the last block of each group of 16
sums the group's partials, and the last of those the groups' sums, each in
a fixed order (bitwise reproducible; no atomics on a gradient). The TPU kernel's gates (row tiles, ``C <= 64``) are not carried
over: any row count, any ``C`` that is a multiple of 8 up to :data:`MAX_C`.

The forward is also the custom operator ``segdistill::layer_norm``
(:data:`LAYER_NORM`): the dispatcher runs :func:`layer_norm_plain` on a CPU
tensor and launches K10 (or raises) on a CUDA tensor, and ``torch.export``
keeps the call as one node. :func:`fused_layer_norm` calls it where no input
needs a gradient and the call is traced or on a CPU tensor; an eager call on
a CUDA tensor launches K10 directly, since the dispatcher's host time
showed in the train steps (a frozen teacher's calls). Where an input needs a
gradient it is a ``torch.autograd.Function`` whose forward runs
:func:`layer_norm_plain` on a CPU tensor and launches K10 on a CUDA tensor
(no program holds a gradient), and whose backward is the plain version's
autograd gradient on a CPU tensor and K11 on a CUDA tensor. The forward
hands the backward what it checked (row stride, row count, dtype code), so
the backward validates only the incoming gradient; a parameter that needs
no gradient gets ``None`` and, where neither does, the kernel skips their
sums.
"""

import ctypes

import torch
from torch.autograd.function import once_differentiable

from .cuda_kernel import (DTYPE_CODES, CudaKernel, custom_op, device_sm_count,
                          sm_count)
from .ln_plan import forward_plan

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

MAX_C = 1536      # 32 lanes x 48 values in registers (kMaxC)
_THREADS = 256    # kThreads in csrc/layer_norm.cu
# K11's grid: at most this many blocks for each SM, each writing one (2, C)
# partial: 4 x 256 threads keep 32 KB of loads in flight on an SM; beyond
# C = 256 a lane holds 16 values or more and the registers leave room for
# two blocks, so more would only queue up. The last block of every
# _GROUP_BLOCKS neighbours sums their partials (kGroupBlocks in the source).
_BWD_BLOCKS_PER_SM = 4
_BWD_BLOCKS_PER_SM_WIDE = 2
_GROUP_BLOCKS = 16

FWD_KERNEL = CudaKernel(
    'layer_norm_fwd', 'layer_norm_fwd', source='layer_norm',
    argtypes=[_P, _L, _P, _P, _I, _I, _F, _I, _P] + [_I] * 6 + [_P],
    replaces='segdistill_tpu/ops/pallas/layer_norm.py:113')
# launch K10 as a programmatic dependent launch: its grid is set up while
# the kernel ahead of it finishes, and it waits for that kernel before it
# reads anything (x, weight or bias may be that kernel's output)
PDL = True
# an empty kernel on a given grid: the floor under a K10 launch, which the
# measuring tools time beside it; no path launches it
EMPTY_KERNEL = CudaKernel(
    'layer_norm_empty', 'layer_norm_empty', source='layer_norm',
    argtypes=[_I, _I, _P], replaces='none: a measuring floor')
BWD_KERNEL = CudaKernel(
    'layer_norm_bwd', 'layer_norm_bwd', source='layer_norm',
    argtypes=[_P, _L, _P, _L, _P, _I, _I, _F, _I, _P, _P, _I, _I, _P, _P],
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


def _bwd_lanes(C):
    """Lanes of a warp that hold one row in K11, 8 values a lane
    (``lanes_for(C, kBwdPerLane)`` in the source)."""
    for g in (4, 8, 16):
        if C <= 8 * g:
            return g
    return 32


def _aligned(t):
    """Every row of the (rows, C) tensor starts on a 16-byte boundary."""
    return t.data_ptr() % 16 == 0 and (t.stride(0) * t.element_size()) % 16 == 0


def _rows(name, t, C, copy=False):
    """-> a (rows, C) tensor of ``t``'s values with a unit last stride and
    16-byte aligned rows: a view of ``t`` where its leading axes fold into
    one row stride, else a copy. A strided last axis or misaligned rows
    raise, or with ``copy`` are copied (a fresh allocation is aligned)."""
    if t.stride(-1) == 1:
        t2 = t.reshape(-1, C)  # a copy where the leading axes do not fold
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
    """-> (pointer, row stride, rows, the (rows, C) tensor they describe):
    ``t`` itself for a contiguous aligned tensor, the common case, else a
    view, or a copy where ``t``'s leading axes do not fold. The pointer is
    that tensor's, never to be paired with ``t``'s own memory."""
    if t.is_contiguous():
        ptr = t.data_ptr()
        if ptr % 16 == 0:
            return ptr, C, t.numel() // C, t
    t2 = _rows(name, t, C, copy)
    return t2.data_ptr(), t2.stride(0), t2.shape[0], t2


def _launch_fwd(x, weight, bias, eps):
    """-> (y, xrows, plan): ``xrows`` is the (rows, C) tensor whose memory
    K10 read (``x`` itself, a view of it, or a copy where ``x``'s leading
    axes do not fold into one row stride) and ``plan`` = (row stride, rows,
    C, dtype code, ``x``'s shape), all the backward needs to know of what
    was checked here. K11 must read ``xrows``: the plan describes it, not
    ``x``."""
    C = x.shape[-1]
    code = DTYPE_CODES.get(x.dtype)
    if code is None or C % 8 or C > MAX_C or x.numel() == 0 \
            or not (_param_ok(weight, x, C) and _param_ok(bias, x, C)):
        _refuse(x, weight, bias)
    ptr, stride, rows, xrows = _rows_of('x', x, C)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    FWD_KERNEL.launch(x.device, ptr, stride, weight.data_ptr(),
                      bias.data_ptr(), rows, C, eps, code, y.data_ptr(),
                      *forward_plan(rows, C, code, device_sm_count(x.device)),
                      PDL)
    return y, xrows, (stride, rows, C, code, x.shape)


def _plain(x, weight, bias, eps):
    return layer_norm_plain(x, weight, bias, eps).contiguous()


def _launch(x, weight, bias, eps):
    return _launch_fwd(x, weight, bias, eps)[0]


def _fake(x, weight, bias, eps):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


LAYER_NORM = custom_op('layer_norm(Tensor x, Tensor weight, Tensor bias, '
                       'float eps) -> Tensor', _plain, _launch, _fake)


# K11's scratch memory: for each (device index, stream, C, capacity) one
# float32 tensor of ``capacity * 2 * C`` partials, the groups' sums and the
# ticket counters behind them (:func:`workspace_floats`), zeroed when it is
# made (a launch that runs to its end leaves the counters at 0; one that
# raised gives its workspace up). Launches on one stream run in order, so
# they may share it; two streams, two widths or two capacities (whose
# counters lie at other offsets) never do.
WORKSPACES = {}


def bwd_capacity(index, C):
    """The most blocks a K11 launch of width ``C`` takes on device
    ``index``."""
    return sm_count(index) * (_BWD_BLOCKS_PER_SM if C <= 256
                              else _BWD_BLOCKS_PER_SM_WIDE)


def workspace(index, stream, C, capacity):
    """-> the workspace tensor of this key, made at its first use."""
    key = (index, stream, C, capacity)
    ws = WORKSPACES.get(key)
    if ws is None:
        ws = WORKSPACES[key] = torch.zeros(
            workspace_floats(capacity, C), dtype=torch.float32,
            device=torch.device('cuda', index))
    return ws


def workspace_floats(capacity, C):
    """Size of K11's workspace for ``capacity`` blocks of width ``C``: the
    blocks' (2, C) partials, one (2, C) sum for each group of blocks, one
    ticket counter for the groups' round and one for each group."""
    groups = -(-capacity // _GROUP_BLOCKS)
    return (capacity + groups) * 2 * C + 1 + groups


def workspace_tickets(ws, C, capacity):
    """The ticket counters at the end of workspace ``ws``, as int32: all 0
    between launches."""
    groups = -(-capacity // _GROUP_BLOCKS)
    return ws[(capacity + groups) * 2 * C:].view(torch.int32)


def bwd_blocks(rows, C, capacity):
    """K11's grid for (rows, C): one block for each 256 / lanes rows, at
    most ``capacity``."""
    return min(-(-rows // (_THREADS // _bwd_lanes(C))), capacity)


def _launch_bwd(xrows, weight, dy, eps, plan, want_params=True):
    """-> (dx, dwdb): ``dwdb`` (2, C) float32, dweight then dbias, or None
    without ``want_params``. ``xrows`` and ``plan`` are the forward's."""
    stride, rows, C, code, shape = plan
    if dy.dtype != xrows.dtype or dy.shape != shape \
            or dy.device != xrows.device:
        raise ValueError(f'fused_layer_norm: the incoming gradient is '
                         f'{dy.dtype} {tuple(dy.shape)} on {dy.device}, the '
                         f'input {xrows.dtype} {tuple(shape)} on '
                         f'{xrows.device}')
    # a gradient whose last axis is strided (it was produced in another
    # layout, e.g. NCHW) or misaligned, or whose leading axes do not fold,
    # is copied; a row stride is passed on
    dptr, dstride, _, _dkeep = _rows_of('dy', dy, C, copy=True)
    device = xrows.device
    dx = torch.empty(shape, dtype=xrows.dtype, device=device)
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    capacity = bwd_capacity(index, C)
    key = dwdb = ws_ptr = dwdb_ptr = None
    if want_params:
        key = (index, torch._C._cuda_getCurrentRawStream(index), C, capacity)
        ws_ptr = workspace(*key).data_ptr()
        dwdb = torch.empty((2, C), dtype=torch.float32, device=device)
        dwdb_ptr = dwdb.data_ptr()
    try:
        BWD_KERNEL.launch(device, xrows.data_ptr(), stride, dptr, dstride,
                          weight.data_ptr(), rows, C, eps, code,
                          dx.data_ptr(), ws_ptr, capacity,
                          bwd_blocks(rows, C, capacity), dwdb_ptr)
    except BaseException:
        # its counters may not be at 0: the next launch gets a fresh one
        WORKSPACES.pop(key, None)
        raise
    return dx, dwdb


class _LayerNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.eps = eps
        ctx.set_materialize_grads(False)
        # the backward never reads bias: the graph does not keep it
        if x.device.type == 'cpu':
            ctx.save_for_backward(x, weight)
            return layer_norm_plain(x, weight, bias, eps)
        # the rows K10 read, which the plan describes: x, a view of it, or
        # a copy where x's leading axes do not fold
        y, xrows, ctx.plan = _launch_fwd(x, weight, bias, eps)
        ctx.save_for_backward(xrows, weight)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        if dy is None:
            return None, None, None, None
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        if x.device.type == 'cpu':
            with torch.enable_grad():
                # dbias does not depend on bias's values
                args = [t.detach().requires_grad_()
                        for t in (x, weight, torch.zeros_like(weight))]
                y = layer_norm_plain(*args, ctx.eps)
                dx, dw, db = torch.autograd.grad(y, args, dy)
        else:
            dx, dwdb = _launch_bwd(x, weight, dy, ctx.eps, ctx.plan,
                                   need_w or need_b)
            dw, db = (None, None) if dwdb is None else (dwdb[0], dwdb[1])
        return (dx if need_x else None, dw if need_w else None,
                db if need_b else None, None)


def fused_layer_norm(x, weight, bias, eps=1e-6):
    """LayerNorm over the last axis. ``x`` (..., C) in float32 or bfloat16;
    ``weight``/``bias`` (C,) float32, used as stored (no cast copy). ->
    ``x``'s shape and dtype, contiguous. Differentiable in all three.

    The kernels read rows whose last axis is contiguous, one row stride
    apart (leading axes that fold into one stride, as ``x[:, ::2]``'s do,
    are read in place). An ``x`` with a strided last axis (the token view
    of an NCHW convolution output, as MiT's first patch embedding gives) is
    copied to contiguous memory first, by one ``contiguous()`` here; one
    whose leading axes do not fold (``x[:, 1:]``) by the forward's
    ``reshape``, and the backward reads that copy; such an incoming
    gradient is copied in the backward."""
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'fused_layer_norm: unsupported device {x.device}')
    if x.is_cuda and x.stride(-1) != 1:
        x = x.contiguous()
    if not (torch.is_grad_enabled() and (
            x.requires_grad or weight.requires_grad or bias.requires_grad)):
        # nothing to differentiate (a frozen teacher, serving)
        if x.is_cuda and not torch.compiler.is_compiling():
            # eager on the card: the launch without the dispatcher (a CGD
            # step's frozen teacher makes 89 of these calls)
            return _launch_fwd(x, weight, bias, float(eps))[0]
        # traced, or on a CPU tensor: the operator (one node of an
        # exported program)
        return LAYER_NORM(x, weight, bias, float(eps))
    return _LayerNorm.apply(x, weight, bias, float(eps))
