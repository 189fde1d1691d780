"""K1: sum of bilinear upsamples of K NHWC maps to one grid.

Replaces ``segdistill_tpu/ops/pallas/resize_sum.py::fused_resize_sum``
(the Pallas call at ``resize_sum.py:235``). The kernel is
``csrc/resize_sum.cu``: a thread owns one 16-byte channel vector at one
output column and walks 16 output rows of it, keeping each part's two
x-lerped source rows in registers and loading a source row only when the
part's y tap moves on (~2.5 loads a stored vector at the head's ratios,
where one thread per stored vector took 12); fp32 lerps and sum, one
streaming store per vector. Its bound is the output write (67 MB at the B0
head, batch 8, bf16; 201 MB at the B3 teacher's E = 768). It takes any
ratio, integer or not; the TPU kernel's eligibility gate is not carried
over.

The forward is also the custom operator ``segdistill::resize_sum``
(:data:`RESIZE_SUM`): the dispatcher runs :func:`resize_sum_plain` on a CPU
tensor and launches the kernel (or raises) on a CUDA tensor, and
``torch.export`` keeps the call as one node. :func:`fused_resize_sum` calls
it where no part needs a gradient and the call is traced or on a CPU
tensor; an eager call on a CUDA tensor launches directly, as K10's do
(``ops/layer_norm.py``). Where a part needs a gradient it is a
``torch.autograd.Function`` whose forward runs the plain version on a CPU
tensor and launches the kernel on a CUDA tensor, and whose backward is the
adjoint of the plain version, as the JAX kernel's VJP takes XLA's resize
adjoint (``resize_sum.py:255-267``): torch's bilinear-upsample backward for
each part. On the card that backward adds with atomics, so no two runs
agree bitwise. Inside :func:`deterministic_adjoint` (steps per dispatch: a
train step's CUDA graph and the eager steps of the same run) a CUDA
tensor's backward is :func:`resize_adjoint` instead: the same adjoint,
summed in a fixed order.
"""

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from .cuda_kernel import CudaKernel, check_cuda_inputs, custom_op

MAX_PARTS = 8

KERNEL = CudaKernel(
    'resize_sum', 'resize_sum_fwd',
    argtypes=[ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p],
    replaces='segdistill_tpu/ops/pallas/resize_sum.py:235')


def resize_sum_plain(parts, out_hw):
    """The plain version: fp32 ``F.interpolate`` per part, summed, cast
    back to the parts' dtype."""
    acc = None
    for p in parts:
        r = F.interpolate(p.permute(0, 3, 1, 2).float(), size=tuple(out_hw),
                          mode='bilinear', align_corners=False)
        acc = r if acc is None else acc + r
    return acc.permute(0, 2, 3, 1).to(parts[0].dtype).contiguous()


def _check(parts, out_hw):
    if not parts:
        raise ValueError('fused_resize_sum needs at least one part')
    if len(parts) > MAX_PARTS:
        raise ValueError(f'fused_resize_sum takes at most {MAX_PARTS} parts, '
                         f'got {len(parts)}')
    B, C = parts[0].shape[0], parts[0].shape[-1]
    for p in parts:
        if p.ndim != 4:
            raise ValueError(f'parts must be 4D NHWC, got {tuple(p.shape)}')
        if p.shape[0] != B or p.shape[3] != C:
            raise ValueError('parts must share batch and channels, got '
                             f'{[tuple(q.shape) for q in parts]}')
        if not p.is_contiguous():
            raise ValueError('fused_resize_sum takes contiguous NHWC parts')
    H, W = (int(s) for s in out_hw)
    if H < 1 or W < 1:
        raise ValueError(f'bad output size {out_hw}')
    return B, H, W, C


def _launch(parts, out_h, out_w):
    """The operator's CUDA implementation: K1 into a fresh (B, H, W, C)
    tensor, after the checks that read the parts' dtype and addresses."""
    dtype_code = check_cuda_inputs('fused_resize_sum', parts)
    B, C = parts[0].shape[0], parts[0].shape[3]
    if B > 65535 or out_h > 65535:
        raise ValueError(f'fused_resize_sum: batch {B} and height {out_h} '
                         f'must be <= 65535 (grid dims)')
    vec = 16 // parts[0].element_size()
    if C % vec or any(p.data_ptr() % 16 for p in parts):
        raise ValueError(f'fused_resize_sum: the CUDA kernel moves 16-byte '
                         f'channel vectors, so C must be a multiple of {vec} '
                         f'and every part 16-byte aligned, got C={C}')
    out = torch.empty((B, out_h, out_w, C), dtype=parts[0].dtype,
                      device=parts[0].device)
    n = len(parts)
    ptrs = (ctypes.c_void_p * n)(*[p.data_ptr() for p in parts])
    hs = (ctypes.c_int * n)(*[p.shape[1] for p in parts])
    ws = (ctypes.c_int * n)(*[p.shape[2] for p in parts])
    KERNEL.launch(out.device, ptrs, hs, ws, n, out.data_ptr(), B, out_h,
                  out_w, C, dtype_code, vec)
    return out


def _plain(parts, out_h, out_w):
    return resize_sum_plain(parts, (out_h, out_w))


def _fake(parts, out_h, out_w):
    p = parts[0]
    return p.new_empty((p.shape[0], out_h, out_w, p.shape[3]))


RESIZE_SUM = custom_op('resize_sum(Tensor[] parts, int out_h, int out_w) '
                       '-> Tensor', _plain, _launch, _fake)


class _ResizeSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, out_hw, *parts):
        ctx.out_hw = out_hw
        ctx.parts = [(tuple(p.shape), p.dtype) for p in parts]
        if parts[0].device.type == 'cpu':
            return resize_sum_plain(parts, out_hw)
        return _launch(parts, *out_hw)

    @staticmethod
    def backward(ctx, grad):
        if grad.device.type == 'cuda' and _DETERMINISTIC[0]:
            return (None, *resize_adjoint(grad, ctx.parts))
        g = grad.permute(0, 3, 1, 2).float()
        grads = []
        for (B, h, w, C), dtype in ctx.parts:
            d = torch.ops.aten.upsample_bilinear2d_backward(
                g, list(ctx.out_hw), [B, C, h, w], False, None, None)
            grads.append(d.permute(0, 2, 3, 1).to(dtype))
        return (None, *grads)


# whether the backward on a CUDA tensor is :func:`resize_adjoint`
_DETERMINISTIC = [False]


@contextlib.contextmanager
def deterministic_adjoint():
    """Within it, K1's backward on a CUDA tensor sums in a fixed order
    (:func:`resize_adjoint`), so that two runs, or two replays of a CUDA
    graph, agree bitwise."""
    before = _DETERMINISTIC[0]
    _DETERMINISTIC[0] = True
    try:
        yield
    finally:
        _DETERMINISTIC[0] = before


# the resize matrices of :func:`resize_adjoint` for each (out, in, device),
# made at their first use (before a CUDA graph's capture: its warm-up)
RESIZE_MATRICES = {}


def resize_matrix(out_size, in_size):
    """(out_size, in_size) float32 weights of torch's bilinear resize along
    one axis (align_corners=False): output i takes ``1 - l`` of source
    ``i0`` and ``l`` of ``min(i0 + 1, in - 1)``, with ``src = max((i + 0.5)
    * in / out - 0.5, 0)``, ``i0 = floor(src)``, ``l = src - i0``, in
    float32 as torch's kernel computes them."""
    scale = torch.tensor(in_size / out_size, dtype=torch.float32)
    dst = torch.arange(out_size, dtype=torch.float32)
    src = ((dst + 0.5) * scale - 0.5).clamp_min(0.0)
    i0 = src.floor().long().clamp_max(in_size - 1)
    i1 = (i0 + 1).clamp_max(in_size - 1)
    lam = src - i0.float()
    rows = torch.arange(out_size)
    m = torch.zeros(out_size, in_size, dtype=torch.float32)
    m.index_put_((rows, i0), 1.0 - lam, accumulate=True)
    m.index_put_((rows, i1), lam, accumulate=True)
    return m


def _matrix(out_size, in_size, device):
    key = (out_size, in_size, device)
    if key not in RESIZE_MATRICES:
        RESIZE_MATRICES[key] = resize_matrix(out_size, in_size).to(device)
    return RESIZE_MATRICES[key]


def resize_adjoint(grad, parts):
    """The parts' gradients of the resize-sum for ``grad`` (B, H, W, C),
    in float32 and in a fixed order (no atomics): for each part (its
    ``((B, h, w, C), dtype)``), ``Ry^T . grad . Rx`` over (H, W) as two
    products with the resize's (out, in) matrices on NHWC data, cast to
    the part's dtype. On the card it is also faster than the atomic
    backward at the SegFormer heads' shapes
    (``tools/bench_resize_adjoint.py``)."""
    B, H, W, C = grad.shape
    g = grad.float().contiguous()
    grads = []
    for (_, h, w, _), dtype in parts:
        if (h, w) == (H, W):
            d = g
        else:
            ry = _matrix(H, h, g.device)
            rx = _matrix(W, w, g.device)
            t = torch.matmul(ry.t(), g.reshape(B, H, W * C))  # (B, h, W*C)
            d = torch.matmul(rx.t(), t.reshape(B * h, W, C))  # (B*h, w, C)
            d = d.reshape(B, h, w, C)
        grads.append(d.to(dtype))
    return grads


def fused_resize_sum(parts, out_hw):
    """sum_k bilinear_upsample(parts[k], out_hw), align_corners=False.

    parts: sequence of NHWC tensors ``(B, h_k, w_k, C)``. Returns
    ``(B, H, W, C)`` in the parts' dtype, differentiable in every part.
    """
    parts = tuple(parts)
    _, H, W, _ = _check(parts, out_hw)
    if parts[0].device.type not in ('cpu', 'cuda'):
        raise ValueError(f'fused_resize_sum: unsupported device '
                         f'{parts[0].device}')
    if not (torch.is_grad_enabled() and any(p.requires_grad
                                            for p in parts)):
        # nothing to differentiate (serving, a frozen teacher)
        if parts[0].is_cuda and not torch.compiler.is_compiling():
            # eager on the card: the launch without the dispatcher
            return _launch(parts, H, W)
        # traced, or on a CPU tensor: the operator (one node of an
        # exported program)
        return RESIZE_SUM(list(parts), H, W)
    return _ResizeSum.apply((H, W), *parts)
