"""K2/K9: MiT spatial-reduction attention, forward and backward.

Replaces ``segdistill_tpu/ops/pallas/sra_attn.py``'s
``fused_sra_attention`` (the Pallas call at ``sra_attn.py:78``) and
``sra_attention_train`` (its forward is that kernel; its backward is the
Pallas call at ``:182``). The kernels are ``csrc/sra_attn.cu``: K2, one
block per (b*h, 128 query rows), K/V streamed through shared memory with an
fp32 online softmax, so any N and M work and the scores never reach device
memory; for training it also keeps each row's log-sum-exp. K9 recomputes
the probabilities from it: dq one query row per thread, dk and dv one key
row per thread over splits of N whose fp32 partials are summed in a fixed
order. Both are bound by CUDA-core FMAs (2*N*M*d per head forward, 7*N*M*d
backward); tensor cores are later work. The TPU gate (N % 128, M <= 2048) is
not carried over: the kernels take d <= 128 with d % 8 == 0.

On a CPU tensor :func:`fused_sra_attention` runs :func:`sra_attention_plain`
and :func:`sra_attention_train` also its autograd gradient; on a CUDA
tensor they launch the kernels or raise.
"""

import ctypes

import torch

from .cuda_kernel import CudaKernel, check_cuda_inputs

_P = ctypes.c_void_p
_I = ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)

KERNEL = CudaKernel(
    'sra_attn', 'sra_attn_fwd',
    argtypes=[_P, _P, _P, _P, _I, _I, _I, _I, _I, _STRIDES, _STRIDES,
              _STRIDES, _STRIDES, ctypes.c_float, _I, _P, _P],
    replaces='segdistill_tpu/ops/pallas/sra_attn.py:78')
BWD_KERNEL = CudaKernel(
    'sra_attn_bwd', 'sra_attn_bwd', source='sra_attn',
    argtypes=[_P] * 12 + [_I] * 7 + [_STRIDES, ctypes.c_float, _I],
    replaces='segdistill_tpu/ops/pallas/sra_attn.py:182')

# blocks the dk/dv pass aims for: 132 SMs x 4 blocks of 128 threads
_TARGET_BLOCKS = 132 * 4
_KEYS_PER_BLOCK = 128  # kRows in csrc/sra_attn.cu


def sra_attention_plain(q, k, v, scale):
    """The plain version: fp32 scores, fp32 softmax, fp32 product with v,
    output in the input dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.matmul(s.softmax(dim=-1), v.float()).to(q.dtype)


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError('fused_sra_attention takes (B, h, N, d) tensors')
    B, h, _, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, h) or k.shape[3] != d:
        raise ValueError(f'shape mismatch: q {tuple(q.shape)}, '
                         f'k {tuple(k.shape)}, v {tuple(v.shape)}')
    if k.shape[2] < 1:
        raise ValueError('fused_sra_attention needs at least one key')


def _strides(*tensors):
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _heads_last(shape, dtype, device):
    """(B, h, n, d) view of (B, n, h, d) memory: merging the heads back
    into (B, n, h*d) needs no copy."""
    B, h, n, d = shape
    return torch.empty((B, n, h, d), dtype=dtype,
                       device=device).transpose(1, 2)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fwd(q, k, v, scale, for_backward=False):
    """K2 -> (out, lse, out32); lse (B*h, N) and the fp32 output only
    ``for_backward`` (out32 is ``out`` for float32 inputs)."""
    if q.device.type != 'cuda':
        raise ValueError(f'fused_sra_attention: unsupported device '
                         f'{q.device}')
    dtype_code = check_cuda_inputs('fused_sra_attention', (q, k, v))
    B, h, N, d = q.shape
    M = k.shape[2]
    if d > 128 or d % 8:
        raise ValueError(f'fused_sra_attention takes head dims <= 128 and a '
                         f'multiple of 8, got {d}')
    if B * h > 65535:
        raise ValueError(f'fused_sra_attention: B*h = {B * h} > 65535')
    for name, t in (('q', q), ('k', k), ('v', v)):
        if t.stride(3) != 1:
            raise ValueError(f'fused_sra_attention: {name} needs a '
                             f'contiguous last dim')
    out = _heads_last(q.shape, q.dtype, q.device)
    lse = out32 = None
    if for_backward:
        lse = torch.empty((B * h, N), dtype=torch.float32, device=q.device)
        out32 = out if q.dtype == torch.float32 else \
            _heads_last(q.shape, torch.float32, q.device)
    KERNEL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), B, h, N, M, d, _strides(q), _strides(k),
                  _strides(v), _strides(out), float(scale), dtype_code,
                  _ptr(lse), None if out32 is out else _ptr(out32))
    return out, lse, out32


def _splits(N, blocks):
    """(splits of the query rows, rows per split) for the dk/dv pass:
    enough blocks to fill the card, whole chunks of 32 rows, at least 64
    rows each."""
    per_split = -(-N // -(-_TARGET_BLOCKS // blocks))
    rows = max(64, -(-per_split // 32) * 32)
    return -(-N // rows), rows


def _launch_bwd(q, k, v, out32, lse, g, scale):
    dtype_code = check_cuda_inputs('sra_attention_train', (q, k, v))
    B, h, N, d = q.shape
    M = k.shape[2]
    g = g.to(q.dtype)
    if g.stride(3) != 1:
        g = g.contiguous()
    dq = _heads_last(q.shape, q.dtype, q.device)
    dk = _heads_last(k.shape, k.dtype, k.device)
    dv = _heads_last(v.shape, v.dtype, v.device)
    splits, rows = _splits(N, -(-M // _KEYS_PER_BLOCK) * B * h)
    f32 = dict(dtype=torch.float32, device=q.device)
    dsum = torch.empty((B * h, N), **f32)
    part = torch.empty((2, splits, B * h, M, d), **f32)
    BWD_KERNEL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out32.data_ptr(), g.data_ptr(), lse.data_ptr(),
                      dsum.data_ptr(), part[0].data_ptr(),
                      part[1].data_ptr(), dq.data_ptr(), dk.data_ptr(),
                      dv.data_ptr(), B, h, N, M, d, splits, rows,
                      _strides(q, k, v, out32, g, dq, dk, dv), float(scale),
                      dtype_code)
    return dq, dk, dv


def fused_sra_attention(q, k, v, scale):
    """softmax(q @ k^T * scale) @ v with fp32 scores and softmax, forward
    only: the output carries no gradient on CUDA.

    q (B, h, N, d); k, v (B, h, M, d) -> (B, h, N, d) in q's dtype. Inputs
    may be strided views whose last dim is contiguous. On CUDA the result
    is a view of (B, N, h, d) memory, so merging the heads back into
    (B, N, h*d) needs no copy.
    """
    _check(q, k, v)
    if q.device.type == 'cpu':
        return sra_attention_plain(q, k, v, scale)
    return _launch_fwd(q, k, v, scale)[0]


class _SRATrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        if q.device.type == 'cpu':
            ctx.save_for_backward(q, k, v)
            return sra_attention_plain(q, k, v, scale)
        out, lse, out32 = _launch_fwd(q, k, v, scale, for_backward=True)
        ctx.save_for_backward(q, k, v, out32, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.saved_tensors[0].device.type == 'cpu':
            with torch.enable_grad():
                qkv = [t.detach().requires_grad_()
                       for t in ctx.saved_tensors]
                grads = torch.autograd.grad(
                    sra_attention_plain(*qkv, ctx.scale), qkv, g)
        else:
            grads = _launch_bwd(*ctx.saved_tensors, g, ctx.scale)
        return (*grads, None)


def sra_attention_train(q, k, v, scale):
    """:func:`fused_sra_attention` with a gradient: on CUDA K2 keeps each
    row's log-sum-exp and K9 computes dq, dk and dv in the inputs' shapes
    and dtype. Without a gradient to compute it is the forward-only call."""
    _check(q, k, v)
    if not (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return fused_sra_attention(q, k, v, scale)
    return _SRATrain.apply(q, k, v, float(scale))
