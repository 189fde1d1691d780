"""K2: MiT spatial-reduction attention, forward only.

Replaces ``segdistill_tpu/ops/pallas/sra_attn.py::fused_sra_attention``
(the Pallas call at ``sra_attn.py:78``). The kernel is
``csrc/sra_attn.cu``: one block per (b*h, 128 query rows), K/V streamed
through shared memory with an fp32 online softmax, so any N and M work and
the scores never reach device memory. It is bound by CUDA-core FMAs
(4*N*M*d per head); tensor cores are later work. The TPU gate (N % 128,
M <= 2048) is not carried over: the kernel takes d <= 128 with d % 8 == 0.

On a CPU tensor :func:`fused_sra_attention` runs :func:`sra_attention_plain`;
on a CUDA tensor it launches the kernel or raises.
"""

import ctypes

import torch

from .cuda_kernel import CudaKernel, check_cuda_inputs

_STRIDES = ctypes.POINTER(ctypes.c_longlong)

KERNEL = CudaKernel(
    'sra_attn', 'sra_attn_fwd',
    argtypes=[ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, _STRIDES, _STRIDES, _STRIDES,
              _STRIDES, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    replaces='segdistill_tpu/ops/pallas/sra_attn.py:78')


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


def _strides(t):
    return (ctypes.c_longlong * 3)(*t.stride()[:3])


def fused_sra_attention(q, k, v, scale):
    """softmax(q @ k^T * scale) @ v with fp32 scores and softmax.

    q (B, h, N, d); k, v (B, h, M, d) -> (B, h, N, d) in q's dtype. Inputs
    may be strided views whose last dim is contiguous. On CUDA the result
    is a view of (B, N, h, d) memory, so merging the heads back into
    (B, N, h*d) needs no copy.
    """
    _check(q, k, v)
    if q.device.type == 'cpu':
        return sra_attention_plain(q, k, v, scale)
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
    out = torch.empty((B, N, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    for name, t in (('q', q), ('k', k), ('v', v)):
        if t.stride(3) != 1:
            raise ValueError(f'fused_sra_attention: {name} needs a '
                             f'contiguous last dim')
    KERNEL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), B, h, N, M, d, _strides(q), _strides(k),
                  _strides(v), _strides(out), float(scale), dtype_code)
    return out
