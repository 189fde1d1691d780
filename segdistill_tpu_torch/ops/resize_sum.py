"""K1: sum of bilinear upsamples of K NHWC maps to one grid.

Replaces ``segdistill_tpu/ops/pallas/resize_sum.py::fused_resize_sum``
(the Pallas call at ``resize_sum.py:235``). The kernel is
``csrc/resize_sum.cu``: one thread per 16-byte channel vector of one output
pixel, fp32 taps and sum, one store. It is bound by memory traffic: the
output write (67 MB at the B0 head, batch 8, bf16) and four tap loads per
part for every stored vector, which L1/L2 serve. It takes any ratio,
integer or not; the TPU kernel's eligibility gate is not carried over.

On a CPU tensor :func:`fused_resize_sum` runs :func:`resize_sum_plain`; on a
CUDA tensor it launches the kernel or raises.
"""

import ctypes

import torch
import torch.nn.functional as F

from .cuda_kernel import CudaKernel, check_cuda_inputs

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


def fused_resize_sum(parts, out_hw):
    """sum_k bilinear_upsample(parts[k], out_hw), align_corners=False.

    parts: sequence of NHWC tensors ``(B, h_k, w_k, C)``. Returns
    ``(B, H, W, C)`` in the parts' dtype.
    """
    parts = tuple(parts)
    B, H, W, C = _check(parts, out_hw)
    if parts[0].device.type == 'cpu':
        return resize_sum_plain(parts, (H, W))
    if parts[0].device.type != 'cuda':
        raise ValueError(f'fused_resize_sum: unsupported device '
                         f'{parts[0].device}')
    dtype_code = check_cuda_inputs('fused_resize_sum', parts)
    if B > 65535 or H > 65535:
        raise ValueError(f'fused_resize_sum: batch {B} and height {H} must '
                         f'be <= 65535 (grid dims)')
    vec = 16 // parts[0].element_size()
    if C % vec or any(p.data_ptr() % 16 for p in parts):
        raise ValueError(f'fused_resize_sum: the CUDA kernel moves 16-byte '
                         f'channel vectors, so C must be a multiple of {vec} '
                         f'and every part 16-byte aligned, got C={C}')
    out = torch.empty((B, H, W, C), dtype=parts[0].dtype,
                      device=parts[0].device)
    n = len(parts)
    ptrs = (ctypes.c_void_p * n)(*[p.data_ptr() for p in parts])
    hs = (ctypes.c_int * n)(*[p.shape[1] for p in parts])
    ws = (ctypes.c_int * n)(*[p.shape[2] for p in parts])
    KERNEL.launch(out.device, ptrs, hs, ws, n, out.data_ptr(), B, H, W, C,
                  dtype_code, vec)
    return out
