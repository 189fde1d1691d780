"""K7/K8: the pixel-wise distillation (PD) loss, forward and backward.

Replaces ``segdistill_tpu/ops/pallas/pixel_kl.py::fused_pixel_kl`` (the
Pallas calls at ``pixel_kl.py:169``, forward, and ``:200``, backward). The
kernels are ``csrc/pixel_kl.cu``: K7 is the forward tile kernel of
``csrc/common.cuh`` that K3 and K5 share: a block owns an image's tile of
32 x 64 output pixels and walks the channels in chunks of 4 of both maps,
whose windows of sources sit in shared memory; each pixel keeps, per map,
its running maximum and exp-sum and the cross term of the KL, rescaled once
a chunk, and writes its two log-sum-exps for K8; the last block to finish
sums the blocks' KLs in a fixed order. :func:`forward_plan` is its launch's
planning, which the source checks; where a window is larger than the block
stages (upsampling ratios near 1, downsampling) it names the gather
variant, one output pixel per thread. K8 is the tile kernel of
``csrc/common.cuh`` that K6 and K4 share: a block owns a tile of source
pixels and a chunk of the channels, keeps the two log-sum-exps of the
outputs that read the tile in shared memory once, and per channel
evaluates p_s - p_t once at every one of those outputs and sums it back
through the transposed upsample one axis after the other.
:func:`backward_plan` is its launch's planning (``ops/tile_plan.py``),
which the source checks; where no tile fits (upsampling ratios above ~15)
the plan names the gather variant, one thread per source element. The
upsampled maps never reach memory, and any output size works: the TPU
integer-ratio gate is not carried over.

:func:`fused_pixel_kl` is a ``torch.autograd.Function`` on every device: on
a CPU tensor the forward is :func:`pixel_kl_plain` and the backward its
autograd gradient; on a CUDA tensor the forward launches K7 and the backward
K8, or they raise. The teacher gets no gradient.
"""

import ctypes

import torch
import torch.nn.functional as F

from . import tile_plan
from .cuda_kernel import (CudaKernel, check_cuda_inputs, device_sm_count,
                          ticket)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_THREADS = 256  # kThreads in csrc/common.cuh: the gather variant's block

FWD_KERNEL = CudaKernel(
    'pixel_kl_fwd', 'pixel_kl_fwd', source='pixel_kl',
    argtypes=[_P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _P,
              _P, _P, _P, _P],
    replaces='segdistill_tpu/ops/pallas/pixel_kl.py:169')
BWD_KERNEL = CudaKernel(
    'pixel_kl_bwd', 'pixel_kl_bwd', source='pixel_kl',
    argtypes=[_P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P, _P, _P, _P, _I,
              _I, _I, _I, _I],
    replaces='segdistill_tpu/ops/pallas/pixel_kl.py:200')

# K8 on the tile of csrc/common.cuh (pkl_tile in csrc/pixel_kl.cu): two
# per-output maps (the log-sum-exps), two maps read, compiled for three
# blocks an SM
RECT_MAPS, SRC_MAPS, BLOCKS_PER_SM = 2, 2, 3


def backward_plan(B, C, h, w, H, W, sms=132):
    """K8's launch for (B, C, h, w) maps upsampled to (H, W) on a card of
    ``sms`` SMs: :func:`tile_plan.plan` with K8's maps and blocks an SM."""
    return tile_plan.plan(B, C, h, w, H, W, sms, RECT_MAPS, SRC_MAPS,
                          BLOCKS_PER_SM)


# K7 on the forward tile of csrc/common.cuh (pkl_fwd_tile in
# csrc/pixel_kl.cu): a step reads 4 channels of both maps (8 units), 8 rows
# a thread, one window element a thread and unit
FWD_UNITS, FWD_ROWS, FWD_SLOTS = 8, 8, 1


def forward_plan(h, w, H, W):
    """K7's launch for (h, w) maps upsampled to (H, W):
    :func:`tile_plan.forward_plan` with K7's counts."""
    return tile_plan.forward_plan(h, w, H, W, FWD_UNITS, FWD_ROWS,
                                  FWD_SLOTS)


def pixel_kl_plain(xs, xt, out_hw, tau):
    """The plain version: fp32 ``F.interpolate`` of both maps to
    ``out_hw`` and ``KL(softmax(xt/tau) || softmax(xs/tau))`` over the
    channels at every pixel, summed over all B*H*W pixels (no ignore
    mask). Differentiable."""
    xs = F.interpolate(xs.float(), size=tuple(out_hw), mode='bilinear',
                       align_corners=False)
    xt = F.interpolate(xt.float(), size=tuple(out_hw), mode='bilinear',
                       align_corners=False)
    log_s = F.log_softmax(xs / tau, dim=1)
    p_t = F.softmax(xt / tau, dim=1)
    return (torch.xlogy(p_t, p_t) - p_t * log_s).sum()


def _launch_fwd(xs, xt, out_hw, tau):
    dtype_code = check_cuda_inputs('fused_pixel_kl', (xs, xt))
    B, C, h, w = xs.shape
    H, W = out_hw
    plan = forward_plan(h, w, H, W)
    f32 = dict(dtype=torch.float32, device=xs.device)
    lse = torch.empty((2, B, H, W), **f32)
    blocks = plan['tiles'] if plan['oh'] else -(-H * W // _THREADS)
    part = torch.empty(B * blocks, **f32)
    kl = torch.empty((), **f32)
    with ticket(xs.device, plan['oh'] > 0) as ticket_ptr:
        FWD_KERNEL.launch(xs.device, xs.data_ptr(), xt.data_ptr(), B, C, h,
                          w, H, W, tau, dtype_code,
                          *tile_plan.forward_plan_args(plan),
                          lse[0].data_ptr(), lse[1].data_ptr(),
                          part.data_ptr(), ticket_ptr, kl.data_ptr())
    return kl, lse


def _launch_bwd(xs, xt, out_hw, tau, lse, gbar):
    dtype_code = check_cuda_inputs('fused_pixel_kl', (xs, xt))
    B, C, h, w = xs.shape
    H, W = out_hw
    dxs = torch.empty_like(xs)
    gbar = gbar.detach().to(torch.float32).contiguous()
    plan = backward_plan(B, C, h, w, H, W, device_sm_count(xs.device))
    BWD_KERNEL.launch(xs.device, xs.data_ptr(), xt.data_ptr(), B, C, h, w, H,
                      W, tau, dtype_code, lse[0].data_ptr(),
                      lse[1].data_ptr(), gbar.data_ptr(), dxs.data_ptr(),
                      *tile_plan.plan_args(plan))
    return dxs


class _PixelKL(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xs, xt, out_hw, tau):
        ctx.cfg = (out_hw, tau)
        if xs.device.type == 'cpu':
            ctx.save_for_backward(xs, xt)
            return pixel_kl_plain(xs, xt, out_hw, tau)
        kl, lse = _launch_fwd(xs, xt, out_hw, tau)
        ctx.save_for_backward(xs, xt, lse)
        return kl

    @staticmethod
    def backward(ctx, gbar):
        out_hw, tau = ctx.cfg
        if ctx.saved_tensors[0].device.type == 'cpu':
            xs, xt = ctx.saved_tensors
            with torch.enable_grad():
                a = xs.detach().requires_grad_()
                (dxs,) = torch.autograd.grad(
                    pixel_kl_plain(a, xt, out_hw, tau), a, gbar)
        else:
            xs, xt, lse = ctx.saved_tensors
            dxs = _launch_bwd(xs, xt, out_hw, tau, lse, gbar)
        return dxs, None, None, None


def fused_pixel_kl(xs, xt, out_hw, tau):
    """Sum over the B*H*W pixels of the per-pixel channel-softmax
    KL(teacher || student) at ``out_hw``: a 0-d fp32 loss; the 'pixel'
    transform divides it by B*H*W. xs, xt: (B, C, h, w) NCHW in float32
    or bfloat16; only ``xs`` gets a gradient."""
    if xs.ndim != 4 or xs.shape != xt.shape:
        raise ValueError(f'fused_pixel_kl takes two (B, C, h, w) maps of one '
                         f'shape, got {tuple(xs.shape)} and '
                         f'{tuple(xt.shape)}')
    H, W = (int(s) for s in out_hw)
    if H < 1 or W < 1 or not tau > 0:
        raise ValueError(f'bad output size {out_hw} or tau {tau}')
    xt = xt.detach()
    if xs.device.type == 'cuda':
        if xs.dtype != xt.dtype:  # exact: both upcast, as the kernel would
            xs, xt = xs.float(), xt.float()
        xs, xt = xs.contiguous(), xt.contiguous()
    elif xs.device.type != 'cpu':
        raise ValueError(f'fused_pixel_kl: unsupported device {xs.device}')
    return _PixelKL.apply(xs, xt, (H, W), float(tau))
