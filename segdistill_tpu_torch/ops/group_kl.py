"""K3/K4: the channel-group KL distillation loss (CGD, CD), forward and
backward.

Replaces ``segdistill_tpu/ops/pallas/group_kl.py``'s
``fused_group_kl_shuffled`` (the Pallas calls at ``group_kl.py:474``,
forward, and ``:527``, backward) and ``fused_group_kl`` (``:347``,
``:389``), which is the same computation with the identity permutation and
runs on the same two kernels here. The kernels are ``csrc/group_kl.cu``:
K3 takes the group's source maxima in one pass, then is the forward tile
kernel of ``csrc/common.cuh`` that K5 shares: a block owns an (image,
group)'s tile of 128 x 64 outputs, stages per position the window of
sources it reads of both maps in shared memory and sums the group's
(Z_s, Z_t, W) over the tile; the group's last block merges its tiles'
partials and the last group's block the KLs, in fixed orders.
:func:`forward_plan` is its launch's planning (``ops/tile_plan.py``),
which the source checks; where a window is larger than the block stages
(upsampling ratios near 1, downsampling) it names the gather variant,
blocks over flat ranges of a group's values. K4 is the tile kernel of
``csrc/common.cuh`` that K6 and K8 share: a block owns a tile of source
pixels and a chunk of shuffled positions; per position it reads the source
channel and its group's two log-sum-exps (scalars), evaluates p_s - p_t
once at every output that reads the tile and sums it back through the
transposed upsample one axis after the other, onto the source channel.
:func:`backward_plan` is its launch's planning (``ops/tile_plan.py``),
which the source checks; where no tile fits (upsampling ratios above ~30
for K4, which keeps no per-output map) the plan names the gather variant,
one thread per source element. Neither kernel writes the upsampled maps to
memory, and both take any output size.

Both functions are ``torch.autograd.Function``s on every device: on a CPU
tensor the forward is :func:`group_kl_plain` and the backward its autograd
gradient; on a CUDA tensor the forward launches K3 and the backward K4, or
they raise. The teacher gets no gradient.
"""

import ctypes

import torch
import torch.nn.functional as F

from . import tile_plan
from .cuda_kernel import CudaKernel, check_cuda_inputs, device_sm_count

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

FWD_KERNEL = CudaKernel(
    'group_kl_fwd', 'group_kl_fwd', source='group_kl',
    argtypes=[_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I,
              _I, _I, _I, _P, _P, _P, _P],
    replaces='segdistill_tpu/ops/pallas/group_kl.py:474')
BWD_KERNEL = CudaKernel(
    'group_kl_bwd', 'group_kl_bwd', source='group_kl',
    argtypes=[_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P, _P, _P,
              _I, _I, _I, _I, _I],
    replaces='segdistill_tpu/ops/pallas/group_kl.py:527')

# K4 on the tile of csrc/common.cuh (gkl_tile in csrc/group_kl.cu): no
# per-output map (the group stats are scalars a position), two maps read,
# compiled for three blocks an SM
RECT_MAPS, SRC_MAPS, BLOCKS_PER_SM = 0, 2, 3


def backward_plan(B, C, h, w, H, W, sms=132):
    """K4's launch for (B, C, h, w) maps upsampled to (H, W) on a card of
    ``sms`` SMs: :func:`tile_plan.plan` with K4's maps and blocks an SM;
    the chunks are of shuffled positions."""
    return tile_plan.plan(B, C, h, w, H, W, sms, RECT_MAPS, SRC_MAPS,
                          BLOCKS_PER_SM)


# K3 on the forward tile of csrc/common.cuh (gkl_fwd_tile in
# csrc/group_kl.cu): both maps of a position a step, 32 rows a thread, 3
# window elements a thread and map
FWD_UNITS, FWD_ROWS, FWD_SLOTS = 2, 32, 3


def forward_plan(h, w, H, W):
    """K3's launch for (h, w) maps upsampled to (H, W):
    :func:`tile_plan.forward_plan` with K3's counts."""
    return tile_plan.forward_plan(h, w, H, W, FWD_UNITS, FWD_ROWS,
                                  FWD_SLOTS)


# blocks per wave the gather variant and the max pass aim for: 132 SMs x 8
# blocks of 256 threads
_TARGET_BLOCKS = 132 * 8


def group_kl_plain(xs, xt, perm, out_hw, group_size, tau):
    """The plain version: fp32 ``F.interpolate`` of both maps to
    ``out_hw``, channels gathered by ``perm`` (None: identity), padded with
    -1e9 channels to a multiple of ``group_size``, and
    ``KL(softmax(xt/tau) || softmax(xs/tau))`` over each (b, group) of
    g*H*W values, summed and divided by B*K. Differentiable."""
    xs = F.interpolate(xs.float(), size=tuple(out_hw), mode='bilinear',
                       align_corners=False)
    xt = F.interpolate(xt.float(), size=tuple(out_hw), mode='bilinear',
                       align_corners=False)
    if perm is not None:
        perm = perm.to(xs.device, torch.long)
        xs, xt = xs[:, perm], xt[:, perm]
    b, c = xs.shape[:2]
    pad = (-c) % group_size
    if pad:
        fill = xs.new_full((b, pad) + tuple(xs.shape[2:]), -1e9)
        xs = torch.cat([xs, fill], dim=1)
        xt = torch.cat([xt, fill], dim=1)
    k = (c + pad) // group_size
    log_s = F.log_softmax(xs.reshape(b, k, -1) / tau, dim=-1)
    p_t = F.softmax(xt.reshape(b, k, -1) / tau, dim=-1)
    kl = torch.xlogy(p_t, p_t) - p_t * log_s
    return kl.sum() / (b * k)


def _splits(n_groups, per_group):
    """Blocks per group: enough to fill the card, none without work."""
    want = -(-_TARGET_BLOCKS // n_groups)
    return max(1, min(want, -(-per_group // 256), 65535))


def _launch_fwd(xs, xt, perm, out_hw, g, tau):
    dtype_code = check_cuda_inputs('fused_group_kl', (xs, xt))
    B, C, h, w = xs.shape
    H, W = out_hw
    BK = B * -(-C // g)
    plan = forward_plan(h, w, H, W)
    max_splits = _splits(BK, h * w)  # slices of each plane
    sum_splits = _splits(BK, min(g, C) * H * W)
    f32 = dict(dtype=torch.float32, device=xs.device)
    pmax = torch.empty(BK * max_splits * 2, **f32)
    # the tile variant's partials, KLs and tickets; the gather's partials
    psum = torch.empty(BK * (plan['tiles'] * 3 + 2) + 1 if plan['oh']
                       else BK * sum_splits * 3, **f32)
    stats = torch.empty(BK, 4, **f32)
    loss = torch.empty((), **f32)
    FWD_KERNEL.launch(xs.device, xs.data_ptr(), xt.data_ptr(),
                      perm.data_ptr(), B, C, h, w, H, W, g, tau, dtype_code,
                      *tile_plan.forward_plan_args(plan), max_splits,
                      sum_splits, pmax.data_ptr(), psum.data_ptr(),
                      stats.data_ptr(), loss.data_ptr())
    return loss, stats


def _launch_bwd(xs, xt, perm, out_hw, g, tau, stats, gbar):
    dtype_code = check_cuda_inputs('fused_group_kl', (xs, xt))
    B, C, h, w = xs.shape
    H, W = out_hw
    dxs = torch.empty_like(xs)
    gbar = gbar.detach().to(torch.float32).contiguous()
    plan = backward_plan(B, C, h, w, H, W, device_sm_count(xs.device))
    BWD_KERNEL.launch(xs.device, xs.data_ptr(), xt.data_ptr(),
                      perm.data_ptr(), B, C, h, w, H, W, g, tau, dtype_code,
                      stats.data_ptr(), gbar.data_ptr(), dxs.data_ptr(),
                      *tile_plan.plan_args(plan))
    return dxs


class _GroupKL(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xs, xt, perm, out_hw, group_size, tau):
        ctx.cfg = (out_hw, group_size, tau)
        if xs.device.type == 'cpu':
            ctx.save_for_backward(xs, xt, perm)
            return group_kl_plain(xs, xt, perm, out_hw, group_size, tau)
        loss, stats = _launch_fwd(xs, xt, perm, out_hw, group_size, tau)
        ctx.save_for_backward(xs, xt, perm, stats)
        return loss

    @staticmethod
    def backward(ctx, gbar):
        out_hw, group_size, tau = ctx.cfg
        if ctx.saved_tensors[0].device.type == 'cpu':
            xs, xt, perm = ctx.saved_tensors
            with torch.enable_grad():
                a = xs.detach().requires_grad_()
                loss = group_kl_plain(a, xt, perm, out_hw, group_size, tau)
                (dxs,) = torch.autograd.grad(loss, a, gbar)
        else:
            xs, xt, perm, stats = ctx.saved_tensors
            dxs = _launch_bwd(xs, xt, perm, out_hw, group_size, tau, stats,
                              gbar)
        return dxs, None, None, None, None, None


def _prepare(xs, xt, perm, out_hw, group_size, tau):
    if xs.ndim != 4 or xs.shape != xt.shape:
        raise ValueError(f'fused_group_kl takes two (B, C, h, w) maps of one '
                         f'shape, got {tuple(xs.shape)} and '
                         f'{tuple(xt.shape)}')
    C = xs.shape[1]
    H, W = (int(s) for s in out_hw)
    if H < 1 or W < 1 or int(group_size) < 1 or not tau > 0:
        raise ValueError(f'bad output size {out_hw}, group size '
                         f'{group_size} or tau {tau}')
    if perm is not None and tuple(perm.shape) != (C,):
        raise ValueError(f'perm must have shape ({C},), got '
                         f'{tuple(perm.shape)}')
    xt = xt.detach()
    if xs.device.type == 'cuda':
        if xs.dtype != xt.dtype:  # exact: both upcast, as the kernel would
            xs, xt = xs.float(), xt.float()
        xs, xt = xs.contiguous(), xt.contiguous()
        if perm is None:
            perm = torch.arange(C, device=xs.device, dtype=torch.int32)
        perm = perm.to(xs.device, torch.int32).contiguous()
    elif xs.device.type != 'cpu':
        raise ValueError(f'fused_group_kl: unsupported device {xs.device}')
    return xs, xt, perm, (H, W), int(group_size), float(tau)


def fused_group_kl_shuffled(xs, xt, perm, out_hw, group_size, tau):
    """Group KL with the channels taken in ``perm`` order (shuffled
    position -> source channel, shape (C,)): a 0-d fp32 loss, the mean over
    (b, group) of KL(teacher || student). xs, xt: (B, C, h, w) NCHW in
    float32 or bfloat16; only ``xs`` gets a gradient."""
    return _GroupKL.apply(*_prepare(xs, xt, perm, out_hw, group_size, tau))


def fused_group_kl(xs, xt, out_hw, group_size, tau):
    """:func:`fused_group_kl_shuffled` with the identity permutation (the
    channel order as it is: CD and unshuffled CGD)."""
    return _GroupKL.apply(*_prepare(xs, xt, None, out_hw, group_size, tau))
