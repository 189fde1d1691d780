"""K5/K6: the head's cross-entropy at label resolution, forward and
backward.

Replaces ``segdistill_tpu/ops/pallas/seg_ce.py::fused_seg_ce`` (the Pallas
calls at ``seg_ce.py:241``, forward, and ``:293``, backward). The kernels
are ``csrc/seg_ce.cu``: K5 is the forward tile kernel of
``csrc/common.cuh`` that K3 shares: a block owns an image's tile of 32 x
64 output pixels and walks the channels in chunks of 8 whose windows of
sources sit in shared memory; each pixel keeps its running (max, exp-sum),
rescaled once a chunk, and its first argmax, writes its (max, exp-sum) for
K6 and lerps its label's logit once; the last block to finish sums the
blocks' (ce_sum, correct) in a fixed order. :func:`forward_plan` is its
launch's planning, which the source checks; where a window is larger than
the block stages (upsampling ratios near 1, downsampling) it names the
gather variant, one output pixel per thread. K6 gives a block a tile of
source pixels and a chunk of the channels: the outputs that read the tile
form one rectangle, whose label and log-sum-exp go to shared memory once;
per channel every output of the rectangle is evaluated once and the
transposed upsample runs over the shared buffer one axis after the other.
That kernel is ``tile_bwd`` of ``csrc/common.cuh``, which K4 and K8 share.
:func:`backward_plan` is the launch's planning in pure Python
(``ops/tile_plan.py``: tile edge, rectangle, shared bytes, channels per
block), mirrored by the source, which refuses a plan that is not its own.
Shapes whose rectangle fits no tile (upsampling ratios above ~15) take the
source's gather variant, one thread per source element. The upsampled
logits never reach memory, and any output size works.

:func:`fused_seg_ce` is a ``torch.autograd.Function`` on every device: on a
CPU tensor the forward is :func:`seg_ce_plain` and the backward its
autograd gradient; on a CUDA tensor the forward launches K5 and the
backward K6, or they raise. ``correct`` has no gradient.
"""

import collections
import ctypes

import torch
import torch.nn.functional as F

from . import tile_plan
from .cuda_kernel import (CudaKernel, check_cuda_inputs, device_sm_count,
                          ticket)

_P = ctypes.c_void_p
_I = ctypes.c_int
_THREADS = 256  # kThreads in csrc/common.cuh: the gather variant's block

FWD_KERNEL = CudaKernel(
    'seg_ce_fwd', 'seg_ce_fwd', source='seg_ce',
    argtypes=[_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
              _P, _P, _P, _P, _P, _P],
    replaces='segdistill_tpu/ops/pallas/seg_ce.py:241')
BWD_KERNEL = CudaKernel(
    'seg_ce_bwd', 'seg_ce_bwd', source='seg_ce',
    argtypes=[_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
              _I, _I, _I, _I, _I, _P],
    replaces='segdistill_tpu/ops/pallas/seg_ce.py:293')
# the launches of each kernel by geometry (B, C, h, w, H, W), raised beside
# the kernel's own count where it launches
LAUNCHES_BY_SHAPE = {FWD_KERNEL.name: collections.Counter(),
                     BWD_KERNEL.name: collections.Counter()}

# K6 on the tile of csrc/common.cuh (ce_tile in csrc/seg_ce.cu): two
# per-output maps (the label and the log-sum-exp), one map read, compiled
# for three blocks an SM (registers)
RECT_MAPS, SRC_MAPS = 2, 1
_MAX_BLOCKS_PER_SM = 3
TILE_EDGES, TILE_BUDGET = tile_plan.TILE_EDGES, tile_plan.TILE_BUDGET
tile_reach = tile_plan.tile_reach


def tile_shared_bytes(tile, h, w, H, W):
    """Dynamic shared memory of a K6 block with a ``tile`` x ``tile`` source
    tile (``tile_plan.shared_bytes`` with K6's maps)."""
    return tile_plan.shared_bytes(tile, h, w, H, W, RECT_MAPS, SRC_MAPS)


def backward_plan(B, C, h, w, H, W, sms=132):
    """K6's launch for (B, C, h, w) logits and (H, W) labels on a card of
    ``sms`` SMs: :func:`tile_plan.plan` with K6's maps and blocks an SM."""
    return tile_plan.plan(B, C, h, w, H, W, sms, RECT_MAPS, SRC_MAPS,
                          _MAX_BLOCKS_PER_SM)


# K5 on the forward tile of csrc/common.cuh (ce_fwd_tile in
# csrc/seg_ce.cu): a chunk of 8 channels a step, 8 rows a thread, one window
# element a thread and channel
FWD_UNITS, FWD_ROWS, FWD_SLOTS = 8, 8, 1


def forward_plan(h, w, H, W):
    """K5's launch for (h, w) logits upsampled to (H, W):
    :func:`tile_plan.forward_plan` with K5's counts."""
    return tile_plan.forward_plan(h, w, H, W, FWD_UNITS, FWD_ROWS,
                                  FWD_SLOTS)


def _valid(labels, num_classes, ignore_index):
    return (labels != ignore_index) & (labels >= 0) & (labels < num_classes)


def seg_ce_plain(logits, labels, out_hw, num_classes, ignore_index=255):
    """The plain version: fp32 ``F.interpolate`` of the logits to
    ``out_hw``, ``F.cross_entropy(reduction='sum')`` over the valid pixels
    and the count of valid pixels whose argmax is the label."""
    z = F.interpolate(logits.float(), size=tuple(out_hw), mode='bilinear',
                      align_corners=False)
    valid = _valid(labels, num_classes, ignore_index)
    target = torch.where(valid, labels, torch.full_like(labels, -100))
    ce = F.cross_entropy(z, target.long(), reduction='sum',
                         ignore_index=-100)
    correct = ((z.argmax(dim=1) == labels) & valid).sum().float()
    return ce, correct


def _dims(z, labels):
    B, C, h, w = z.shape
    H, W = labels.shape[1:]
    return B, C, h, w, H, W


def _launch_fwd(z, labels, num_classes, ignore_index):
    dtype_code = check_cuda_inputs('fused_seg_ce', (z,))
    B, C, h, w, H, W = _dims(z, labels)
    plan = forward_plan(h, w, H, W)
    f32 = dict(dtype=torch.float32, device=z.device)
    m = torch.empty((B, H, W), **f32)
    se = torch.empty((B, H, W), **f32)
    blocks = plan['tiles'] if plan['oh'] else -(-H * W // _THREADS)
    part = torch.empty(2 * B * blocks, **f32)
    ce = torch.empty((), **f32)
    correct = torch.empty((), **f32)
    with ticket(z.device, plan['oh'] > 0) as ticket_ptr:
        FWD_KERNEL.launch(z.device, z.data_ptr(), labels.data_ptr(), B, C, h,
                          w, H, W, num_classes, ignore_index, dtype_code,
                          *tile_plan.forward_plan_args(plan), m.data_ptr(),
                          se.data_ptr(), part.data_ptr(), ticket_ptr,
                          ce.data_ptr(), correct.data_ptr())
    LAUNCHES_BY_SHAPE[FWD_KERNEL.name][(B, C, h, w, H, W)] += 1
    return ce, correct, m, se


def _launch_bwd(z, labels, num_classes, ignore_index, m, se, gbar):
    dtype_code = check_cuda_inputs('fused_seg_ce', (z,))
    B, C, h, w, H, W = _dims(z, labels)
    dz = torch.empty_like(z)
    gbar = gbar.detach().to(torch.float32).contiguous()
    plan = backward_plan(B, C, h, w, H, W, device_sm_count(z.device))
    BWD_KERNEL.launch(z.device, z.data_ptr(), labels.data_ptr(), B, C, h, w,
                      H, W, num_classes, ignore_index, dtype_code,
                      m.data_ptr(), se.data_ptr(), gbar.data_ptr(),
                      dz.data_ptr(), *tile_plan.plan_args(plan))
    LAUNCHES_BY_SHAPE[BWD_KERNEL.name][(B, C, h, w, H, W)] += 1
    return dz


class _SegCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, labels, out_hw, num_classes, ignore_index):
        ctx.cfg = (out_hw, num_classes, ignore_index)
        if logits.device.type == 'cpu':
            ctx.save_for_backward(logits, labels)
            ce, correct = seg_ce_plain(logits, labels, out_hw, num_classes,
                                       ignore_index)
        else:
            ce, correct, m, se = _launch_fwd(logits, labels, num_classes,
                                             ignore_index)
            ctx.save_for_backward(logits, labels, m, se)
        ctx.mark_non_differentiable(correct)
        return ce, correct

    @staticmethod
    def backward(ctx, g_ce, g_correct):
        del g_correct
        out_hw, num_classes, ignore_index = ctx.cfg
        if ctx.saved_tensors[0].device.type == 'cpu':
            logits, labels = ctx.saved_tensors
            with torch.enable_grad():
                a = logits.detach().requires_grad_()
                ce, _ = seg_ce_plain(a, labels, out_hw, num_classes,
                                     ignore_index)
                (dz,) = torch.autograd.grad(ce, a, g_ce)
        else:
            logits, labels, m, se = ctx.saved_tensors
            dz = _launch_bwd(logits, labels, num_classes, ignore_index, m,
                             se, g_ce)
        return dz, None, None, None, None


def fused_seg_ce(logits, labels, out_hw, num_classes, ignore_index=255):
    """logits (B, C, h, w) NCHW in float32 or bfloat16; labels (B, H, W)
    integer with (H, W) == ``out_hw``. -> (ce_sum, correct), 0-d float32
    sums over the valid pixels; the caller divides both by the total
    pixel count."""
    if logits.ndim != 4 or labels.ndim != 3 \
            or labels.shape[0] != logits.shape[0]:
        raise ValueError(f'fused_seg_ce takes (B, C, h, w) logits and '
                         f'(B, H, W) labels, got {tuple(logits.shape)} and '
                         f'{tuple(labels.shape)}')
    if tuple(labels.shape[1:]) != tuple(int(s) for s in out_hw):
        raise ValueError(f'labels {tuple(labels.shape)} are not of the '
                         f'output size {tuple(out_hw)}')
    if logits.device.type == 'cuda':
        logits = logits.contiguous()
        labels = labels.to(logits.device, torch.int32).contiguous()
    elif logits.device.type != 'cpu':
        raise ValueError(f'fused_seg_ce: unsupported device {logits.device}')
    return _SegCE.apply(logits, labels, tuple(labels.shape[1:]),
                        int(num_classes), int(ignore_index))
