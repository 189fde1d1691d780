"""K5/K6: the head's cross-entropy at label resolution, forward and
backward.

Replaces ``segdistill_tpu/ops/pallas/seg_ce.py::fused_seg_ce`` (the Pallas
calls at ``seg_ce.py:241``, forward, and ``:293``, backward). The kernels
are ``csrc/seg_ce.cu``: K5 takes one output pixel per thread through an
online softmax over the channels' bilinear taps and keeps the pixel's
(max, exp-sum). K6 gives a block a tile of source pixels and a chunk of the
channels: the outputs that read the tile form one rectangle, whose label
and log-sum-exp go to shared memory once; per channel every output of
the rectangle is evaluated once and the transposed upsample runs over the
shared buffer one axis after the other. :func:`backward_plan` is that
launch's planning in pure Python (tile edge, rectangle, shared bytes,
channels per block), mirrored by the source, which refuses a plan that is
not its own. Shapes whose rectangle fits no tile (upsampling ratios above
~15) take the source's gather variant, one thread per source element. The
upsampled logits never reach memory, and any output size works.

:func:`fused_seg_ce` is a ``torch.autograd.Function`` on every device: on a
CPU tensor the forward is :func:`seg_ce_plain` and the backward its
autograd gradient; on a CUDA tensor the forward launches K5 and the
backward K6, or they raise. ``correct`` has no gradient.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from .cuda_kernel import CudaKernel, check_cuda_inputs, sm_count

_P = ctypes.c_void_p
_I = ctypes.c_int
_THREADS = 256  # kThreads in csrc/common.cuh: one pixel per thread

FWD_KERNEL = CudaKernel(
    'seg_ce_fwd', 'seg_ce_fwd', source='seg_ce',
    argtypes=[_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
              _P, _P],
    replaces='segdistill_tpu/ops/pallas/seg_ce.py:241')
BWD_KERNEL = CudaKernel(
    'seg_ce_bwd', 'seg_ce_bwd', source='seg_ce',
    argtypes=[_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
              _I, _I, _I, _I, _I, _P],
    replaces='segdistill_tpu/ops/pallas/seg_ce.py:293')

# K6's tiles (csrc/seg_ce.cu): the edges tried, largest first; the shared
# memory a block may take (kTileBudget: two blocks fit an SM's 228 KB, 1 KB
# of it reserved per block); what setting a block up costs, in channels
# (the rectangle's labels, maxima and exp-sums, the tap tables).
TILE_EDGES = (16, 8, 4)
TILE_BUDGET = 113 * 1024
_SM_SHARED = 228 * 1024
_SETUP_CHANNELS = 4
_MAX_BLOCKS_PER_SM = 3  # the source's __launch_bounds__(512, 3): registers
_PLAN_KEYS = ('tile', 'rh', 'rw', 'shared_bytes', 'cpc', 'chunks', 'blocks')


def tile_reach(tile, n_in, n_out):
    """The most outputs along one axis whose taps can read ``tile``
    neighbouring sources (``tile_reach`` in csrc/common.cuh): those whose
    source position falls into a window of ``tile + 1`` source steps, and 3
    for the window's ends and the rounding of the positions."""
    return min(-(-(tile + 1) * n_out // n_in) + 3, n_out)


def tile_shared_bytes(tile, h, w, H, W):
    """Dynamic shared memory of a K6 block with a ``tile`` x ``tile`` source
    tile (``tile_smem_bytes`` in the source): three maps over the rectangle
    of its readers, the x-summed buffer, two source tiles with their halo,
    the taps of the rectangle's rows and columns, and for each row and
    column of the tile its first reader, their count and their weights."""
    rh, rw = tile_reach(tile, h, H), tile_reach(tile, w, W)
    ny, nx = tile_reach(1, h, H), tile_reach(1, w, W)
    return 4 * (3 * rh * (rw | 1) + tile * (rh | 1) + 2 * (tile + 2) ** 2
                + 2 * rh + 2 * rw + tile * (4 + ny + nx))


def backward_plan(B, C, h, w, H, W, sms=132):
    """K6's launch for (B, C, h, w) logits and (H, W) labels on a card of
    ``sms`` SMs -> dict: ``tile`` (the edge of a block's source tile; 0:
    the gather variant), ``rh, rw`` (the rectangle of outputs a block
    holds), ``shared_bytes``, ``cpc`` (channels per block), ``chunks`` and
    ``blocks``.

    The tile is the largest edge whose block fits :data:`TILE_BUDGET`. The
    channels are cut into the number of chunks that costs the least: waves
    of blocks over the card's slots times the channels (and the set-up) of
    one block."""
    return dict(zip(_PLAN_KEYS, _plan(B, C, h, w, H, W, sms)))


@functools.lru_cache(maxsize=64)
def _plan(B, C, h, w, H, W, sms):
    for tile in TILE_EDGES:
        shared = tile_shared_bytes(tile, h, w, H, W)
        if shared <= TILE_BUDGET:
            break
    else:
        return 0, 0, 0, 0, 1, C, B * C * -(-h * w // _THREADS)
    tiles = B * -(-h // tile) * -(-w // tile)
    slots = sms * min(_SM_SHARED // (shared + 1024), _MAX_BLOCKS_PER_SM)
    best = None
    for k in range(1, C + 1):
        cpc = -(-C // k)
        chunks = -(-C // cpc)
        cost = -(-tiles * chunks // slots) * (cpc + _SETUP_CHANNELS)
        if best is None or cost < best[0]:
            best = (cost, cpc, chunks)
    _, cpc, chunks = best
    return (tile, tile_reach(tile, h, H), tile_reach(tile, w, W), shared,
            cpc, chunks, tiles * chunks)


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
    f32 = dict(dtype=torch.float32, device=z.device)
    m = torch.empty((B, H, W), **f32)
    se = torch.empty((B, H, W), **f32)
    part = torch.empty(2 * B * (-(-H * W // _THREADS)), **f32)
    ce = torch.empty((), **f32)
    correct = torch.empty((), **f32)
    FWD_KERNEL.launch(z.device, z.data_ptr(), labels.data_ptr(), B, C, h, w,
                      H, W, num_classes, ignore_index, dtype_code,
                      m.data_ptr(), se.data_ptr(), part.data_ptr(),
                      ce.data_ptr(), correct.data_ptr())
    return ce, correct, m, se


def _launch_bwd(z, labels, num_classes, ignore_index, m, se, gbar):
    dtype_code = check_cuda_inputs('fused_seg_ce', (z,))
    B, C, h, w, H, W = _dims(z, labels)
    dz = torch.empty_like(z)
    gbar = gbar.detach().to(torch.float32).contiguous()
    index = z.device.index
    plan = backward_plan(B, C, h, w, H, W, sm_count(
        torch.cuda.current_device() if index is None else index))
    BWD_KERNEL.launch(z.device, z.data_ptr(), labels.data_ptr(), B, C, h, w,
                      H, W, num_classes, ignore_index, dtype_code,
                      m.data_ptr(), se.data_ptr(), gbar.data_ptr(),
                      dz.data_ptr(), plan['tile'], plan['rh'], plan['rw'],
                      plan['shared_bytes'], plan['cpc'])
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
