"""K2/K9: MiT spatial-reduction attention, forward and backward.

Replaces ``segdistill_tpu/ops/pallas/sra_attn.py``'s
``fused_sra_attention`` (the Pallas call at ``sra_attn.py:78``) and
``sra_attention_train`` (its forward is that kernel; its backward is the
Pallas call at ``:182``). The kernels are ``csrc/sra_attn.cu`` (K2) and
``csrc/sra_attn_bwd.cu`` (K9), with shared pieces in
``csrc/sra_common.cuh``. The scores never reach device memory; K2 keeps an
fp32 online softmax, so any N and M work, and for training each row's
log-sum-exp, from which K9 recomputes the probabilities.

Both are bound by operations on the card (4*N*M*d forward, 10*N*M*d
backward, plus N*M exponentials, against a few bytes per row). For bf16
inputs the products run on the tensor cores (``mma.sync`` m16n8k16, bf16
operands, fp32 sums): the probabilities P, and in the backward dS, are
rounded to bf16 as operands, as the JAX kernel rounds them. For fp32
inputs they stay full fp32 on CUDA cores (no TF32), four lanes sharing a
query row. K9 is one fused pass (S and dP computed once per query tile and
key block, dq written directly, dk and dv summed in shared memory and
written as one fp32 partial per split of the query rows) and a second
small kernel that sums the partials in a fixed order: the gradients are
deterministic. :func:`forward_plan` and :func:`backward_plan` say which
kernel variant, tiles, key chunks, splits and shared memory a shape gets.
The TPU gate (N % 128, M <= 2048) is not carried over: the kernels take
d <= 128 with d % 8 == 0.

K2's forward is also the custom operator ``segdistill::sra_attention``
(:data:`SRA_ATTENTION`): the dispatcher runs :func:`sra_attention_plain` on
a CPU tensor and launches K2 (or raises) on a CUDA tensor, and
``torch.export`` keeps the call as one node; both give the output in
(B, N, h, d) memory. :func:`fused_sra_attention` calls it where the call is
traced or on a CPU tensor; an eager call on a CUDA tensor launches K2
directly, as K10's do (``ops/layer_norm.py``). :func:`sra_attention_train` runs the plain
version and its gradient on a CPU tensor (autograd for fp32,
:func:`sra_attention_backward_plain` for bf16) and on a CUDA tensor K2
keeping each row's log-sum-exp, then K9, or raises: that forward's extra
outputs are training state, which no exported program holds.
"""

import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from .cuda_kernel import CudaKernel, check_cuda_inputs, custom_op

_P = ctypes.c_void_p
_I = ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)

KERNEL = CudaKernel(
    'sra_attn', 'sra_attn_fwd',
    argtypes=[_P, _P, _P, _P, _I, _I, _I, _I, _I, _STRIDES, ctypes.c_float,
              _I, _P, _P],
    replaces='segdistill_tpu/ops/pallas/sra_attn.py:78')
BWD_KERNEL = CudaKernel(
    'sra_attn_bwd', 'sra_attn_bwd',
    argtypes=[_P] * 12 + [_I] * 8 + [_STRIDES, ctypes.c_float, _I],
    replaces='segdistill_tpu/ops/pallas/sra_attn.py:182')

# What a block may ask of an SM's shared memory on the card.
MAX_SHARED_BYTES = 232448
# Blocks of K9's fused pass that run at once: its shared memory lets one
# live on each of the card's 132 SMs.
_TARGET_BLOCKS = 132
_TILE = 64  # query rows per tile of K9, and per block of K2 under bf16
# The kernel templates instantiated in csrc/: (family, padded head dim).
VARIANTS = frozenset((family, dp) for family in
                     ('fwd_mma', 'fwd_f32', 'bwd_mma', 'bwd_f32')
                     for dp in (32, 64, 128))
# Keys of a head resident in shared memory per block (fwd_keys in
# sra_attn.cu; MmaPlan::KS and F32Plan::KS in sra_attn_bwd.cu).
_FWD_MMA_KEYS = {32: 256, 64: 256, 128: 128}
_BWD_KEYS = {'bwd_mma': {32: 256, 64: 128, 128: 64},
             'bwd_f32': {32: 256, 64: 128, 128: 32}}


def _padded_dim(d):
    if d > 128 or d % 8 or d < 8:
        raise ValueError(f'fused_sra_attention takes head dims <= 128 and a '
                         f'multiple of 8, got {d}')
    return 32 if d <= 32 else (64 if d <= 64 else 128)


def forward_plan(dtype, heads, N, M, d):
    """How K2 runs ``heads`` = B*h heads of (N, M, d) in ``dtype``: the
    kernel variant, the query rows per block (bf16 at d = 64: 128, 32 a
    warp, where such blocks still give every SM one; else 64), the keys
    per pass through shared memory, the blocks per head and the
    shared-memory bytes of a block. The C dispatcher decides the same way."""
    dp = _padded_dim(d)
    if dtype == torch.bfloat16:
        keys = _FWD_MMA_KEYS[dp]
        wide = dp == 64 and -(-N // (2 * _TILE)) * heads >= _TARGET_BLOCKS
        rows = 2 * _TILE if wide else _TILE
        return dict(variant=('fwd_mma', dp), rows=rows, keys=keys,
                    blocks=-(-N // rows), shared_bytes=2 * keys * (dp + 8) * 2)
    lanes_d = dp // 32                  # lanes of a row that split d
    keys = 16 * (4 // lanes_d)
    return dict(variant=('fwd_f32', dp), rows=_TILE, keys=keys,
                blocks=-(-N // _TILE),
                shared_bytes=2 * keys * (dp + 4 * lanes_d) * 4)


@functools.lru_cache(maxsize=None)
def _split_rows(N, blocks_per_split):
    """(splits of the N query rows, rows per split) for K9's fused pass:
    whole tiles per split, and the fewest waves of blocks over the card's
    SMs times the tiles a block walks (plus one for its prologue and its
    partials); among equals the fewest splits, whose partials are the
    smallest."""
    tiles = -(-N // _TILE)
    best = None
    for want in range(1, tiles + 1):
        per_split = -(-tiles // want)
        splits = -(-tiles // per_split)
        waves = -(-splits * blocks_per_split // _TARGET_BLOCKS)
        cost = waves * (per_split + 1)
        if best is None or cost < best[0]:
            best = (cost, splits, per_split * _TILE)
    return best[1:]


def backward_plan(dtype, heads, N, M, d):
    """How K9 runs ``heads`` = B*h heads of (N, M, d) in ``dtype``: the
    kernel variant, the keys resident per block and the chunks M is cut
    into (more than one: dq goes through fp32 partials), the splits of the
    query rows and the rows of each (whole tiles, enough blocks to fill the
    card), and the shared-memory bytes of a block."""
    dp = _padded_dim(d)
    family = 'bwd_mma' if dtype == torch.bfloat16 else 'bwd_f32'
    keys = _BWD_KEYS[family][dp]
    key_chunks = -(-M // keys)
    splits, rows = _split_rows(N, heads * key_chunks)
    if family == 'bwd_mma':
        ld = dp + 8
        shared = (2 * keys * ld * 2 + 2 * _TILE * ld * 2
                  + 2 * _TILE * (64 + 8) * 2 + 2 * keys * ld * 4
                  + 2 * _TILE * 4)
    else:
        block_keys = 64 if dp <= 64 else 32
        ld = dp + 4 * (dp // 32)
        shared = 4 * (2 * keys * ld + 2 * _TILE * ld
                      + 2 * _TILE * (block_keys + 1) + 2 * keys * (dp + 4))
    return dict(variant=(family, dp), tile=_TILE, keys=keys,
                key_chunks=key_chunks, splits=splits, rows=rows,
                shared_bytes=shared)


def _round_like(x, dtype):
    """fp32 ``x`` rounded to ``dtype``'s values: what a matrix unit with
    ``dtype`` operands sees."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def sra_attention_plain(q, k, v, scale):
    """The plain version: fp32 scores and softmax, the product with v summed
    in fp32, output in the input dtype. Under bf16 the normalised
    probabilities are rounded to bf16 before that product, as the JAX
    kernel rounds them (and as tensor cores with bf16 operands need)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = _round_like(s.softmax(dim=-1), q.dtype)
    return torch.matmul(p, v.float()).to(q.dtype)


def sra_attention_backward_plain(q, k, v, g, scale):
    """The plain backward with the JAX kernel's math and rounding: P
    recomputed in fp32, P and dS rounded to the input dtype as operands of
    their products, all sums fp32 -> (dq, dk, dv) in the input dtype. For
    fp32 inputs it is the gradient of :func:`sra_attention_plain`."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    p = (torch.matmul(qf, kf.transpose(-1, -2)) * scale).softmax(dim=-1)
    dv = torch.matmul(_round_like(p, q.dtype).transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    ds = _round_like(ds, q.dtype)
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
    """A (B, h, n, d) tensor laid out as (B, n, h, d) memory: merging the
    heads back into (B, n, h*d) needs no copy."""
    B, h, n, d = shape
    return torch.empty_strided(shape, (n * h * d, d, h * d, 1), dtype=dtype,
                               device=device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _rows_at_16_bytes(t):
    """``t`` if every (b, h, n) row of it starts at a multiple of 16 bytes
    and its last dim is contiguous (the head-split views of the model's
    linear outputs do), else a contiguous copy: the kernels load 16 bytes
    at a time."""
    per16 = 16 // t.element_size()
    if t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(
            s % per16 == 0 for s in t.stride()[:3]):
        return t
    return t.contiguous()


def _launch_fwd(q, k, v, scale, for_backward=False):
    """K2 -> (out, lse, out32, (q, k, v) as launched); lse (B*h, N) and the
    fp32 output only ``for_backward`` (out32 is ``out`` for float32
    inputs)."""
    if q.device.type != 'cuda':
        raise ValueError(f'fused_sra_attention: unsupported device '
                         f'{q.device}')
    dtype_code = check_cuda_inputs('fused_sra_attention', (q, k, v))
    B, h, N, d = q.shape
    M = k.shape[2]
    _padded_dim(d)
    if B * h > 65535:
        raise ValueError(f'fused_sra_attention: B*h = {B * h} > 65535')
    q, k, v = (_rows_at_16_bytes(t) for t in (q, k, v))
    out = _heads_last(q.shape, q.dtype, q.device)
    lse = out32 = None
    if for_backward:
        lse = torch.empty((B * h, N), dtype=torch.float32, device=q.device)
        out32 = out if q.dtype == torch.float32 else \
            _heads_last(q.shape, torch.float32, q.device)
    KERNEL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), B, h, N, M, d, _strides(q, k, v, out),
                  float(scale), dtype_code,
                  _ptr(lse), None if out32 is out else _ptr(out32))
    return out, lse, out32, (q, k, v)


def _launch_bwd(q, k, v, out32, lse, g, scale):
    dtype_code = check_cuda_inputs('sra_attention_train', (q, k, v))
    B, h, N, d = q.shape
    M = k.shape[2]
    g = _rows_at_16_bytes(g.to(q.dtype))
    dq = _heads_last(q.shape, q.dtype, q.device)
    dk = _heads_last(k.shape, k.dtype, k.device)
    dv = _heads_last(v.shape, v.dtype, v.device)
    plan = backward_plan(q.dtype, B * h, N, M, d)
    splits, rows, chunks = plan['splits'], plan['rows'], plan['key_chunks']
    f32 = dict(dtype=torch.float32, device=q.device)
    part = torch.empty((2, splits, B * h, M, d), **f32)
    dq_part = torch.empty((chunks, B * h, N, d), **f32) if chunks > 1 \
        else None
    BWD_KERNEL.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out32.data_ptr(), g.data_ptr(), lse.data_ptr(),
                      part[0].data_ptr(), part[1].data_ptr(), _ptr(dq_part),
                      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, h, N,
                      M, d, splits, rows, chunks,
                      _strides(q, k, v, out32, g, dq, dk, dv), float(scale),
                      dtype_code)
    return dq, dk, dv


def fused_sra_attention(q, k, v, scale):
    """softmax(q @ k^T * scale) @ v with fp32 scores and softmax, forward
    only: the output carries no gradient on CUDA.

    q (B, h, N, d); k, v (B, h, M, d) -> (B, h, N, d) in q's dtype. Inputs
    may be strided views whose last dim is contiguous. The result lies in
    (B, N, h, d) memory, so merging the heads back into (B, N, h*d) needs
    no copy.
    """
    _check(q, k, v)
    if q.is_cuda and not torch.compiler.is_compiling():
        # eager on the card: the launch without the dispatcher
        return _launch_fwd(q, k, v, scale)[0]
    # traced, or on a CPU tensor: the operator (one node of an exported
    # program)
    return SRA_ATTENTION(q, k, v, float(scale))


def _plain(q, k, v, scale):
    out = _heads_last(q.shape, q.dtype, q.device)
    return out.copy_(sra_attention_plain(q, k, v, scale))


def _launch(q, k, v, scale):
    return _launch_fwd(q, k, v, scale)[0]


def _fake(q, k, v, scale):
    return _heads_last(q.shape, q.dtype, q.device)


SRA_ATTENTION = custom_op('sra_attention(Tensor q, Tensor k, Tensor v, '
                          'float scale) -> Tensor', _plain, _launch, _fake)


@register_flop_formula(torch.ops.segdistill.sra_attention)
def _flops(q_shape, k_shape, v_shape, *args, **kwargs):
    """What ``FlopCounterMode`` counts for the two products the unfused
    attention runs: q k^T and P v, 2 * B * h * N * M * d each."""
    B, h, N, d = q_shape
    return 4 * B * h * N * k_shape[2] * d


class _SRATrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        if q.device.type == 'cpu':
            ctx.save_for_backward(q, k, v)
            return sra_attention_plain(q, k, v, scale)
        out, lse, out32, qkv = _launch_fwd(q, k, v, scale, for_backward=True)
        ctx.save_for_backward(*qkv, out32, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        # read once: a recomputed block (activation checkpointing) hands
        # each saved tensor out a single time
        saved = ctx.saved_tensors
        q = saved[0]
        if q.device.type == 'cpu' and q.dtype != torch.float32:
            grads = sra_attention_backward_plain(*saved, g, ctx.scale)
        elif q.device.type == 'cpu':
            with torch.enable_grad():
                qkv = [t.detach().requires_grad_() for t in saved]
                grads = torch.autograd.grad(
                    sra_attention_plain(*qkv, ctx.scale), qkv, g)
        else:
            grads = _launch_bwd(*saved, g, ctx.scale)
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
