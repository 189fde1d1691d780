"""The port's LayerNorm (``ops/layer_norm.py``, ``FusedLayerNorm``, and MiT
with it in every norm) against the JAX package on the same numpy-seeded
inputs, on the CPU.

The JAX kernel runs in interpret mode, as ``tests/test_pallas_ln.py`` runs
it, or through the JAX module's fallback where its row-tile and width gates
refuse a shape; the port takes :func:`layer_norm_plain`, the kernels' plain
version, because its tensors lie on the CPU. Tolerances are those of
``test_pallas_ln.py``: fp32 forward rtol 1e-5 / atol 1e-6, gradients rtol
2e-5 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segdistill_tpu.models import build_segmentor as build_jax_segmentor
from segdistill_tpu.models.utils import FusedLayerNorm as JaxFusedLayerNorm
from segdistill_tpu.ops.pallas.layer_norm import fused_layer_norm as jax_ln
from segdistill_tpu_torch.convert import state_dict_from_jax
from segdistill_tpu_torch.models import build_segmentor
from segdistill_tpu_torch.models.utils import FusedLayerNorm
from segdistill_tpu_torch.ops import layer_norm as ln

from torch_port_fixtures import (ATOL, RTOL, nhwc_to_nchw,
                                 random_jax_variables, segformer_cfg)


def _inputs(seed, shape):
    rs = np.random.RandomState(seed)
    c = shape[-1]
    return ((rs.randn(*shape) * 2 + 1).astype(np.float32),
            (1 + 0.1 * rs.randn(c)).astype(np.float32),
            (0.1 * rs.randn(c)).astype(np.float32),
            rs.randn(*shape).astype(np.float32))


def _port_grads(fn, x, w, b, cot, dtype=torch.float32):
    """y and (dx, dw, db) of ``fn`` on the CPU, x and the cotangent in
    ``dtype``."""
    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    y = fn(tx, tw, tb)
    grads = torch.autograd.grad(y, (tx, tw, tb),
                                torch.from_numpy(cot).to(dtype))
    return y.detach(), grads


@pytest.mark.parametrize('shape,eps', [((8, 64, 32), 1e-6),
                                       ((2, 256, 64), 1e-5),
                                       ((4, 128, 128), 1e-6)])
def test_layer_norm_matches_jax_kernel(shape, eps):
    """Forward and the three gradients against the Pallas kernel in
    interpret mode."""
    x, w, b, cot = _inputs(0, shape)
    want = jax_ln(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), eps,
                  interpret=True)
    gwant = jax.grad(
        lambda *a: jnp.sum(jax_ln(*a, eps, interpret=True) * cot),
        argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    for fn in (ln.layer_norm_plain, ln.fused_layer_norm):
        y, grads = _port_grads(lambda *a: fn(*a, eps), x, w, b, cot)
        np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
        for got, g, name in zip(grads, gwant, ('dx', 'dweight', 'dbias')):
            np.testing.assert_allclose(got.numpy(), np.asarray(g),
                                       rtol=2e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize('shape,dtype', [((2, 33, 160), 'float32'),
                                         ((3, 40, 320), 'float32'),
                                         ((2, 64, 32), 'bfloat16'),
                                         ((2, 33, 160), 'bfloat16')])
def test_layer_norm_matches_jax_fallback(shape, dtype):
    """Widths and row counts the TPU gates refuse (C = 160, 320; odd rows)
    and bf16, against the JAX module's fallback arithmetic. bf16: both
    round an fp32 result once, so they agree to one bf16 step (2^-7
    relative) where the fp32 values straddle a rounding boundary."""
    x, w, b, _ = _inputs(1, shape)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    module = JaxFusedLayerNorm(epsilon=1e-5)
    want = module.apply({'params': {'scale': jnp.asarray(w),
                                    'bias': jnp.asarray(b)}},
                        jnp.asarray(x).astype(jdt))
    got = ln.fused_layer_norm(torch.from_numpy(x).to(tdt),
                              torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    assert got.dtype == tdt and want.dtype == jdt
    want = np.asarray(want.astype(jnp.float32))
    if dtype == 'float32':
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                                   atol=1e-6)


def test_fused_layer_norm_module_matches_jax_module():
    """The port's module under torch's parameter names against the JAX
    module under flax's, and its state-dict layout."""
    x, w, b, cot = _inputs(2, (2, 33, 48))
    want = JaxFusedLayerNorm(epsilon=1e-6).apply(
        {'params': {'scale': jnp.asarray(w), 'bias': jnp.asarray(b)}},
        jnp.asarray(x))
    module = FusedLayerNorm(48, eps=1e-6)
    assert isinstance(module, torch.nn.LayerNorm)  # init loops find it
    assert set(module.state_dict()) == {'weight', 'bias'}
    module.load_state_dict({'weight': torch.from_numpy(w),
                            'bias': torch.from_numpy(b)})
    tx = torch.from_numpy(x).requires_grad_()
    y = module(tx)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    y.backward(torch.from_numpy(cot))
    assert module.weight.grad.shape == (48,) and tx.grad.shape == x.shape
    assert module.weight.dtype == torch.float32
    # bf16 activations keep float32 parameters and return bf16
    assert module(tx.detach().bfloat16()).dtype == torch.bfloat16


def test_mit_norms_are_fused_and_stage_outputs_match_jax():
    """Every LayerNorm of the port's MiT-B0 is a ``FusedLayerNorm``, a JAX
    tree loads into it with no new mapping, and the four stage outputs
    equal the JAX backbone's."""
    jax_model = build_jax_segmentor(segformer_cfg())
    variables = random_jax_variables(jax_model, seed=3)
    port = build_segmentor(segformer_cfg())
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    norms = [m for m in port.backbone.modules()
             if isinstance(m, torch.nn.LayerNorm)]
    # per stage: patch-embed norm, stage norm, 2 x (norm1, norm2), and the
    # SRA norm of both blocks in stages 1-3
    assert len(norms) == 4 * (2 + 4) + 3 * 2
    assert all(type(m) is FusedLayerNorm for m in norms)
    x = np.random.RandomState(4).randn(2, 64, 96, 3).astype(np.float32)
    want = jax_model.net.apply(variables, jnp.asarray(x), train=False,
                               method=jax_model.net.extract_feat)
    with torch.no_grad():
        got = port.eval().extract_feat(
            torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert len(got) == len(want) == 4
    for s, (a, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), nhwc_to_nchw(w), rtol=RTOL,
                                   atol=ATOL, err_msg=f'stage {s + 1}')


@pytest.mark.parametrize('make,match', [
    (lambda: (torch.zeros(4, 12), torch.ones(12), torch.zeros(12)),
     'multiple of 8'),
    (lambda: (torch.zeros(4, 2048), torch.ones(2048), torch.zeros(2048)),
     'up to 1536'),
    (lambda: (torch.zeros(4, 32, dtype=torch.float16), torch.ones(32),
              torch.zeros(32)), 'float32 or bfloat16'),
    (lambda: (torch.zeros(4, 32), torch.ones(32).bfloat16(),
              torch.zeros(32)), 'weight must be'),
    (lambda: (torch.zeros(4, 32), torch.ones(32), torch.zeros(16)),
     'bias must be'),
], ids=['C-not-8', 'C-too-wide', 'dtype', 'weight-dtype', 'bias-shape'])
def test_kernel_wrapper_says_what_it_refuses(make, match):
    """What the CUDA wrapper refuses, with its reason (the checks run on
    any device; a launch needs the card)."""
    with pytest.raises((TypeError, ValueError), match=match):
        ln._refuse(*make())


def test_rows_view_and_alignment():
    """A contiguous tensor is passed without a view; leading axes that
    fold give a row stride; a strided last axis raises for x and is copied
    for a gradient."""
    x = torch.zeros(4, 6, 32)
    ptr, stride, rows, _ = ln._rows_of('x', x, 32)
    assert (ptr, stride, rows) == (x.data_ptr(), 32, 24)
    _, stride, rows, _ = ln._rows_of('x', x[:, ::2], 32)
    assert (stride, rows) == (64, 12)
    wide = torch.zeros(4, 6, 64)
    with pytest.raises(ValueError, match='contiguous'):
        ln._rows_of('x', wide[..., ::2], 32)
    with pytest.raises(ValueError, match='16-byte'):
        ln._rows_of('x', wide[..., 1:33], 32)
    ptr, stride, rows, kept = ln._rows_of('dy', wide[..., ::2], 32, copy=True)
    assert (stride, rows) == (32, 24) and ptr == kept.data_ptr()
    assert ln.FWD_KERNEL.launches == 0 and ln.BWD_KERNEL.launches == 0


def _grad_fn_tensors(y):
    """Every tensor the autograd node of ``y`` saved."""
    node = y.grad_fn
    return [t for t in getattr(node, 'saved_tensors', ())]


def test_bias_is_not_kept_alive_by_the_graph():
    """The backward never reads bias: the node saves x and weight alone,
    and dbias is right all the same."""
    import weakref
    x = torch.randn(6, 32, requires_grad=True)
    w = torch.randn(32, requires_grad=True)
    b = torch.randn(32, requires_grad=True)
    y = ln.fused_layer_norm(x, w, b)
    saved = _grad_fn_tensors(y)
    assert len(saved) == 2
    assert {t.data_ptr() for t in saved} == {x.data_ptr(), w.data_ptr()}
    bias = torch.randn(32)
    ref = weakref.ref(bias)
    y2 = ln.fused_layer_norm(x, w, bias)
    del bias
    assert ref() is None and y2.grad_fn is not None
    g = torch.randn(6, 32)
    got = torch.autograd.grad(y, (x, w, b), g)
    want = torch.autograd.grad(
        torch.nn.functional.layer_norm(x, (32,), w, b, 1e-6), (x, w, b), g)
    for a, c in zip(got, want):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('frozen', [(False, True, True), (False, True, False),
                                    (True, False, False), (False, False, True)],
                         ids=['params', 'weight', 'x', 'bias'])
def test_frozen_inputs_get_no_gradient(frozen):
    """An input that needs no gradient gets None from the node (not a
    tensor of zeros); the others get theirs."""
    tensors = [torch.randn(5, 16), torch.randn(16), torch.randn(16)]
    for t, f in zip(tensors, frozen):
        t.requires_grad_(not f)
    y = ln.fused_layer_norm(*tensors)
    g = torch.randn(5, 16)
    ctx_grads = y.grad_fn.apply(g)
    assert [c is None for c in ctx_grads[:3]] == list(frozen)
    live = [t for t, f in zip(tensors, frozen) if not f]
    got = torch.autograd.grad(y, live, g)
    want = torch.autograd.grad(
        torch.nn.functional.layer_norm(tensors[0], (16,), tensors[1],
                                       tensors[2], 1e-6), live, g)
    for a, c in zip(got, want):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-5, atol=1e-5)


def test_no_incoming_gradient_gives_none():
    """``set_materialize_grads(False)``: an output nobody differentiates
    costs no backward work."""
    x = torch.randn(4, 16, requires_grad=True)
    y = ln.fused_layer_norm(x, torch.ones(16), torch.zeros(16))
    assert y.grad_fn.apply(None) == (None, None, None, None)


def test_workspace_is_reused_per_device_stream_and_width(monkeypatch):
    made = []

    real_zeros = torch.zeros

    def zeros(n, dtype, device):
        made.append((n, dtype, device))
        return real_zeros(n, dtype=dtype)
    monkeypatch.setattr(ln, 'sm_count', lambda index: 30 + index)
    monkeypatch.setattr(ln, 'WORKSPACES', {})
    monkeypatch.setattr(torch, 'zeros', zeros)  # no card here
    cap = ln._BWD_BLOCKS_PER_SM * 30
    assert cap == ln.bwd_capacity(0, 32) == ln.bwd_capacity(0, 256)
    assert ln.bwd_capacity(0, 320) == ln._BWD_BLOCKS_PER_SM_WIDE * 30
    a = ln.workspace(0, 111, 32, cap)
    # the partials, the groups' sums, the tickets of both rounds
    groups = -(-cap // ln._GROUP_BLOCKS)
    assert a.numel() == ln.workspace_floats(cap, 32) \
        == (cap + groups) * 64 + 1 + groups and not a.any()
    assert made == [(a.numel(), torch.float32, torch.device('cuda', 0))]
    assert ln.workspace_tickets(a, 32, cap).numel() == 1 + groups
    assert ln.workspace(0, 111, 32, cap) is a and len(made) == 1
    b = ln.workspace(0, 111, 64, cap)       # another width: its own counter
    c = ln.workspace(0, 222, 32, cap)       # another stream
    cap1 = ln.bwd_capacity(1, 32)           # another device, other SM count
    d = ln.workspace(1, 111, 32, cap1)
    e = ln.workspace(0, 111, 32, cap // 2)  # another capacity: other offsets
    assert len({t.data_ptr() for t in (a, b, c, d, e)}) == 5
    assert b.numel() == ln.workspace_floats(cap, 64) \
        and cap1 == ln._BWD_BLOCKS_PER_SM * 31 \
        and e.numel() == ln.workspace_floats(cap // 2, 32)
    assert len(ln.WORKSPACES) == 5 and len(made) == 5
    assert ln.workspace(0, 222, 32, cap) is c and len(made) == 5


def test_rows_that_do_not_fold_are_copied_and_kept():
    """``x[:, 1:]`` has a unit last stride but no single row stride: the
    rows handed to the kernels are a copy, and the pointer, the stride and
    the tensor returned describe that copy, not ``x``'s memory."""
    x = torch.arange(4 * 6 * 32, dtype=torch.float32).view(4, 6, 32)
    cut = x[:, 1:, :]
    ptr, stride, rows, kept = ln._rows_of('x', cut, 32)
    assert (stride, rows) == (32, 20) and ptr == kept.data_ptr()
    assert kept.data_ptr() != cut.data_ptr()
    assert torch.equal(kept, cut.reshape(-1, 32))
    # a slice that folds is read in place
    ptr, stride, rows, kept = ln._rows_of('x', x[:, ::2], 32)
    assert ptr == x.data_ptr() and (stride, rows) == (64, 12)


@pytest.mark.parametrize('rows,C,capacity,want', [
    (131072, 32, 528, 528),   # more row groups than blocks
    (10, 32, 528, 1),         # fewer rows than one block holds
    (65, 32, 528, 2),
    (2048, 256, 528, 256),   # 8 values a lane: a warp holds one row
    (2048, 512, 528, 256),
    (1001, 160, 8, 8),
])
def test_bwd_blocks(rows, C, capacity, want):
    assert ln.bwd_blocks(rows, C, capacity) == want


def test_grid_constants_mirror_the_source():
    import re
    from pathlib import Path
    src = (Path(ln.__file__).resolve().parent.parent / 'csrc'
           / 'layer_norm.cu').read_text()
    assert int(re.search(r'kGroupBlocks = (\d+);', src).group(1)) \
        == ln._GROUP_BLOCKS
    assert int(re.search(r'kThreads = (\d+);', src).group(1)) == ln._THREADS
    assert int(re.search(r'kBwdPerLane = (\d+);', src).group(1)) == 8
    assert [ln._bwd_lanes(c) for c in (8, 32, 40, 64, 128, 160, 256, 1024)] \
        == [4, 4, 8, 8, 16, 32, 32, 32]
