"""The pieces of the Tab5 PSP and Swin slice that are not models, on the
CPU, against the JAX package where it has them.

- Two sizes: the group-KL (CGD, CD) and pixel-KL (PD) wrappers with a
  student and a teacher of different sizes (the PSP student's logits at
  stride 8 against the teacher's at stride 4) run their plain versions
  here; held against the JAX ``KLDLoss``, which on the CPU resizes each
  map to the label size and then takes the KL (its unfused path), with
  the gradients: losses at rtol 1e-5, gradients at rtol 1e-4 and an atol
  of 1e-6 of the largest. Such a pair plans K3/K4's two-geometry tiles
  where both maps' windows fit and the gather variants elsewhere, K7/K8's
  gather variants (the sources insist), and same-size pairs keep their
  tile plans.
- K10/K11 at C = 1536 (the last PatchMerging norm of Swin-T): the plans
  and the plain version against flax's LayerNorm, 2e-5 relative.
- ``init_segmentor`` (lenient, the student of a distillation config)
  against the JAX ``init_segmentor`` on seeded ``.pth`` files: the loaded
  tensors bit for bit.
"""

import textwrap

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segdistill_tpu.apis import init_segmentor as jax_init_segmentor
from segdistill_tpu.distill.losses import KLDLoss as JaxKLDLoss
from segdistill_tpu_torch.apis import init_segmentor
from segdistill_tpu_torch.convert import state_dict_from_jax
from segdistill_tpu_torch.ops import group_kl, layer_norm, ln_plan, pixel_kl
from segdistill_tpu_torch.ops import tile_plan

from torch_port_fixtures import psp_cfg, segformer_cfg

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_SHARE = 1e-4, 1e-6
RESIZE = {'mode': 'bilinear', 'align_corners': False}

# (B, C, student hw, teacher hw, output hw)
TWO_SIZES = [(2, 19, (8, 8), (16, 16), (64, 64)),
             (1, 7, (9, 11), (13, 5), (37, 41)),
             (2, 10, (16, 16), (8, 8), (64, 64))]


def _maps(B, C, hs, ht, seed):
    rng = np.random.RandomState(seed)
    return (3 * rng.randn(B, C, *hs)).astype(np.float32), \
        (3 * rng.randn(B, C, *ht)).astype(np.float32)


def _jax_loss_and_grad(crit, xs, xt, out_hw, step=1000, key=None):
    gt = jnp.zeros((xs.shape[0],) + tuple(out_hw), jnp.int32)
    return jax.value_and_grad(lambda a: crit(a, jnp.asarray(xt), gt, step,
                                             key))(jnp.asarray(xs))


def _check(got, dgot, want, dwant):
    np.testing.assert_allclose(got, float(want), rtol=LOSS_RTOL)
    dwant = np.asarray(dwant)
    np.testing.assert_allclose(dgot, dwant, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_SHARE * np.abs(dwant).max())


@pytest.mark.parametrize('B,C,hs,ht,out_hw', TWO_SIZES)
@pytest.mark.parametrize('g', [5, 1, 10])
@pytest.mark.parametrize('shuffled', [False, True])
def test_group_kl_two_sizes_match_jax(B, C, hs, ht, out_hw, g, shuffled):
    xs, xt = _maps(B, C, hs, ht, seed=C + g)
    crit = JaxKLDLoss(alpha=1, tau=2, resize_config=RESIZE,
                      shuffle_config={'interval': 1000} if shuffled else None,
                      transform_config={'loss_type': 'channel',
                                        'group_size': g})
    key = jax.random.key(3)
    want, dwant = _jax_loss_and_grad(crit, xs, xt, out_hw, key=key)
    a = torch.from_numpy(xs).requires_grad_()
    t = torch.from_numpy(xt)
    if shuffled:
        perm = torch.from_numpy(np.asarray(crit._shuffle_idx(C, 1000, key)))
        loss = group_kl.fused_group_kl_shuffled(a, t, perm, out_hw, g, 2.0)
    else:
        loss = group_kl.fused_group_kl(a, t, out_hw, g, 2.0)
    loss.backward()
    _check(loss.item(), a.grad.numpy(), want, dwant)


@pytest.mark.parametrize('B,C,hs,ht,out_hw', TWO_SIZES)
@pytest.mark.parametrize('tau', [1.0, 2.0])
def test_pixel_kl_two_sizes_match_jax(B, C, hs, ht, out_hw, tau):
    xs, xt = _maps(B, C, hs, ht, seed=C)
    crit = JaxKLDLoss(alpha=1, tau=tau, resize_config=RESIZE,
                      transform_config={'loss_type': 'pixel'})
    want, dwant = _jax_loss_and_grad(crit, xs, xt, out_hw)
    a = torch.from_numpy(xs).requires_grad_()
    n = B * out_hw[0] * out_hw[1]
    loss = pixel_kl.fused_pixel_kl(a, torch.from_numpy(xt), out_hw, tau) / n
    loss.backward()
    _check(loss.item(), a.grad.numpy(), want, dwant)


def test_two_size_pairs_plan_the_gather_variants():
    """A teacher of another size. group_kl (K3/K4) plans the tiles'
    two-geometry form at the PSP pair (both windows fit) and the gather
    variants only where a window does not fit (a teacher at ratio 1: K3's
    teacher window; a student at ratio 40: no K4 tile); pixel_kl (K7/K8)
    plans its gather variants: oh 0 and tile 0 (no window, rectangle or
    bytes; a grid of B * C rows of ceil(h * w / 256) blocks). The same size
    keeps the tile plans of ``tile_plan``."""
    gather_bwd = dict(tile=0, rh=0, rw=0, shared_bytes=0, cpc=1, chunks=150,
                      blocks=2 * 150 * 16)
    psp = (2, 150, 64, 64, 512, 512, 132, (128, 128))
    assert group_kl.forward_plan(64, 64, 512, 512, (128, 128)) == \
        tile_plan.forward_plan_two(64, 64, 128, 128, 512, 512, 2, 32, 3)
    assert group_kl.forward_plan(64, 64, 512, 512, (128, 128))['oh'] == 128
    assert group_kl.backward_plan(*psp) == tile_plan.plan_two(
        2, 150, 64, 64, 128, 128, 512, 512, 132, 0, 2, 2)
    assert group_kl.backward_plan(*psp)['tile'] == 16
    assert pixel_kl.forward_plan(64, 64, 512, 512, (128, 128)) == \
        tile_plan.gather_forward_plan()
    assert pixel_kl.backward_plan(*psp) == gather_bwd
    # past the tiles' reach: a teacher at ratio 1 (K3), a student at 40 (K4)
    assert group_kl.forward_plan(32, 32, 128, 128, (128, 128)) == \
        tile_plan.gather_forward_plan()
    assert group_kl.backward_plan(1, 19, 8, 8, 320, 320, 132, (16, 16)) == \
        tile_plan.gather_plan(1, 19, 8, 8)
    for mod in (group_kl, pixel_kl):
        same = mod.forward_plan(64, 64, 512, 512, (64, 64))
        assert same == mod.forward_plan(64, 64, 512, 512) and same['oh'] > 0
        tile = mod.backward_plan(2, 150, 64, 64, 512, 512, 132, (64, 64))
        assert tile == mod.backward_plan(2, 150, 64, 64, 512, 512, 132)
        assert tile['tile'] > 0


def test_two_size_inputs_are_checked():
    xs = torch.zeros(2, 4, 8, 8)
    for bad in (torch.zeros(2, 5, 16, 16), torch.zeros(3, 4, 16, 16),
                torch.zeros(2, 4, 16)):
        with pytest.raises(ValueError, match='teacher map'):
            group_kl.fused_group_kl(xs, bad, (32, 32), 2, 1.0)
        with pytest.raises(ValueError, match='teacher map'):
            pixel_kl.fused_pixel_kl(xs, bad, (32, 32), 1.0)


# ---- K10/K11 at C = 1536 ------------------------------------------------

@pytest.mark.parametrize('rows', [1, 512, 2048, 40000])
def test_ln_plan_takes_1536(rows):
    """C = 1536 (192 bf16 or 384 fp32 vectors): 32 lanes of 6 or 12
    vectors, 48 values a lane, one row a group; K11's 32 lanes."""
    for code, nch in ((1, 6), (0, 12)):
        plan = ln_plan.forward_plan(rows, 1536, code, 132)
        assert (plan.lanes, plan.nch, plan.rows_in_flight) == (32, nch, 1)
        assert plan.nch * ln_plan.VEC[code] == ln_plan.MAX_VALUES == 48
        assert plan.blocks == -(-rows // (plan.threads // 32))
    assert layer_norm._bwd_lanes(1536) == 32
    assert layer_norm.MAX_C == 1536
    # the widths up to 1024 keep their plans: no new instance is taken
    for C in range(8, 1025, 8):
        for code in (0, 1):
            assert ln_plan.forward_plan(rows, C, code, 132).nch \
                * ln_plan.VEC[code] <= 40


def test_layer_norm_1536_matches_flax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 16, 16, 1536).astype(np.float32) * 2 + 0.5
    w = (1 + 0.1 * rng.randn(1536)).astype(np.float32)
    b = (0.1 * rng.randn(1536)).astype(np.float32)
    dy = rng.randn(*x.shape).astype(np.float32)
    ln = fnn.LayerNorm(epsilon=1e-5)
    params = {'params': {'scale': jnp.asarray(w), 'bias': jnp.asarray(b)}}
    want, vjp = jax.vjp(lambda p, a: ln.apply(p, a), params, jnp.asarray(x))
    dp, dx = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = layer_norm.fused_layer_norm(xt, wt, bt, 1e-5)
    y.backward(torch.from_numpy(dy))
    dw, db = dp['params']['scale'], dp['params']['bias']
    for got, ref in ((y, want), (xt.grad, dx), (wt.grad, dw), (bt.grad, db)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=2e-5,
                                   atol=2e-5 * np.abs(ref).max())


# ---- init_segmentor, lenient, the student of a distillation config -------

def _write_config(path, model):
    path.write_text(textwrap.dedent(f'''
        model = {model!r}
        data = dict(test=dict(pipeline=[]))
    '''))
    return str(path)


def _seeded_state(model, seed):
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.randn(v.shape, generator=g) if v.is_floating_point()
                else v.clone()) for k, v in model.state_dict().items()}


@pytest.mark.parametrize('kind', ['segmentor', 'distillation'])
def test_init_segmentor_matches_jax(kind, tmp_path):
    """A ``.pth`` with every tensor of the served model, seeded, plus one
    key the model lacks (an auxiliary head's) and one of another shape:
    both packages skip those two and load the rest into the segmentor, or
    into the student of a distillation config, and serve that."""
    student = psp_cfg(50, dropout_ratio=0.0)
    if kind == 'segmentor':
        model_cfg = student
    else:
        model_cfg = dict(type='SDModule', cfg_s=student,
                         cfg_t=segformer_cfg(dropout_ratio=0.0),
                         distillation=[dict(
                             student_layer='decode_head.conv_seg',
                             teacher_layer='decode_head.linear_pred',
                             loss_name='CGDLoss',
                             loss_config={'group_size': 5})],
                         train_cfg={}, test_cfg=dict(mode='whole'))
    cfg = _write_config(tmp_path / 'cfg.py', model_cfg)
    served = init_segmentor(cfg, device='cpu', seed=1)
    assert type(served).__name__ == 'EncoderDecoder'
    state = _seeded_state(served, seed=2)
    shape_key = 'decode_head.conv_seg.bias'
    state[shape_key] = torch.zeros(7)
    state['auxiliary_head.conv_seg.weight'] = torch.ones(19, 8, 1, 1)
    ckpt = tmp_path / 'student.pth'
    torch.save({'state_dict': state}, ckpt)

    model = init_segmentor(cfg, str(ckpt), device='cpu', seed=1)
    assert type(model).__name__ == 'EncoderDecoder' and not model.training
    assert model.cfg.model['type'] == 'EncoderDecoder'
    _, variables = jax_init_segmentor(cfg, str(ckpt),
                                      input_shape=(1, 64, 64, 3))
    skip = 'num_batches_tracked'
    want = {k: v for k, v in state_dict_from_jax(variables).items()
            if not k.endswith(skip)}
    got = model.state_dict()
    init = served.state_dict()
    assert set(want) == {k for k in got if not k.endswith(skip)}
    for k, v in want.items():
        if k == shape_key:  # kept its own value on both sides
            assert torch.equal(got[k], init[k])
        else:
            assert torch.equal(got[k], state[k]), k
            assert torch.equal(v, state[k]), k


# ---- the paramwise optimizer rules on the new students -------------------

def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, 'items'):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize('family', ['psp', 'swin'])
def test_paramwise_labels_match_jax(family):
    """``swin_adamw()``'s keys (``relative_position_bias_table``, ``norm``;
    Swin-T has no ``absolute_pos_embed``) on the Swin student and
    ``distill_adamw()``'s (``pos_block``, ``norm``, ``head``) on the PSP
    student give every parameter, under the port's name, the (lr, decay)
    multipliers the JAX optimizer gives it under its path."""
    from segdistill_tpu.engine.optimizer import (
        paramwise_labels as jax_paramwise_labels)
    from segdistill_tpu.models import build_segmentor as build_jax_segmentor
    from segdistill_tpu_torch import zoo
    from segdistill_tpu_torch.engine import paramwise_labels

    from torch_port_fixtures import random_jax_variables, swin_cfg
    cfg = psp_cfg(50) if family == 'psp' else swin_cfg()
    keys = (zoo.distill_adamw() if family == 'psp'
            else zoo.swin_adamw())['paramwise_cfg']['custom_keys']
    params = random_jax_variables(build_jax_segmentor(cfg))['params']
    tree = {}
    paths = [p for p, _ in _flat(params)]
    for i, (path, value) in enumerate(_flat(params)):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.full(value.shape, i, np.float32)
    names = {int(t.flatten()[0]): n
             for n, t in state_dict_from_jax({'params': tree}).items()
             if t.is_floating_point()}
    want = jax_paramwise_labels(params, keys)
    got = paramwise_labels(names.values(), keys)
    for i, path in enumerate(paths):
        assert got[names[i]] == want[path], (names[i], path)
    assert len({v for v in got.values()}) >= 2


def test_unported_options_are_refused():
    """Options no Tab5 config sets raise rather than being ignored; Swin's
    absolute position embedding is ported and builds."""
    from segdistill_tpu_torch.models import build_segmentor
    from torch_port_fixtures import swin_cfg
    for cfg in (swin_cfg(frozen_stages=1), psp_cfg(50, frozen_stages=1)):
        with pytest.raises(NotImplementedError, match='not ported'):
            build_segmentor(cfg)
    ape = build_segmentor(swin_cfg(ape=True)).backbone.absolute_pos_embed
    assert tuple(ape.shape) == (1, (224 // 4) ** 2, 24)


@pytest.mark.parametrize('where', ['segmentor', 'backbone', 'both'])
@pytest.mark.parametrize('family', ['segformer', 'pointrend'])
def test_build_segmentor_keeps_pretrained_as_jax(family, where):
    """A config that names a backbone checkpoint, on the segmentor, on its
    backbone or on both: both packages' ``build_segmentor`` build it
    (EncoderDecoder, and the cascade built on it) and keep the same
    ``.pretrained``, the segmentor's before the backbone's; the trainer
    loads it."""
    import copy
    from segdistill_tpu.models import build_segmentor as build_jax_segmentor
    from segdistill_tpu_torch.models import build_segmentor
    from torch_port_fixtures import pointrend_cfg
    cfg = segformer_cfg() if family == 'segformer' else pointrend_cfg()
    if where != 'backbone':
        cfg['pretrained'] = 'x.pth'
    if where != 'segmentor':
        cfg['backbone']['pretrained'] = 'backbone.pth'
    want = 'backbone.pth' if where == 'backbone' else 'x.pth'
    jax_model = build_jax_segmentor(copy.deepcopy(cfg))
    model = build_segmentor(copy.deepcopy(cfg))
    assert model.pretrained == jax_model.pretrained == want
    assert type(model).__name__ == type(jax_model).__name__
