"""The checks that hold the attention heads' Cityscapes models in the port
to the JAX package on the CPU, run as tests by four files
(``test_torch_port_attn_{nl,apc_ann,da,ema_enc}.py``, on a module fixture
``case`` from :func:`make_case`): the ``configs/_base_/models/`` fragments
``nonlocal``, ``gcnet``, ``dnl``, ``ccnet``, ``ann``, ``apcnet``,
``dmnet``, ``danet``, ``emanet`` and ``encnet_r50-d8``, each on a narrow
ResNetV1c-18-d8 with the FCN auxiliary head (``torch_port_zoo_models``),
19 classes, dropout 0, the same seeded weights and 64 x 64 inputs.

Each model, in fp32: the backbone's maps and every output of every head
(DANet's three logits, EncNet's logits and se logits) within 1e-5 of the
largest |value| of each (``REL``), and the train-mode loss dict
(``decode.pam_cam.loss_seg``, ``decode.loss_se``, ...) against JAX's step
0 (in float64). In float64 on both sides: every step-0 gradient within
5e-7 of the largest (``GRAD_REL``; EMANet's frozen ``ema_mid_conv`` has no
gradient in the port and a zero one in JAX), with the JAX package's
float32 islands traced in float64 (:func:`float64_islands`), and the
3-step SGD trajectory of ``torch_port_extra_models`` (weight decay 0, so
EMANet's frozen conv stays put on both sides; its bases buffer is held
after each step). The JAX loader reads the port's state dict with nothing
unmatched, bit for bit.

Per-module cases (:data:`HEAD_CASES`, one head alone on seeded maps,
eval mode, fp32 within ``REL``): NL in 'dot_product' mode, GC with
average pooling and both fusions, CC on a 5 x 7 map (a wrong transpose
shows only where h != w), EncNet with ``add_lateral``, DM at each filter
size 1-7 (the even ones padded (p + 1, p)). :func:`check_gc_layer_norm_eps`
holds GC at context vectors of variance ~1e-3, where mmcv's LayerNorm eps
(1e-5, the port's) and flax's (1e-6, the JAX package's) part.
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from segdistill_tpu.convert.torch_loader import translate_state_dict
from segdistill_tpu.models import build_segmentor as build_jax_segmentor
from segdistill_tpu.models.builder import build_head as build_jax_head
from segdistill_tpu.models.decode_heads import apc_head as jax_apc_head
from segdistill_tpu.models.decode_heads import da_head as jax_da_head
from segdistill_tpu.models.decode_heads import nl_head as jax_nl_head
from segdistill_tpu.models.decode_heads import psp_head as jax_psp_head
from segdistill_tpu.models.utils import self_attention_block as jax_attention
from segdistill_tpu_torch.convert import state_dict_from_jax
from segdistill_tpu_torch.engine import (TrainState, build_lr_schedule,
                                         build_optimizer, build_train_step)
from segdistill_tpu_torch.models import build_head
from segdistill_tpu_torch.models.decode_heads import nl_head as port_nl_head
from segdistill_tpu_torch.models.segmentors import parse_losses

import torch_port_extra_models as extra
import torch_port_zoo_models as zoo
from torch_port_fixtures import (_randomize_leaf, float64_kept, nhwc_to_nchw,
                                 random_jax_variables)
from torch_port_zoo2_models import _pool_matrix64
from torch_port_zoo_models import (GRAD_REL, REL, _Float64Numpy, _segmentor,
                                   fcn_aux18, one_thread, resnet18_d8,
                                   run_jit)

__all__ = ['one_thread']


def _head(type_, channels=16, in_channels=64, in_index=3, **kw):
    return zoo._head(type_, in_channels, in_index, channels, **kw)


HEADS = {
    'nonlocal': lambda: _head('NLHead', reduction=2, use_scale=True,
                              mode='embedded_gaussian'),
    'gcnet': lambda: _head('GCHead', ratio=0.25, pooling_type='att',
                           fusion_types=('channel_add',)),
    'dnl': lambda: _head('DNLHead', reduction=2, use_scale=True,
                         mode='embedded_gaussian'),
    'ccnet': lambda: _head('CCHead', recurrence=2),
    'ann': lambda: _head('ANNHead', in_channels=[32, 64], in_index=[2, 3],
                         project_channels=8, query_scales=(1,),
                         key_pool_scales=(1, 3, 6, 8)),
    'apcnet': lambda: _head('APCHead', pool_scales=(1, 2, 3, 6)),
    'dmnet': lambda: _head('DMHead', filter_sizes=(1, 3, 5, 7)),
    'danet': lambda: _head('DAHead', pam_channels=8),
    'emanet': lambda: _head('EMAHead', ema_channels=24, num_bases=8,
                            num_stages=3, momentum=0.1),
    'encnet': lambda: _head(
        'EncHead', in_channels=[16, 32, 64], in_index=(1, 2, 3),
        num_codes=8, use_se_loss=True, add_lateral=False,
        loss_se_decode=dict(type='CrossEntropyLoss', use_sigmoid=True,
                            loss_weight=0.2)),
}


def model_cfg(name):
    return _segmentor(resnet18_d8(), HEADS[name](), fcn_aux18())


@contextlib.contextmanager
def float64_islands():
    """Within the block, the JAX package's float32 islands on these paths
    (the attention products and softmaxes of the NL, DA and APC files and
    of the attention block, the adaptive pools' matrices) trace in
    float64: a float64 run then rounds nothing to float32."""
    with contextlib.ExitStack() as stack:
        for module in (jax_nl_head, jax_da_head, jax_apc_head, jax_psp_head,
                       jax_attention):
            stack.enter_context(mock.patch.object(module, 'jnp',
                                                  _Float64Numpy()))
        stack.enter_context(mock.patch.object(
            jax_psp_head, '_adaptive_pool_matrix', _pool_matrix64))
        yield


def _jax_steps(jax_model, variables, img, gt, optimizer=None):
    """``zoo._jax_run`` (float64, 3 steps) under ``optimizer`` (default:
    the trajectory's, weight decay 0)."""
    if optimizer is None:
        return zoo._jax_run(jax_model, variables, img, gt)
    with mock.patch.object(extra, 'OPTIMIZER', optimizer):
        return zoo._jax_run(jax_model, variables, img, gt)


def make_case(name):
    """The model's JAX variables, its fp32 eval outputs (backbone maps,
    every head's outputs) and its float64 3-step trajectory."""
    def make():
        return model_cfg(name)
    jax_model = build_jax_segmentor(make())
    variables = random_jax_variables(jax_model, seed=3)
    img, gt = zoo._batch(zoo.HW)

    def outputs(v, i):
        outs, inter = jax_model.net.apply(
            v, i, train=False, with_aux=True, mutable=['intermediates'],
            capture_intermediates=lambda mdl, method: (
                mdl.name == 'backbone' and method == '__call__'))
        return inter['intermediates']['backbone']['__call__'][0], outs
    feats, outs = jax.tree.map(np.asarray, run_jit(outputs, variables,
                                                   jnp.asarray(img)))
    with jax.enable_x64(True), float64_islands():
        steps = _jax_steps(*_float64_model(make, variables, img, gt))
    return dict(name=name, make=make, jax_model=jax_model,
                variables=variables, img=img, gt=gt, steps=steps,
                feats=feats, outs=outs)


# the JAX package's ContextBlock LayerNorm eps (flax's), which the port's
# GC checks against JAX take (``port_nl_head.LN_EPS``; the port's own,
# mmcv's 1e-5, parts visibly: check_gc_layer_norm_eps)
FLAX_LN_EPS = 1e-6


@contextlib.contextmanager
def flax_ln_eps(name):
    """Within the block, the port's GC heads built for ``name`` (a model
    or head case) take flax's LayerNorm eps."""
    if not name.startswith('gc'):
        yield
        return
    with mock.patch.object(port_nl_head, 'LN_EPS', FLAX_LN_EPS):
        yield


def run_check(check, case):
    """``check_<check>(case)`` with :func:`flax_ln_eps`."""
    with flax_ln_eps(case['name']):
        globals()[f'check_{check}'](case)


def _float64_model(make, variables, img, gt):
    cfg64 = make()
    cfg64['backbone']['dtype'] = 'float64'
    return (build_jax_segmentor(cfg64),
            jax.tree.map(lambda a: np.asarray(a, np.float64), variables),
            jnp.asarray(img, jnp.float64), jnp.asarray(gt))


def _close_rel(got, want, what, rel=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=what)


def _as_nchw(a):
    """An NHWC map as NCHW; per-image vectors (EncNet's se logits) as
    they are."""
    a = np.asarray(a, np.float32)
    return nhwc_to_nchw(a) if a.ndim == 4 else a


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def check_feature_maps_and_logits(case):
    """The backbone's maps and every output of every head, eval mode,
    fp32; and the segmentor's forward gives the primary logits."""
    x, _ = extra._tensors(case)
    port = extra._port(case).eval()
    with torch.no_grad():
        got_feats = port.extract_feat(x)
        got = {'decode': port.decode_head(got_feats),
               'aux': port.auxiliary_head(got_feats)}
        primary = port(x)
    for i, (g, w) in enumerate(zip(got_feats, case['feats'])):
        _close_rel(g.numpy(), nhwc_to_nchw(w), f'level {i}')
    assert set(got) == set(case['outs'])
    for k, g in got.items():
        want = _outputs(case['outs'][k])
        assert len(_outputs(g)) == len(want), k
        for i, (gi, wi) in enumerate(zip(_outputs(g), want)):
            _close_rel(gi.numpy(), _as_nchw(wi), f'{k} output {i}')
    assert torch.equal(primary, _outputs(got['decode'])[0])


check_losses = zoo.check_losses


def check_step0_gradients_float64(case):
    """Every trainable parameter's gradient, both packages in float64,
    within ``GRAD_REL`` of the largest; a frozen parameter (EMANet's
    ``ema_mid_conv``) has none in the port and exactly 0 in JAX."""
    step = case['steps'][0]
    port = extra._port(case, float64=True).train()
    x, y = extra._tensors(case, torch.float64)
    with float64_kept():
        losses, _ = port.forward_train(x, y, generator=torch.Generator())
        total, got = parse_losses(losses)
        total.backward()
    for k, v in step['log_vars'].items():
        np.testing.assert_allclose(got[k].item(), v, rtol=GRAD_REL, err_msg=k)
    grads = state_dict_from_jax({'params': step['grads']})
    named = dict(port.named_parameters())
    assert named.keys() == grads.keys()
    frozen = {k for k, p in named.items() if not p.requires_grad}
    assert frozen == ({'decode_head.ema_mid_conv.conv.weight',
                       'decode_head.ema_mid_conv.conv.bias'}
                      if case['name'] == 'emanet' else set())
    scale = max(float(g.abs().max()) for g in grads.values())
    for k, g in grads.items():
        if k in frozen:
            assert named[k].grad is None and not g.any(), k
            continue
        assert named[k].grad is not None, k
        np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(), rtol=0,
                                   atol=GRAD_REL * scale, err_msg=k)


check_sgd_trajectory_float64 = extra.check_sgd_trajectory_float64


def check_the_jax_loader_reads_the_port_state_dict(case):
    """The port's state dict (the reference layout) through the JAX
    package's loader gives back every variable bit for bit (EMANet's
    bases, GCNet's (planes, 1, 1) LayerNorm, the Scale and Encoding
    parameters included), with nothing unmatched on either side."""
    port = extra._port(case)
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    fresh = random_jax_variables(case['jax_model'], seed=9)
    loaded, _, missing, unexpected = translate_state_dict(state, fresh)
    assert not missing and not unexpected, (missing, unexpected)
    want = dict(extra._leaves(case['variables']))
    got = dict(extra._leaves(loaded))
    assert want.keys() == got.keys()
    for k, w in want.items():
        assert np.array_equal(got[k], w), k


# ---------------------------------------------------------------- modules
# one head alone on seeded maps: (head config, input maps (C, H, W) at
# batch 2, JAX-variable edits)
HEAD_CASES = {
    'nl_dot_product': (lambda: _head('NLHead', in_index=0,
                                     mode='dot_product'), [(64, 8, 8)]),
    'gc_avg_channel_mul': (
        lambda: _head('GCHead', in_index=0, pooling_type='avg',
                      fusion_types=('channel_add', 'channel_mul')),
        [(64, 8, 8)]),
    'cc_5x7': (lambda: _head('CCHead', in_index=0, recurrence=2),
               [(64, 5, 7)]),
    'enc_add_lateral': (
        lambda: _head('EncHead', in_channels=[16, 32, 64],
                      in_index=(0, 1, 2), num_codes=8, add_lateral=True),
        [(16, 16, 12), (32, 8, 6), (64, 8, 6)]),
}
HEAD_CASES.update({
    f'dm_s{s}': (lambda s=s: _head('DMHead', in_index=0,
                                   filter_sizes=(s,)), [(64, 8, 10)])
    for s in (1, 2, 3, 4, 5, 7)})


def _head_inputs(shapes, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, *s).astype(np.float32) for s in shapes]


def _jax_head(cfg, maps, seed, edit=None):
    """-> (JAX head, seeded variables, its eval outputs on ``maps``)."""
    head = build_jax_head(cfg)
    feats = [jnp.asarray(m.transpose(0, 2, 3, 1)) for m in maps]
    shapes = jax.eval_shape(lambda: head.init(
        {'params': jax.random.key(0)}, feats))
    rng = np.random.RandomState(seed)
    variables = {col: jax.tree_util.tree_map_with_path(
        lambda p, v: np.asarray(_randomize_leaf(
            (col,) + tuple(k.key for k in p), v.shape, rng), np.float32),
        shapes[col])
        for col in ('params', 'batch_stats') if col in shapes}
    if edit is not None:
        edit(variables)
    return head, variables, head.apply(variables, feats)


def _port_head(cfg, variables):
    head = build_head(cfg)
    head.load_state_dict(state_dict_from_jax(variables), strict=True)
    return head.eval()


def check_head_case(name):
    """One head alone on seeded maps, eval mode: every output within
    ``REL`` of its largest value."""
    make, shapes = HEAD_CASES[name]
    maps = _head_inputs(shapes, seed=21)
    _, variables, want = _jax_head(make(), maps, seed=22)
    with flax_ln_eps(name):
        port = _port_head(make(), variables)
    with torch.no_grad():
        got = port([torch.from_numpy(m) for m in maps])
    assert len(_outputs(got)) == len(_outputs(want))
    for i, (g, w) in enumerate(zip(_outputs(got), _outputs(want))):
        assert g.shape == _as_nchw(w).shape, (name, i)
        _close_rel(g.numpy(), _as_nchw(w), f'{name} output {i}')


# GCNet's context transform at a small spread: the first conv scaled so
# that the LayerNorm's input has a variance of ~1e-3 over the planes
GC_SMALL_SCALE = 0.066


def check_gc_layer_norm_eps():
    """GC at context vectors of variance ~1e-3 (-> ``rel``): with the
    port's LayerNorm at flax's eps (1e-6) the two packages agree within
    ``REL``; at mmcv's 1e-5, the port's, the logits part by more than
    ``REL``: the eps is a visible, deliberate divergence (ROADMAP)."""
    cfg = HEAD_CASES['gc_avg_channel_mul'][0]
    maps = _head_inputs([(64, 8, 8)], seed=23)

    def shrink(variables):
        block = variables['params']['gc_block']
        for name in ('channel_add_conv_0', 'channel_mul_conv_0'):
            block[name] = {k: v * GC_SMALL_SCALE
                           for k, v in block[name].items()}
    _, variables, want = _jax_head(cfg(), maps, seed=24, edit=shrink)
    port = _port_head(cfg(), variables)
    x = [torch.from_numpy(maps[0])]
    ctx = port.gc_block._context(port.convs[0](x[0]))
    spread = port.gc_block.channel_add_conv[0](ctx).var(dim=1).mean()
    assert 3e-4 < float(spread) < 3e-3, float(spread)
    norms = [port.gc_block.channel_add_conv[1],
             port.gc_block.channel_mul_conv[1]]
    assert {n.eps for n in norms} == {1e-5}
    want = nhwc_to_nchw(want)
    with torch.no_grad():
        mmcv_eps = port(x).numpy()
        for n in norms:
            n.eps = 1e-6
        flax_eps = port(x).numpy()
    _close_rel(flax_eps, want, 'GC logits at flax eps')
    gap = np.abs(mmcv_eps - want).max() / np.abs(want).max()
    assert gap > REL, gap
    return gap


# ---------------------------------------------------- the JAX-side fault
FAULT_OPTIMIZER = dict(extra.OPTIMIZER, weight_decay=5e-4)


def check_frozen_conv_under_weight_decay():
    """EMANet under SGD with the recipe's weight decay: three port steps
    leave ``ema_mid_conv`` bitwise as it was (its parameters take no
    gradient and the optimizer holds none of them), while the JAX chain
    (``engine/optimizer.py`` decays every leaf) moves it by lr * wd * p
    a step, the head's lr multiplier included (ROADMAP, known faults on
    the reference side). Float64 on both sides."""
    def make():
        return model_cfg('emanet')
    variables = random_jax_variables(build_jax_segmentor(make()), seed=3)
    img, gt = zoo._batch(zoo.HW)
    with jax.enable_x64(True), float64_islands():
        steps = _jax_steps(*_float64_model(make, variables, img, gt),
                           optimizer=FAULT_OPTIMIZER)
    case = dict(make=make, variables=variables, img=img, gt=gt)
    port = extra._port(case, float64=True)
    optimizer = build_optimizer(FAULT_OPTIMIZER, port)
    held = {id(p) for g in optimizer.param_groups for p in g['params']}
    mid = port.decode_head.ema_mid_conv.conv
    assert id(mid.weight) not in held and id(mid.bias) not in held
    before = {k: v.clone() for k, v in mid.state_dict().items()}
    schedule = build_lr_schedule(extra.LR_CONFIG, FAULT_OPTIMIZER['lr'],
                                 extra.MAX_ITERS)
    step = build_train_step(port, optimizer, schedule)
    state = TrainState(model=port, optimizer=optimizer, seed=0)
    x, y = extra._tensors(case, torch.float64)
    with float64_kept():
        for _ in range(extra.STEPS):
            step(state, x, y)
    for k, v in mid.state_dict().items():
        assert torch.equal(v, before[k]), k
    # the JAX chain: the momentum trace of a zero gradient, plus the decay
    # added after it (decoupled), the head's parameters at 10x the rate
    p0 = variables['params']['decode_head']['ema_mid_conv']['conv']['kernel']
    p = np.asarray(p0, np.float64)
    wd, mult = FAULT_OPTIMIZER['weight_decay'], 10.0
    for i, ref in enumerate(steps):
        p = p - schedule(i) * (mult * (wd * p))
        got = ref['variables']['params']['decode_head']['ema_mid_conv'][
            'conv']['kernel']
        np.testing.assert_allclose(got, p, rtol=1e-12, atol=0)
    assert not np.array_equal(p, p0)


def _jax_apply_refuses(cfg, maps):
    head = build_jax_head(cfg)
    feats = [jnp.asarray(m.transpose(0, 2, 3, 1)) for m in maps]
    head.init({'params': jax.random.key(0)}, feats)


REFUSALS = {
    'dnl_mode': (lambda: _head('DNLHead', in_index=0, mode='dot_product'),
                 ValueError, ValueError),
    'ann_query_scales': (
        lambda: _head('ANNHead', in_channels=[32, 64], in_index=[0, 1],
                      project_channels=8, query_scales=(1, 2)),
        NotImplementedError, NotImplementedError),
}


def check_refusal(name):
    """A setting that neither package computes raises on both sides: the
    port when the head is built, JAX when it is built or first applied."""
    make, port_error, jax_error = REFUSALS[name]
    try:
        build_head(make())
    except port_error:
        pass
    else:
        raise AssertionError(f'the port built {name}')
    maps = _head_inputs([(32, 8, 8), (64, 8, 8)], seed=25)
    try:
        _jax_apply_refuses(make(), maps if 'ann' in name else maps[1:])
    except jax_error:
        return
    raise AssertionError(f'the JAX package built {name}')
