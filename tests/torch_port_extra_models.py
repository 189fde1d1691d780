"""The checks that hold the ``configs/extra`` models in the port to the JAX
package on the CPU, run as tests by one file a model
(``test_torch_port_extra_{psanet,pointrend,psp_city}.py``, on a module
fixture ``case`` from :func:`make_case`): PSANet (ResNetV1c-d8 + PSAHead +
FCN auxiliary head), PointRend (ResNetV1c + FPN neck + FPNHead +
PointHead, a cascade) and PSPNet with the FCN auxiliary head (the
Cityscapes config), narrow (``torch_port_fixtures``), on the same weights
and 128 x 128 inputs.

Each model, in fp32 at the fixtures' ``RTOL, ATOL``: the backbone's
(PointRend: the neck's) maps, the logits of the decode head (PointRend:
after the test-time subdivision) and of the auxiliary head, the
train-mode loss dict (keys and values). In float64 on both sides, at
``RTOL64`` of each tensor's largest value: the step-0 gradients, and a
3-step SGD trajectory (momentum 0.9, weight decay 0, the heads at 10x the
learning rate, the schedule's poly LR) of the port's train step against
the JAX package's optimizer on its own gradients: losses, parameters and
BN running means after each step. (Train-mode BN over a few values a
channel magnifies fp32 rounding: each fp32 side's gradients lie up to 6%
of the largest from float64, which would hide any real difference.) The
point head's training points are drawn by JAX and injected.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from segdistill_tpu.convert.torch_loader import translate_state_dict
from segdistill_tpu.engine import build_lr_schedule as jax_lr_schedule
from segdistill_tpu.engine import build_optimizer as jax_build_optimizer
from segdistill_tpu.models import build_segmentor as build_jax_segmentor
from segdistill_tpu.models.segmentors import parse_losses as jax_parse
from segdistill_tpu_torch.convert import state_dict_from_jax
from segdistill_tpu_torch.engine import (TrainState, build_lr_schedule,
                                         build_optimizer, build_train_step)
from segdistill_tpu_torch.models import build_segmentor
from segdistill_tpu_torch.models.segmentors import parse_losses

from torch_port_fixtures import (ATOL, NUM_CLASSES, POINT_HEAD, RTOL,
                                 float64_kept, nhwc_to_nchw, pointrend_cfg,
                                 psanet_cfg, psp_city_cfg,
                                 random_jax_variables)

MODELS = {'psanet': psanet_cfg, 'pointrend': pointrend_cfg,
          'psp_city': psp_city_cfg}
HW = (128, 128)
# the schedules' SGD without weight decay, the heads at 10x; at 1e-4 of the
# configs' learning rate (see test_sgd_trajectory_float64)
OPTIMIZER = dict(type='SGD', lr=1e-4, momentum=0.9, weight_decay=0.0,
                 paramwise_cfg=dict(custom_keys={'head': dict(lr_mult=10.)}))
LR_CONFIG = dict(policy='poly', power=0.9, min_lr=1e-4, by_epoch=False)
MAX_ITERS = 40000
STEPS = 3
# float64 on both sides, relative to the largest value of the tensor: the
# JAX package keeps float32 islands in float64 runs (the PSA softmax, the
# PSP pooling, point_sample's positions), which train-mode BN over a few
# values a channel magnifies: measured at most 5e-7 (gradients) and 2e-6
# (3 steps) at 128 x 128
RTOL64 = 1e-5


def _batch():
    rng = np.random.RandomState(0)
    img = rng.randn(2, *HW, 3).astype(np.float32)
    gt = rng.randint(0, NUM_CLASSES, (2,) + HW).astype(np.int32)
    gt[0, :4] = 255
    return img, gt


def _loss_fn(model, bstats, img, gt, key):
    def f(p):
        svars = {'params': p, 'batch_stats': bstats}
        losses, _, new_state = model.forward_train(svars, img, gt,
                                                   rngs={'dropout': key})
        total, log_vars = jax_parse(losses)
        return total, (log_vars, new_state['batch_stats'])
    return f


def _jax_points(model, variables, img, key):
    """The point head's training points of one train-mode forward."""
    outs, _ = model.net.apply(variables, img, train=True, with_aux=True,
                              rngs={'dropout': key}, mutable=['batch_stats'])
    return outs['decode_1'][1] if 'decode_1' in outs else None


def _jax_run(model, variables, img, gt):
    """float64: 3 steps of the JAX optimizer on the JAX gradients: per step
    the log vars, the gradients, the point head's points, and the params
    and BN statistics after it."""

    cascade = hasattr(model, 'num_stages')

    @jax.jit
    def step(params, bstats, key):
        grads, (log_vars, new_bs) = jax.grad(
            _loss_fn(model, bstats, img, gt, key), has_aux=True)(params)
        points = _jax_points(model, {'params': params,
                                     'batch_stats': bstats}, img, key) \
            if cascade else None
        return grads, log_vars, new_bs, points

    tx = jax_build_optimizer(OPTIMIZER, variables['params'],
                             jax_lr_schedule(LR_CONFIG, OPTIMIZER['lr'],
                                             MAX_ITERS))
    params, bstats = variables['params'], variables['batch_stats']
    opt_state = tx.init(params)
    steps = []
    for i in range(STEPS):
        grads, log_vars, bstats, points = step(params, bstats,
                                               jax.random.key(11 + i))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        steps.append(dict(
            log_vars={k: float(v) for k, v in log_vars.items()},
            grads=jax.tree.map(np.asarray, grads),
            points=None if points is None else np.asarray(points),
            variables=jax.tree.map(np.asarray, {'params': params,
                                                'batch_stats': bstats})))
    return steps


def make_case(name):
    """The model's JAX variables and its float64 3-step trajectory."""
    make = MODELS[name]
    jax_model = build_jax_segmentor(make())
    variables = random_jax_variables(jax_model, seed=3)
    img, gt = _batch()
    with jax.enable_x64(True):
        cfg64 = make()
        cfg64['backbone']['dtype'] = 'float64'
        steps = _jax_run(build_jax_segmentor(cfg64),
                         jax.tree.map(lambda a: np.asarray(a, np.float64),
                                      variables),
                         jnp.asarray(img, jnp.float64), jnp.asarray(gt))
    return dict(name=name, make=make, jax_model=jax_model,
                variables=variables, img=img, gt=gt, steps=steps)


def _port(case, float64=False):
    model = build_segmentor(case['make']())
    model.load_state_dict(state_dict_from_jax(case['variables']),
                          strict=True)
    if float64:
        model.double()
        model.backbone.dtype = torch.float64
    return model


def _tensors(case, dtype=torch.float32):
    return (torch.from_numpy(nhwc_to_nchw(case['img']).copy()).to(dtype),
            torch.from_numpy(case['gt'].astype(np.int64)))


def _points(points, dtype=torch.float64):
    return None if points is None else torch.from_numpy(points).to(dtype)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def check_feature_maps_and_logits(case):
    """The backbone's maps (PointRend: the FPN neck's four levels), the
    decode head's eval logits (PointRend: the point head's refined map at
    16x the coarse one's size) and the auxiliary head's logits."""
    jax_model, variables = case['jax_model'], case['variables']
    x, _ = _tensors(case)
    img = jnp.asarray(case['img'])

    def feats(mdl, img):
        out = mdl.backbone(img, train=False)
        return out if mdl.neck is None else mdl.neck(out, train=False)
    want_feats = jax_model.net.apply(variables, img, method=feats)
    outs = jax_model.net.apply(variables, img, train=False, with_aux=True)
    port = _port(case).eval()
    with torch.no_grad():
        got_feats = port.extract_feat(x)
        got = port(x)
    assert len(got_feats) == len(want_feats) == 4
    for i, (g, w) in enumerate(zip(got_feats, want_feats)):
        _close(g.numpy(), nhwc_to_nchw(w), f'level {i}')
    want = nhwc_to_nchw(outs['decode'])
    stride = 4 if case['name'] == 'pointrend' else 8
    assert got.shape[2:] == tuple(
        s // stride * (4 if case['name'] == 'pointrend' else 1) for s in HW)
    # the point MLP's inputs are sampled at positions that JAX forms as
    # p * W - 0.5 and grid_sample as ((2p - 1 + 1) * W - 1) / 2: ATOL of
    # the largest |logit|
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(want).max()),
                               err_msg='decode logits')
    if 'aux' in outs:
        with torch.no_grad():
            aux = port.auxiliary_head(got_feats)
        _close(aux.numpy(), nhwc_to_nchw(outs['aux']), 'aux logits')


def check_losses(case):
    """The train-mode loss dict in fp32 against JAX's step 0 (in float64),
    at the points JAX drew there."""
    step = case['steps'][0]
    port = _port(case).train()
    x, y = _tensors(case)
    losses, _ = port.forward_train(
        x, y, generator=torch.Generator(),
        points=_points(step['points'], torch.float32))
    _, got = parse_losses(losses)
    want = step['log_vars']
    assert set(got) == set(want)
    heads = {'psanet': {'decode', 'aux'}, 'psp_city': {'decode', 'aux'},
             'pointrend': {'decode_0', 'decode_1'}}[case['name']]
    assert {k.split('.')[0] for k in got if k != 'loss'} == heads
    for k in want:
        if '.acc_' in k:  # an argmax near-tie may flip: one pixel (point)
            n = HW[0] * HW[1] * 2 if 'point' not in k \
                else 2 * POINT_HEAD['num_points']
            assert abs(got[k].item() - want[k]) <= 100.0 / n * 1.001, k
        else:
            _close(got[k].item(), want[k], k)


def _close64(got, want, scale, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL64, atol=RTOL64 * scale, err_msg=what)


def check_step0_gradients_float64(case):
    """Every parameter's gradient, both packages in float64 (fp32 rounding
    is magnified by train-mode BN over a few values a channel, e.g. the
    stride-32 maps of PointRend at 2 x 2: each fp32 side lies up to 6% of
    the largest gradient from float64 there)."""
    step = case['steps'][0]
    port = _port(case, float64=True).train()
    x, y = _tensors(case, torch.float64)
    with float64_kept():
        losses, _ = port.forward_train(x, y, generator=torch.Generator(),
                                       points=_points(step['points']))
        total, got = parse_losses(losses)
        total.backward()
    for k, v in step['log_vars'].items():
        _close64(got[k].item(), v, abs(v), k)
    grads = state_dict_from_jax({'params': step['grads']})
    named = dict(port.named_parameters())
    assert named.keys() == grads.keys()
    scale = max(float(g.abs().max()) for g in grads.values())
    for k, g in grads.items():
        assert named[k].grad is not None, k
        _close64(named[k].grad.numpy(), g.numpy(), scale, k)


def check_sgd_trajectory_float64(case):
    """Three steps of the port's train step and SGD against the JAX
    package's optimizer, float64 on both sides: the loss terms, the
    learning rate, and every parameter and BN running mean after each
    step. At the configs' learning rate (0.01) the untrained narrow
    models take steps of the size of their weights, and any difference
    (the float32 islands above) doubles every few iterations: 1e-7 after
    one step, 1e-2 after three; at 1e-4 the three steps stay within 2e-6,
    which leaves a wrong momentum, multiplier or schedule (changes of
    1e-2 or more of a step) in plain view."""
    port = _port(case, float64=True)
    optimizer = build_optimizer(OPTIMIZER, port)
    assert isinstance(optimizer, torch.optim.SGD)
    assert sorted(g['lr_mult'] for g in optimizer.param_groups) == [1.0,
                                                                    10.0]
    schedule = build_lr_schedule(LR_CONFIG, OPTIMIZER['lr'], MAX_ITERS)
    step_fn = build_train_step(port, optimizer, schedule)
    state = TrainState(model=port, optimizer=optimizer, seed=0)
    x, y = _tensors(case, torch.float64)
    for i, ref in enumerate(case['steps']):
        with float64_kept():
            log_vars = step_fn(state, x, y, points=_points(ref['points']))
        assert log_vars['lr'] == pytest.approx(schedule(i))
        for k, v in ref['log_vars'].items():
            _close64(float(log_vars[k]), v, abs(v), f'step {i + 1} {k}')
        want = state_dict_from_jax(ref['variables'])
        got = port.state_dict()
        for k, w in want.items():
            if not k.endswith(('running_var', 'num_batches_tracked')):
                _close64(got[k].numpy(), w.numpy(),
                         float(w.abs().max()), f'step {i + 1} {k}')


def check_the_jax_loader_reads_the_port_state_dict(case):
    """The port's state dict (the reference layout) through the JAX
    package's loader gives back the variables, bit for bit: every tensor
    but the point head's MLP (``fcs.{k}``, which that loader has no rule
    for) and its ``fc_seg`` Conv1d weight ((O, I, 1), which it does not
    map onto its kernel) (ROADMAP, known faults on the reference side)."""
    port = _port(case)
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    fresh = random_jax_variables(case['jax_model'], seed=9)
    loaded, _, missing, unexpected = translate_state_dict(state, fresh)
    lost = sorted(k for k, v in state.items()
                  if v.ndim == 3 or '.fcs.' in k)
    assert sorted(unexpected) == lost
    assert len(missing) == len(lost)
    assert (case['name'] == 'pointrend') == bool(lost)
    want = dict(_leaves(case['variables']))
    got = dict(_leaves(loaded))
    skip = {'/'.join(k) for k in missing}
    for k, w in want.items():
        if k not in skip:
            assert np.array_equal(got[k], w), k


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, 'items'):
            yield from _leaves(v, prefix + (k,))
        else:
            yield '/'.join(prefix + (k,)), np.asarray(v)


def check_slide_inference_matches_jax():
    """The Cityscapes config's slide inference (windows at a stride that
    overlaps them, count-matrix averaging) on the narrow PSPNet."""
    test_cfg = dict(mode='slide', crop_size=(40, 40), stride=(24, 24))
    jax_model = build_jax_segmentor(psp_city_cfg(test_cfg=test_cfg))
    variables = random_jax_variables(jax_model, seed=4)
    img = np.random.RandomState(5).randn(1, 64, 88, 3).astype(np.float32)
    want = jax_model.slide_inference(variables, jnp.asarray(img))
    port = build_segmentor(psp_city_cfg(test_cfg=copy.deepcopy(test_cfg)))
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = port.eval().slide_inference(
            torch.from_numpy(nhwc_to_nchw(img).copy()))
    assert got.shape == (1, NUM_CLASSES, 64, 88)
    _close(got.numpy(), nhwc_to_nchw(want), 'slide logits')
