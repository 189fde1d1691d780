"""The port's multi-teacher segmentor SDModuleMT against the JAX package,
fp32 on the CPU, in both dispatch modes: aligned (two CGD entries, entry
i against teacher i, the second with a 1x1 channel adapter) and the random
ensemble (one CGD entry with an adapter against both teachers, one teacher
a step).

Three small SegFormers (MiT-b0 widths at one block a stage, head embed
64, 19 classes, dropout 0 on every side: JAX's PRNG cannot be reproduced) carry the JAX variables
through ``state_dict_from_jax`` (``student.*``, ``teachers.{i}.*``,
``distill_adapters.*``), on 64x64 images at batch 2. Step 1000 draws a
channel permutation; the JAX permutation and, for the random ensemble,
the JAX teacher index (``jax.random.randint(fold_in(shuffle_rng, step),
(), 0, 2)``, which the port cannot reproduce: it draws its own on the
host) are injected. Held against JAX: the loss dict (keys and values within
2e-5 relative) and the student's gradients at step 1000, and a 3-step
AdamW trajectory (loss steps 1000-1002 at the poly schedule's first three
learning rates, paramwise) of
``build_train_step`` against the JAX package's model and optimizer, one
jit a mode giving each step's gradients and update: losses, parameters and
BN statistics at the fixtures' ``RTOL, ATOL``, BN's running variance to
torch's N/(N-1) relation, as ``test_torch_port_train.py`` holds SDModule.
Then the teachers' freezing, one teacher's forward a random-ensemble step,
the adapters, the recipes, the checkpoint loading and saving, and the two
faults of the JAX package found beside this port (ROADMAP, known faults
on the reference side).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from segdistill_tpu.apis import train as jax_train_api
from segdistill_tpu.distill import engine as jax_engine
from segdistill_tpu.engine import build_lr_schedule as jax_lr_schedule
from segdistill_tpu.engine import build_optimizer as jax_build_optimizer
from segdistill_tpu.models import build_segmentor as build_jax_segmentor
from segdistill_tpu.models.segmentors import parse_losses as jax_parse
from segdistill_tpu.models.segmentors.sd_module import _init_adapters
from segdistill_tpu_torch.apis import student_config
from segdistill_tpu_torch.apis.train import _load_pretrained
from segdistill_tpu_torch.convert import state_dict_from_jax
from segdistill_tpu_torch.distill.engine import convert_tap
from segdistill_tpu_torch.engine import (TrainState, build_lr_schedule,
                                         build_optimizer, build_train_step,
                                         save_checkpoint)
from segdistill_tpu_torch.models import build_segmentor
from segdistill_tpu_torch.models.segmentors import (draw_teacher_index,
                                                    parse_losses)
from segdistill_tpu_torch.recipes import (MT_RECIPES, mt_bf16_options,
                                         mt_recipe)

from test_torch_port_train import (LR_CONFIG, OPTIMIZER, key_bias_mask,
                                   trajectory_optimizer)
from torch_port_fixtures import (ATOL, NUM_CLASSES, RTOL, nhwc_to_nchw,
                                 random_jax_variables, segformer_cfg)
from torch_port_zoo_models import XLA_OPTIONS, one_thread  # noqa: F401

CGD = dict(student_layer='decode_head.linear_pred',
           teacher_layer='decode_head.linear_pred', loss_name='CGDLoss',
           loss_config={})
ADAPTED = dict(CGD, channel_nums=[NUM_CLASSES, NUM_CLASSES])
MODES = {'aligned': [dict(CGD), dict(ADAPTED)], 'random': [dict(ADAPTED)]}
KEYS = {'aligned': ['loss_decode_head.linear_pred<->'
                    'decode_head.linear_pred0_0',
                    'loss_decode_head.linear_pred<->'
                    'decode_head.linear_pred1_1'],
        'random': ['loss_random']}
LOSS_RTOL = 2e-5  # the loss terms, relative
FIRST_STEP = 1000  # draws a channel permutation (interval 1000)
MAX_ITERS = 2000
N_TEACHERS = 2


def tiny_segformer():
    """A SegFormer of MiT-b0's widths at one block a stage (the three
    models' JAX jits are most of this file's time)."""
    cfg = segformer_cfg(dropout_ratio=0.0)
    cfg['backbone'] = dict(
        type='MixVisionTransformer', embed_dims=(32, 64, 160, 256),
        num_heads=(1, 2, 5, 8), mlp_ratios=(4, 4, 4, 4), qkv_bias=True,
        depths=(1, 1, 1, 1), sr_ratios=(8, 4, 2, 1), drop_path_rate=0.0,
        gelu_approximate=True, fused_attention=False)
    return cfg


def mt_cfg(mode):
    return dict(type='SDModuleMT', cfg_s=tiny_segformer(),
                cfg_t=[tiny_segformer() for _ in range(N_TEACHERS)],
                distillation=copy.deepcopy(MODES[mode]), train_cfg={},
                test_cfg=dict(mode='whole'))


def _jax_draws(model, step, key):
    """The JAX step's channel permutation and (random ensemble) teacher
    index, from its ``shuffle_rng``."""
    losses = model.per_teacher_losses if model.random_ensemble \
        else [model.distillation_loss]
    crit = losses[0].entries[0]['criterion']
    perm = np.asarray(crit._shuffle_idx(NUM_CLASSES, step, key))
    index = int(jax.random.randint(jax.random.fold_in(key, step), (), 0,
                                   N_TEACHERS))
    return perm, index


def _jax_case(mode):
    """The JAX model's variables and its 3 steps from FIRST_STEP: per step
    the log vars, the student gradients, the permutation and teacher index
    it drew, and the student's params and BN statistics after it (one jit
    of the gradient and the AdamW update)."""
    model = build_jax_segmentor(mt_cfg(mode))
    sv = random_jax_variables(model.student, seed=0)
    sv['params']['distill_adapters'] = jax.tree.map(
        np.asarray, _init_adapters(model.distillation, jax.random.key(4)))
    tvs = [random_jax_variables(t, seed=1 + i)
           for i, t in enumerate(model.teachers)]
    rng = np.random.RandomState(0)
    img = rng.randn(2, 64, 64, 3).astype(np.float32)
    gt = rng.randint(0, NUM_CLASSES, (2, 64, 64)).astype(np.int32)
    gt[0, :4] = 255
    schedule = jax_lr_schedule(LR_CONFIG, OPTIMIZER['lr'], MAX_ITERS)
    tx = jax_build_optimizer(trajectory_optimizer('jax'), sv['params'],
                             schedule)

    def step_fn(params, bstats, opt_state, step, key):
        def f(p):
            losses, new_ms = model.forward_train(
                {'params': p, 'batch_stats': bstats}, tvs, jnp.asarray(img),
                jnp.asarray(gt), step, rngs={'dropout': key},
                shuffle_rng=key)
            total, log_vars = jax_parse(losses)
            return total, (log_vars, new_ms['batch_stats'])
        grads, (log_vars, bstats) = jax.grad(f, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return (grads, log_vars, optax.apply_updates(params, updates),
                bstats, opt_state)

    params, bstats = sv['params'], sv['batch_stats']
    opt_state = tx.init(params)
    jitted = jax.jit(step_fn).lower(
        params, bstats, opt_state, jnp.int32(FIRST_STEP),
        jax.random.key(5)).compile(compiler_options=XLA_OPTIONS)
    steps = []
    for i in range(3):
        step, key = FIRST_STEP + i, jax.random.key(5 + i)
        perm, index = _jax_draws(model, step, key)
        grads, log_vars, params, bstats, opt_state = jitted(
            params, bstats, opt_state, jnp.int32(step), key)
        steps.append(dict(
            log_vars={k: float(v) for k, v in log_vars.items()},
            grads=jax.tree.map(np.asarray, grads), perm=perm, index=index,
            variables=jax.tree.map(np.asarray, {'params': params,
                                                'batch_stats': bstats})))
    return dict(mode=mode, model=model, sv=sv, tvs=tvs, img=img, gt=gt,
                steps=steps)


@pytest.fixture(scope='module', params=sorted(MODES))
def case(request):
    return _jax_case(request.param)


def _port(case):
    model = build_segmentor(mt_cfg(case['mode']))
    model.load_state_dict(state_dict_from_jax(
        {'student': case['sv'], 'teachers': case['tvs']}), strict=True)
    return model.train()


def _batch(case):
    return (torch.from_numpy(nhwc_to_nchw(case['img']).copy()),
            torch.from_numpy(case['gt'].astype(np.int64)))


def _draws(ref):
    return dict(perm=torch.from_numpy(ref['perm'].copy()),
                teacher_index=ref['index'])


def _close_loss(got, want, what, rtol):
    """A loss term within ``rtol``; an accuracy within one pixel (an
    argmax near-tie may flip)."""
    if '.acc_' in what:
        assert abs(got - want) <= 100.0 / (2 * 64 * 64) * 1.001, what
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0,
                                   err_msg=what)


def test_loss_dict_matches_jax(case):
    ref = case['steps'][0]
    model = _port(case)
    img, gt = _batch(case)
    _, got = parse_losses(model.forward_train(img, gt, FIRST_STEP,
                                              **_draws(ref)))
    want = ref['log_vars']
    assert set(got) == set(want)
    assert set(KEYS[case['mode']]) <= set(got)
    for k in want:
        _close_loss(got[k].item(), want[k], k, LOSS_RTOL)


def test_student_gradients_match_jax(case):
    ref = case['steps'][0]
    model = _port(case)
    img, gt = _batch(case)
    total, _ = parse_losses(model.forward_train(img, gt, FIRST_STEP,
                                                **_draws(ref)))
    total.backward()
    grads = dict(ref['grads'])
    adapters = grads.pop('distill_adapters')
    want = state_dict_from_jax({'params': grads})
    want.update({f'distill_adapters.{k}': v for k, v in state_dict_from_jax(
        {'params': adapters}).items()})
    got = {n: p.grad for n, p in model.student.named_parameters()}
    got.update({f'distill_adapters.{n}': p.grad
                for n, p in model.distill_adapters.named_parameters()})
    assert got.keys() == want.keys()
    # atol relative to the largest gradient (the embedding biases' true
    # gradient is 0: float noise on both sides, test_torch_port_train.py)
    scale = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        assert got[name] is not None, name
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=RTOL,
                                   atol=ATOL * scale, err_msg=name)
    assert all(p.grad is None for p in model.teachers.parameters())


def test_three_step_trajectory_matches_jax(case):
    """Losses, parameters, adapters and BN statistics after each of three
    AdamW steps (noise-only parameters frozen and masked as in the CGD
    trajectory test; BN's running variance held to torch's unbiased
    update). Adam's first step moves an element by ~lr * g / |g| whatever
    |g| is, so an element whose first gradient is float noise (below 1e-6
    of the largest) is held to that bound instead, as the PD trajectory
    test does (0.1% of the elements at most)."""
    grads = dict(case['steps'][0]['grads'])
    grads.pop('distill_adapters')
    grads = state_dict_from_jax({'params': grads})
    g_scale = max(float(g.abs().max()) for g in grads.values())
    tiny = {n: g.abs() <= 1e-6 * g_scale for n, g in grads.items()}
    assert sum(int(t.sum()) for t in tiny.values()) \
        <= 1e-3 * sum(t.numel() for t in tiny.values())
    lr_mult = max(v.get('lr_mult', 1.0) for v in
                  OPTIMIZER['paramwise_cfg']['custom_keys'].values())
    model = _port(case)
    teachers_before = copy.deepcopy(model.teachers.state_dict())
    optimizer = build_optimizer(trajectory_optimizer('port'), model)
    schedule = build_lr_schedule(LR_CONFIG, OPTIMIZER['lr'], MAX_ITERS)
    # the schedule's first three updates (its warmup, as on the JAX side)
    # at loss steps 1000-1002: Adam turns gradient noise into steps of ~lr,
    # which the warmup's learning rate keeps inside the tolerance
    step_fn = build_train_step(model, optimizer,
                               lambda n: schedule(n - FIRST_STEP + 1))
    state = TrainState(model=model, optimizer=optimizer, seed=0,
                       step=FIRST_STEP - 1)
    img, gt = _batch(case)
    n_bn = 2 * 16 * 16  # the head BN's batch: 2 maps at stride 4 of 64x64
    prev_t = {k: v.clone() for k, v in model.student.state_dict().items()}
    prev_j = state_dict_from_jax({'params': case['sv']['params'],
                                  'batch_stats': case['sv']['batch_stats']})
    noise_bound = 0.0
    for i, ref in enumerate(case['steps']):
        log_vars = step_fn(state, img, gt, **_draws(ref))
        noise_bound += 2 * lr_mult * schedule(i)
        assert state.step == FIRST_STEP + i
        for k, v in ref['log_vars'].items():
            _close_loss(float(log_vars[k]), v, f'step {i} {k}', RTOL)
        params = dict(ref['variables']['params'])
        adapters = params.pop('distill_adapters')
        want = state_dict_from_jax({'params': params, 'batch_stats': ref[
            'variables']['batch_stats']})
        got = model.student.state_dict()
        for name, w in want.items():
            if name.endswith('running_var'):
                # torch: 0.9 rv + 0.1 * unbiased; flax: 0.9 rv + 0.1 biased
                np.testing.assert_allclose(
                    got[name] - 0.9 * prev_t[name],
                    (w - 0.9 * prev_j[name]) * n_bn / (n_bn - 1), rtol=RTOL,
                    atol=ATOL, err_msg=f'step {i} {name}')
            elif not name.endswith('num_batches_tracked'):
                noise = key_bias_mask(name, w)
                if name in tiny:  # a parameter, not a BN statistic
                    noise |= tiny[name]
                assert bool(((got[name] - w)[noise].abs()
                             <= noise_bound).all()), name
                np.testing.assert_allclose(got[name][~noise], w[~noise],
                                           rtol=RTOL, atol=ATOL,
                                           err_msg=f'step {i} {name}')
        for name, w in state_dict_from_jax({'params': adapters}).items():
            np.testing.assert_allclose(
                model.distill_adapters.state_dict()[name], w, rtol=RTOL,
                atol=ATOL, err_msg=f'step {i} adapter {name}')
        prev_t = {k: v.clone() for k, v in got.items()}
        prev_j = want
    for name, value in model.teachers.state_dict().items():
        assert torch.equal(value, teachers_before[name]), name


def test_teachers_stay_frozen_and_out_of_the_optimizer(case, tmp_path):
    model = _port(case)
    assert not any(p.requires_grad for p in model.teachers.parameters())
    assert model.train().student.training
    assert not any(t.training for t in model.teachers)
    optimizer = build_optimizer(trajectory_optimizer('port'), model)
    in_opt = {id(p) for g in optimizer.param_groups for p in g['params']}
    assert in_opt == {id(p) for p in model.student.parameters()} | {
        id(p) for p in model.distill_adapters.parameters()}
    state = TrainState(model=model, optimizer=optimizer, seed=0, step=3)
    save_checkpoint(str(tmp_path), state)
    saved = torch.load(tmp_path / 'checkpoints' / 'iter_3.pth',
                       weights_only=False)
    assert saved['state_dict'].keys() == model.student.state_dict().keys()
    assert saved['adapters'].keys() == \
        model.distill_adapters.state_dict().keys()


def test_from_jax_carries_each_teacher(case):
    model = _port(case)
    for i, tv in enumerate(case['tvs']):
        want = state_dict_from_jax(tv)
        got = model.teachers[i].state_dict()
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert torch.equal(got[k], w), (i, k)


def test_adapters_apply_per_entry(case):
    """``adapter_{i}`` for the entries with ``channel_nums``: the aligned
    path's second entry alone, the random ensemble's single entry against
    either teacher; moving an adapter moves its entry's loss only."""
    model = _port(case)
    assert sorted(model.distill_adapters) == (
        ['adapter_1'] if case['mode'] == 'aligned' else ['adapter_0'])
    img, gt = _batch(case)
    draws = _draws(case['steps'][0])
    with torch.no_grad():
        before = model.forward_train(img, gt, FIRST_STEP, **draws)
        for p in model.distill_adapters.parameters():
            p.mul_(1.5)
        after = model.forward_train(img, gt, FIRST_STEP, **draws)
    moved = {k for k in KEYS[case['mode']]
             if not torch.equal(before[k], after[k])}
    assert moved == {KEYS[case['mode']][-1]}


def _count_forwards(model):
    calls = [0] * len(model.teachers)
    for i, teacher in enumerate(model.teachers):
        teacher.backbone.register_forward_hook(
            lambda *_, i=i: calls.__setitem__(i, calls[i] + 1))
    return calls


def test_random_ensemble_runs_one_teacher_a_step():
    """Each random-ensemble step runs the forward of one teacher: the
    injected one, or the one :func:`draw_teacher_index` gives for the
    step's generator seed (host-side, no device sync); the aligned path
    runs every teacher."""
    for mode in sorted(MODES):
        model = build_segmentor(mt_cfg(mode)).train()
        model.init_weights(torch.Generator().manual_seed(0))
        calls = _count_forwards(model)
        img = torch.randn(2, 3, 64, 64)
        gt = torch.randint(0, NUM_CLASSES, (2, 64, 64))
        seen = set()
        for step in range(1, 7):
            before = list(calls)
            gen = torch.Generator().manual_seed(1000 + step)
            with torch.no_grad():
                model.forward_train(img, gt, step, generator=gen)
            ran = [c - b for c, b in zip(calls, before)]
            if mode == 'aligned':
                assert ran == [1, 1]
            else:
                index = draw_teacher_index(1000 + step, N_TEACHERS)
                assert ran == [int(i == index) for i in range(N_TEACHERS)]
                seen.add(index)
        assert mode == 'aligned' or seen == {0, 1}
        if mode == 'random':
            with pytest.raises(ValueError, match='generator'):
                model.forward_train(img, gt, 1)
            before = list(calls)
            with torch.no_grad():
                model.forward_train(img, gt, 1, teacher_index=1)
            assert [c - b for c, b in zip(calls, before)] == [0, 1]


def test_each_teacher_loads_its_own_checkpoint(tmp_path):
    """``t_pretrain`` is a list: teacher i loads file i leniently (a key
    of another model is skipped), None leaves a teacher as it is, and a
    missing file raises; the student is not touched."""
    model = build_segmentor(mt_cfg('aligned'))
    model.init_weights(torch.Generator().manual_seed(0))
    before = copy.deepcopy(model.state_dict())
    other = build_segmentor(tiny_segformer())
    other.init_weights(torch.Generator().manual_seed(1))
    ckpt = dict(other.state_dict(), **{'extra.weight': torch.zeros(1)})
    torch.save({'state_dict': ckpt}, tmp_path / 't0.pth')
    model.t_pretrain = [str(tmp_path / 't0.pth'), None]
    _load_pretrained(model)
    for k, v in model.state_dict().items():
        if k.startswith('teachers.0.'):
            assert torch.equal(v, other.state_dict()[k[len('teachers.0.'):]])
        else:
            assert torch.equal(v, before[k]), k
    model.t_pretrain = [None, str(tmp_path / 'missing.pth')]
    with pytest.raises(FileNotFoundError, match='t_pretrain\\[1\\]'):
        _load_pretrained(model)


@pytest.mark.parametrize('name', sorted(MT_RECIPES))
def test_mt_recipes(name):
    """B0 <- [B2, B3] on ``configs/exp_tab5/segformer_CGD.py``'s recipe:
    the CGD entries (one a teacher aligned, one for the random ensemble),
    AdamW, poly warmup, every checkpoint path cleared, bf16 backbones
    through ``mt_bf16_options``; the config serves its student."""
    cfg = mt_recipe(name)
    assert 'dtype' not in cfg.model['cfg_s']['backbone']
    cfg.merge_from_dict(mt_bf16_options(cfg))
    m = cfg.model
    assert m['type'] == 'SDModuleMT'
    assert [t['backbone']['type'] for t in m['cfg_t']] == ['mit_b2',
                                                           'mit_b3']
    assert [t['decode_head']['decoder_params']['embed_dim']
            for t in m['cfg_t']] == [768, 768]
    assert m['cfg_s']['backbone']['type'] == 'mit_b0'
    assert {t['backbone']['dtype'] for t in m['cfg_t'] + [m['cfg_s']]} == \
        {'bfloat16'}
    assert len(m['distillation']) == MT_RECIPES[name]
    assert all(d['loss_name'] == 'CGDLoss' and d['student_layer'] ==
               'decode_head.linear_pred' for d in m['distillation'])
    assert m['t_pretrain'] is None and m.get('s_pretrain') is None
    assert 'pretrained' not in m['cfg_s']
    assert cfg.optimizer['type'] == 'AdamW'
    assert cfg.lr_config['warmup'] == 'linear'
    served = student_config(cfg)
    assert served.model['type'] == 'EncoderDecoder'
    assert served.model['backbone']['type'] == 'mit_b0'
    model = build_segmentor(dict(m))
    assert model.random_ensemble == (name == 'mt_cgd_random')
    assert [type(t.backbone).__name__ for t in model.teachers] == \
        ['MixVisionTransformer'] * 2


def test_jax_train_segmentor_cannot_take_an_mt_model():
    """Known fault on the reference side: the JAX ``init_segmentor_state``
    unpacks only an SDModule's ``'teacher'``, so an SDModuleMT's
    ``{'student', 'teachers'}`` comes back whole as the "student"
    variables, with no ``'params'`` for ``build_optimizer``
    (``segdistill_tpu/apis/train.py:82,130``), and no teacher's
    ``t_pretrain`` is loaded. The port trains it (above)."""
    model = build_jax_segmentor(mt_cfg('aligned'))
    model.t_pretrain = ['/nonexistent/t0.pth', '/nonexistent/t1.pth']
    fake = {'student': {'params': {}}, 'teachers': [{}, {}]}
    model.init_variables = lambda rng, shape: fake
    student_vars, teacher_vars = jax_train_api.init_segmentor_state(
        model, None, jax.random.key(0), (1, 64, 64, 3))
    assert teacher_vars == {} and student_vars is fake
    with pytest.raises(KeyError):
        student_vars['params']


def test_jax_convert_tap_reads_the_teacher_suffix():
    """Known fault on the reference side: the JAX ``convert_tap`` decides
    from the last part of a tap's name whether a 4-D tap is NHWC, so a
    teacher's attention tap with the index appended (``...attn.ATTN0``)
    is transposed where the student's ``...attn.ATTN`` is not. The port's
    taps are NCHW already: its ``convert_tap`` is the identity."""
    x = np.zeros((2, 1, 16, 4), np.float32)  # (B, heads, N, M)
    assert jax_engine.convert_tap('backbone.block1.0.attn.ATTN', x).shape \
        == (2, 1, 16, 4)
    assert jax_engine.convert_tap('backbone.block1.0.attn.ATTN0', x).shape \
        == (2, 4, 1, 16)
    t = torch.zeros(2, 1, 16, 4)
    assert convert_tap('backbone.block1.0.attn.ATTN0', t) is t
