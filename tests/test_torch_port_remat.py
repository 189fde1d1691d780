"""MiT's per-block recompute in the port (``with_cp``: each block under
``torch.utils.checkpoint``, the JAX package's ``nn.remat(Block)``), on the
CPU.

A CGD SDModule of two small SegFormers (MiT-b0 widths at depths (2, 1, 1,
1), head embed 64, 19 classes) on 32x32 images at batch 2:

* against the same step without the flag, at dropout and drop-path 0.1
  (the masks drawn from the step's generator, which the recompute must
  replay): the loss terms, the student's gradients and a 3-step AdamW
  trajectory bitwise, with the student's attention through the SRA
  kernels' plain versions (``fused_attention='train'``), with distillation
  taps inside blocks (``attn.Q``, ``FEA``) and with ``log_grad`` (two
  ``autograd.grad`` passes through the recomputed blocks); each block runs
  again in each backward, and the generator ends where it ends without
  the flag;
* against the JAX package with ``with_cp=True`` on the same weights, at
  dropout 0 (JAX's PRNG cannot be reproduced) with the JAX permutation
  injected, at ``test_torch_port_train.py``'s limits: the loss dict and
  the student's gradients at step 1000, a 3-step AdamW trajectory;
* eval and ``no_grad`` forwards unchanged and never recomputed; the same
  state-dict keys either way (the JAX variables of either form load into
  either); a k = 3 chunk equal to its single steps; the full-width CGD and
  PD configs through ``prepare_training`` and the command line with
  ``model.cfg_s.backbone.with_cp=True``, equal to the same runs without it.
"""

import contextlib
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segdistill_tpu.engine import build_lr_schedule as jax_lr_schedule
from segdistill_tpu.engine import build_optimizer as jax_build_optimizer
from segdistill_tpu.engine import build_train_step as jax_train_step
from segdistill_tpu.engine import create_train_state
from segdistill_tpu.models import build_segmentor as build_jax_segmentor
from segdistill_tpu.models.segmentors import parse_losses as jax_parse
from segdistill_tpu_torch.apis import init_segmentor_state, prepare_training
from segdistill_tpu_torch.convert import state_dict_from_jax
from segdistill_tpu_torch.engine import (TrainState, build_lr_schedule,
                                         build_multi_train_step,
                                         build_optimizer, build_train_step)
from segdistill_tpu_torch.models import build_segmentor
from segdistill_tpu_torch.models.builder import build_backbone
from segdistill_tpu_torch.models.backbones import mix_transformer
from segdistill_tpu_torch.models.backbones.mix_transformer import Block
from segdistill_tpu_torch.models.segmentors import parse_losses
from segdistill_tpu_torch.models.utils import recompute
from segdistill_tpu_torch.tools import train as train_cli

from test_torch_port_cli import CONFIG as CLI_CONFIG
from test_torch_port_cli import DATA, _json_log
from test_torch_port_train import (CGD, LR_CONFIG, MAX_ITERS, OPTIMIZER,
                                   _jax_perm, key_bias_mask,
                                   trajectory_optimizer)
from torch_port_fixtures import (ATOL, NUM_CLASSES, RTOL,
                                 random_jax_variables, segformer_cfg)

DEPTHS = (2, 1, 1, 1)
HW = 32
STEPS = 3
DROP = 0.1
AT = dict(loss_name='ATLoss', loss_config={})
# distillation entries of each variant of the bitwise check
VARIANTS = {
    'cgd': [CGD],
    'fused attention': [CGD],
    'taps inside blocks': [
        CGD, dict(AT, student_layer='backbone.block1.0.attn.Q',
                  teacher_layer='backbone.block1.0.attn.Q'),
        dict(AT, student_layer='backbone.block1.1.FEA',
             teacher_layer='backbone.block1.1.FEA')],
    'log_grad': [dict(CGD, log_grad=True)]}
# each block's runs in a step: the forward, then one recompute a backward
# pass (log_grad: two autograd.grad passes before the step's backward)
RUNS = {'cgd': 2, 'fused attention': 2, 'taps inside blocks': 2,
        'log_grad': 4}


def tiny_segformer(with_cp=False, drop=0.0, fused_attention=False):
    cfg = segformer_cfg(dropout_ratio=drop)
    cfg['backbone'] = dict(
        type='MixVisionTransformer', embed_dims=(32, 64, 160, 256),
        num_heads=(1, 2, 5, 8), mlp_ratios=(4, 4, 4, 4), qkv_bias=True,
        depths=DEPTHS, sr_ratios=(8, 4, 2, 1), drop_rate=drop,
        drop_path_rate=drop, gelu_approximate=True,
        fused_attention=fused_attention, with_cp=with_cp)
    return cfg


def sd_cfg(with_cp, drop=0.0, distillation=(CGD,), fused_attention=False,
           teacher_cp=False):
    return dict(type='SDModule',
                cfg_s=tiny_segformer(with_cp, drop, fused_attention),
                cfg_t=tiny_segformer(teacher_cp), train_cfg={},
                distillation=[dict(d) for d in distillation],
                test_cfg=dict(mode='whole'))


def _batch(seed=0, k=None, hw=HW):
    rng = np.random.RandomState(seed)
    lead = (2,) if k is None else (k, 2)
    img = rng.randn(*lead, hw, hw, 3).astype(np.float32)
    gt = rng.randint(0, NUM_CLASSES, lead + (hw, hw)).astype(np.int64)
    gt[..., 0, :4] = 255
    return img, gt


def _port_batch(img, gt):
    return (torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(img, -1, -3))), torch.from_numpy(gt))


@contextlib.contextmanager
def _block_runs():
    """Yields a list whose length is the number of ``Block.forward`` calls
    made within the block."""
    runs, forward = [], Block.forward

    def counted(blk, *args, **kwargs):
        runs.append(1)
        return forward(blk, *args, **kwargs)
    Block.forward = counted
    try:
        yield runs
    finally:
        Block.forward = forward


def _optimizer(model):
    schedule = build_lr_schedule(LR_CONFIG, OPTIMIZER['lr'], MAX_ITERS)
    return build_optimizer(copy.deepcopy(OPTIMIZER), model), schedule


@functools.lru_cache(maxsize=None)
def _weights():
    model = build_segmentor(sd_cfg(False, DROP))
    model.init_weights(torch.Generator().manual_seed(0))
    return {k: v.clone() for k, v in model.state_dict().items()}


def _model(with_cp, variant='cgd', **kwargs):
    fused = 'train' if variant == 'fused attention' else False
    model = build_segmentor(sd_cfg(with_cp, DROP, VARIANTS[variant],
                                   fused_attention=fused, **kwargs))
    model.load_state_dict(_weights(), strict=True)
    return model.train()


@functools.lru_cache(maxsize=None)
def _run(variant, with_cp):
    """STEPS steps of ``build_train_step`` from seed 0 at dropout and
    drop-path DROP: per step the log vars, the student's gradients and the
    blocks' runs; the state dict and the optimizer state at the end."""
    model = _model(with_cp, variant)
    optimizer, schedule = _optimizer(model)
    step_fn = build_train_step(model, optimizer, schedule)
    state = TrainState(model=model, optimizer=optimizer, seed=0)
    img, gt = _port_batch(*_batch())
    logs, grads, runs = [], [], []
    for _ in range(STEPS):
        with _block_runs() as blocks:
            logs.append({k: float(v) for k, v in
                         step_fn(state, img, gt).items()})
        runs.append(len(blocks))
        grads.append({n: p.grad.clone() for n, p in
                      model.student.named_parameters()})
    return dict(logs=logs, grads=grads, runs=runs,
                state_dict={k: v.clone()
                            for k, v in model.state_dict().items()},
                optimizer=copy.deepcopy(optimizer.state_dict()['state']))


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_losses_bitwise_without_recompute(variant):
    want, got = _run(variant, False), _run(variant, True)
    assert got['logs'] == want['logs']
    assert all(len(lv) > 3 for lv in got['logs'])


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_gradients_bitwise_without_recompute(variant):
    """Every step's student gradients; the student's blocks ran again in
    each backward pass, the teacher's once."""
    want, got = _run(variant, False), _run(variant, True)
    n_blocks = sum(DEPTHS)
    assert want['runs'] == [2 * n_blocks] * STEPS
    assert got['runs'] == [(RUNS[variant] + 1) * n_blocks] * STEPS
    for a, b in zip(got['grads'], want['grads']):
        assert a.keys() == b.keys()
        for name in b:
            assert (a[name] is None) == (b[name] is None), name
            if b[name] is not None:
                assert torch.equal(a[name], b[name]), name


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_trajectory_bitwise_without_recompute(variant):
    """The parameters, BN statistics and AdamW moments after 3 steps."""
    want, got = _run(variant, False), _run(variant, True)
    assert got['state_dict'].keys() == want['state_dict'].keys()
    for name, value in want['state_dict'].items():
        assert torch.equal(got['state_dict'][name], value), name
    for i, st in want['optimizer'].items():
        for key, value in st.items():
            assert torch.equal(got['optimizer'][i][key], value), (i, key)


def _forward_backward(model):
    """One loss and backward at step 1 with a generator of seed 3 ->
    (loss, the student's gradients, the generator's state after)."""
    img, gt = _port_batch(*_batch())
    generator = torch.Generator().manual_seed(3)
    total, _ = parse_losses(model.forward_train(img, gt, 1,
                                                generator=generator))
    total.backward()
    grads = {n: p.grad for n, p in model.student.named_parameters()}
    return float(total.detach()), grads, generator.get_state()


def test_generator_stream_is_the_same(monkeypatch):
    """The step's generator ends where it ends without the flag (the
    recompute draws nothing from it). The masks must be the forward's: a
    checkpoint that hands the block the generator itself (its
    ``preserve_rng_state`` saves only the default generators) draws new
    ones in the recompute and moves the gradients."""
    loss, grads, end = _forward_backward(_model(False))
    got = _forward_backward(_model(True))
    assert got[0] == loss and torch.equal(got[2], end)
    assert all(torch.equal(got[1][n], g) for n, g in grads.items())

    def redrawn(block, x, *args, generator=None):
        return torch.utils.checkpoint.checkpoint(
            block, x, *args, generator, use_reentrant=False)
    monkeypatch.setattr(mix_transformer, 'recomputed', redrawn)
    got = _forward_backward(_model(True))
    assert got[0] == loss
    assert any(not torch.equal(got[1][n], g) for n, g in grads.items())


# -- against the JAX package's nn.remat ---------------------------------------

@pytest.fixture(scope='module')
def jax_remat():
    """The JAX SDModule with ``with_cp=True`` (``nn.remat(Block)``) at
    dropout 0: seeded variables, the batch, the step-1000 loss dict and
    student gradients with their permutation (one jit), and three steps of
    its ``build_train_step`` (log vars, permutations, the student's
    variables after each)."""
    model = build_jax_segmentor(sd_cfg(True))
    assert model.student.net.backbone.with_cp
    sv = random_jax_variables(model.student, seed=0)
    tv = random_jax_variables(model.teacher, seed=1)
    img, gt = _batch()
    gt = gt.astype(np.int32)

    @jax.jit
    def loss_and_grad(params, bstats, tvars, img, gt, step, key):
        def f(p):
            losses, _ = model.forward_train(
                {'params': p, 'batch_stats': bstats}, tvars, img, gt, step,
                rngs={'dropout': key}, shuffle_rng=key)
            return jax_parse(losses)
        return jax.grad(f, has_aux=True)(params)

    key = jax.random.key(5)
    grads, log_vars = loss_and_grad(sv['params'], sv['batch_stats'], tv,
                                    jnp.asarray(img), jnp.asarray(gt),
                                    jnp.int32(1000), key)
    out = dict(sv=sv, tv=tv, img=img, gt=gt,
               log_vars={k: float(v) for k, v in log_vars.items()},
               grads=jax.tree.map(np.asarray, grads),
               perm=_jax_perm(model, 1000, key))
    schedule = jax_lr_schedule(LR_CONFIG, OPTIMIZER['lr'], MAX_ITERS)
    tx = jax_build_optimizer(trajectory_optimizer('jax'), sv['params'],
                             schedule)
    state = create_train_state(jax.random.key(1), sv, tx)
    step_fn = jax_train_step(model, tx, schedule, donate=False)
    out['steps'] = []
    for _ in range(STEPS):
        step = int(state.step) + 1
        shuffle_rng = jax.random.split(jax.random.fold_in(state.rng, step))[1]
        perm = _jax_perm(model, step, shuffle_rng)
        state, log_vars = step_fn(state, tv, jnp.asarray(img),
                                  jnp.asarray(gt))
        out['steps'].append(dict(
            log_vars={k: float(v) for k, v in log_vars.items()}, perm=perm,
            variables=jax.tree.map(np.asarray, {
                'params': state.params,
                'batch_stats': state.model_state['batch_stats']})))
    return out


def _port_from_jax(jax_remat, with_cp=True):
    model = build_segmentor(sd_cfg(with_cp))
    model.load_state_dict(state_dict_from_jax(
        {'student': jax_remat['sv'], 'teacher': jax_remat['tv']}),
        strict=True)
    return model.train()


def _close(got, want, what, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=atol, err_msg=what)


def test_loss_dict_matches_jax_remat(jax_remat):
    model = _port_from_jax(jax_remat)
    img, gt = _port_batch(jax_remat['img'], jax_remat['gt'].astype(np.int64))
    _, got = parse_losses(model.forward_train(
        img, gt, 1000, perm=torch.from_numpy(jax_remat['perm'].copy())))
    want = jax_remat['log_vars']
    assert set(got) == set(want)
    for k in want:
        _close(got[k].item(), want[k], k)


def test_student_gradients_match_jax_remat(jax_remat):
    model = _port_from_jax(jax_remat)
    img, gt = _port_batch(jax_remat['img'], jax_remat['gt'].astype(np.int64))
    with _block_runs() as runs:
        total, _ = parse_losses(model.forward_train(
            img, gt, 1000, perm=torch.from_numpy(jax_remat['perm'].copy())))
        total.backward()
    # the student's blocks twice (forward, recompute), the teacher's once
    assert len(runs) == 3 * sum(DEPTHS)
    want = state_dict_from_jax({'params': jax_remat['grads']})
    got = {n: p.grad for n, p in model.student.named_parameters()}
    assert got.keys() == want.keys()
    scale = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        _close(got[name].numpy(), g.numpy(), name, ATOL * scale)


def test_three_step_trajectory_matches_jax_remat(jax_remat):
    model = _port_from_jax(jax_remat)
    optimizer = build_optimizer(trajectory_optimizer('port'), model)
    schedule = build_lr_schedule(LR_CONFIG, OPTIMIZER['lr'], MAX_ITERS)
    step_fn = build_train_step(model, optimizer, schedule)
    state = TrainState(model=model, optimizer=optimizer, seed=0)
    img, gt = _port_batch(jax_remat['img'], jax_remat['gt'].astype(np.int64))
    n_bn = 2 * (HW // 4) ** 2  # the head BN's batch at stride 4
    prev_t = {k: v.clone() for k, v in model.student.state_dict().items()}
    prev_j = state_dict_from_jax({'params': jax_remat['sv']['params'],
                                  'batch_stats': jax_remat['sv'][
                                      'batch_stats']})
    noise_bound = 0.0
    for i, ref in enumerate(jax_remat['steps']):
        log_vars = step_fn(state, img, gt,
                           perm=torch.from_numpy(ref['perm'].copy()))
        noise_bound += 2 * 2 * schedule(i)
        for k, v in ref['log_vars'].items():
            _close(float(log_vars[k]), v, f'step {i + 1} {k}')
        want = state_dict_from_jax(ref['variables'])
        got = model.student.state_dict()
        for name, w in want.items():
            if name.endswith('running_var'):
                _close(got[name] - 0.9 * prev_t[name],
                       (w - 0.9 * prev_j[name]) * n_bn / (n_bn - 1),
                       f'step {i + 1} {name}')
            elif not name.endswith('num_batches_tracked'):
                noise = key_bias_mask(name, w)
                assert bool(((got[name] - w)[noise].abs()
                             <= noise_bound).all()), name
                _close(got[name][~noise], w[~noise], f'step {i + 1} {name}')
        prev_t = {k: v.clone() for k, v in got.items()}
        prev_j = want


def test_jax_variables_load_across_the_flag(jax_remat):
    """The JAX variables of either form have one layout (``nn.remat``
    keeps the block names), and load strictly into the port either way."""
    plain = build_jax_segmentor(sd_cfg(False))
    shapes = jax.tree.map(np.shape, random_jax_variables(plain.student))
    assert shapes == jax.tree.map(np.shape, jax_remat['sv'])
    for with_cp in (False, True):
        _port_from_jax(jax_remat, with_cp)


# -- the forwards that take no gradient, the state dict, the chunk ------------

def test_eval_and_no_grad_forwards_are_unchanged(monkeypatch):
    """Serving (eval mode), a train-mode forward under ``no_grad`` and the
    frozen teacher's forward (its backbone with the flag too) give the
    outputs of the model without the flag and run no checkpoint; a student
    forward that takes a gradient runs one a block."""
    calls, checkpoint = [], recompute.checkpoint

    def counted(*args, **kwargs):
        calls.append(1)
        return checkpoint(*args, **kwargs)
    monkeypatch.setattr(recompute, 'checkpoint', counted)
    img, gt = _port_batch(*_batch())
    outs = []
    for with_cp in (False, True):
        model = _model(with_cp, teacher_cp=with_cp)
        with torch.no_grad():
            feats = model.student.backbone(img, torch.Generator()
                                           .manual_seed(3))
            logits = model.eval().encode_decode(img)
        outs.append(list(feats) + [logits])
    assert calls == []
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    model.train().forward_train(img, gt, 1, generator=torch.Generator()
                                .manual_seed(3))
    assert model.teacher.backbone.with_cp
    assert len(calls) == sum(DEPTHS)


@pytest.mark.parametrize('variant', ['b0', 'b1', 'b2', 'b3', 'b4', 'b5'])
def test_mit_variants_take_the_flag(variant):
    backbone = build_backbone(dict(type=f'mit_{variant}', with_cp=True))
    assert backbone.with_cp and not build_backbone(
        dict(type=f'mit_{variant}')).with_cp


def test_state_dict_keys_are_the_same():
    a, b = (build_segmentor(sd_cfg(with_cp)) for with_cp in (False, True))
    assert list(a.state_dict()) == list(b.state_dict())
    assert b.student.backbone.with_cp and not a.student.backbone.with_cp
    b.load_state_dict(a.state_dict(), strict=True)
    a.load_state_dict(b.state_dict(), strict=True)


def test_chunk_equals_its_single_steps():
    """A k = 3 chunk of ``build_multi_train_step`` with the flag (on the
    CPU the eager step three times) against three single steps."""
    img, gt = _port_batch(*_batch(seed=1, k=STEPS))
    ends = []
    for chunk in (False, True):
        model = _model(True)
        optimizer, schedule = _optimizer(model)
        state = TrainState(model=model, optimizer=optimizer, seed=0)
        if chunk:
            log_vars = build_multi_train_step(model, optimizer, schedule,
                                              STEPS)(state, img, gt)
        else:
            step_fn = build_train_step(model, optimizer, schedule)
            for i in range(STEPS):
                log_vars = step_fn(state, img[i], gt[i])
        assert state.step == STEPS
        ends.append(({k: float(v) for k, v in log_vars.items()},
                     model.state_dict()))
    assert ends[0][0] == ends[1][0]
    for name, value in ends[0][1].items():
        assert torch.equal(ends[1][1][name], value), name


# -- the configs and the command line with the option -------------------------

TAB5 = {'CGD': ('configs/exp_tab5/segformer_CGD.py', {}),
        'PD': ('configs/exp_tab5/segformer_PD.py',
               {'model.cfg_s.backbone.fused_attention': 'train'})}


@pytest.mark.parametrize('name', sorted(TAB5))
def test_tab5_config_trains_with_the_option(name):
    """The full-width config (B0 student, B3 teacher) with
    ``model.cfg_s.backbone.with_cp=True`` through ``prepare_training`` at
    k = 1 and k = 2, 64x64: the loss terms of both equal the runs without
    the option bitwise."""
    path, options = TAB5[name]
    img, gt = _port_batch(*_batch(seed=2, k=2, hw=64))
    logs = {}
    for with_cp in (False, True):
        for k in (1, 2):
            model = init_segmentor_state(path, device='cpu', cfg_options=dict(
                options, **{'model.t_pretrain': None,
                            'model.cfg_s.pretrained': None,
                            'model.cfg_s.backbone.with_cp': with_cp,
                            'runner.steps_per_dispatch': k}))
            assert model.student.backbone.with_cp == with_cp
            state, step = prepare_training(model)
            if k == 1:
                for i in range(2):
                    log_vars = step(state, img[i], gt[i])
            else:
                log_vars = step(state, img, gt)
            logs[with_cp, k] = {n: float(v) for n, v in log_vars.items()}
    assert all(np.isfinite(v) for v in logs[True, 2].values())
    assert logs[True, 1] == logs[False, 1]
    assert logs[True, 2] == logs[False, 2] == logs[True, 1]


def test_command_line_trains_with_the_option(tmp_path):
    """``tools.train --options model.cfg_s.backbone.with_cp=True`` (k = 2,
    4 iterations) logs the losses of the run without it."""
    config = tmp_path / 'tiny_cgd.py'
    config.write_text(CLI_CONFIG.format(data_root=str(DATA)))
    logs = {}
    for with_cp in (False, True):
        work = tmp_path / f'with_cp_{with_cp}'
        state = train_cli.main([
            str(config), '--work-dir', str(work), '--seed', '7', '--device',
            'cpu', '--no-validate', '--options', 'runner.max_iters=4',
            'runner.steps_per_dispatch=2',
            f'model.cfg_s.backbone.with_cp={with_cp}'])
        assert state.step == 4
        assert state.model.student.backbone.with_cp == with_cp
        logs[with_cp] = _json_log(work)[0]
    assert sorted(logs[True]) == [2, 4]
    for it, line in logs[False].items():
        assert {k: v for k, v in logs[True][it].items() if 'time' not in k} \
            == {k: v for k, v in line.items() if 'time' not in k}, it
