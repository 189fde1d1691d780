"""The port's engine beyond the bare train step: checkpoints (save, resume,
warm start, the meta sidecar, the reference ``.pth`` layout read back by
the JAX package), the eval hook, the runner's hooks and the gradient-angle
diagnostic, on a small SDModule (MiT-b0 student and teacher, 19 classes,
head embed 64, 64x64 images) on the CPU.

Held against the JAX package: the logits of a port checkpoint loaded into
the JAX model by ``load_pth_into_variables`` (the fixtures' ``RTOL,
ATOL``), and ``deg``: against the angle between the JAX package's own two
partial gradients, taken with ``jax.grad`` and reduced in float64, to 0.01
degrees (the two sides' gradients agree to ~1e-4 relative, which moves the
cosine by as much), and against the ``deg`` that the jitted JAX train step
logs, to 0.25 degrees: on the CPU that step's float32 ``vdot`` sums come
out 0.3% below the float64 norms of the very same gradients (1.1946 against
1.1985 here), which moves its angle by 0.10 degrees. Everything about
resuming is held to an uninterrupted run of the port itself, bitwise: the
CPU step is deterministic.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segdistill_tpu.convert.torch_loader import load_pth_into_variables
from segdistill_tpu.engine import build_lr_schedule as jax_lr_schedule
from segdistill_tpu.engine import build_optimizer as jax_build_optimizer
from segdistill_tpu.engine import build_train_step as jax_train_step
from segdistill_tpu.engine import create_train_state
from segdistill_tpu.models import build_segmentor as build_jax_segmentor
from segdistill_tpu_torch.apis import load_checkpoint as load_pth
from segdistill_tpu_torch.apis import prepare_training
from segdistill_tpu_torch.config import Config
from segdistill_tpu_torch.convert import state_dict_from_jax
from segdistill_tpu_torch.core.evaluation import EvalHook
from segdistill_tpu_torch.engine import (IterBasedRunner, checkpoint_file,
                                         load_checkpoint, load_meta,
                                         load_weights, resume_latest,
                                         save_checkpoint)
from segdistill_tpu_torch.models import build_segmentor

from torch_port_fixtures import (ATOL, NUM_CLASSES, RTOL, nhwc_to_nchw,
                                 random_jax_variables, segformer_cfg)

CGD = dict(student_layer='decode_head.linear_pred',
           teacher_layer='decode_head.linear_pred', loss_name='CGDLoss',
           loss_config={})
CFG = Config(dict(
    optimizer=dict(type='AdamW', lr=1e-3, weight_decay=0.01,
                   paramwise_cfg=dict(custom_keys={
                       'norm': dict(decay_mult=0.),
                       'head': dict(lr_mult=10.)})),
    lr_config=dict(policy='poly', warmup='linear', warmup_iters=2,
                   warmup_ratio=0.1, power=1.0, min_lr=0.0),
    runner=dict(type='IterBasedRunner', max_iters=20)))


def _sd_cfg(**entry):
    return dict(type='SDModule', cfg_s=segformer_cfg(dropout_ratio=0.0),
                cfg_t=segformer_cfg(dropout_ratio=0.0),
                distillation=[dict(CGD, **entry)], train_cfg={},
                test_cfg=dict(mode='whole'))


def _model(student_seed=None):
    """The SDModule from seed 0 (a checkpoint holds no teacher: it comes
    from the config and the seed), with another student if asked."""
    model = build_segmentor(_sd_cfg())
    model.init_weights(torch.Generator().manual_seed(0))
    if student_seed is not None:
        model.student.init_weights(
            torch.Generator().manual_seed(student_seed))
    return model.train()


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [dict(img=rng.randn(2, 3, 64, 64).astype(np.float32),
                 gt_semantic_seg=rng.randint(0, NUM_CLASSES, (2, 64, 64)))
            for _ in range(n)]


def _steps(state, train_step, batches):
    return [{k: float(v) for k, v in train_step(
        state, torch.from_numpy(b['img']),
        torch.from_numpy(b['gt_semantic_seg'])).items()} for b in batches]


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """An uninterrupted run of six steps that saves after the third:
    (work dir, the six batches, the six log dicts, the final state)."""
    work = str(tmp_path_factory.mktemp('work'))
    batches = _batches(6)
    state, train_step = prepare_training(_model(), CFG, seed=3)
    logs = _steps(state, train_step, batches[:3])
    meta = dict(segdistill_tpu_torch_version='0', config='text',
                CLASSES=['a', 'b'], PALETTE=[[0, 0, 0], [1, 1, 1]])
    assert save_checkpoint(work, state, max_keep=2, meta=meta) == 3
    logs += _steps(state, train_step, batches[3:])
    return work, batches, logs, state


def test_resume_repeats_an_uninterrupted_run(run):
    """Step, seed, optimizer state and the next three steps' losses after a
    resume equal the uninterrupted run's, bitwise."""
    work, batches, logs, final = run
    state, train_step = prepare_training(_model(student_seed=9), CFG, seed=0)
    state, resumed = resume_latest(work, state, strict=True)
    assert resumed and state.step == 3 and state.seed == 3
    saved = torch.load(checkpoint_file(work), weights_only=True)
    assert saved['step'] == 3 and set(saved) == {
        'state_dict', 'adapters', 'optimizer', 'step', 'seed', 'meta'}
    opt = state.optimizer.state_dict()
    assert opt['param_groups'] == saved['optimizer']['param_groups']
    for idx, slot in saved['optimizer']['state'].items():
        for name, value in slot.items():
            assert torch.equal(opt['state'][idx][name], value), (idx, name)
    assert _steps(state, train_step, batches[3:]) == logs[3:]
    for (name, a), b in zip(state.model.student.state_dict().items(),
                            final.model.student.state_dict().values()):
        assert torch.equal(a, b), name


def test_load_weights_keeps_step_and_optimizer_fresh(run):
    work = run[0]
    state, _ = prepare_training(_model(student_seed=9), CFG, seed=5)
    load_weights(work, state)
    assert state.step == 0 and state.seed == 5
    assert not state.optimizer.state_dict()['state']
    saved = torch.load(checkpoint_file(work), weights_only=True)['state_dict']
    for name, value in state.model.student.state_dict().items():
        assert torch.equal(value, saved[name]), name


def test_resume_strictness(run, tmp_path):
    """Nothing to resume: the forgiving form starts from scratch, the
    strict one (an explicit --resume-from) raises; so does a corrupt
    file."""
    state, _ = prepare_training(_model(), CFG)
    assert resume_latest(str(tmp_path), state) == (state, False)
    with pytest.raises(FileNotFoundError, match='no checkpoint'):
        resume_latest(str(tmp_path), state, strict=True)
    with pytest.raises(FileNotFoundError):
        resume_latest(str(tmp_path / 'checkpoints' / 'iter_7.pth'), state,
                      strict=True)
    os.makedirs(tmp_path / 'checkpoints')
    (tmp_path / 'checkpoints' / 'iter_2.pth').write_bytes(b'not a checkpoint')
    assert resume_latest(str(tmp_path), state)[1] is False
    with pytest.raises(RuntimeError, match='failed to resume'):
        resume_latest(str(tmp_path), state, strict=True)
    assert state.step == 0


def test_paths_max_keep_and_meta(run, tmp_path):
    """A work dir, its checkpoints dir and one file all resolve; only the
    newest ``max_keep`` files stay; ``meta.json`` carries the JAX sidecar's
    keys and the last saved iteration."""
    work = run[0]
    ckpt_dir = os.path.join(work, 'checkpoints')
    file = os.path.join(ckpt_dir, 'iter_3.pth')
    assert checkpoint_file(work) == checkpoint_file(ckpt_dir) \
        == checkpoint_file(file) == file
    for path in (work, ckpt_dir, file):
        meta = load_meta(path)
        assert meta == dict(segdistill_tpu_torch_version='0', config='text',
                            CLASSES=['a', 'b'],
                            PALETTE=[[0, 0, 0], [1, 1, 1]], iter=3)
        state, _ = prepare_training(_model(student_seed=9), CFG)
        assert load_checkpoint(path, state).step == 3
    assert load_meta(str(tmp_path)) is None

    state, train_step = prepare_training(_model(), CFG)
    for n in range(1, 5):
        _steps(state, train_step, _batches(1))
        save_checkpoint(str(tmp_path), state, max_keep=2,
                        meta=dict(CLASSES=None))
        kept = sorted(os.listdir(tmp_path / 'checkpoints'))
        assert kept == sorted([f'iter_{i}.pth' for i in range(
            max(1, n - 1), n + 1)] + ['meta.json'])
    with open(tmp_path / 'checkpoints' / 'meta.json') as f:
        assert json.load(f) == dict(CLASSES=None, iter=4)
    assert load_checkpoint(str(tmp_path), state, step=3).step == 3


def test_checkpoint_loads_into_the_jax_model(run, tmp_path):
    """``state_dict`` is the reference layout: the port's own ``.pth``
    loader and the JAX package's ``load_pth_into_variables`` read the
    checkpoint file as it is, and the JAX model then gives the port's
    logits."""
    work, _, _, final = run
    state, _ = prepare_training(_model(student_seed=9), CFG)
    load_checkpoint(work, state)
    student = state.model.student.eval()
    fresh = build_segmentor(segformer_cfg(dropout_ratio=0.0))
    load_pth(fresh, checkpoint_file(work))
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        want = student(xt).numpy()
        assert np.array_equal(fresh.eval()(xt).numpy(), want)
    jax_model = build_jax_segmentor(segformer_cfg(dropout_ratio=0.0))
    variables = load_pth_into_variables(
        random_jax_variables(jax_model, seed=2), checkpoint_file(work),
        strict=True)
    got = jax_model.net.apply(variables, jnp.asarray(x), train=False,
                              with_aux=False)['decode']
    np.testing.assert_allclose(nhwc_to_nchw(got), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('start,steps,fired', [
    (0, [1, 2, 3, 4, 5, 6, 7, 8], [4, 8]),
    (6, [7, 8, 9], [8]),
    (4, [5, 6, 7], []),            # resumed exactly on a multiple
    (0, [3, 6, 9, 12], [6, 9, 12]),  # a stride of three: crossings, not ==
    (3, [5], [5]),
], ids=['from-0', 'resumed', 'on-a-multiple', 'strided', 'first-call'])
def test_eval_hook_fires_on_interval_crossings(start, steps, fired):
    class State:
        step = 0
    calls = []
    hook = EvalHook(lambda st: calls.append(st.step) or {'mIoU': st.step},
                    interval=4, start_iter=start)
    for s in steps:
        State.step = s
        out = hook.after_train_iter(State)
        assert (out == {'mIoU': s}) == (s in fired)
    assert calls == fired and (hook.latest_results is None) == (not fired)
    with pytest.raises(NotImplementedError):
        EvalHook(lambda st: None, by_epoch=True)


def test_runner_checkpoints_evaluates_and_logs(tmp_path, caplog):
    """The runner over in-memory batches with a work dir: checkpoints at
    the interval and at the end (``max_keep_ckpts``), the hook after every
    step, ``data_time`` in the log line, one JSON object per log line and
    evaluation."""
    state, train_step = prepare_training(_model(), CFG)
    seen = []
    hook = EvalHook(lambda st: seen.append(st.step) or {'mIoU': 0.5},
                    interval=2)
    log = str(tmp_path / 'run.log.json')
    runner = IterBasedRunner(train_step, state, 5, log_interval=2,
                             work_dir=str(tmp_path), checkpoint_interval=2,
                             max_keep_ckpts=2, eval_hook=hook,
                             meta=dict(CLASSES=['x']), json_log=log)
    with caplog.at_level('INFO'):
        assert runner.run(_batches(5)) is state and state.step == 5
    assert seen == [2, 4]
    assert sorted(os.listdir(tmp_path / 'checkpoints')) == [
        'iter_4.pth', 'iter_5.pth', 'meta.json']
    assert load_meta(str(tmp_path)) == dict(CLASSES=['x'], iter=5)
    lines = [r.getMessage() for r in caplog.records]
    iters = [ln for ln in lines if ln.startswith('Iter [')]
    assert [ln.split(']')[0] for ln in iters] == ['Iter [2/5', 'Iter [4/5']
    assert all('data_time: ' in ln and 'decode.loss_seg: ' in ln
               for ln in iters)
    assert sum('Saved checkpoint' in ln for ln in lines) == 2
    assert sum(ln.startswith('Eval at iter') for ln in lines) == 2
    with open(log) as f:
        records = [json.loads(line) for line in f]
    assert [(r['mode'], r['iter']) for r in records] == [
        ('train', 2), ('val', 2), ('train', 4), ('val', 4)]
    assert records[1]['mIoU'] == 0.5 and records[1]['seconds'] >= 0
    assert {'loss', 'lr', 'time', 'data_time'} <= set(records[0])


def test_grad_angle_matches_jax_step():
    """``deg`` of the port's train step against the JAX train step with
    ``log_grad`` on the same weights and batch, the JAX permutation
    injected."""
    jax_model = build_jax_segmentor(_sd_cfg(log_grad=True))
    assert jax_model.log_grad
    sv = random_jax_variables(jax_model.student, seed=0)
    tv = random_jax_variables(jax_model.teacher, seed=1)
    rng = np.random.RandomState(0)
    img = rng.randn(1, 64, 64, 3).astype(np.float32)
    gt = rng.randint(0, NUM_CLASSES, (1, 64, 64)).astype(np.int32)
    opt = dict(type='AdamW', lr=1e-3, weight_decay=0.0)
    schedule = jax_lr_schedule(dict(policy='poly', power=1.0), 1e-3, 100)
    tx = jax_build_optimizer(opt, sv['params'], schedule)
    jstate = create_train_state(jax.random.key(1), sv, tx)
    shuffle_rng = jax.random.split(jax.random.fold_in(jstate.rng, 1))[1]
    crit = jax_model.distillation_loss.entries[0]['criterion']
    perm = np.asarray(crit._shuffle_idx(NUM_CLASSES, 1, shuffle_rng))
    _, want = jax_train_step(jax_model, tx, schedule, donate=False)(
        jstate, tv, jnp.asarray(img), jnp.asarray(gt))

    def partial_grad(selector):
        def f(params):
            losses, _ = jax_model.forward_train(
                {'params': params, 'batch_stats': sv['batch_stats']}, tv,
                jnp.asarray(img), jnp.asarray(gt), 1,
                rngs={'dropout': shuffle_rng}, shuffle_rng=shuffle_rng)
            return sum(jnp.mean(v) for k, v in losses.items() if selector(k))
        return [np.asarray(g, np.float64) for g in jax.tree.leaves(
            jax.jit(jax.grad(f))(sv['params']))]
    g_seg = partial_grad(lambda k: 'loss_seg' in k)
    g_dist = partial_grad(lambda k: 'loss' in k and 'loss_seg' not in k
                          and 'acc' not in k)
    cos = sum((a * b).sum() for a, b in zip(g_seg, g_dist)) / np.sqrt(
        sum((a * a).sum() for a in g_seg)
        * sum((b * b).sum() for b in g_dist))
    exact = np.arccos(cos) * 180.0 / 3.1416

    model = build_segmentor(_sd_cfg(log_grad=True))
    assert model.log_grad
    model.load_state_dict(state_dict_from_jax({'student': sv,
                                               'teacher': tv}), strict=True)
    cfg = Config(dict(optimizer=opt, runner=dict(max_iters=100),
                      lr_config=dict(policy='poly', power=1.0, min_lr=0.0)))
    state, train_step = prepare_training(model.train(), cfg)
    got = train_step(state, torch.from_numpy(nhwc_to_nchw(img).copy()),
                     torch.from_numpy(gt.astype(np.int64)),
                     perm=torch.from_numpy(perm.astype(np.int64)))
    assert 0.0 < float(want['deg']) < 180.0
    assert float(got['deg']) == pytest.approx(exact, abs=0.01)
    assert float(got['deg']) == pytest.approx(float(want['deg']), abs=0.25)
    assert float(got['loss']) == pytest.approx(float(want['loss']), rel=RTOL)
    # without the key the step logs no angle
    plain = build_segmentor(_sd_cfg()).train()
    plain.init_weights(torch.Generator().manual_seed(0))
    state, train_step = prepare_training(plain, cfg)
    assert 'deg' not in _steps(state, train_step, _batches(1))[0]
