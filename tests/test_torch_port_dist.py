"""Data parallelism of the PyTorch port across processes, on the CPU: two
gloo ranks against one process and against the JAX package's step on the
global batch (its mesh step equals that step, ``tests/test_engine.py``).

One module fixture starts the two ranks once (``parallel.Workers``, 300 s
limit, every rank killed when one fails) and they run every multi-rank
case of ``torch_port_dist_worker.py`` while this process computes the JAX
references; the tests compare what the ranks wrote.

* The tiny MiT SDModule CGD step of ``test_torch_port_train.py`` (SyncBN
  in the head, ``log_grad`` on, so the gradient angle's two
  ``autograd.grad`` passes run before the real backward), 2 images a
  rank, 2 AdamW steps with the JAX permutations injected, fp32: the loss
  terms, the student's parameters and the head's running statistics (the
  unbiased factor of the global count) at the fixtures' ``RTOL, ATOL``.
* A narrow ResNetV1c-50-d8 (``torch_port_fixtures.resnet_v1c``, SyncBN in
  every layer) with an EMAHead and the FCN auxiliary head, 2 images a
  rank, 3 SGD steps in float64 on both sides (train-mode BN over a few
  values a channel magnifies fp32 rounding, ``torch_port_extra_models``):
  the loss terms, parameters, running statistics and the EMA bases at
  ``RTOL64`` of each tensor's largest value.
* Both: every parameter, buffer and optimizer moment bitwise equal on the
  two ranks.
* A random ensemble (``test_torch_port_mt.py``'s SDModuleMT, one CGD
  entry with an adapter against two teachers) through DDP's static graph,
  4 steps that draw both teachers, also with the student's ``with_cp``:
  bitwise the default DDP's steps (its trained set is the same at every
  step, so a CUDA graph of its DDP step may take the static graph).
* Steps per dispatch through DDP: the ResNet's 3 steps as one chunk of
  ``build_multi_train_step`` (on CPU tensors the DDP step 3 times) equal
  the rank's single steps bitwise, hence the JAX steps; ``tools.train
  --multi-host`` with ``runner.steps_per_dispatch=3`` logs the chunk ends
  3, 6, then 7 and 8 with the k = 1 run's losses.
* ``SyncBatchNorm2d`` and EncNet's BN1d at two ranks against one process
  on the concatenated batch; the log vars' mean over the ranks;
  ``tools.train --multi-host`` / ``tools.test --multi-host`` (rank 0 alone
  writes, a resume continues each rank's stream, the sharded evaluation
  equals one process exactly); the dry run's line.
* Without processes: the loader's shards and seeds against the JAX loader
  at worlds 2 and 3, a resume, and the one-process behaviour of every
  piece.

Accuracies (``*.acc_seg``) are left out of the JAX comparisons: each rank
logs its own share's accuracy and the ranks' mean is logged, as in the
reference, where the JAX step logs the global batch's (ROADMAP,
divergences).
"""

import ast
import json
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segdistill_tpu.datasets.builder import DataLoader as JaxDataLoader
from segdistill_tpu.engine import build_lr_schedule as jax_lr_schedule
from segdistill_tpu.engine import build_optimizer as jax_build_optimizer
from segdistill_tpu.engine import build_train_step as jax_train_step
from segdistill_tpu.engine import create_train_state
from segdistill_tpu.models import build_segmentor as build_jax_segmentor
from segdistill_tpu_torch import parallel
from segdistill_tpu_torch.apis import init_segmentor, single_device_test
from segdistill_tpu_torch.convert import state_dict_from_jax
from segdistill_tpu_torch.datasets import build_dataset
from segdistill_tpu_torch.datasets.builder import DataLoader
from segdistill_tpu_torch.engine import step_seed
from segdistill_tpu_torch.models.segmentors import draw_teacher_index
from segdistill_tpu_torch.models.utils import (BatchNorm2d, SyncBatchNorm2d,
                                               build_norm_layer)
from segdistill_tpu_torch.tools import test as test_cli

import test_torch_port_cli as cli
import torch_port_dist_worker as worker
import torch_port_extra_models as extra
import torch_port_zoo_models as zoo
from test_torch_port_mt import N_TEACHERS, mt_cfg
from test_torch_port_train import (CGD, LR_CONFIG, MAX_ITERS, OPTIMIZER,
                                   _jax_perm, key_bias_mask, sd_cfg,
                                   trajectory_optimizer)
from torch_port_attn_models import float64_islands
from torch_port_fixtures import (ATOL, NUM_CLASSES, RTOL, fcn_aux,
                                 nhwc_to_nchw, random_jax_variables,
                                 resnet_v1c)

TESTS = Path(__file__).resolve().parent
WORLD, PER_RANK = 2, 2
CGD_STEPS = 2
# the random ensemble's steps under DDP: 1001-1004 draw teachers 0, 0, 1, 0
# from seed 0 (the test checks that both are drawn)
MT_START, MT_STEPS = 1000, 4
WAIT = 300  # seconds the two ranks may take together


def _batch(seed=0, hw=(64, 64)):
    """The global batch: 4 NHWC images and labels, the first image's top
    rows ignored (so the ranks' valid pixel counts differ)."""
    rng = np.random.RandomState(seed)
    img = rng.randn(WORLD * PER_RANK, *hw, 3).astype(np.float32)
    gt = rng.randint(0, NUM_CLASSES, (WORLD * PER_RANK,) + hw).astype(
        np.int32)
    gt[0, :4] = 255
    return img, gt


def _port_batch(img, gt):
    return (torch.from_numpy(nhwc_to_nchw(img).copy()),
            torch.from_numpy(gt.astype(np.int64)))


def _resnet_cfg():
    """ResNetV1c-50-d8 (narrow) + EMAHead + the FCN auxiliary head."""
    return zoo._segmentor(
        resnet_v1c(), zoo._head('EMAHead', 256, 3, 16, ema_channels=24,
                                num_bases=8, num_stages=3, momentum=0.1),
        fcn_aux())


def _cgd_case():
    """The CGD pair's JAX model and variables, the batch, the optimizer
    state and the permutations of steps 1 and 2 (no step run yet)."""
    model = build_jax_segmentor(sd_cfg())
    sv = random_jax_variables(model.student, seed=0)
    tv = random_jax_variables(model.teacher, seed=1)
    img, gt = _batch()
    schedule = jax_lr_schedule(LR_CONFIG, OPTIMIZER['lr'], MAX_ITERS)
    tx = jax_build_optimizer(trajectory_optimizer('jax'), sv['params'],
                             schedule)
    state = create_train_state(jax.random.key(1), sv, tx)
    perms = [_jax_perm(model, step, jax.random.split(
        jax.random.fold_in(state.rng, step))[1])
        for step in range(1, CGD_STEPS + 1)]
    return dict(model=model, sv=sv, tv=tv, img=img, gt=gt, tx=tx,
                schedule=schedule, state=state, perms=perms)


def _jax_cgd(case):
    """The JAX train step on the global batch: the log vars of each step,
    the student's variables after the last."""
    step_fn = jax_train_step(case['model'], case['tx'], case['schedule'],
                             donate=False)
    state, logs = case['state'], []
    for _ in range(CGD_STEPS):
        state, log_vars = step_fn(state, case['tv'],
                                  jnp.asarray(case['img']),
                                  jnp.asarray(case['gt']))
        logs.append({k: float(v) for k, v in log_vars.items()})
    return dict(logs=logs, variables=jax.tree.map(np.asarray, {
        'params': state.params,
        'batch_stats': state.model_state['batch_stats']}))


def _jax_resnet(case):
    """The JAX package's float64 SGD steps on the global batch."""
    with jax.enable_x64(True), float64_islands():
        cfg64 = _resnet_cfg()
        cfg64['backbone']['dtype'] = 'float64'
        return zoo._jax_run(
            build_jax_segmentor(cfg64),
            jax.tree.map(lambda a: np.asarray(a, np.float64),
                         case['variables']),
            jnp.asarray(case['img'], jnp.float64), jnp.asarray(case['gt']))


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """Both ranks' results, the JAX references and the job's inputs."""
    tmp = tmp_path_factory.mktemp('dist')
    cgd = _cgd_case()
    resnet = dict(variables=random_jax_variables(
        build_jax_segmentor(_resnet_cfg()), seed=3))
    resnet['img'], resnet['gt'] = _batch(seed=1)
    config = tmp / 'tiny_cgd.py'
    config.write_text(cli.CONFIG.format(data_root=str(cli.DATA)))
    img, gt = _port_batch(cgd['img'], cgd['gt'])
    resnet_img, resnet_gt = _port_batch(resnet['img'], resnet['gt'])
    job = dict(
        cgd=dict(cfg=sd_cfg(distillation=(dict(CGD, log_grad=True),)),
                 state_dict=state_dict_from_jax({'student': cgd['sv'],
                                                 'teacher': cgd['tv']}),
                 optimizer=trajectory_optimizer('port'),
                 lr_config=LR_CONFIG, max_iters=MAX_ITERS, img=img, gt=gt,
                 perms=[torch.from_numpy(p.copy()) for p in cgd['perms']],
                 steps=CGD_STEPS),
        resnet=dict(cfg=_resnet_cfg(),
                    state_dict=state_dict_from_jax(resnet['variables']),
                    optimizer=extra.OPTIMIZER, lr_config=extra.LR_CONFIG,
                    max_iters=extra.MAX_ITERS, img=resnet_img,
                    gt=resnet_gt, steps=extra.STEPS, float64=True),
        mt=dict(cfg=mt_cfg('random'), optimizer=OPTIMIZER,
                lr_config=LR_CONFIG, max_iters=2 * MT_START, img=img,
                gt=gt, start=MT_START, steps=MT_STEPS),
        cli=dict(config=str(config), work=str(tmp / 'work'),
                 work2=str(tmp / 'work_resumed'),
                 work3=str(tmp / 'work_chunked')))
    torch.save(job, tmp / 'job.pt')
    t0 = time.perf_counter()
    with parallel.Workers('torch_port_dist_worker:run', WORLD,
                          [str(tmp / 'job.pt'), str(tmp)],
                          env={'PYTHONPATH': str(TESTS)}, threads=1) as ranks:
        refs = dict(cgd=_jax_cgd(cgd), resnet=_jax_resnet(resnet))
        outputs = ranks.wait(timeout=WAIT)
    seconds = time.perf_counter() - t0
    results = [torch.load(tmp / f'rank{r}.pt', weights_only=False)
               for r in range(WORLD)]
    return dict(refs=refs, ranks=results, outputs=outputs, job=job,
                cgd=cgd, resnet=resnet, tmp=tmp, seconds=seconds)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _close64(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=extra.RTOL64,
        atol=extra.RTOL64 * max(float(np.abs(want).max()), 1e-30),
        err_msg=what)


def _same(a, b):
    """Bitwise equality of two nests of tensors and plain values."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def _unbiased_factor(count):
    return count / (count - 1)


# ------------------------------------------------------- against JAX


def test_cgd_step_matches_the_jax_global_batch(run):
    ref, got = run['refs']['cgd'], run['ranks'][0]['cgd']
    schedule = run['cgd']['schedule']
    for i, (want_logs, logs) in enumerate(zip(ref['logs'], got['logs'])):
        for k, v in want_logs.items():
            if 'acc' not in k:
                _close(logs[k], v, f'step {i + 1} {k}')
        assert 0.0 <= logs['deg'] <= 180.0
    want = state_dict_from_jax(ref['variables'])
    before = state_dict_from_jax({'params': run['cgd']['sv']['params'],
                                  'batch_stats': run['cgd']['sv'][
                                      'batch_stats']})
    # noise that Adam turns into steps of ~lr on gradients that are 0 in
    # exact arithmetic (test_torch_port_train's trajectory)
    noise_bound = sum(2 * 2 * float(schedule(i)) for i in range(CGD_STEPS))
    state = got['state_dict']
    decay = 0.9 ** CGD_STEPS
    for name, w in want.items():
        value = state[f'student.{name}']
        if name.endswith('running_var'):
            count = got['bn_counts'][f'student.{name[:-len(".running_var")]}']
            _close(value - decay * before[name],
                   (w - decay * before[name]) * _unbiased_factor(count),
                   name)
        elif name.endswith('num_batches_tracked'):
            assert int(value) == CGD_STEPS
        else:
            noise = key_bias_mask(name, w)
            assert bool(((value - w)[noise].abs() <= noise_bound).all()), name
            _close(value[~noise], w[~noise], name)


def test_resnet_syncbn_step_matches_the_jax_global_batch(run):
    """SyncBN through a ResNetV1c backbone and both heads, float64: the
    loss terms of each step, every parameter and the running statistics
    after the last."""
    ref, got = run['refs']['resnet'], run['ranks'][0]['resnet']
    for i, (step, logs) in enumerate(zip(ref, got['logs'])):
        for k, v in step['log_vars'].items():
            if 'acc' not in k:
                _close64(logs[k], v, f'step {i + 1} {k}')
    want = state_dict_from_jax(ref[-1]['variables'])
    before = state_dict_from_jax(run['resnet']['variables'])
    decay = 0.9 ** extra.STEPS
    n_bn = 0
    for name, w in want.items():
        value = got['state_dict'][name]
        if name.endswith('running_var'):
            count = got['bn_counts'][name[:-len('.running_var')]]
            b = before[name].double()
            _close64(value - decay * b,
                     (w - decay * b) * _unbiased_factor(count), name)
            n_bn += 1
        elif not name.endswith('num_batches_tracked'):
            _close64(value, w, name)
    assert n_bn > 50  # every BN of the backbone and both heads


def test_ema_bases_match_jax_and_every_rank(run):
    """The EMA bases: each rank's batch-mean bases averaged over the ranks
    before the unit norm and the momentum step (the reference's
    ``reduce_mean``): the JAX global batch's, and the same bits on both
    ranks."""
    name = 'decode_head.ema_module.bases'
    want = state_dict_from_jax(run['refs']['resnet'][-1]['variables'])[name]
    got = [r['resnet']['state_dict'][name] for r in run['ranks']]
    assert torch.equal(got[0], got[1])
    assert not torch.equal(got[0], state_dict_from_jax(
        run['resnet']['variables'])[name].double())
    _close64(got[0], want, name)


def test_resnet_chunk_equals_single_steps_and_jax(run):
    """The k = 3 chunk through DDP on each rank: its parameters, buffers
    (BN statistics, the EMA bases), optimizer state and last log vars are
    the rank's three single DDP steps' bitwise, and within ``RTOL64`` of
    the JAX steps on the global batch."""
    for r in run['ranks']:
        chunk, single = r['resnet chunk'], r['resnet']
        assert _same(chunk['state_dict'], single['state_dict'])
        assert _same(chunk['optimizer'], single['optimizer'])
        assert chunk['logs'] == single['logs'][-1:]
    ref = run['refs']['resnet'][-1]
    got = run['ranks'][0]['resnet chunk']
    for k, v in ref['log_vars'].items():
        if 'acc' not in k:
            _close64(got['logs'][-1][k], v, k)
    for name, w in state_dict_from_jax(ref['variables']).items():
        if not name.endswith(('running_var', 'num_batches_tracked')):
            _close64(got['state_dict'][name], w, name)


def test_random_ensemble_static_graph_equals_default_ddp(run):
    """The random ensemble's steps through DDP's static graph, without
    and with the student's ``with_cp`` (the non-reentrant checkpoint under
    DDP), are the default DDP's (which searches for unused parameters each
    step), bitwise, on both ranks, over steps that draw both teachers."""
    drawn = {draw_teacher_index(step_seed(0, step), N_TEACHERS)
             for step in range(MT_START + 1, MT_START + MT_STEPS + 1)}
    assert drawn == set(range(N_TEACHERS))
    for r in run['ranks']:
        default = r['mt random default']
        assert not default['static_graph']
        for case in ('mt random', 'mt random with_cp'):
            static = r[case]
            assert static['static_graph']
            assert all('loss_random' in lv for lv in static['logs'])
            assert static['logs'] == default['logs']
            assert _same(static['state_dict'], default['state_dict'])
            assert _same(static['optimizer'], default['optimizer'])


@pytest.mark.parametrize('case', ['cgd', 'resnet', 'resnet chunk',
                                  'mt random'])
def test_state_is_bitwise_equal_on_every_rank(run, case):
    """Parameters, buffers (BN statistics, the EMA bases) and the
    optimizer's state after the steps; the log vars of every step."""
    a, b = (r[case] for r in run['ranks'])
    assert _same(a['state_dict'], b['state_dict'])
    assert _same(a['optimizer'], b['optimizer'])
    assert a['logs'] == b['logs']


# ------------------------------------------------- against one process


@pytest.mark.parametrize('case', worker.SYNCBN_CASES, ids=lambda c: c[0])
def test_sync_batch_norm_equals_one_process(run, case):
    """SyncBN's output, input gradient and running statistics at two
    ranks equal BN's on the concatenated batch in one process; its weight
    and bias gradients are each rank's own, which sum to one process's.
    fp32 within 2e-6 of each tensor's largest value (the merged mean and
    variance against torch's one-pass ones; dx of the size of its terms,
    dy * weight / std); bf16 outputs within a bf16
    step (2^-8 relative) of the value, as one rounding of the same fp32
    result. Where the mean is large against the spread, the float32 mean
    itself is rounded by up to a few units of its last place, which moves
    every output by that share of the spread: the limit grows to 8 such
    units (1e-3 of the outputs at a mean 1e3 of the spread, where E[x^2] -
    mean^2 in float32 would miss the variance by several percent)."""
    name, shape, dtype, mean, spread = case
    want = worker.bn_case(name, shape, dtype, mean, spread, 0, 1,
                          sync=False)
    ranks = [r['syncbn'][name] for r in run['ranks']]
    # the size of dx's terms, dy * weight / std: at two values a channel
    # they cancel exactly, and dx is their rounding alone
    x, dy, weight, _ = worker.syncbn_data(shape, dtype, mean, spread)
    dims = [0] + list(range(2, x.dim()))
    invstd = (x.double().var(dims, unbiased=False) + 1e-5).rsqrt()
    terms = float(dy.float().abs().max() * weight.abs().max() * invstd.max())

    def check(key, got):
        w = want[key].float()
        if dtype == torch.bfloat16 and key in ('y', 'dx'):
            np.testing.assert_allclose(got.float(), w, rtol=2.0 ** -7,
                                       atol=1e-3, err_msg=key)
        else:
            scale = max(float(w.abs().max()), terms if key == 'dx' else 0)
            np.testing.assert_allclose(got.float(), w, rtol=0,
                                       atol=limit * scale, err_msg=key)
    limit = max(2e-6, 8 * 2.0 ** -23 * abs(mean) / spread)
    check('y', torch.cat([r['y'] for r in ranks]))
    check('dx', torch.cat([r['dx'] for r in ranks]))
    check('dw', ranks[0]['dw'] + ranks[1]['dw'])
    check('db', ranks[0]['db'] + ranks[1]['db'])
    for key in ('running_mean', 'running_var', 'num_batches_tracked'):
        assert _same(ranks[0][key], ranks[1][key]), key
    check('running_mean', ranks[0]['running_mean'])
    check('running_var', ranks[0]['running_var'])


def test_log_vars_are_the_mean_over_ranks(run):
    """parse_losses: the total is the rank's own (for its backward); the
    log vars, lists and non-losses included, are the ranks' mean."""
    got = [r['reduce'] for r in run['ranks']]
    assert [g['total'] for g in got] == [2.5, 5.5]
    for g in got:
        assert g['log_vars'] == {'a.loss_x': 1.5, 'b.acc_y': 5.0,
                                 'c.loss_z': 2.5, 'loss': 4.0}


def _json_log(work):
    paths = sorted(Path(work).glob('*.log.json'))
    assert len(paths) == 1, paths
    lines = [json.loads(ln) for ln in paths[0].read_text().splitlines()]
    return ([ln for ln in lines if ln['mode'] == 'train'],
            [ln for ln in lines if ln['mode'] == 'val'])


def test_cli_multi_host_trains_resumes_and_tests(run):
    """``tools.train --multi-host`` at two ranks runs to ``max_iters``
    with the same weights on both; rank 0 alone writes the text log, the
    JSON log (each iteration once), the config dump and the checkpoints
    (no ``module.`` prefix); a resume from iteration 4 logs the
    uninterrupted run's losses bitwise (each rank continues its own
    stream); ``tools.test --multi-host`` gives both ranks the last
    evaluation's metrics, and rank 0 alone prints them."""
    got = [r['cli'] for r in run['ranks']]
    assert [(g['step'], g['resumed_step']) for g in got] == [(8, 8), (8, 8)]
    assert got[0]['digest'] == got[1]['digest']
    work = Path(run['job']['cli']['work'])
    assert sorted(p.name for p in work.iterdir() if p.is_file()) == sorted(
        [p.name for p in work.glob('*.log')]
        + [p.name for p in work.glob('*.log.json')] + ['tiny_cgd.py'])
    assert len(list(work.glob('*.log'))) == 1
    assert sorted(p.name for p in (work / 'checkpoints').iterdir()) == [
        'iter_4.pth', 'iter_8.pth', 'meta.json']
    ckpt = torch.load(work / 'checkpoints' / 'iter_8.pth',
                      weights_only=True)
    assert ckpt['step'] == 8 and ckpt['state_dict']
    assert not any(k.startswith('module.') or k.startswith('model.')
                   for part in ('state_dict', 'adapters')
                   for k in ckpt[part])
    train, val = _json_log(work)
    assert [ln['iter'] for ln in train] == list(range(1, 9))
    assert [ln['iter'] for ln in val] == [4, 8]
    train2, val2 = _json_log(run['job']['cli']['work2'])
    assert [ln['iter'] for ln in train2] == [5, 6, 7, 8]
    for a, b in zip(train[4:], train2):
        for key in ('loss', 'decode.loss_seg', cli.KD_KEY, 'lr'):
            assert a[key] == b[key], (a['iter'], key)
    for key in ('mIoU', 'mAcc', 'aAcc'):
        assert val2[-1][key] == val[-1][key]
        for g in got:
            assert g['metrics'][key] == pytest.approx(val[-1][key],
                                                      abs=1e-12)
    (out0, err0), (out1, err1) = run['outputs']
    assert 'Iter [8/8]' in err0 and 'Iter [' not in err1
    assert "'mIoU'" in out0 and "'mIoU'" not in out1


def test_cli_multi_host_steps_per_dispatch(run):
    """``tools.train --multi-host --options runner.steps_per_dispatch=3``
    at two ranks: the JAX runner's cadence (chunk ends 3 and 6, then single
    steps 7 and 8; the checkpoints where a chunk crosses 4 and at 8), the
    losses of the k = 1 run at those iterations (on the CPU a chunk is the
    DDP step k times; within the fixtures' limits, as CPU sums in several
    busy processes may split in other orders)."""
    assert [r['cli']['chunked_step'] for r in run['ranks']] == [8, 8]
    work = Path(run['job']['cli']['work3'])
    train, val = _json_log(work)
    assert [ln['iter'] for ln in train] == [3, 6, 7, 8] and val == []
    assert sorted(p.name for p in (work / 'checkpoints').iterdir()) == [
        'iter_6.pth', 'iter_8.pth', 'meta.json']
    k1 = {ln['iter']: ln for ln in _json_log(run['job']['cli']['work'])[0]}
    for line in train:
        assert line['lr'] == k1[line['iter']]['lr']
        for key in ('loss', 'decode.loss_seg', cli.KD_KEY):
            _close(line[key], k1[line['iter']][key],
                   f"{line['iter']} {key}")


def test_sharded_evaluation_equals_one_process(run):
    """The two ranks' sharded evaluation of the checkpoint (each two of
    the four images, histograms summed) against ``tools.test`` in this
    process (one process, every image): equal, the histograms being
    integers; each rank's ``multi_device_test`` predicts images rank,
    rank + 2 as one process does."""
    config, work = run['job']['cli']['config'], run['job']['cli']['work']
    one = test_cli.main([config, work, '--eval', 'mIoU', '--device', 'cpu'])
    for r in run['ranks']:
        assert {k: r['cli']['metrics'][k] for k in one} == one
    assert 0.0 < one['mIoU'] < 1.0
    model = init_segmentor(config, f'{work}/checkpoints/iter_8.pth',
                           device='cpu')
    maps = single_device_test(model, build_dataset(
        model.cfg.data['test'], dict(test_mode=True)))
    for rank, r in enumerate(run['ranks']):
        indices, shard = r['cli']['shard']
        assert indices == list(range(rank, len(maps), WORLD))
        assert all(np.array_equal(a, maps[i])
                   for a, i in zip(shard, indices))


def test_dryrun_multichip_prints_the_jax_line(run):
    (out0, _), (out1, _) = run['outputs']
    (line,) = [ln for ln in out0.splitlines()
               if ln.startswith('dryrun_multichip(2) ok: loss=')]
    assert 'dryrun_multichip' not in out1
    logs = [r['dryrun'] for r in run['ranks']]
    assert logs[0] == logs[1] and np.isfinite(logs[0]['loss'])
    assert ast.literal_eval(line.split('log_vars=')[1]) == sorted(logs[0])


def test_ranks_import_no_jax_and_report_their_time(run):
    for r in run['ranks']:
        assert r['foreign_modules'] == []
    print(f"two ranks: {run['seconds']:.1f} s with the JAX references; "
          f"per case on rank 0: {run['ranks'][0]['seconds']}")


# ------------------------------------------------------- no processes


class _Samples:
    """A dataset whose samples are their index and a draw from the
    sample's generator."""

    def __len__(self):
        return 23

    def __getitem__(self, idx, rng=None):
        return {'idx': np.array(idx), 'draw': np.array(rng.randint(2**30))}


def _stream(loader, n):
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


@pytest.mark.parametrize('world', [2, 3])
def test_loader_shards_match_the_jax_loader(world):
    """Each rank's batches (indices and per-sample draws) over three
    epochs, and the loader's length, equal the JAX loader's; a loader
    resumed at batch 4 goes on with the batches the rank saw from 4."""
    for rank in range(world):
        kw = dict(samples_per_gpu=2, num_workers=2, shuffle=True, seed=5,
                  process_index=rank, process_count=world)
        got = _stream(DataLoader(_Samples(), **kw), 12)
        want = _stream(JaxDataLoader(_Samples(), **kw), 12)
        assert len(DataLoader(_Samples(), **kw)) == len(
            JaxDataLoader(_Samples(), **kw)) == 23 // (2 * world)
        for a, b in zip(got, want):
            assert np.array_equal(a['idx'], b['idx'])
            assert np.array_equal(a['draw'], b['draw'])
        resumed = _stream(DataLoader(_Samples(), start_batch=4, **kw), 8)
        for a, b in zip(resumed, got[4:]):
            assert np.array_equal(a['idx'], b['idx'])
            assert np.array_equal(a['draw'], b['draw'])
    shards = [np.concatenate([b['idx'] for b in _stream(DataLoader(
        _Samples(), samples_per_gpu=2, seed=5, process_index=r,
        process_count=world), 1)]) for r in range(world)]
    assert len(set(np.concatenate(shards))) == 2 * world


def test_loader_refuses_a_dataset_smaller_than_the_global_batch():
    loader = DataLoader(_Samples(), samples_per_gpu=8, process_index=1,
                        process_count=3)
    with pytest.raises(ValueError, match='global batch is 24'):
        iter(loader)


def test_one_process_is_unchanged():
    """Without a process group: rank 0 of 1, no collective, SyncBN is
    BatchNorm2d bit for bit in training and evaluation; asking for DDP or
    a group without torchrun's environment raises."""
    assert parallel.get_dist_info() == (0, 1) and parallel.is_main_process()
    t = torch.ones(3)
    assert parallel.all_reduce_mean(t) is t
    _, sync = build_norm_layer(dict(type='SyncBN'), 6)
    _, local = build_norm_layer(dict(type='BN'), 6)
    assert type(sync) is SyncBatchNorm2d and type(local) is BatchNorm2d
    with torch.no_grad():
        sync.weight.uniform_(0.5, 1.5,
                             generator=torch.Generator().manual_seed(1))
    local.load_state_dict(sync.state_dict())
    x = torch.randn(3, 6, 5, 4, generator=torch.Generator().manual_seed(0))
    outs = []
    for layer in (sync, local):
        xi = x.clone().requires_grad_()
        y = layer.train()(xi)
        (y * x).sum().backward()
        outs.append((y, xi.grad, layer.weight.grad, layer.bias.grad))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert _same(sync.state_dict(), local.state_dict())
    assert torch.equal(sync.eval()(x), local.eval()(x))
    with pytest.raises(RuntimeError, match='process group'):
        parallel.wrap_model(torch.nn.Linear(2, 2))


def test_init_distributed_needs_torchrun_environment(monkeypatch):
    for key in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT'):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match='RANK is not set'):
        parallel.init_distributed('gloo')


def test_launcher_stops_every_rank_when_one_fails():
    """Rank 1 exits at once while rank 0 would wait two minutes: the
    launcher raises with rank 1's error within seconds and leaves no rank
    running."""
    t0 = time.perf_counter()
    workers = parallel.Workers('torch_port_dist_worker:misbehave', 2, [120],
                               env={'PYTHONPATH': str(TESTS)})
    with pytest.raises(RuntimeError, match='rank 1 gives up'):
        workers.wait(timeout=60)
    assert time.perf_counter() - t0 < 60
    assert all(p.poll() is not None for p in workers.procs)
