"""One rank of ``test_torch_port_dist.py``: every multi-rank case of that
file, run in the ranks that one ``parallel.Workers`` starts there (two gloo
processes on the CPU). Each rank writes what it saw to
``<out_dir>/rank<r>.pt``; the test file compares the ranks with each other,
with one process and with the JAX package. Imports nothing of JAX.

The cases, in order (a collective that one rank skips would hang the
other, so both run every case):

* ``syncbn``: ``SyncBatchNorm2d`` (and EncNet's BN1d) on the rank's share
  of seeded batches, forward and backward, in fp32 and bf16, at one value
  a channel a rank, and on a map whose mean is 10^3 of its spread;
* ``reduce``: ``parse_losses`` of rank-dependent values;
* ``cgd``, ``resnet``: train steps through ``build_train_step`` with the
  DDP wrapper on the rank's share of the job's batch;
* ``resnet chunk``: the ``resnet`` steps as one chunk of
  ``build_multi_train_step`` with the DDP wrapper;
* ``mt random``, ``mt random default``, ``mt random with_cp``: a random
  ensemble's steps from one seeded initialisation through DDP's static
  graph (the form a CUDA graph of the step holds), through the default
  DDP, and through the static graph with the student's blocks recomputed
  in the backward;
* ``dryrun``: ``tools.dryrun_multichip``'s rank step;
* ``cli``: ``tools.train --multi-host`` (8 iterations), a resume from
  iteration 4 into a second work dir, ``tools.test --multi-host``,
  ``multi_device_test`` of the last checkpoint, and ``tools.train
  --multi-host`` with ``runner.steps_per_dispatch=3`` into a third.
"""

import contextlib
import copy
import hashlib
import os
import sys
import time

import numpy as np
import torch

from segdistill_tpu_torch.apis import init_segmentor, multi_device_test
from segdistill_tpu_torch.datasets import build_dataset
from segdistill_tpu_torch.engine import (TrainState, build_lr_schedule,
                                         build_multi_train_step,
                                         build_optimizer, build_train_step)
from segdistill_tpu_torch.models import build_segmentor
from segdistill_tpu_torch.models.decode_heads.da_head import (
    _BatchNorm1d, _SyncBatchNorm1d)
from segdistill_tpu_torch.models.segmentors import parse_losses
from segdistill_tpu_torch.models.utils import BatchNorm2d, SyncBatchNorm2d
from segdistill_tpu_torch.parallel import process_group, wrap_model
from segdistill_tpu_torch.tools import dryrun_multichip

# SyncBN cases: (name, the global batch's shape, dtype, mean, spread)
SYNCBN_CASES = [('fp32', (4, 6, 5, 7), torch.float32, 0.5, 2.0),
                ('bf16', (4, 6, 5, 7), torch.bfloat16, 0.5, 2.0),
                ('one value a channel a rank', (2, 6, 1, 1), torch.float32,
                 0.0, 1.0),
                ('mean 1e3 of the spread', (4, 6, 8, 8), torch.float32,
                 1000.0, 1.0),
                ('bn1d', (4, 6, 9), torch.float32, 0.5, 2.0)]


def syncbn_data(shape, dtype, mean, spread, seed=0):
    """The global batch, the incoming gradient, the weight and the bias of
    a SyncBN case (also made by the test for its one-process run)."""
    rng = np.random.RandomState(seed)
    x = mean + spread * rng.randn(*shape)
    dy = rng.randn(*shape)
    c = shape[1]
    weight, bias = 1 + 0.2 * rng.randn(c), 0.1 * rng.randn(c)
    return (torch.tensor(x, dtype=torch.float32).to(dtype),
            torch.tensor(dy, dtype=torch.float32).to(dtype),
            torch.tensor(weight, dtype=torch.float32),
            torch.tensor(bias, dtype=torch.float32))


def bn_step(layer, x, dy):
    """One train-mode forward and backward of ``layer`` -> what it gave
    and what it holds afterwards."""
    x = x.clone().requires_grad_()
    y = layer.train()(x)
    (y.float() * dy.float()).sum().backward()
    return dict(y=y.detach(), dx=x.grad, dw=layer.weight.grad,
                db=layer.bias.grad,
                running_mean=layer.running_mean.clone(),
                running_var=layer.running_var.clone(),
                num_batches_tracked=int(layer.num_batches_tracked))


def bn_layer(name, c, sync):
    if name == 'bn1d':
        return (_SyncBatchNorm1d if sync else _BatchNorm1d)(c)
    return (SyncBatchNorm2d if sync else BatchNorm2d)(c)


def bn_case(name, shape, dtype, mean, spread, rank, world, sync=True):
    """The case on this rank's share (``sync``) or, with ``rank`` 0 and
    ``world`` 1, on the whole batch in one process."""
    x, dy, weight, bias = syncbn_data(shape, dtype, mean, spread)
    layer = bn_layer(name, shape[1], sync)
    with torch.no_grad():
        layer.weight.copy_(weight)
        layer.bias.copy_(bias)
    per = shape[0] // world
    share = slice(rank * per, (rank + 1) * per)
    return bn_step(layer, x[share], dy[share])


@contextlib.contextmanager
def float64_kept():
    """``Tensor.float()`` leaves a float64 tensor as it is (the float64
    steps; ``torch_port_fixtures.float64_kept``, which imports JAX)."""
    upcast = torch.Tensor.float
    torch.Tensor.float = lambda t, *a, **k: t if t.dtype == torch.float64 \
        else upcast(t, *a, **k)
    try:
        yield
    finally:
        torch.Tensor.float = upcast


def bn_counts(model, world):
    """{BN module name: the global count of values a channel} of the next
    forward, filled by hooks."""
    counts = {}
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.register_forward_hook(
                lambda mod, inp, out, name=name: counts.__setitem__(
                    name, inp[0].numel() // inp[0].shape[1] * world))
    return counts


def train_case(spec, rank, world, chunk=False):
    """``spec['steps']`` train steps of the spec's model through the DDP
    wrapper, on this rank's share of the batch; with ``chunk``, as one
    chunk of that many steps (``build_multi_train_step``), which logs the
    last."""
    model = build_segmentor(spec['cfg'])
    model.load_state_dict(spec['state_dict'], strict=True)
    float64 = spec.get('float64', False)
    if float64:
        model.double()
        model.backbone.dtype = torch.float64
    model.train()
    optimizer = build_optimizer(spec['optimizer'], model)
    schedule = build_lr_schedule(spec['lr_config'], spec['optimizer']['lr'],
                                 spec['max_iters'])
    steps = spec['steps']
    build = build_multi_train_step if chunk else build_train_step
    step_fn = build(model, optimizer, schedule,
                    *([steps] if chunk else []), wrap_model(model))
    state = TrainState(model=model, optimizer=optimizer, seed=0)
    img, gt = spec['img'], spec['gt']
    per = img.shape[0] // world
    share = slice(rank * per, (rank + 1) * per)
    img = img[share].to(torch.float64 if float64 else torch.float32)
    counts = bn_counts(model, world)
    logs = []
    for i in range(1 if chunk else steps):
        perm = spec['perms'][i] if spec.get('perms') else None
        with float64_kept() if float64 else contextlib.nullcontext():
            if chunk:
                log_vars = step_fn(state, torch.stack([img] * steps),
                                   torch.stack([gt[share]] * steps))
            else:
                log_vars = step_fn(state, img, gt[share], perm=perm)
        logs.append({k: float(v) for k, v in log_vars.items()})
    return dict(logs=logs, bn_counts=counts,
                state_dict={k: v.clone() for k, v in
                            model.state_dict().items()},
                optimizer=optimizer.state_dict())


def mt_case(spec, rank, world, static_graph, with_cp=False):
    """The random ensemble of ``spec['cfg']`` from seed 0 (``with_cp``:
    the student's blocks recomputed in the backward): steps
    ``spec['start'] + 1`` on through ``wrap_model(static_graph=...)``, on
    this rank's share of the batch; each step's teacher is drawn from its
    seed."""
    cfg = copy.deepcopy(spec['cfg'])
    cfg['cfg_s']['backbone']['with_cp'] = with_cp
    model = build_segmentor(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    model.train()
    optimizer = build_optimizer(spec['optimizer'], model)
    schedule = build_lr_schedule(spec['lr_config'], spec['optimizer']['lr'],
                                 spec['max_iters'])
    ddp = wrap_model(model, static_graph=static_graph)
    step_fn = build_train_step(model, optimizer, schedule, ddp)
    state = TrainState(model=model, optimizer=optimizer, seed=0)
    state.step = spec['start']
    per = spec['img'].shape[0] // world
    share = slice(rank * per, (rank + 1) * per)
    logs = [{k: float(v) for k, v in step_fn(
        state, spec['img'][share], spec['gt'][share]).items()}
        for _ in range(spec['steps'])]
    return dict(logs=logs, static_graph=ddp.static_graph,
                state_dict={k: v.clone() for k, v in
                            model.state_dict().items()},
                optimizer=optimizer.state_dict())


def cli_case(spec, rank):
    """tools.train --multi-host, a resume, tools.test --multi-host."""
    from segdistill_tpu_torch.tools import test as test_cli
    from segdistill_tpu_torch.tools import train as train_cli
    common = ['--seed', '7', '--device', 'cpu', '--multi-host']
    state = train_cli.main([spec['config'], '--work-dir', spec['work']]
                           + common)
    digest = hashlib.sha1()
    for value in state.model.state_dict().values():
        digest.update(value.numpy().tobytes())
    resumed = train_cli.main(
        [spec['config'], '--work-dir', spec['work2'], '--resume-from',
         f"{spec['work']}/checkpoints/iter_4.pth"] + common)
    metrics = test_cli.main([spec['config'], spec['work'], '--eval', 'mIoU',
                             '--device', 'cpu', '--multi-host'])
    model = init_segmentor(spec['config'],
                           f"{spec['work']}/checkpoints/iter_8.pth",
                           device='cpu')
    shard = multi_device_test(model, build_dataset(
        model.cfg.data['test'], dict(test_mode=True)))
    chunked = train_cli.main(
        [spec['config'], '--work-dir', spec['work3'], '--no-validate']
        + common + ['--options', 'runner.steps_per_dispatch=3'])
    return dict(step=state.step, resumed_step=resumed.step, metrics=metrics,
                digest=digest.hexdigest(), shard=shard,
                chunked_step=chunked.step)


def run(job_path, out_dir):
    """Every case on this rank; -> nothing, the results in a file."""
    job = torch.load(job_path, weights_only=False)
    out, seconds = {}, {}
    with process_group('gloo') as (rank, world):
        t0 = time.perf_counter()
        out['syncbn'] = {name: bn_case(name, *case, rank, world)
                         for name, *case in SYNCBN_CASES}
        total, log_vars = parse_losses({
            'a.loss_x': torch.tensor([rank + 1.0, 3.0 * rank]),
            'b.acc_y': torch.tensor(10.0 * rank),
            'c.loss_z': [torch.tensor(2.0), torch.tensor(float(rank))]})
        out['reduce'] = dict(total=float(total),
                             log_vars={k: float(v)
                                       for k, v in log_vars.items()})
        seconds['syncbn and reduce'] = time.perf_counter() - t0
        for case in ('cgd', 'resnet', 'resnet chunk'):
            t0 = time.perf_counter()
            out[case] = train_case(job[case.split()[0]], rank, world,
                                   chunk=case.endswith('chunk'))
            seconds[case] = time.perf_counter() - t0
        for case, static_graph, with_cp in (
                ('mt random', True, False),
                ('mt random default', False, False),
                ('mt random with_cp', True, True)):
            t0 = time.perf_counter()
            out[case] = mt_case(job['mt'], rank, world, static_graph,
                                with_cp)
            seconds[case] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out['dryrun'] = dryrun_multichip.rank_step(world)
        seconds['dryrun'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out['cli'] = cli_case(job['cli'], rank)
        seconds['cli'] = time.perf_counter() - t0
    out['seconds'] = seconds
    out['foreign_modules'] = sorted(
        m for m in sys.modules
        if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'segdistill_tpu'))
    torch.save(out, f'{out_dir}/rank{rank}.pt')


def misbehave(hang_seconds):
    """Rank 1 fails at once, rank 0 waits (the launcher must not)."""
    if int(os.environ['RANK']) == 1:
        raise SystemExit('rank 1 gives up')
    time.sleep(hang_seconds)
