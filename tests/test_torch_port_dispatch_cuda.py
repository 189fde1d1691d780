"""Steps per dispatch on the card: the train step's CUDA graph against the
same step run eagerly, and two replays from one snapshot.

Marked ``cuda``: they skip without a CUDA device. On the card (which has
no JAX, so the repository's conftest is not loaded):

    python -m pytest --noconftest -m cuda tests/test_torch_port_dispatch_cuda.py

A narrow CGD SDModule (MiT-b0 pair, head embed 32, 4 classes; the student
with dropout 0.1 and drop path 0.1, so the replays draw from the step's
generator) trains on a chunk of 3 batches of 2 at 64x64, fp32. The eager
side runs the multi step's single step (``MultiTrainStep.step``: the
optimizer capturable, K1's deterministic backward), so the two compute the
same operations: they are held bitwise (cuDNN deterministic, as
``apis.set_random_seed`` sets it by default). So is a k = 4 run resumed at
an unaligned iteration against the uninterrupted run.

The same model under SGD (momentum 0.9, weight decay) from a fresh
optimizer (the first replay is SGD's first step, its buffers made by the
capture's warm-up and put back to 0) and from a checkpoint's momentum
buffers loaded at an aligned iteration, and under DDP at
NCCL world size 1 (a process group of this process alone: DDP's static
graph, its all-reduce in the graph), each against its eager steps,
bitwise. On a card, torch's SGD and the capturable SGD are compared as
well, from one state (the same product, rounded once, is the aim).

The student's per-block recompute (``with_cp``), bf16, CGD and PD (the
student's attention through K2/K9): the eager steps against the same steps
without the flag, each step's recomputed K10 (and K2) launches counted; a
chunk of replays with the flag against its eager steps; the DDP graph with
the flag at NCCL world size 1; all bitwise.
"""

import copy
import os

import pytest
import torch
import torch.distributed as dist

from segdistill_tpu_torch.apis import init_segmentor_state, prepare_training
from segdistill_tpu_torch.config import Config
from segdistill_tpu_torch.engine import (IterBasedRunner, load_checkpoint,
                                         make_capturable)
from segdistill_tpu_torch.engine.optimizer import (CapturableSGD,
                                                   plain_state_dict)
from segdistill_tpu_torch.parallel.launch import free_port

import torch_port_threads  # noqa: F401  (torch threads a test worker)

pytestmark = pytest.mark.cuda


def _segformer(dropout_ratio=0.0, drop_path_rate=0.0):
    return dict(
        type='EncoderDecoder',
        backbone=dict(type='mit_b0', drop_path_rate=drop_path_rate),
        decode_head=dict(
            type='SegFormerHead', in_channels=[32, 64, 160, 256],
            in_index=[0, 1, 2, 3], feature_strides=[4, 8, 16, 32],
            channels=32, dropout_ratio=dropout_ratio, num_classes=4,
            norm_cfg=dict(type='SyncBN', requires_grad=True),
            align_corners=False, decoder_params=dict(embed_dim=32)),
        test_cfg=dict(mode='whole'))


CONFIG = dict(
    model=dict(type='SDModule',
               cfg_s=_segformer(dropout_ratio=0.1, drop_path_rate=0.1),
               cfg_t=_segformer(), train_cfg={}, test_cfg=dict(mode='whole'),
               distillation=[dict(
                   student_layer='decode_head.linear_pred',
                   teacher_layer='decode_head.linear_pred',
                   loss_name='CGDLoss', loss_config=dict(group_size=2))]),
    optimizer=dict(type='AdamW', lr=1e-3, weight_decay=0.01),
    lr_config=dict(policy='poly', warmup='linear', warmup_iters=2,
                   power=1.0),
    runner=dict(type='IterBasedRunner', max_iters=2000,
                steps_per_dispatch=3))


@pytest.fixture
def cuda():
    """The card, with cuDNN's deterministic algorithms (its weight-gradient
    convolutions may otherwise add in another order each run)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device('cuda')
    torch.backends.cudnn.deterministic = deterministic


SGD = dict(type='SGD', lr=0.01, momentum=0.9, weight_decay=5e-4)


@pytest.fixture
def nccl(cuda):
    """A NCCL process group of this process alone (world size 1)."""
    if dist.is_initialized():
        pytest.skip('a process group exists already')
    os.environ.update(MASTER_ADDR='localhost', MASTER_PORT=str(free_port()))
    dist.init_process_group('nccl', rank=0, world_size=1)
    yield cuda
    dist.destroy_process_group()


def _run(device, optimizer=None, distributed=False, model=None, **runner):
    """(state, the chunk's step) of the model (``model``: another model
    config) from seed 0, its optimizer capturable."""
    cfg = Config(dict(CONFIG, runner=dict(CONFIG['runner'], **runner)))
    if optimizer is not None:
        cfg.optimizer = optimizer
    if model is not None:
        cfg.model = model
    model = init_segmentor_state(cfg, seed=0, device=device)
    state, multi = prepare_training(model, cfg, distributed=distributed)
    make_capturable(state.optimizer, device)
    return state, multi


def _chunk(device):
    g = torch.Generator().manual_seed(3)
    imgs = torch.randn(3, 2, 3, 64, 64, generator=g).to(device)
    gts = torch.randint(0, 4, (3, 2, 64, 64), generator=g).to(device)
    return imgs, gts


def _assert_same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name
    for p, q in zip(a.optimizer.param_groups, b.optimizer.param_groups):
        for x, y in zip(p['params'], q['params']):
            for key, value in b.optimizer.state[y].items():
                assert torch.equal(a.optimizer.state[x][key], value), key


def test_graph_replays_equal_the_eager_steps(cuda):
    """Steps 998-1000 (the shuffle draws a permutation at 1000: a graph of
    its own) as replays and eagerly: the parameters, the optimizer state,
    the BN statistics and the last log vars, bitwise."""
    graphed, multi = _run(cuda)
    eager, twin = _run(cuda)
    imgs, gts = _chunk(cuda)
    graphed.step = eager.step = 997
    got = multi(graphed, imgs, gts)
    for img, gt in zip(imgs, gts):
        want = twin.step(eager, img, gt)
    assert len(multi.graphed.graphs) == 2
    assert graphed.step == eager.step == 1000
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in want.items()}
    _assert_same_state(graphed, eager)


def _remat_model(name, with_cp):
    """CONFIG's model with bf16 backbones and the student's ``with_cp``:
    CGD as it stands, or PD with the student's attention through K2/K9."""
    model = copy.deepcopy(CONFIG['model'])
    for part in ('cfg_s', 'cfg_t'):
        model[part]['backbone']['dtype'] = 'bfloat16'
    model['cfg_s']['backbone']['with_cp'] = with_cp
    if name == 'PD':
        model['cfg_s']['backbone']['fused_attention'] = 'train'
        model['distillation'][0].update(loss_name='PDLoss', loss_config={})
    return model


def _replays_against_eager(device, first, prepare=None, **kwargs):
    """Steps ``first + 1`` to ``first + 3`` as a chunk and eagerly, from
    the same fresh state (``prepare(state)`` on each): (chunk's state, its
    step, eager state)."""
    graphed, multi = _run(device, **kwargs)
    eager, twin = _run(device, **kwargs)
    for state in (graphed, eager) if prepare else ():
        prepare(state)
    imgs, gts = _chunk(device)
    graphed.step = eager.step = first
    got = multi(graphed, imgs, gts)
    for img, gt in zip(imgs, gts):
        want = twin.step(eager, img, gt)
    assert graphed.step == eager.step == first + 3
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in want.items()}
    _assert_same_state(graphed, eager)
    return graphed, multi, eager


def _load_momentum(state):
    """A checkpoint's optimizer state (the plain form, momentum buffers from
    seed 4) loaded into ``state``'s optimizer."""
    saved = plain_state_dict(state.optimizer)
    params = [p for group in state.optimizer.param_groups
              for p in group['params']]
    g = torch.Generator().manual_seed(4)
    saved['state'] = {i: {'momentum_buffer': torch.randn(
        p.shape, generator=g).mul_(1e-3).to(p.device)}
        for i, p in enumerate(params)}
    state.optimizer.load_state_dict(saved)


@pytest.mark.parametrize('loaded', [False, True])
def test_sgd_replays_equal_the_eager_steps(cuda, loaded):
    """SGD, steps 1-3 from a fresh optimizer (the first replay is SGD's
    first step, the momentum buffer the gradient itself) or steps 4-6 from
    momentum buffers loaded at iteration 3, a chunk's end (the capture's
    warm-up must put them back), bitwise."""
    state, multi, _ = _replays_against_eager(
        cuda, 3 if loaded else 0, _load_momentum if loaded else None,
        optimizer=SGD)
    assert type(state.optimizer) is CapturableSGD
    assert all(st['momentum_buffer'].is_cuda
               for st in state.optimizer.state.values())


def test_capturable_sgd_against_torch_sgd(cuda):
    """Two SGD steps (momentum, weight decay) of the model's parameters
    with the same gradients: torch's SGD (its learning rate a float) and
    the capturable SGD (a float64 scalar on the card), from one state.
    On the CPU the two are bitwise equal (``test_torch_port_dispatch.py``);
    on the card torch's foreach ``add_(alpha=-lr)`` rounds the learning
    rate's product with the update and the sum once (a fused multiply-add),
    ``addcmul_`` with a tensor scalar rounds the product first. So each
    step may move a parameter by half a unit of its update's last place
    and one of its own, other than torch's step: the two end within the
    sum of both over the two steps (units of fp32's last place: eps times
    the value; 1% more for the weight decay's share of the difference)."""
    state, _ = _run(cuda, optimizer=SGD)
    params = [p for p in state.model.parameters() if p.requires_grad]
    g = torch.Generator(device=cuda).manual_seed(9)
    grads = [[torch.randn(p.shape, device=cuda, generator=g) * 1e-2
              for p in params] for _ in range(2)]
    results = []
    for capturable in (False, True):
        with torch.no_grad():
            copies = [p.detach().clone().requires_grad_() for p in params]
        opt = torch.optim.SGD(copies, lr=0.0123, momentum=0.9,
                              weight_decay=5e-4)
        if capturable:
            make_capturable(opt, cuda)
        steps = [[p.detach().clone() for p in copies]]
        for step_grads in grads:
            for p, grad in zip(copies, step_grads):
                p.grad = grad.clone()
            opt.step()
            steps.append([p.detach().clone() for p in copies])
        results.append(steps)
    eps = torch.finfo(torch.float32).eps
    worst, differ = 0.0, 0
    for i in range(len(params)):
        p0, p1, p2 = (step[i] for step in results[0])
        limit = 1.01 * eps * ((p1 - p0).abs() / 2 + (p2 - p1).abs() / 2
                              + p1.abs() + p2.abs()) + 1e-44
        diff = (results[1][2][i] - p2).abs()
        differ += int((diff > 0).sum())
        worst = max(worst, float((diff / limit).max()))
    assert worst <= 1.0, f'{worst:.3f} of the limit ({differ} differ)'
    print(f'capturable SGD against torch SGD on the card: {differ} '
          f'elements differ, at most {worst:.3f} of the limit')


def test_ddp_graph_replays_equal_the_eager_ddp_steps(nccl):
    """At NCCL world size 1: the DDP step (static graph, built on a side
    stream) captured with its all-reduce, steps 998-1000 (two graphs),
    against the eager DDP steps; SGD the same from step 0."""
    _, multi, _ = _replays_against_eager(nccl, 997, distributed=True)
    assert len(multi.graphed.graphs) == 2
    assert multi.forward_train.static_graph
    _replays_against_eager(nccl, 0, distributed=True, optimizer=SGD)


# launches a step that the narrow B0 student's recompute adds: its blocks'
# LayerNorms (K10), their SRA attention under fused_attention='train' (K2)
RECOMPUTED = {'CGD': {'layer_norm_fwd': 22},
              'PD': {'layer_norm_fwd': 22, 'sra_attn': 8}}


@pytest.mark.parametrize('name', sorted(RECOMPUTED))
def test_with_cp_steps_equal_the_steps_without(cuda, name):
    """bf16, steps 998-1000 eagerly (the multi step's single step) with
    the student's blocks recomputed and without: the parameters, the
    optimizer state, the BN statistics and each step's log vars bitwise;
    each step with the flag launches the recompute's K10 (and PD's K2)
    beside the step's own."""
    from segdistill_tpu_torch.ops import layer_norm, sra_attn
    kernels = [layer_norm.FWD_KERNEL, sra_attn.KERNEL]
    imgs, gts = _chunk(cuda)
    runs = {}
    for with_cp in (False, True):
        state, multi = _run(cuda, model=_remat_model(name, with_cp))
        state.step = 997
        logs, counts = [], []
        for img, gt in zip(imgs, gts):
            before = [k.launches for k in kernels]
            logs.append({k: float(v) for k, v in
                         multi.step(state, img, gt).items()})
            counts.append({k.name: k.launches - b
                           for k, b in zip(kernels, before)})
        runs[with_cp] = state, logs, counts
    assert runs[True][1] == runs[False][1]
    _assert_same_state(runs[True][0], runs[False][0])
    for plain, recomputed in zip(runs[False][2], runs[True][2]):
        assert recomputed == {k: n + RECOMPUTED[name].get(k, 0)
                              for k, n in plain.items()}


@pytest.mark.parametrize('name', sorted(RECOMPUTED))
def test_with_cp_replays_equal_the_eager_steps(cuda, name):
    """bf16 with the flag: steps 998-1000 as a chunk of replays (the
    recompute and its kernels inside the graph's backward) against the
    same steps run eagerly, bitwise."""
    _, multi, _ = _replays_against_eager(
        cuda, 997, model=_remat_model(name, True))
    assert len(multi.graphed.graphs) == (2 if name == 'CGD' else 1)


def test_ddp_graph_with_cp_equals_the_eager_ddp_steps(nccl):
    """The DDP step (static graph, NCCL at world size 1) with the
    student's blocks recomputed, captured and replayed, against the eager
    DDP steps, bitwise."""
    _, multi, _ = _replays_against_eager(
        nccl, 997, distributed=True, model=_remat_model('CGD', True))
    assert multi.forward_train.static_graph


def test_two_replays_from_one_snapshot_are_equal(cuda):
    state, multi = _run(cuda)
    imgs, gts = _chunk(cuda)
    multi(state, imgs, gts)  # captures and trains 3 steps
    graphed = multi.graphed
    saved = [(t, t.detach().clone()) for t in graphed._state_tensors()]
    results = []
    for _ in range(2):
        graphed._restore(saved)
        state.step = 3
        log_vars = multi(state, imgs, gts)
        results.append(({k: float(v) for k, v in log_vars.items()},
                        {k: v.clone() for k, v in
                         state.model.state_dict().items()}))
    assert results[0][0] == results[1][0]
    for name, value in results[0][1].items():
        assert torch.equal(results[1][1][name], value), name


def test_resume_at_an_unaligned_step(cuda, tmp_path):
    """k = 4: 11 steps in one run (chunks 1-4 and 5-8, then 9-11 one by
    one) against 5 steps (a chunk, then step 5), saved, loaded into a fresh
    state and run on to 11 (a chunk 6-9, then 10 and 11). The parameters,
    the optimizer state and the BN statistics end bitwise equal, and after
    the resume each group's learning rate is a float64 scalar on the card,
    equal to the uninterrupted run's (a learning rate left on the host
    would be fixed at its value when the graph was captured)."""
    g = torch.Generator().manual_seed(5)
    batches = [{'img': torch.randn(2, 3, 64, 64, generator=g),
                'gt_semantic_seg': torch.randint(0, 4, (2, 64, 64),
                                                 generator=g)}
               for _ in range(11)]

    def train(state, multi, max_iters, work_dir=None):
        IterBasedRunner(multi, state, max_iters, log_interval=100,
                        work_dir=work_dir, checkpoint_interval=1000).run(
            iter(batches[state.step:]))

    whole, multi = _run(cuda, steps_per_dispatch=4)
    train(whole, multi, 11)
    first, multi = _run(cuda, steps_per_dispatch=4)
    train(first, multi, 5, str(tmp_path))
    resumed, multi = _run(cuda, steps_per_dispatch=4)
    load_checkpoint(str(tmp_path), resumed)
    assert resumed.step == 5
    train(resumed, multi, 11)
    assert resumed.step == whole.step == 11
    _assert_same_state(resumed, whole)
    for p, q in zip(resumed.optimizer.param_groups,
                    whole.optimizer.param_groups):
        assert p['lr'].is_cuda and p['lr'].dtype == torch.float64
        assert torch.equal(p['lr'], q['lr'])
        assert p['capturable'] and q['capturable']


class _Switch(torch.nn.Module):
    """Two branches, one taken a step: the other's parameters unused."""

    def __init__(self):
        super().__init__()
        self.a, self.b, self.c = (torch.nn.Linear(16, 16) for _ in range(3))

    def forward(self, x, first):
        return (self.b if first else self.c)(self.a(x)).square().mean()


def _ddp_switch(device, **kwargs):
    side = torch.cuda.Stream(device)
    with torch.cuda.stream(side):
        ddp = torch.nn.parallel.DistributedDataParallel(
            _Switch().to(device), device_ids=[device.index or 0], **kwargs)
    torch.cuda.current_stream(device).wait_stream(side)
    return ddp


def test_ddp_cannot_follow_a_changing_used_set(nccl):
    """Why a DDP without its static graph has no graph (``cuda_graph.
    check_ddp_capture``): DDP's search for unused parameters copies its map
    from the host inside the backward, which a capture refuses (the second
    half). DDP's static graph raises at the first step whose used set
    differs (the first half): a module whose used set switches, which a
    random ensemble is not (its one entry's adapters take part at every
    step, its teachers are frozen)."""
    x = torch.randn(4, 16, device=nccl)
    ddp = _ddp_switch(nccl, static_graph=True)
    ddp(x, True).backward()
    with pytest.raises(RuntimeError, match='graph has changed'):
        ddp(x, False).backward()
    ddp = _ddp_switch(nccl, find_unused_parameters=True)
    ddp._set_ddp_runtime_logging_sample_rate(2**31 - 1)
    stream = torch.cuda.Stream(nccl)
    stream.wait_stream(torch.cuda.current_stream(nccl))
    with torch.cuda.stream(stream):
        for i in range(11):  # DDP's timed iterations before a capture
            ddp(x, i % 2 == 0).backward()
    torch.cuda.current_stream(nccl).wait_stream(stream)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match='Cannot copy between CPU and '
                       'CUDA tensors during CUDA graph capture'):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=stream,
                              capture_error_mode='thread_local'):
            ddp(x, False).backward()
