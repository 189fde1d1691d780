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
"""

import pytest
import torch

from segdistill_tpu_torch.apis import init_segmentor_state, prepare_training
from segdistill_tpu_torch.config import Config
from segdistill_tpu_torch.engine import (IterBasedRunner, load_checkpoint,
                                         make_capturable)

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


def _run(device, **runner):
    """(state, the chunk's step) of the model from seed 0, its optimizer
    capturable."""
    cfg = Config(dict(CONFIG, runner=dict(CONFIG['runner'], **runner)))
    model = init_segmentor_state(cfg, seed=0, device=device)
    state, multi = prepare_training(model, cfg)
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
