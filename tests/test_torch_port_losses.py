"""The port's loss side against the JAX package, fp32 on the CPU: the
group-KL (K3/K4) and seg-CE (K5/K6) wrappers against the JAX Pallas
kernels in interpret mode (as ``tests/test_pallas_kernel.py`` and
``tests/test_pallas_ce.py`` run them), the distillation losses against
JAX's ``__call__`` (which takes its unfused path on the CPU), and the
head's ``losses()``.

On the CPU the port's wrappers run their plain versions. Inputs are seeded
numpy arrays given to both sides. Tolerances: losses at rtol 1e-5 (the
same fp32 formula summed in another order), gradients at rtol 1e-4 /
atol 1e-6 (gradient entries are ~1e-3); bfloat16 gradients are rounded
once from fp32 values that agree to ~1e-7, so they may sit one bf16 step
(2^-7 relative) apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segdistill_tpu.distill import losses as jax_losses
from segdistill_tpu.models.decode_heads.decode_head import (
    BaseDecodeHead as JaxBaseDecodeHead)
from segdistill_tpu.models.decode_heads.segformer_head import (
    SegFormerHead as JaxSegFormerHead)
from segdistill_tpu.models.segmentors import parse_losses as jax_parse
from segdistill_tpu.ops.pallas import fused_group_kl as jax_group_kl
from segdistill_tpu.ops.pallas import (
    fused_group_kl_shuffled as jax_group_kl_shuffled)
from segdistill_tpu.ops.pallas.seg_ce import fused_seg_ce as jax_seg_ce
from segdistill_tpu_torch.distill import DISTILL_LOSSES, DistillationLoss
from segdistill_tpu_torch.models.decode_heads import (BaseDecodeHead,
                                                      SegFormerHead)
from segdistill_tpu_torch.models.segmentors import parse_losses
from segdistill_tpu_torch.ops import group_kl, seg_ce
from segdistill_tpu_torch.ops.group_kl import (fused_group_kl,
                                               fused_group_kl_shuffled)
from segdistill_tpu_torch.ops.seg_ce import fused_seg_ce

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
BF16_GRAD_RTOL = 2.0 ** -7


def _maps(b, c, h, w, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, c, h, w) * 3).astype(np.float32) for _ in range(2)]


def _torch(a, dtype=torch.float32, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype) \
        .requires_grad_(grad)


# ---------------------------------------------------------------- group KL

GROUP_KL_CASES = [
    # (ratio, channels, group size, shuffled, dtype)
    (1, 7, 3, True, 'float32'),
    (2, 7, 3, True, 'float32'),      # C=7, g=3: one -1e9 pad channel
    (4, 7, 3, True, 'float32'),
    (2, 6, 3, False, 'float32'),     # fused_group_kl, no pad
    (4, 5, 2, False, 'float32'),
    (2, 6, 1, False, 'float32'),     # group size 1: the CD loss
    (2, 6, 3, True, 'bfloat16'),
]


@pytest.fixture(scope='module', params=GROUP_KL_CASES,
                ids=lambda c: f'r{c[0]}-c{c[1]}-g{c[2]}-'
                              f'{"perm" if c[3] else "id"}-{c[4]}')
def group_kl_case(request):
    """One case, with the JAX kernel's loss and dxs (interpret mode) for
    3 * loss, on inputs in the case's dtype."""
    ratio, c, g, shuffled, dtype = request.param
    xs, xt = _maps(2, c, 6, 6, seed=ratio * 10 + c)
    jdt = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
    jxs, jxt = jnp.asarray(xs, jdt), jnp.asarray(xt, jdt)
    out_hw = (6 * ratio, 6 * ratio)
    perm = np.random.RandomState(c).permutation(c).astype(np.int32) \
        if shuffled else None

    def f(a):
        if shuffled:
            return 3.0 * jax_group_kl_shuffled(a, jxt, jnp.asarray(perm),
                                               out_hw, g, 2.0, True)
        return 3.0 * jax_group_kl(a, jxt, out_hw, g, 2.0, True)
    loss, dxs = jax.value_and_grad(f)(jxs)
    return dict(xs=np.asarray(jxs.astype(jnp.float32)),
                xt=np.asarray(jxt.astype(jnp.float32)), perm=perm,
                out_hw=out_hw, g=g, dtype=getattr(torch, dtype),
                loss=float(loss), dxs=np.asarray(dxs.astype(jnp.float32)))


def _port_group_kl(case):
    xs = _torch(case['xs'], case['dtype'], grad=True)
    xt = _torch(case['xt'], case['dtype'])
    if case['perm'] is not None:
        loss = 3.0 * fused_group_kl_shuffled(
            xs, xt, torch.from_numpy(case['perm']), case['out_hw'],
            case['g'], 2.0)
    else:
        loss = 3.0 * fused_group_kl(xs, xt, case['out_hw'], case['g'], 2.0)
    loss.backward()
    return loss, xs.grad


def test_group_kl_loss_matches_jax_kernel(group_kl_case):
    loss, _ = _port_group_kl(group_kl_case)
    assert loss.dtype == torch.float32 and loss.ndim == 0
    assert loss.item() == pytest.approx(group_kl_case['loss'],
                                        rel=LOSS_RTOL)


def test_group_kl_gradient_matches_jax_kernel(group_kl_case):
    _, dxs = _port_group_kl(group_kl_case)
    assert dxs.dtype == group_kl_case['dtype']
    rtol = BF16_GRAD_RTOL if dxs.dtype == torch.bfloat16 else GRAD_RTOL
    np.testing.assert_allclose(dxs.float().numpy(), group_kl_case['dxs'],
                               rtol=rtol, atol=GRAD_ATOL)


def test_group_kl_identity_perm_and_teacher_gradient():
    """The unshuffled loss is the shuffled one at the identity, and the
    teacher gets no gradient."""
    xs, xt = (_torch(a, grad=True) for a in _maps(1, 6, 5, 5, seed=3))
    a = fused_group_kl_shuffled(xs, xt, torch.arange(6), (10, 10), 3, 1.5)
    b = fused_group_kl(xs, xt, (10, 10), 3, 1.5)
    assert a.item() == b.item()
    a.backward()
    assert xt.grad is None and xs.grad is not None


def test_group_kl_any_output_size():
    """No integer-ratio gate: a non-integer upsample and a downsample match
    the plain version, which the JAX reference formula also is."""
    xs, xt = (_torch(a) for a in _maps(2, 7, 9, 11, seed=4))
    perm = torch.randperm(7, generator=torch.Generator().manual_seed(0))
    for out_hw in ((23, 17), (5, 6)):
        got = fused_group_kl_shuffled(xs, xt, perm, out_hw, 3, 2.0)
        want = group_kl.group_kl_plain(xs, xt, perm, out_hw, 3, 2.0)
        assert got.item() == want.item()


# ----------------------------------------------------------------- seg CE

def _ce_data(c=7, h=8, ratio=2, seed=0, all_ignored=False):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(2, c, h, h) * 3).astype(np.float32)
    labels = rng.randint(0, c, (2, h * ratio, h * ratio)).astype(np.int64)
    labels[0, 0, :3] = 255
    labels[1, 2:4, 1] = 255
    if all_ignored:
        labels[:] = 255
    return logits, labels, (h * ratio, h * ratio)


@pytest.fixture(scope='module', params=[(1, False), (2, False), (4, False),
                                        (2, True)],
                ids=['r1', 'r2', 'r4', 'all-ignored'])
def seg_ce_case(request):
    ratio, all_ignored = request.param
    logits, labels, out_hw = _ce_data(ratio=ratio, seed=ratio,
                                      all_ignored=all_ignored)
    jl = jnp.asarray(labels.astype(np.int32))

    def f(z):
        ce, correct = jax_seg_ce(z, jl, out_hw, 7, 255, True)
        return ce / labels.size, (ce, correct)
    dz, (ce, correct) = jax.grad(f, has_aux=True)(jnp.asarray(logits))
    return dict(logits=logits, labels=labels, out_hw=out_hw, ce=float(ce),
                correct=float(correct), dz=np.asarray(dz))


def test_seg_ce_matches_jax_kernel(seg_ce_case):
    z = _torch(seg_ce_case['logits'], grad=True)
    labels = torch.from_numpy(seg_ce_case['labels'])
    ce, correct = fused_seg_ce(z, labels, seg_ce_case['out_hw'], 7, 255)
    assert not correct.requires_grad
    assert ce.item() == pytest.approx(seg_ce_case['ce'], rel=LOSS_RTOL)
    assert correct.item() == seg_ce_case['correct']
    (ce / labels.numel()).backward()
    np.testing.assert_allclose(z.grad.numpy(), seg_ce_case['dz'],
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_seg_ce_all_ignored_is_zero():
    logits, labels, out_hw = _ce_data(all_ignored=True)
    z = _torch(logits, grad=True)
    ce, correct = fused_seg_ce(z, torch.from_numpy(labels), out_hw, 7, 255)
    ce.backward()
    assert ce.item() == 0.0 and correct.item() == 0.0
    assert not z.grad.any()


def test_cpu_tensors_never_launch_the_loss_kernels():
    logits, labels, out_hw = _ce_data()
    fused_seg_ce(_torch(logits), torch.from_numpy(labels), out_hw, 7, 255)
    xs, xt = (_torch(a) for a in _maps(1, 4, 3, 3, seed=5))
    fused_group_kl(xs, xt, (6, 6), 2, 1.0)
    for kernel in (group_kl.FWD_KERNEL, group_kl.BWD_KERNEL,
                   seg_ce.FWD_KERNEL, seg_ce.BWD_KERNEL):
        assert kernel.launches == 0 and not kernel.loaded


# ------------------------------------------------- distillation losses

def _jax_criterion(name, cfg):
    return jax_losses.DISTILL_LOSSES[name](**cfg)


@pytest.mark.parametrize('name,cfg', [
    ('CGDLoss', {}),
    ('CGDLoss', {'group_size': 3, 'alpha': 2, 'tau': 1.5}),  # C=7: a pad
    ('CGDLossWS', {}),
    ('CDLoss', {}),
    # not the fused form (align_corners resize): the plain pipeline
    ('KLDLoss', {'alpha': 2, 'tau': 2,
                 'resize_config': {'mode': 'bilinear', 'align_corners': True},
                 'shuffle_config': {'interval': 2},
                 'transform_config': {'loss_type': 'channel',
                                      'group_size': 2}}),
    # no transform: a softmax over the last axis of the NCHW maps
    ('KLDLoss', {'tau': 3, 'resize_config': {'mode': 'bilinear',
                                             'align_corners': False}}),
])
@pytest.mark.parametrize('step', [0, 1, 1000])
def test_distill_loss_matches_jax(name, cfg, step):
    """The JAX permutation of ``step`` is injected; the value and the
    student's gradient match JAX's unfused ``__call__``."""
    xs, xt = _maps(2, 7, 5, 6, seed=step % 97)
    gt = np.random.RandomState(7).randint(0, 7, (2, 10, 12))
    jcrit = _jax_criterion(name, cfg)
    rng = jax.random.key(3)
    perm = None
    if getattr(jcrit, 'shuffle_config', None):
        perm = torch.from_numpy(np.array(jcrit._shuffle_idx(7, step, rng)))
    want, dwant = jax.value_and_grad(
        lambda a: jcrit(a, jnp.asarray(xt), jnp.asarray(gt), step,
                        rng=rng))(jnp.asarray(xs))
    crit = DISTILL_LOSSES[name](**cfg)
    a = _torch(xs, grad=True)
    got = crit(a, _torch(xt), torch.from_numpy(gt), step, perm=perm)
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=LOSS_RTOL, abs=1e-7)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(dwant),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_alpha_schedule_matches_jax():
    """alpha across the warmup and early-decay edges, for every mode."""
    steps = [0, 1, 1000, 1999, 2000, 2001, 50000, 110000, 110001, 115000,
             119999, 120000, 130000]
    configs = [('CGDLossWS', {}), ('CGDLoss', {})]
    for mode in ('linear', 'exp', 'jump'):
        configs.append(('KLDLoss', {
            'alpha': 3,
            'warmup_config': {'mode': mode, 'warmup_iters': 2000},
            'earlydecay_config': {'mode': mode, 'earlydecay_start': 110000,
                                  'earlydecay_end': 120000}}))
    for name, cfg in configs:
        jcrit, crit = _jax_criterion(name, cfg), DISTILL_LOSSES[name](**cfg)
        for step in steps:
            assert crit.alpha_at(step) == pytest.approx(
                float(jcrit.alpha_at(step)), rel=1e-6, abs=1e-9), \
                (name, cfg, step)


def test_shuffle_draws_only_on_interval_steps():
    crit = DISTILL_LOSSES['CGDLoss']()
    assert torch.equal(crit.shuffle_idx(150, 999), torch.arange(150))
    drawn = [crit.shuffle_idx(150, 1000, torch.Generator().manual_seed(s))
             for s in (0, 0, 1)]
    assert torch.equal(drawn[0], drawn[1])
    assert not torch.equal(drawn[0], drawn[2])
    assert sorted(drawn[0].tolist()) == list(range(150))
    with pytest.raises(ValueError, match='Generator'):
        crit.shuffle_idx(150, 2000)


@pytest.mark.parametrize('name', ['PDLoss', 'ATLoss', 'IFVDLoss'])
def test_unported_losses_raise_with_the_registry(name):
    """An unknown loss name raises with the registry, which now lists
    ``name``; ``name`` itself builds."""
    entry = dict(student_layer='decode_head.linear_pred',
                 teacher_layer='decode_head.linear_pred', loss_config={})
    with pytest.raises(KeyError, match=f'registered: .*{name!r}'):
        DistillationLoss([dict(entry, loss_name=name + 'Typo')])
    loss = DistillationLoss([dict(entry, loss_name=name)])
    assert type(loss.entries[0]['criterion']) is DISTILL_LOSSES[name]


# ------------------------------------------------------------ head losses

def _head_logits(c=5, seed=0):
    rng = np.random.RandomState(seed)
    z = (rng.randn(2, c, 6, 7) * 2).astype(np.float32)
    y = rng.randint(0, c, (2, 24, 28))
    y[0, :2] = 255
    return z, y


@pytest.mark.parametrize('kind', ['segformer', 'segformer_align_corners',
                                  'class_weight', 'default'])
def test_head_losses_match_jax(kind):
    """SegFormerHead's CE (reduction 'none', the fused path) and the plain
    resize -> CE -> accuracy path (align_corners, class weights) against
    the JAX heads, through ``parse_losses``."""
    z, y = _head_logits()
    kw = dict(num_classes=5, in_channels=[8, 8, 8, 8], channels=8,
              in_index=[0, 1, 2, 3])
    if kind.startswith('segformer'):
        kw['align_corners'] = kind.endswith('corners')
        jhead, head = JaxSegFormerHead(**kw), SegFormerHead(**kw)
    else:
        kw['loss_decode'] = dict(type='CrossEntropyLoss',
                                 class_weight=[1.0, 2.0, 0.5, 1.0, 3.0]) \
            if kind == 'class_weight' else None
        jhead, head = JaxBaseDecodeHead(**kw), BaseDecodeHead(**kw)
    want = jhead.losses(jnp.asarray(z.transpose(0, 2, 3, 1)),
                        jnp.asarray(y))
    got = head.losses(_torch(z), torch.from_numpy(y))
    _, want_log = jax_parse(want)
    _, got_log = parse_losses(got)
    assert got_log.keys() == want_log.keys()
    for k in want_log:
        assert got_log[k].item() == pytest.approx(float(want_log[k]),
                                                  rel=LOSS_RTOL), k


def test_parse_losses_semantics():
    """Means of tensors, sums of lists, every 'loss' key in the total."""
    losses = {'decode.loss_seg': torch.tensor([[1.0, 3.0]]),
              'decode.acc_seg': torch.tensor(50.0),
              'loss_x': [torch.tensor([1.0, 2.0]), torch.tensor(4.0)]}
    total, log_vars = parse_losses(losses)
    assert log_vars['decode.loss_seg'].item() == 2.0
    assert log_vars['loss_x'].item() == 5.5
    assert total.item() == log_vars['loss'].item() == 7.5
