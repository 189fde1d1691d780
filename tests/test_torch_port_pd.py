"""The port's PD distillation slice against the JAX package, fp32 on the
CPU: the pixel-KL wrapper (K7/K8) against the JAX Pallas kernel in
interpret mode (as ``tests/test_pallas_pixel.py`` runs it), the
differentiable SRA attention (K2 + K9) against JAX's
``sra_attention_train`` in interpret mode (as ``tests/test_sra_attn.py``
runs it), the PD/AT/IFVD losses and the 'pixel' transform against JAX's
``__call__`` (its unfused path on the CPU), and a small SDModule with the
PD entry and the student's ``fused_attention='train'`` against JAX's
``forward_train`` and ``build_train_step`` (JAX runs its einsum attention
on the CPU, where its fused gate is off: that is the oracle).

On the CPU the port's wrappers run their plain versions. Inputs are seeded
numpy arrays given to both sides. Tolerances: losses at rtol 1e-5 (the
same fp32 formula summed in another order); gradients at rtol 1e-4 with
an atol of 1e-6 absolute (losses) or 1e-5 of the largest entry
(attention, whose gradients are O(1)); the SDModule at the fixtures'
``RTOL, ATOL``, as the CGD slice is held.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segdistill_tpu.distill import losses as jax_losses
from segdistill_tpu.engine import build_lr_schedule as jax_lr_schedule
from segdistill_tpu.engine import build_optimizer as jax_build_optimizer
from segdistill_tpu.engine import build_train_step as jax_train_step
from segdistill_tpu.engine import create_train_state
from segdistill_tpu.models import build_segmentor as build_jax_segmentor
from segdistill_tpu.models.segmentors import parse_losses as jax_parse
from segdistill_tpu.ops.pallas.pixel_kl import fused_pixel_kl as jax_pixel_kl
from segdistill_tpu.ops.pallas.sra_attn import (
    sra_attention_train as jax_sra_train)
from segdistill_tpu_torch.convert import state_dict_from_jax
from segdistill_tpu_torch.distill import DISTILL_LOSSES
from segdistill_tpu_torch.engine import (TrainState, build_lr_schedule,
                                         build_optimizer, build_train_step)
from segdistill_tpu_torch.models import build_segmentor
from segdistill_tpu_torch.models.segmentors import parse_losses
from segdistill_tpu_torch.ops import pixel_kl, sra_attn
from segdistill_tpu_torch.ops.pixel_kl import fused_pixel_kl, pixel_kl_plain
from segdistill_tpu_torch.ops.sra_attn import sra_attention_train

from test_torch_port_train import (LR_CONFIG, MAX_ITERS, OPTIMIZER,
                                   key_bias_mask, trajectory_optimizer)
from torch_port_fixtures import (ATOL, NUM_CLASSES, RTOL, nhwc_to_nchw,
                                 random_jax_variables, segformer_cfg)

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
ATTN_FWD_TOL = 2e-5
ATTN_GRAD_ATOL_SHARE = 1e-5
PD = dict(student_layer='decode_head.linear_pred',
          teacher_layer='decode_head.linear_pred', loss_name='PDLoss',
          loss_config={})
PD_KEY = 'loss_decode_head.linear_pred<->decode_head.linear_pred_other'


def _torch(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _maps(b, c, h, w, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, c, h, w) * 3).astype(np.float32) for _ in range(2)]


# ---------------------------------------------------------------- pixel KL

@pytest.fixture(scope='module', params=[(1, 1.0), (2, 1.0), (4, 2.0)],
                ids=['r1', 'r2', 'r4-tau2'])
def pixel_case(request):
    """C = 7, not a multiple of the JAX kernel's 32-channel tile; the JAX
    kernel's loss and dxs (interpret mode) for 3 * loss."""
    ratio, tau = request.param
    xs, xt = _maps(2, 7, 8, 8, seed=ratio)
    out_hw = (8 * ratio, 8 * ratio)
    loss, dxs = jax.value_and_grad(
        lambda a: 3.0 * jax_pixel_kl(a, jnp.asarray(xt), out_hw, tau, True))(
        jnp.asarray(xs))
    return dict(xs=xs, xt=xt, out_hw=out_hw, tau=tau, loss=float(loss),
                dxs=np.asarray(dxs))


def test_pixel_kl_matches_jax_kernel(pixel_case):
    c = pixel_case
    xs, xt = _torch(c['xs'], grad=True), _torch(c['xt'], grad=True)
    loss = 3.0 * fused_pixel_kl(xs, xt, c['out_hw'], c['tau'])
    assert loss.dtype == torch.float32 and loss.ndim == 0
    assert loss.item() == pytest.approx(c['loss'], rel=LOSS_RTOL)
    plain = 3.0 * pixel_kl_plain(_torch(c['xs']), _torch(c['xt']),
                                 c['out_hw'], c['tau'])
    assert plain.item() == pytest.approx(c['loss'], rel=LOSS_RTOL)
    loss.backward()
    assert xt.grad is None  # the teacher gets no gradient
    np.testing.assert_allclose(xs.grad.numpy(), c['dxs'], rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    for kernel in (pixel_kl.FWD_KERNEL, pixel_kl.BWD_KERNEL):
        assert kernel.launches == 0 and not kernel.loaded


def test_pixel_kl_any_output_size():
    """No integer-ratio gate: a non-integer upsample and a downsample match
    the plain version, and the gradient is the plain one's."""
    xs, xt = _maps(2, 7, 9, 11, seed=4)
    for out_hw in ((23, 17), (5, 6)):
        a, b = _torch(xs, grad=True), _torch(xs, grad=True)
        got = fused_pixel_kl(a, _torch(xt), out_hw, 1.5)
        want = pixel_kl_plain(b, _torch(xt), out_hw, 1.5)
        assert got.item() == want.item()
        got.backward()
        want.backward()
        assert torch.equal(a.grad, b.grad)


# ------------------------------------------------------ SRA attention train

@pytest.fixture(scope='module', params=[(2, 1, 256, 32), (1, 2, 512, 32),
                                        (1, 1, 1024, 64)],
                ids=lambda s: 'x'.join(map(str, s)))
def sra_case(request):
    """JAX's custom-VJP kernel (interpret mode) at M = 256: its output and
    dq, dk, dv for the cotangent ``cot``."""
    B, H, N, d = request.param
    rs = np.random.RandomState(0)
    q, k, v = (rs.randn(B, H, n, d).astype(np.float32) for n in (N, 256, 256))
    cot = rs.randn(B, H, N, d).astype(np.float32)
    scale = d ** -0.5
    out, vjp = jax.vjp(lambda a, b, c: jax_sra_train(a, b, c, scale, True),
                       *map(jnp.asarray, (q, k, v)))
    grads = vjp(jnp.asarray(cot))
    return dict(qkv=(q, k, v), cot=cot, scale=scale, out=np.asarray(out),
                grads=[np.asarray(g) for g in grads])


def test_sra_attention_train_matches_jax(sra_case):
    c = sra_case
    qkv = [_torch(a, grad=True) for a in c['qkv']]
    out = sra_attention_train(*qkv, c['scale'])
    np.testing.assert_allclose(out.detach().numpy(), c['out'],
                               rtol=ATTN_FWD_TOL, atol=ATTN_FWD_TOL)
    (out * _torch(c['cot'])).sum().backward()
    for name, t, want in zip(('dq', 'dk', 'dv'), qkv, c['grads']):
        assert t.grad.shape == t.shape, name
        np.testing.assert_allclose(
            t.grad.numpy(), want, rtol=GRAD_RTOL,
            atol=ATTN_GRAD_ATOL_SHARE * np.abs(want).max(), err_msg=name)
    for kernel in (sra_attn.KERNEL, sra_attn.BWD_KERNEL):
        assert kernel.launches == 0 and not kernel.loaded


# bf16 inputs: the JAX kernel and the port's plain backward both recompute P
# in fp32, round the normalised P and dS to bf16 as operands and sum in
# fp32; what is left is the order of the fp32 sums, which can move a P or a
# dS across one bf16 rounding boundary (a step of 2^-8 of it, entering the
# sum over up to 256 keys or rows as noise: 2^-9 of the gradient's rms,
# generously), and the final rounding of the gradient to bf16 (one step,
# 2^-7 of its magnitude).
BF16_TOL_REL = 2.0 ** -7
BF16_TOL_RMS = 2.0 ** -9


@pytest.fixture(scope='module', params=[(1, 256, 256, 32), (2, 256, 256, 64)],
                ids=lambda s: 'x'.join(map(str, s)))
def sra_bf16_case(request):
    """JAX's custom-VJP kernel (interpret mode) on bf16 inputs: its output
    and dq, dk, dv for a bf16 cotangent."""
    H, N, M, d = request.param
    rs = np.random.RandomState(2)
    arrays = [rs.randn(2, H, n, d).astype(np.float32)
              for n in (N, M, M, N)]
    tensors = [torch.from_numpy(a).bfloat16() for a in arrays]
    q, k, v, cot = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                    for t in tensors)
    scale = d ** -0.5
    out, vjp = jax.vjp(lambda a, b, c: jax_sra_train(a, b, c, scale, True),
                       q, k, v)
    grads = vjp(cot)
    assert out.dtype == jnp.bfloat16
    assert all(g.dtype == jnp.bfloat16 for g in grads)
    return dict(qkv=tensors[:3], cot=tensors[3], scale=scale,
                out=np.asarray(out.astype(jnp.float32)),
                grads=[np.asarray(g.astype(jnp.float32)) for g in grads])


def _bf16_close(got, want, name):
    diff = np.abs(got.float().numpy() - want)
    tol = BF16_TOL_REL * np.abs(want) + BF16_TOL_RMS * np.sqrt(
        np.mean(want ** 2))
    assert (diff <= tol).all(), (name, (diff / tol).max())


def test_sra_attention_train_bf16_matches_jax(sra_bf16_case):
    """On bf16 CPU tensors the forward rounds P and the written-out plain
    backward rounds P and dS, as the JAX kernel does."""
    c = sra_bf16_case
    qkv = [t.clone().requires_grad_() for t in c['qkv']]
    out = sra_attention_train(*qkv, c['scale'])
    assert out.dtype == torch.bfloat16
    _bf16_close(out.detach(), c['out'], 'out')
    out.backward(c['cot'])
    for name, t, want in zip(('dq', 'dk', 'dv'), qkv, c['grads']):
        assert t.grad.shape == t.shape and t.grad.dtype == torch.bfloat16
        _bf16_close(t.grad, want, name)
    direct = sra_attn.sra_attention_backward_plain(*c['qkv'], c['cot'],
                                                   c['scale'])
    assert all(torch.equal(a, t.grad) for a, t in zip(direct, qkv))
    for kernel in (sra_attn.KERNEL, sra_attn.BWD_KERNEL):
        assert kernel.launches == 0 and not kernel.loaded


def test_sra_backward_plain_is_the_gradient_in_fp32():
    """For fp32 inputs nothing is rounded: the written-out backward is the
    autograd gradient of the plain version."""
    rs = np.random.RandomState(3)
    q, k, v = (_torch(rs.randn(2, 2, n, 16), grad=True) for n in (40, 10, 10))
    g = _torch(rs.randn(2, 2, 40, 16))
    want = torch.autograd.grad(sra_attn.sra_attention_plain(q, k, v, 0.25),
                               (q, k, v), g)
    got = sra_attn.sra_attention_backward_plain(q, k, v, g, 0.25)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-6)


def test_sra_attention_train_without_gradient_is_the_forward():
    """Under no_grad (a frozen teacher) it is the forward-only call, and it
    carries a gradient to whichever of q, k, v needs one."""
    rs = np.random.RandomState(1)
    q, k, v = (_torch(rs.randn(1, 2, 40, 16)) for _ in range(3))
    with torch.no_grad():
        out = sra_attention_train(q, k, v, 0.25)
    assert not out.requires_grad
    assert torch.equal(out, sra_attn.sra_attention_plain(q, k, v, 0.25))
    v.requires_grad_()
    sra_attention_train(q, k, v, 0.25).sum().backward()
    assert v.grad is not None and q.grad is None and k.grad is None


# ------------------------------------------------- distillation losses

@pytest.mark.parametrize('name,cfg,teacher_hw', [
    ('PDLoss', {}, (5, 6)),
    ('ATLoss', {}, (5, 6)),
    ('IFVDLoss', {}, (10, 12)),            # the teacher is resized down
    # 'pixel' without a resize: the fused form at the maps' own size
    ('KLDLoss', {'tau': 1.5, 'transform_config': {'loss_type': 'pixel'}},
     (5, 6)),
    # not the fused form (align_corners resize): the plain pipeline, with a
    # channel shuffle
    ('KLDLoss', {'alpha': 2, 'tau': 2,
                 'resize_config': {'mode': 'bilinear', 'align_corners': True},
                 'shuffle_config': {'interval': 2},
                 'transform_config': {'loss_type': 'pixel'}}, (5, 6)),
])
@pytest.mark.parametrize('step', [0, 1])
def test_pixel_losses_match_jax(name, cfg, teacher_hw, step):
    """Value and student gradient against JAX's ``__call__`` on the same
    maps and labels (some ignored, some classes absent); the JAX
    permutation of ``step`` is injected where the loss shuffles."""
    rng = np.random.RandomState(10 + step)
    xs = (rng.randn(2, 7, 5, 6) * 3).astype(np.float32)
    xt = (rng.randn(2, 7, *teacher_hw) * 3).astype(np.float32)
    gt = rng.randint(0, 5, (2, 10, 12))
    gt[0, :3] = 255
    jcrit = jax_losses.DISTILL_LOSSES[name](**cfg)
    key = jax.random.key(3)
    perm = None
    if getattr(jcrit, 'shuffle_config', None):
        perm = torch.from_numpy(np.array(jcrit._shuffle_idx(7, step, key)))
    want, dwant = jax.value_and_grad(
        lambda a: jcrit(a, jnp.asarray(xt), jnp.asarray(gt), step,
                        rng=key))(jnp.asarray(xs))
    a = _torch(xs, grad=True)
    got = DISTILL_LOSSES[name](**cfg)(a, _torch(xt), torch.from_numpy(gt),
                                     step, perm=perm)
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=LOSS_RTOL, abs=1e-7)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(dwant),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


# --------------------------------------------- the PD slice as a whole

def pd_cfg():
    return dict(
        type='SDModule',
        cfg_s=segformer_cfg(dropout_ratio=0.0, fused_attention='train'),
        cfg_t=segformer_cfg(dropout_ratio=0.0),
        distillation=[dict(PD)], train_cfg={}, test_cfg=dict(mode='whole'))


@pytest.fixture(scope='module')
def jax_pd():
    model = build_jax_segmentor(pd_cfg())
    sv = random_jax_variables(model.student, seed=0)
    tv = random_jax_variables(model.teacher, seed=1)
    rng = np.random.RandomState(0)
    img = rng.randn(2, 64, 64, 3).astype(np.float32)
    gt = rng.randint(0, NUM_CLASSES, (2, 64, 64)).astype(np.int32)
    gt[0, :4] = 255
    return model, sv, tv, img, gt


@pytest.fixture(scope='module')
def jax_pd_step(jax_pd):
    """Step 1: the log vars and the student's gradients."""
    model, sv, tv, img, gt = jax_pd

    def f(p):
        losses, _ = model.forward_train(
            {'params': p, 'batch_stats': sv['batch_stats']}, tv,
            jnp.asarray(img), jnp.asarray(gt), 1,
            rngs={'dropout': jax.random.key(5)})
        return jax_parse(losses)
    grads, log_vars = jax.jit(jax.grad(f, has_aux=True))(sv['params'])
    return ({k: float(v) for k, v in log_vars.items()},
            jax.tree.map(np.asarray, grads))


def _port_pd(jax_pd):
    _, sv, tv, _, _ = jax_pd
    model = build_segmentor(pd_cfg())
    model.load_state_dict(state_dict_from_jax({'student': sv,
                                               'teacher': tv}), strict=True)
    return model.train()


def _port_batch(jax_pd):
    _, _, _, img, gt = jax_pd
    return (torch.from_numpy(nhwc_to_nchw(img).copy()),
            torch.from_numpy(gt.astype(np.int64)))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def test_pd_loss_dict_and_gradients_match_jax(jax_pd, jax_pd_step):
    want, grads = jax_pd_step
    model = _port_pd(jax_pd)
    assert all(blk.attn.fused_attention == 'train'
               for s in range(1, 5)
               for blk in getattr(model.student.backbone, f'block{s}'))
    img, gt = _port_batch(jax_pd)
    total, got = parse_losses(model.forward_train(img, gt, 1))
    assert set(got) == set(want) and PD_KEY in got
    for k in want:
        _close(got[k].item(), want[k], k)
    total.backward()
    want_g = state_dict_from_jax({'params': grads})
    got_g = {n: p.grad for n, p in model.student.named_parameters()}
    assert got_g.keys() == want_g.keys()
    # atol relative to the largest gradient: some true gradients are 0 (see
    # test_torch_port_train) and hold float noise on both sides
    scale = max(float(g.abs().max()) for g in want_g.values())
    for name, g in want_g.items():
        assert got_g[name] is not None, name
        np.testing.assert_allclose(got_g[name].numpy(), g.numpy(),
                                   rtol=RTOL, atol=ATOL * scale,
                                   err_msg=name)
    assert all(p.grad is None for p in model.teacher.parameters())


@pytest.fixture(scope='module')
def jax_pd_trajectory(jax_pd):
    """Three steps of JAX's build_train_step: per step the log vars, and
    the student params and BN stats after it."""
    model, sv, tv, img, gt = jax_pd
    schedule = jax_lr_schedule(LR_CONFIG, OPTIMIZER['lr'], MAX_ITERS)
    tx = jax_build_optimizer(trajectory_optimizer('jax'), sv['params'],
                             schedule)
    state = create_train_state(jax.random.key(1), sv, tx)
    step_fn = jax_train_step(model, tx, schedule, donate=False)
    steps = []
    for _ in range(3):
        state, log_vars = step_fn(state, tv, jnp.asarray(img),
                                  jnp.asarray(gt))
        steps.append(dict(
            log_vars={k: float(v) for k, v in log_vars.items()},
            variables=jax.tree.map(np.asarray, {
                'params': state.params,
                'batch_stats': state.model_state['batch_stats']})))
    return steps


def test_pd_three_step_trajectory_matches_jax(jax_pd, jax_pd_step,
                                              jax_pd_trajectory):
    """Losses, parameters and BN statistics after each of three AdamW
    steps (noise-only parameters frozen and masked as in the CGD
    trajectory test; BN's running variance held to torch's unbiased
    update). Adam's first step moves an element by ~lr * g / |g| whatever
    |g| is, so an element whose step-1 gradient is float noise (below 1e-6
    of the largest) moves by up to its lr in either direction on each side:
    those are held to that bound instead (0.1% of the elements at most:
    with the ones whose true gradient is 0, ~0.1% here)."""
    grads = state_dict_from_jax({'params': jax_pd_step[1]})
    g_scale = max(float(g.abs().max()) for g in grads.values())
    tiny = {n: g.abs() <= 1e-6 * g_scale for n, g in grads.items()}
    assert sum(int(t.sum()) for t in tiny.values()) \
        <= 1e-3 * sum(t.numel() for t in tiny.values())
    lr_mult = max(v.get('lr_mult', 1.0) for v in
                  OPTIMIZER['paramwise_cfg']['custom_keys'].values())
    model = _port_pd(jax_pd)
    teacher_before = copy.deepcopy(model.teacher.state_dict())
    optimizer = build_optimizer(trajectory_optimizer('port'), model)
    schedule = build_lr_schedule(LR_CONFIG, OPTIMIZER['lr'], MAX_ITERS)
    step_fn = build_train_step(model, optimizer, schedule)
    state = TrainState(model=model, optimizer=optimizer, seed=0)
    img, gt = _port_batch(jax_pd)
    n_bn = 2 * 16 * 16  # the head BN's batch: 2 maps at stride 4 of 64x64
    prev_t = {k: v.clone() for k, v in model.student.state_dict().items()}
    prev_j = state_dict_from_jax({'params': jax_pd[1]['params'],
                                  'batch_stats': jax_pd[1]['batch_stats']})
    noise_bound = 0.0
    for i, ref in enumerate(jax_pd_trajectory):
        log_vars = step_fn(state, img, gt)
        noise_bound += 2 * lr_mult * schedule(i)
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
                if name in tiny:  # a parameter, not a BN statistic
                    noise |= tiny[name]
                assert bool(((got[name] - w)[noise].abs()
                             <= noise_bound).all()), name
                _close(got[name][~noise], w[~noise], f'step {i + 1} {name}')
        prev_t = {k: v.clone() for k, v in got.items()}
        prev_j = want
    assert PD_KEY in log_vars
    for name, value in model.teacher.state_dict().items():
        assert torch.equal(value, teacher_before[name]), name
