"""The distillation train step of the Tab5 PSP and Swin students against
the JAX package, fp32 on the CPU.

A narrow PSP student (ResNetV1c-d8 + PSPHead, logits at stride 8: 8 x 8 at
a 64 x 64 image) distils from a small MiT teacher whose SegFormerHead
logits lie at stride 4 (16 x 16), as the Tab5 PSP configs pair the
student's ``decode_head.conv_seg`` with the B3 teacher's
``decode_head.linear_pred``. Each map is resized to the label size on its
own, then the KL is taken: the JAX package's unfused path (which it takes
on the CPU), the semantics the port is held to. (On a TPU the JAX fused
kernels look at the student's shape alone and compute another loss for
such a pair.) A narrow Swin + UPerHead student, at stride 4 like its
teacher, takes the CGD step too. Dropout and drop-path are 0 on both
sides (JAX's PRNG cannot be reproduced); the channel permutation of the
shuffle is JAX's, injected. Held at the fixtures' ``RTOL, ATOL``: every
loss term; the student gradients against the JAX package in float64 (see
the test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segdistill_tpu.distill.losses import ATLoss as JaxATLoss
from segdistill_tpu.models import build_segmentor as build_jax_segmentor
from segdistill_tpu.models.segmentors import parse_losses as jax_parse
from segdistill_tpu_torch.convert import state_dict_from_jax
from segdistill_tpu_torch.distill.losses import ATLoss
from segdistill_tpu_torch.models import build_segmentor
from segdistill_tpu_torch.models.segmentors import parse_losses

from torch_port_fixtures import (ATOL, NUM_CLASSES, RTOL, nhwc_to_nchw,
                                 psp_cfg, random_jax_variables, segformer_cfg,
                                 swin_cfg)

STEP = 1000  # a shuffle interval step: CGD draws a fresh permutation


def entry(loss_name, loss_config=None):
    return dict(student_layer='decode_head.conv_seg',
                teacher_layer='decode_head.linear_pred', loss_name=loss_name,
                loss_config=loss_config or {})


CASES = {
    'psp_CGD': ('psp', entry('CGDLoss', {'group_size': 5})),
    'psp_CD': ('psp', entry('CDLoss')),
    'psp_PD': ('psp', entry('PDLoss')),
    'psp_IFVD': ('psp', entry('IFVDLoss')),
    'swin_CGD': ('swin', entry('CGDLoss')),
}
STUDENTS = {'psp': lambda: psp_cfg(50, dropout_ratio=0.0),
            'swin': lambda: swin_cfg(dropout_ratio=0.0)}


def sd_cfg(student, dist):
    return dict(type='SDModule', cfg_s=STUDENTS[student](),
                cfg_t=segformer_cfg(dropout_ratio=0.0),
                distillation=[dict(dist)], train_cfg={},
                test_cfg=dict(mode='whole'))


@pytest.fixture(scope='module')
def batch():
    rng = np.random.RandomState(0)
    img = rng.randn(2, 64, 64, 3).astype(np.float32)
    gt = rng.randint(0, NUM_CLASSES, (2, 64, 64)).astype(np.int32)
    gt[0, :4] = 255
    return img, gt


@pytest.fixture(scope='module')
def variables():
    """Seeded JAX variables of each student and of the teacher (shared by
    every case)."""
    out = {s: random_jax_variables(build_jax_segmentor(make()), seed=0)
           for s, make in STUDENTS.items()}
    out['teacher'] = random_jax_variables(
        build_jax_segmentor(segformer_cfg(dropout_ratio=0.0)), seed=1)
    return out


def _jax_step(model, sv, tv, img, gt, dtype=np.float32):
    """-> (log vars, student gradients as port state-dict tensors, the
    permutation): one jit of the loss and its gradient, in ``dtype``."""
    cast = lambda t: jax.tree.map(lambda a: np.asarray(a, dtype), t)  # noqa
    sv, tv = cast(sv), cast(tv)

    @jax.jit
    def loss_and_grad(params, bstats, tvars, img, gt, key):
        def f(p):
            losses, _ = model.forward_train(
                {'params': p, 'batch_stats': bstats}, tvars, img, gt,
                jnp.int32(STEP), rngs={'dropout': key}, shuffle_rng=key)
            return jax_parse(losses)
        return jax.grad(f, has_aux=True)(params)

    key = jax.random.key(5)
    grads, log_vars = loss_and_grad(sv['params'], sv['batch_stats'], tv,
                                    jnp.asarray(img, dtype),
                                    jnp.asarray(gt), key)
    crit = model.distillation_loss.entries[0]['criterion']
    perm = np.asarray(crit._shuffle_idx(NUM_CLASSES, STEP, key)) \
        if getattr(crit, 'shuffle_config', None) else None
    grads = state_dict_from_jax({'params': jax.tree.map(
        lambda a: np.asarray(a, np.float64), grads)})
    return ({k: float(v) for k, v in log_vars.items()},
            {k: v.double() for k, v in grads.items()
             if not k.endswith('relative_position_index')}, perm)


def _max_error(got, truth):
    """The largest |got - truth| over all tensors, over the largest
    |truth|."""
    scale = max(float(t.abs().max()) for t in truth.values())
    return max(float((got[k].double() - t).abs().max())
               for k, t in truth.items()) / scale


@pytest.mark.parametrize('case', sorted(CASES))
def test_distillation_step_matches_jax(case, batch, variables):
    """The loss terms at ``RTOL, ATOL`` against JAX in fp32. The student
    gradients: train-mode BN at batch 2 (the PSP pool-1 branch normalises
    2 values a channel) magnifies float32 rounding, so each fp32 gradient
    is held to the JAX package run in float64 (backbones' ``dtype``
    float64, x64 enabled); the port's largest error, relative to the
    largest gradient, may be no larger than that of the JAX package's own
    fp32 gradients, or 1e-4."""
    student, dist = CASES[case]
    img, gt = batch
    sv, tv = variables[student], variables['teacher']
    cfg = sd_cfg(student, dist)
    want, grads, perm = _jax_step(build_jax_segmentor(cfg), sv, tv, img, gt)
    with jax.enable_x64(True):
        cfg64 = sd_cfg(student, dist)
        for side in ('cfg_s', 'cfg_t'):
            cfg64[side]['backbone']['dtype'] = 'float64'
        _, truth, perm64 = _jax_step(build_jax_segmentor(cfg64), sv, tv, img,
                                     gt, np.float64)
    assert perm is None or np.array_equal(perm, perm64)
    model = build_segmentor(cfg)
    model.load_state_dict(state_dict_from_jax({'student': sv,
                                               'teacher': tv}), strict=True)
    model.train()
    x = torch.from_numpy(nhwc_to_nchw(img).copy())
    y = torch.from_numpy(gt.astype(np.int64))
    with torch.no_grad():
        s_logits = model.student(x)
    if student == 'psp':
        assert s_logits.shape[2:] == (8, 8)  # stride 8; the teacher's 16
    total, got = parse_losses(model.forward_train(
        x, y, STEP, perm=None if perm is None else torch.from_numpy(perm)))
    key = 'loss_decode_head.conv_seg<->decode_head.linear_pred_other'
    assert set(got) == set(want) and key in got
    for k in want:
        np.testing.assert_allclose(got[k].item(), want[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    total.backward()
    got_g = {n: p.grad for n, p in model.student.named_parameters()}
    assert got_g.keys() == truth.keys() == grads.keys()
    assert all(g is not None for g in got_g.values())
    err_port, err_jax = _max_error(got_g, truth), _max_error(grads, truth)
    assert err_port <= max(err_jax, RTOL), (err_port, err_jax)
    assert all(p.grad is None for p in model.teacher.parameters())


def test_at_loss_matches_jax_and_refuses_two_sizes():
    """ATLoss on maps of one size (the Swin student's stride-4 logits
    against the teacher's) is JAX's, with its gradient; on a stride-8
    student against a stride-4 teacher the reference's MSE, and JAX's,
    cannot broadcast, and the port says why."""
    rng = np.random.RandomState(3)
    xs = rng.randn(2, NUM_CLASSES, 16, 16).astype(np.float32)
    xt = rng.randn(2, NUM_CLASSES, 16, 16).astype(np.float32)
    want, dwant = jax.value_and_grad(
        lambda a: JaxATLoss()(a, jnp.asarray(xt), None, 1))(jnp.asarray(xs))
    a = torch.from_numpy(xs).requires_grad_()
    got = ATLoss()(a, torch.from_numpy(xt), None, 1)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(dwant), rtol=RTOL,
                               atol=ATOL * np.abs(dwant).max())
    with pytest.raises(ValueError, match='one shape'):
        ATLoss()(torch.zeros(2, 4, 8, 8), torch.zeros(2, 4, 16, 16), None, 1)
