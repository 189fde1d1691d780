"""The losses and the pixel sampler the ``configs/extra`` slice adds to the
port, against the JAX package's, fp32 on the CPU at the fixtures' ``RTOL,
ATOL`` (gradients: ``ATOL`` of the largest): the sigmoid and mask
cross-entropy forms, Lovasz-Softmax and the Lovasz hinge, ``Accuracy``,
``weighted_loss``, and OHEM (alone and in a head's loss, where it takes
the plain path). Scores are N(0, 1) (NCHW in the port, NHWC in JAX),
labels with a share ignored.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segdistill_tpu.core.seg import OHEMPixelSampler as JaxOHEM
from segdistill_tpu.models import build_head as build_jax_head
from segdistill_tpu.models.losses import Accuracy as JaxAccuracy
from segdistill_tpu.models.losses import CrossEntropyLoss as JaxCE
from segdistill_tpu.models.losses import LovaszLoss as JaxLovasz
from segdistill_tpu.models.losses import weighted_loss as jax_weighted_loss
from segdistill_tpu_torch.core.seg import OHEMPixelSampler
from segdistill_tpu_torch.models import build_head
from segdistill_tpu_torch.models.losses import (Accuracy, CrossEntropyLoss,
                                                LovaszLoss, weighted_loss)

from torch_port_fixtures import ATOL, NORM, RTOL, nhwc_to_nchw

C = 5


def _scores(seed, shape=(2, 6, 7, C)):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    gt = rng.randint(0, shape[-1], shape[:3]).astype(np.int32)
    gt[0, :2] = 255
    return x, gt


def _check(jax_fn, port_fn, x, *rest, nchw=True):
    """The value and the gradient in the scores of ``port_fn`` (NCHW scores)
    against ``jax_fn`` (NHWC)."""
    want, dwant = jax.value_and_grad(lambda a: jnp.sum(jax_fn(a, *rest)))(
        jnp.asarray(x))
    t = torch.from_numpy(nhwc_to_nchw(x).copy() if nchw else x.copy()) \
        .requires_grad_()
    got = port_fn(t).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL, atol=ATOL)
    dwant = np.asarray(dwant)
    np.testing.assert_allclose(
        t.grad.numpy(), nhwc_to_nchw(dwant) if nchw else dwant, rtol=RTOL,
        atol=ATOL * max(np.abs(dwant).max(), 1e-30))


@pytest.mark.parametrize('class_weight', [None, [1.0, 2.0, 0.5, 1.0, 3.0]])
@pytest.mark.parametrize('with_weight', [False, True])
def test_sigmoid_cross_entropy(class_weight, with_weight):
    x, gt = _scores(1)
    w = np.random.RandomState(2).rand(*gt.shape).astype(np.float32) \
        if with_weight else None
    kw = dict(use_sigmoid=True, class_weight=class_weight, loss_weight=0.7)
    jax_loss, port_loss = JaxCE(**kw), CrossEntropyLoss(**kw)
    _check(lambda a: jax_loss(a, jnp.asarray(gt),
                              None if w is None else jnp.asarray(w),
                              ignore_index=255),
           lambda t: port_loss(t, torch.from_numpy(gt).long(),
                               None if w is None else torch.from_numpy(w),
                               ignore_index=255), x)


def test_mask_cross_entropy():
    """(N, C, 7, 7) mask logits, each ROI's own class channel against its
    (N, 7, 7) target; the same layout on both sides."""
    rng = np.random.RandomState(3)
    pred = rng.randn(4, C, 7, 7).astype(np.float32)
    target = (rng.rand(4, 7, 7) > 0.5).astype(np.float32)
    label = rng.randint(0, C, 4)
    kw = dict(use_mask=True, class_weight=None)
    jax_loss, port_loss = JaxCE(**kw), CrossEntropyLoss(**kw)
    _check(lambda a: jax_loss(a, jnp.asarray(target), jnp.asarray(label)),
           lambda t: port_loss(t, torch.from_numpy(target),
                               torch.from_numpy(label)), pred, nchw=False)
    assert port_loss(torch.from_numpy(pred), torch.from_numpy(target),
                     torch.from_numpy(label)).shape == (1,)
    with pytest.raises(ValueError):
        CrossEntropyLoss(use_sigmoid=True, use_mask=True)


LOVASZ = {
    'softmax present': dict(),
    'softmax all, class weight': dict(classes='all',
                                      class_weight=[1., 2., .5, 1., 3.]),
    'softmax per image': dict(per_image=True),
    'hinge': dict(loss_type='binary'),
    'hinge per image': dict(loss_type='binary', per_image=True),
}


@pytest.mark.parametrize('name', sorted(LOVASZ))
def test_lovasz(name):
    kw = dict(LOVASZ[name], loss_weight=0.5)
    binary = kw.get('loss_type') == 'binary'
    x, gt = _scores(4, (2, 6, 7, 1 if binary else C))
    if binary:
        gt = np.where(gt == 255, 255, (x[..., 0] > 0.3).astype(np.int32))
    else:
        gt[1][gt[1] == 3] = 1  # a class absent from image 1
    jax_loss, port_loss = JaxLovasz(**kw), LovaszLoss(**kw)
    _check(lambda a: jax_loss(a, jnp.asarray(gt)),
           lambda t: port_loss(t, torch.from_numpy(gt).long()), x)


def test_accuracy_and_weighted_loss():
    x, gt = _scores(5)
    for topk, thresh in (((1, 3), None), ((2,), 0.1), (1, None)):
        want = JaxAccuracy(topk, thresh)(jnp.asarray(x), jnp.asarray(gt))
        got = Accuracy(topk, thresh)(torch.from_numpy(nhwc_to_nchw(x)
                                                      .copy()),
                                     torch.from_numpy(gt).long())
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), rtol=1e-6)

    def sq(pred, target, scale=1.0):
        return scale * (pred - target) ** 2
    jax_sq, port_sq = jax_weighted_loss(sq), weighted_loss(sq)
    assert port_sq.__name__ == 'sq'
    rng = np.random.RandomState(6)
    p, t, w = (rng.rand(3, 4).astype(np.float32) for _ in range(3))
    for kw in (dict(), dict(reduction='sum'), dict(avg_factor=5.0),
               dict(reduction='none'), dict(scale=2.0)):
        for weight in (None, w):
            want = jax_sq(jnp.asarray(p), jnp.asarray(t),
                          None if weight is None else jnp.asarray(weight),
                          **kw)
            got = port_sq(torch.from_numpy(p), torch.from_numpy(t),
                          None if weight is None else torch.from_numpy(weight),
                          **kw)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, err_msg=str(kw))


@pytest.mark.parametrize('thresh', [None, 0.7])
def test_ohem_keeps_the_same_pixels(thresh):
    x, gt = _scores(7, (2, 10, 12, C))
    want = JaxOHEM(thresh=thresh, min_kept=20).sample(jnp.asarray(x),
                                                      jnp.asarray(gt))
    got = OHEMPixelSampler(thresh=thresh, min_kept=20).sample(
        torch.from_numpy(nhwc_to_nchw(x).copy()), torch.from_numpy(gt).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < (gt != 255).sum()
    with pytest.raises(ValueError):
        OHEMPixelSampler(min_kept=1)


def test_a_head_with_ohem_leaves_the_fused_path():
    """A head with a sampler takes the plain resize -> weighted CE path,
    as JAX does: the loss and its gradient in the logits agree."""
    cfg = dict(type='FCNHead', in_channels=6, channels=4, num_convs=1,
               concat_input=False, dropout_ratio=0.0, num_classes=C,
               norm_cfg=dict(NORM), align_corners=False,
               sampler=dict(type='OHEMPixelSampler', thresh=0.7,
                            min_kept=50))
    jax_head = build_jax_head(dict(cfg))
    port = build_head(dict(cfg))
    assert port.sampler is not None and port.sampler.context is port
    assert not port._fused_ce_eligible(port._loss_cfg(), None)
    logits, _ = _scores(8, (2, 6, 7, C))
    gt = np.random.RandomState(9).randint(0, C, (2, 24, 28)).astype(np.int32)
    _check(lambda a: jax_head.losses(a, jnp.asarray(gt))['loss_seg'],
           lambda t: port.losses(t, torch.from_numpy(gt).long())['loss_seg'],
           logits)
