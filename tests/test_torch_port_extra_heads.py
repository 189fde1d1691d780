"""The heads of the ``configs/extra`` models alone against the JAX package,
fp32 on the CPU, on seeded random weights (every leaf, BN statistics
included) and N(0, 1) feature maps.

PSAHead in each of its forms: 'collect', 'distribute' and 'bi-direction',
each with the scattered window map and compact, a window that covers part
of the shrunk map, a normalisation factor, no softmax, and an odd map
(9 x 9, shrunk to 5 x 5 with ``align_corners``); FCNHead with two convs and
``conv_cat``, and with none. For each: the eval logits, the train-mode
logits, the loss dict at labels 4x the map's size, and the gradients of
the loss in every parameter and the input, at the fixtures' ``RTOL,
ATOL`` (gradients: ``ATOL`` of the largest). Then the point head's pieces:
``point_sample`` against JAX's (bilinear, and nearest at exact half-pixel
positions, which round half to even), the choice of the most uncertain
positions at ties, and the training draw.
"""

from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segdistill_tpu.models import build_head as build_jax_head
from segdistill_tpu.models.decode_heads.point_head import \
    point_sample as jax_point_sample
from segdistill_tpu_torch.convert import state_dict_from_jax
from segdistill_tpu_torch.models import build_head
from segdistill_tpu_torch.models.decode_heads.point_head import (
    point_sample, top_positions)
from segdistill_tpu_torch.models.decode_heads.psa_head import psa_index

from torch_port_fixtures import (ATOL, CE_LOSS, NORM, NUM_CLASSES, POINT_HEAD,
                                 RTOL, _randomize_leaf, nhwc_to_nchw)

IN_CH = 12


def psa(psa_type, compact, mask=(5, 5), **kw):
    return dict(dict(type='PSAHead', in_channels=IN_CH, channels=8,
                     mask_size=mask, psa_type=psa_type, compact=compact,
                     shrink_factor=2, normalization_factor=1.0,
                     psa_softmax=True, dropout_ratio=0.0,
                     num_classes=NUM_CLASSES, norm_cfg=dict(NORM),
                     align_corners=False, loss_decode=dict(CE_LOSS)), **kw)


def fcn(num_convs, concat_input, channels=8):
    return dict(type='FCNHead', in_channels=IN_CH, channels=channels,
                num_convs=num_convs, concat_input=concat_input,
                dropout_ratio=0.0, num_classes=NUM_CLASSES,
                norm_cfg=dict(NORM), align_corners=False,
                loss_decode=dict(CE_LOSS, loss_weight=0.4))


# (head config, the feature map's side)
HEADS = {
    'psa collect': (psa('collect', False), 10),
    'psa distribute': (psa('distribute', False), 10),
    'psa bi-direction': (psa('bi-direction', False), 10),
    'psa collect compact': (psa('collect', True), 10),
    'psa distribute compact': (psa('distribute', True), 10),
    'psa bi-direction compact': (psa('bi-direction', True), 10),
    'psa odd shrink': (psa('bi-direction', False, mask=(7, 7)), 9),
    'psa nf 2, no softmax': (psa('collect', False, normalization_factor=2.0,
                                 psa_softmax=False), 10),
    'fcn 2 convs + conv_cat': (fcn(2, True), 10),
    'fcn no conv': (fcn(0, False, channels=IN_CH), 10),
}


def _random_variables(head, x):
    shapes = jax.eval_shape(lambda: head.init(
        {'params': jax.random.key(0)}, [x], train=False))
    rng = np.random.RandomState(1)

    def walk(tree, path):
        return {k: walk(v, path + (k,)) if isinstance(v, Mapping) else
                _randomize_leaf(path + (k,), v.shape, rng).astype(np.float32)
                for k, v in tree.items()}
    return {c: walk(shapes[c], (c,)) for c in ('params', 'batch_stats')
            if c in shapes}


@pytest.fixture(scope='module', params=sorted(HEADS))
def head_case(request):
    cfg, side = HEADS[request.param]
    rng = np.random.RandomState(2)
    x = rng.randn(2, side, side, IN_CH).astype(np.float32)
    gt = rng.randint(0, NUM_CLASSES, (2, 4 * side, 4 * side)).astype(np.int32)
    gt[1, :3] = 255
    jax_head = build_jax_head(dict(cfg))
    variables = _random_variables(jax_head, jnp.asarray(x))
    port = build_head(dict(cfg))
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jax_head, variables, port, x, gt


def _close(got, want, what, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=atol, err_msg=what)


def test_eval_logits(head_case):
    jax_head, variables, port, x, _ = head_case
    want = jax_head.apply(variables, [jnp.asarray(x)], train=False)
    with torch.no_grad():
        got = port.eval()([torch.from_numpy(nhwc_to_nchw(x).copy())])
    assert got.shape == (2, NUM_CLASSES) + x.shape[1:3]
    _close(got.numpy(), nhwc_to_nchw(want), 'logits')


def test_train_losses_and_gradients(head_case):
    """Train mode (BN on the batch): the logits, the loss dict, and the
    gradients of the loss in every parameter and in the input."""
    jax_head, variables, port, x, gt = head_case

    def loss(params, xj):
        out, _ = jax_head.apply({'params': params,
                                 'batch_stats': variables.get('batch_stats',
                                                              {})},
                                [xj], train=True, mutable=['batch_stats'])
        losses = jax_head.losses(out, jnp.asarray(gt))
        return losses['loss_seg'], (out, losses)
    (dp, dx), (out, want) = jax.grad(loss, argnums=(0, 1), has_aux=True)(
        variables['params'], jnp.asarray(x))
    xt = torch.from_numpy(nhwc_to_nchw(x).copy()).requires_grad_()
    logits = port.train()([xt])
    got = port.losses(logits, torch.from_numpy(gt.astype(np.int64)))
    _close(logits.detach().numpy(), nhwc_to_nchw(out), 'train logits')
    assert set(got) == set(want) == {'loss_seg', 'acc_seg'}
    for k in want:
        _close(got[k].item(), float(want[k]), k)
    got['loss_seg'].backward()
    grads = state_dict_from_jax({'params': jax.tree.map(np.asarray, dp)})
    scale = max(float(g.abs().max()) for g in grads.values())
    named = dict(port.named_parameters())
    assert named.keys() == grads.keys()
    for k, g in grads.items():
        _close(named[k].grad.numpy(), g.numpy(), k, atol=ATOL * scale)
    _close(xt.grad.numpy(), nhwc_to_nchw(dx), 'input',
           atol=ATOL * np.abs(dx).max())


def test_psa_index_table_matches_the_window():
    """Each (source, target) pair reads the window slot of their offset,
    and only offsets inside the window are valid."""
    h, w, mh, mw = 4, 5, 3, 5
    rel, valid = psa_index(h, w, mh, mw, 'cpu')
    for s in range(h * w):
        for t in range(h * w):
            dy = s // w - t // w + (mh - 1) // 2
            dx = s % w - t % w + (mw - 1) // 2
            inside = 0 <= dy < mh and 0 <= dx < mw
            assert bool(valid[s, t]) == inside
            if inside:
                assert int(rel[s, t]) == dy * mw + dx
    assert psa_index(h, w, mh, mw, 'cpu')[0] is rel  # cached


def test_point_sample_matches_jax():
    """Bilinear, with points outside the map's pixel centres (zero
    padding); nearest at exact half-pixel positions (k + 1) / 8 of an
    8 x 8 map, which both round half to even. (At a position one float32
    step from a half pixel the two can round apart: JAX forms p * W - 0.5,
    grid_sample, as the reference's mmcv op, ((2p - 1) + 1) * W / 2 -
    0.5.)"""
    rng = np.random.RandomState(3)
    feat = rng.randn(2, 8, 8, 5).astype(np.float32)
    pts = rng.rand(2, 40, 2).astype(np.float32)
    pts[:, :8, 0] = (np.arange(8) + 1) / 8.0
    pts[:, 8:16, 1] = (np.arange(8) + 1) / 8.0
    pts[:, 16] = [0.01, 0.99]
    ft = torch.from_numpy(nhwc_to_nchw(feat).copy())
    pt = torch.from_numpy(pts)
    for mode in ('bilinear', 'nearest'):
        want = np.asarray(jax_point_sample(jnp.asarray(feat),
                                           jnp.asarray(pts), mode=mode))
        got = point_sample(ft, pt, mode=mode)
        assert got.shape == (2, 5, 40)
        _close(got.numpy().transpose(0, 2, 1), want, mode)


def test_top_positions_keep_the_lower_index_at_ties():
    """``lax.top_k`` puts the lower index first among equal values; the
    port's stable sort picks the same positions, in the same order."""
    scores = np.array([[3, 1, 2, 2, 2, 0, 2, 3],
                       [0, 0, 0, 0, 1, 1, 1, 1]], np.float32)
    rng = np.random.RandomState(4)
    many = rng.randint(0, 4, (3, 50)).astype(np.float32)
    for s, k in ((scores, 3), (scores, 5), (many, 17)):
        want = np.asarray(jax.lax.top_k(jnp.asarray(s), k)[1])
        got = top_positions(torch.from_numpy(s), k).numpy()
        np.testing.assert_array_equal(got, want)


def test_test_points_match_jax_on_a_flat_map():
    """A map whose uncertainty ties everywhere: the refined positions are
    the first k, and their coordinates the pixel centres, as in JAX."""
    from segdistill_tpu.models.decode_heads.point_head import PointHead
    refined = np.zeros((1, 6, 7, 4), np.float32)
    refined[..., 1] = 1.0
    jax_head = PointHead(**{k: v for k, v in POINT_HEAD.items()
                            if k != 'type'})
    idx_j, coords_j = jax_head.get_points_test(jnp.asarray(refined))
    port = build_head(dict(POINT_HEAD, num_classes=4))
    idx, coords = port.get_points_test(
        torch.from_numpy(nhwc_to_nchw(refined).copy()))
    k = min(6 * 7, POINT_HEAD['subdivision_num_points'])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(idx.numpy()[0], np.arange(k))
    np.testing.assert_allclose(coords.numpy(), np.asarray(coords_j),
                               rtol=1e-7, atol=0)


def test_training_points_come_from_the_generator():
    """The training draw: num_points points in [0, 1)^2, the same for the
    same generator seed; without a generator (and no points) it raises."""
    port = build_head(dict(POINT_HEAD, num_classes=4)).train()
    x = [torch.randn(2, 16, 8, 8)]
    prev = torch.randn(2, 4, 8, 8)
    _, pts = port(x, prev, torch.Generator().manual_seed(5))
    _, again = port(x, prev, torch.Generator().manual_seed(5))
    assert pts.shape == (2, POINT_HEAD['num_points'], 2)
    assert torch.equal(pts, again)
    assert bool(((pts >= 0) & (pts < 1)).all())
    with pytest.raises(ValueError, match='Generator'):
        port(x, prev)
