"""The port's Tab5 students, ResNetV1c-d8 + PSPHead and Swin + UPerHead,
against the JAX package on the same weights and inputs, fp32 on the CPU.

Narrow models (``torch_port_fixtures.psp_cfg``, ``swin_cfg``; a ResNet-18
as well for BasicBlock) carry the JAX variables across with
``state_dict_from_jax``, and back with ``torch.save`` and the JAX
package's own ``load_pth_into_variables``. Held to the fixtures' ``RTOL,
ATOL`` (1e-4, 1e-5): the four stage maps, the head's logits, and the
logits in training mode (BN on the batch's statistics, dropout 0), with
the BN running statistics after it. The Swin input (112 x 96) leaves
stage grids of 28 x 24 down to 4 x 3, all padded up to the window 7.
Each JAX forward runs as one jit (``run_jit``: a few seconds to compile,
where op-by-op dispatch compiles every op of the Swin on its own).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segdistill_tpu.convert.torch_loader import load_pth_into_variables
from segdistill_tpu.models import build_segmentor as build_jax_segmentor
from segdistill_tpu_torch.convert import state_dict_from_jax
from segdistill_tpu_torch.models import build_segmentor
from segdistill_tpu_torch.models.utils import capture_taps

from torch_port_fixtures import (ATOL, RTOL, leaves, nhwc_to_nchw, psp_cfg,
                                 random_jax_variables, swin_cfg)
from torch_port_zoo_models import run_jit

MODELS = {'psp50': (lambda **kw: psp_cfg(50, **kw), (64, 96)),
          'psp18': (lambda **kw: psp_cfg(18, **kw), (64, 80)),
          'swin': (lambda **kw: swin_cfg(**kw), (112, 96))}


@pytest.fixture(scope='module', params=sorted(MODELS))
def pair(request):
    make, hw = MODELS[request.param]
    jax_model = build_jax_segmentor(make(dropout_ratio=0.0))
    variables = random_jax_variables(jax_model, seed=3)
    port = build_segmentor(make(dropout_ratio=0.0))
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    return request.param, jax_model, variables, port.eval(), hw


def _img(seed, hw, batch=2):
    x = np.random.RandomState(seed).randn(batch, *hw, 3).astype(np.float32)
    return x, torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def test_stage_outputs(pair):
    _, jax_model, variables, port, hw = pair
    x, xt = _img(1, hw)
    want = run_jit(lambda v, i: jax_model.net.apply(
        v, i, train=False, method=jax_model.net.extract_feat),
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = port.extract_feat(xt)
    assert len(got) == len(want) == 4
    for s, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), nhwc_to_nchw(w), rtol=RTOL,
                                   atol=ATOL, err_msg=f'stage {s + 1}')


def test_logits(pair):
    name, jax_model, variables, port, hw = pair
    x, xt = _img(2, hw)
    want = run_jit(lambda v, i: jax_model.net.apply(
        v, i, train=False, with_aux=False)['decode'],
        variables, jnp.asarray(x))
    with torch.no_grad(), capture_taps(port, ['decode_head.conv_seg']) as t:
        got = port(xt)
    stride = 8 if name.startswith('psp') else 4
    assert got.shape[2:] == (hw[0] // stride, hw[1] // stride)
    assert torch.equal(t['decode_head.conv_seg'], got)
    np.testing.assert_allclose(got.numpy(), nhwc_to_nchw(want), rtol=RTOL,
                               atol=ATOL)


def test_train_mode_logits_and_bn_statistics(pair):
    """Training mode: BN normalises with the batch's statistics and updates
    its running ones. BN over a handful of values a channel (the PSP
    pool-1 branch holds 2) divides by a small deviation, which magnifies
    float32 rounding on either side; so both fp32 results are held to the
    JAX package run in float64 (backbone ``dtype`` float64, x64 enabled),
    and the port's error may be no larger than
    the larger of JAX's own fp32 error and 5e-5 of the logits' scale. The
    running means match JAX's fp32 ones at ``RTOL, ATOL``; the running
    variances take torch's unbiased batch variance, so their batch terms
    stand to flax's at n/(n-1) >= 1."""
    name, jax_model, variables, port, hw = pair
    x, xt = _img(4, hw)
    out, state = run_jit(lambda v, i: jax_model.net.apply(
        v, i, train=True, with_aux=False, mutable=['batch_stats', 'feats']),
        variables, jnp.asarray(x))
    with jax.enable_x64(True):
        jax64 = build_jax_segmentor(MODELS[name][0](dropout_ratio=0.0,
                                                    dtype='float64'))
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        out64, state64 = run_jit(lambda v, i: jax64.net.apply(
            v, i, train=True, with_aux=False,
            mutable=['batch_stats', 'feats']),
            v64, jnp.asarray(x, jnp.float64))
        truth = np.asarray(out64['decode'], np.float64).transpose(0, 3, 1, 2)
        stats64 = state_dict_from_jax({'batch_stats': jax.tree.map(
            lambda a: np.asarray(a, np.float64), state64['batch_stats'])})
    port = copy.deepcopy(port).train()  # the fixture's stays as loaded
    with torch.no_grad():
        got = port(xt, torch.Generator().manual_seed(0)).double().numpy()
    scale = np.abs(truth).max()
    err_port = np.abs(got - truth).max()
    err_jax = np.abs(nhwc_to_nchw(out['decode']) - truth).max()
    assert err_port <= max(err_jax, 5e-5 * scale), (err_port, err_jax, scale)
    want = state_dict_from_jax({'batch_stats': state['batch_stats']})
    before = state_dict_from_jax({'batch_stats': variables['batch_stats']})
    sd = port.state_dict()
    assert want, 'no BN statistics'
    for k, w in want.items():
        if k.endswith('running_mean'):
            assert not torch.equal(sd[k], before[k]), k
            t = stats64[k].double()
            e_port = (sd[k].double() - t).abs().max().item()
            e_jax = (w.double() - t).abs().max().item()
            assert e_port <= max(e_jax, ATOL + RTOL * t.abs().max().item()), \
                (k, e_port, e_jax)
        elif k.endswith('running_var'):
            t_term = sd[k] - 0.9 * before[k]
            j_term = w - 0.9 * before[k]
            ratio = (t_term / j_term.clamp_min(1e-12)).median().item()
            assert ratio >= 1.0 - 1e-4, (k, ratio)


def test_state_dict_round_trip(pair, tmp_path):
    """JAX variables -> port state dict -> .pth -> the JAX package's strict
    loader gives back the same variables, bit for bit."""
    _, jax_model, variables, port, _ = pair
    path = str(tmp_path / 'port.pth')
    torch.save(port.state_dict(), path)
    fresh = random_jax_variables(jax_model, seed=9)
    loaded = load_pth_into_variables(fresh, path, strict=True)
    want, got = dict(leaves(variables)), dict(leaves(loaded))
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_reference_layout(pair):
    name, _, _, port, _ = pair
    keys = set(port.state_dict())
    if name.startswith('psp'):
        want = ['backbone.stem.0.weight', 'backbone.stem.7.running_var',
                'backbone.layer1.0.conv1.weight',
                'backbone.layer1.0.downsample.0.weight',
                'backbone.layer4.1.bn2.weight',
                'decode_head.psp_modules.3.1.conv.weight',
                'decode_head.psp_modules.0.1.bn.running_mean',
                'decode_head.bottleneck.conv.weight',
                'decode_head.conv_seg.weight']
    else:
        want = ['backbone.patch_embed.proj.weight',
                'backbone.patch_embed.norm.weight',
                'backbone.layers.0.blocks.1.attn.relative_position_index',
                'backbone.layers.3.blocks.0.attn.relative_position_bias_table',
                'backbone.layers.2.downsample.norm.weight',
                'backbone.layers.2.downsample.reduction.weight',
                'backbone.norm3.bias', 'decode_head.bottleneck.bn.weight',
                'decode_head.lateral_convs.2.conv.weight',
                'decode_head.fpn_convs.0.bn.running_var',
                'decode_head.fpn_bottleneck.conv.weight',
                'decode_head.conv_seg.bias']
    for k in want:
        assert k in keys, k


def test_swin_relative_position_index_is_the_references():
    """The buffer is the reference's index (ref swin:92-104), also as the
    converter makes it."""
    from segdistill_tpu.models.backbones.swin_transformer import \
        _relative_position_index
    from segdistill_tpu_torch.models.backbones.swin_transformer import \
        relative_position_index
    for ws in (2, 7, 12):
        assert np.array_equal(relative_position_index(ws).numpy(),
                              _relative_position_index(ws))
    sd = state_dict_from_jax({'params': {'backbone': {'l': {'attn': {
        'relative_position_bias_table': np.zeros((169, 3), np.float32)}}}}})
    assert np.array_equal(sd['backbone.l.attn.relative_position_index'],
                          _relative_position_index(7))


def test_resnet_v1d_shortcut_slots():
    """ResNetV1d's shortcut sits behind an average pool
    (``downsample.{1,2}``); the converter takes those slots from the
    target's keys, and the stage maps match JAX."""
    cfg = psp_cfg(50, dropout_ratio=0.0)
    cfg['backbone']['type'] = 'ResNetV1d'
    jax_model = build_jax_segmentor(cfg)
    variables = random_jax_variables(jax_model, seed=5)
    port = build_segmentor(cfg).eval()
    keys = port.state_dict().keys()
    assert 'backbone.layer2.0.downsample.1.weight' in keys
    port.load_state_dict(state_dict_from_jax(variables, keys=keys),
                         strict=True)
    x, xt = _img(6, (64, 64))
    want = run_jit(lambda v, i: jax_model.net.apply(
        v, i, train=False, with_aux=False)['decode'],
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(xt)
    np.testing.assert_allclose(got.numpy(), nhwc_to_nchw(want), rtol=RTOL,
                               atol=ATOL)


def test_block_taps_use_the_jax_names(pair):
    name, jax_model, variables, port, hw = pair
    x, xt = _img(7, hw)
    from segdistill_tpu.models.segmentors.base import flatten_feats
    _, state = run_jit(lambda v, i: jax_model.net.apply(
        v, i, train=False, with_aux=False, mutable=['feats']),
        variables, jnp.asarray(x))
    jax_taps = flatten_feats(jax.tree.map(np.asarray, state['feats']))
    block = 'backbone.layer4.1' if name.startswith('psp') \
        else 'backbone.layers.2.blocks.1'
    assert block in jax_taps
    with torch.no_grad(), capture_taps(port, [block]) as taps:
        port(xt)
    got = taps[block]
    want = jax_taps[block]
    want = nhwc_to_nchw(want) if got.ndim == 4 else want
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
