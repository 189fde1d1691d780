"""The PyTorch port's Segformer (MiT-b0 + SegFormerHead) against the JAX
package on the same weights and inputs, fp32 on the CPU.

The weights are carried across with ``state_dict_from_jax`` (and back with
the JAX package's own ``.pth`` loader). On the CPU the JAX model takes its
unfused paths and the port its kernels' plain versions. Layouts: JAX is
NHWC, the port NCHW; the tests transpose.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from segdistill_tpu.convert.torch_loader import load_pth_into_variables
from segdistill_tpu.models import build_segmentor as build_jax_segmentor
from segdistill_tpu_torch.convert import state_dict_from_jax
from segdistill_tpu_torch.models import build_segmentor
from segdistill_tpu_torch.ops import resize_sum, sra_attn

from torch_port_fixtures import (ATOL, RTOL, nhwc_to_nchw,
                                 random_jax_variables, segformer_cfg)
from torch_port_zoo_models import run_jit

SLIDE = dict(mode='slide', crop_size=(64, 64), stride=(48, 48))


@pytest.fixture(scope='module')
def jax_side():
    model = build_jax_segmentor(segformer_cfg(test_cfg=SLIDE))
    return model, random_jax_variables(model, seed=0)


def _port(variables, **cfg_kw):
    model = build_segmentor(segformer_cfg(**cfg_kw))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model.eval()


@pytest.fixture(scope='module', params=[False, True],
                ids=['unfused_attn', 'fused_attn'])
def pair(request, jax_side):
    jax_model, variables = jax_side
    port = _port(variables, fused_attention=request.param, test_cfg=SLIDE)
    return jax_model, variables, port


def _img(seed, hw=(64, 96), batch=2):
    x = np.random.RandomState(seed).randn(batch, *hw, 3).astype(np.float32)
    return x, torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def test_state_dict_round_trip(jax_side, tmp_path):
    """JAX variables -> port state dict -> .pth -> the JAX package's strict
    loader gives back the same variables, bit for bit."""
    jax_model, variables = jax_side
    port = _port(variables)
    path = str(tmp_path / 'port.pth')
    torch.save(port.state_dict(), path)
    fresh = random_jax_variables(jax_model, seed=1)
    loaded = load_pth_into_variables(fresh, path, strict=True)

    def leaves(tree, prefix=''):
        for k, v in tree.items():
            if hasattr(v, 'items'):
                yield from leaves(v, f'{prefix}{k}/')
            else:
                yield f'{prefix}{k}', np.asarray(v)
    want = dict(leaves(variables))
    got = dict(leaves(loaded))
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_state_dict_has_reference_layout(jax_side):
    port = _port(jax_side[1])
    keys = set(port.state_dict())
    for k in ('backbone.block1.0.attn.q.weight',
              'backbone.block1.0.attn.sr.weight',
              'backbone.block1.0.mlp.dwconv.dwconv.weight',
              'backbone.patch_embed1.proj.weight', 'backbone.norm4.weight',
              'decode_head.linear_c4.proj.weight',
              'decode_head.linear_fuse.conv.weight',
              'decode_head.linear_fuse.bn.running_mean',
              'decode_head.linear_pred.weight'):
        assert k in keys, k
    assert not any('conv_seg' in k for k in keys)


def test_backbone_stages(pair):
    jax_model, variables, port = pair
    x, xt = _img(1)
    # one jit: op-by-op dispatch would compile each op of the MiT alone
    f_outs = run_jit(lambda v, i: jax_model.net.apply(
        v, i, train=False, method=jax_model.net.extract_feat),
        variables, jnp.asarray(x))
    with torch.no_grad():
        t_outs = port.extract_feat(xt)
    for s, (f, t) in enumerate(zip(f_outs, t_outs)):
        np.testing.assert_allclose(t.numpy(), nhwc_to_nchw(f), rtol=RTOL,
                                   atol=ATOL, err_msg=f'stage {s + 1}')


def test_head_logits(pair):
    jax_model, variables, port = pair
    x, xt = _img(2)
    want = jax_model.net.apply(variables, jnp.asarray(x), train=False,
                               with_aux=False)['decode']
    with torch.no_grad():
        got = port(xt)
    np.testing.assert_allclose(got.numpy(), nhwc_to_nchw(want), rtol=RTOL,
                               atol=ATOL)


def test_encode_decode(pair):
    jax_model, variables, port = pair
    x, xt = _img(3)
    want = jax_model.encode_decode(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port.encode_decode(xt)
    assert got.shape == (2, 19, 64, 96)
    np.testing.assert_allclose(got.numpy(), nhwc_to_nchw(want), rtol=RTOL,
                               atol=ATOL)


def test_whole_inference_rescaled(pair):
    jax_model, variables, port = pair
    x, xt = _img(4)
    want = jax_model.whole_inference(variables, jnp.asarray(x),
                                     ori_shape=(50, 70), rescale=True)
    with torch.no_grad():
        got = port.whole_inference(xt, ori_shape=(50, 70), rescale=True)
    np.testing.assert_allclose(got.numpy(), nhwc_to_nchw(want), rtol=RTOL,
                               atol=ATOL)


def test_slide_inference(pair):
    """96x160 image, 64^2 windows, stride 48: overlapping windows at both
    edges exercise the count-matrix averaging."""
    jax_model, variables, port = pair
    x, xt = _img(5, hw=(96, 160), batch=1)
    want = jax_model.slide_inference(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port.slide_inference(xt)
    np.testing.assert_allclose(got.numpy(), nhwc_to_nchw(want), rtol=RTOL,
                               atol=ATOL)


def test_simple_and_aug_test(pair):
    jax_model, variables, port = pair
    x, xt = _img(6, batch=1)
    jx = jnp.asarray(x)
    with torch.no_grad():
        probs = port.inference(xt, ori_shape=(64, 96), rescale=True)
        got = port.simple_test(xt, ori_shape=(64, 96))
        flipped = port.aug_test(
            [xt, xt.flip(dims=(3,))],
            [dict(ori_shape=(64, 96)),
             dict(ori_shape=(64, 96), flip=True)])
    want_probs = jax_model.inference(variables, jx, ori_shape=(64, 96),
                                     rescale=True)
    np.testing.assert_allclose(probs.numpy(), nhwc_to_nchw(want_probs),
                               rtol=RTOL, atol=ATOL)
    want_aug = jax_model.aug_test(
        variables, [jx, jnp.flip(jx, axis=2)],
        [dict(ori_shape=(64, 96)), dict(ori_shape=(64, 96), flip=True)])
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jnp.argmax(want_probs, axis=-1)))
    np.testing.assert_array_equal(flipped.numpy(), np.asarray(want_aug))


def test_kernels_are_on_the_path(pair, monkeypatch):
    """The head sums through fused_resize_sum and, with fused_attention,
    the attention runs through fused_sra_attention (their plain versions
    on the CPU)."""
    _, _, port = pair
    calls = {'resize_sum': 0, 'sra_attn': 0}

    def counting(mod, name, key):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    counting(resize_sum, 'resize_sum_plain', 'resize_sum')
    counting(sra_attn, 'sra_attention_plain', 'sra_attn')
    with torch.no_grad():
        port(_img(7)[1])
    assert calls['resize_sum'] == 1
    fused = port.backbone.block1[0].attn.fused_attention
    assert calls['sra_attn'] == (8 if fused else 0)  # one per block


def test_train_mode_attention_needs_no_grad(jax_side):
    """``fused_attention='train'`` needs no ``no_grad``: it carries
    gradients (K2 + K9; their plain versions here) and gives the unfused
    model's output; the forward-only ``True`` still raises outside
    ``no_grad``."""
    xt = _img(8)[1]
    forward_only = _port(jax_side[1], fused_attention=True)
    with pytest.raises(NotImplementedError, match='backward'):
        forward_only(xt)
    port = _port(jax_side[1], fused_attention='train')
    unfused = _port(jax_side[1])
    out = port(xt)
    assert out.shape == (2, 19, 16, 24) and out.requires_grad
    with torch.no_grad():
        want = unfused(xt)
    np.testing.assert_allclose(out.detach().numpy(), want.numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('gelu_approximate', [True, False])
def test_gelu_knob(jax_side, gelu_approximate):
    """The GELU form is a config knob on both sides (JAX default tanh,
    reference erf); each matches its counterpart."""
    _, variables = jax_side
    jax_model = build_jax_segmentor(
        segformer_cfg(gelu_approximate=gelu_approximate))
    port = _port(variables, gelu_approximate=gelu_approximate)
    x, xt = _img(9, hw=(32, 32), batch=1)
    want = run_jit(lambda v, i: jax_model.net.apply(
        v, i, train=False, with_aux=False)['decode'],
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(xt)
    np.testing.assert_allclose(got.numpy(), nhwc_to_nchw(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize('side,ok', [(28, False), (29, True)])
def test_token_grid_bound(jax_side, side, ok):
    """A stage grid is ceil(side / stride); stage 1 (stride 4, sr 8) needs
    8 rows, so 29 px is the smallest input side."""
    port = _port(jax_side[1])
    x = torch.zeros(1, 3, side, side)
    with torch.no_grad():
        if ok:
            assert port(x).shape == (1, 19, 8, 8)
        else:
            with pytest.raises(ValueError, match='at least 29px'):
                port(x)
