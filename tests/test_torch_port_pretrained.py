"""The port's backbone-only ``pretrained`` loader against the JAX package's.

A seeded small MiT-b0 segmentor of the port saves its backbone as a ``.pth``
with and without the ``backbone.`` prefix (plus a classifier key, as the
published ImageNet files carry); both packages load it leniently into a
model seeded otherwise: the same backbone outputs on a seeded input (the
fixtures' fp32 ``RTOL, ATOL``), the head untouched. Also the training API's
paths to that loader and ``set_random_seed``'s default.
"""

import inspect
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segdistill_tpu.apis.train import set_random_seed as jax_set_random_seed
from segdistill_tpu.convert.torch_loader import load_pth_into_variables
from segdistill_tpu.models import build_segmentor as build_jax_segmentor
from segdistill_tpu_torch.apis import init_segmentor_state, set_random_seed
from segdistill_tpu_torch.apis.inference import load_backbone_checkpoint
from segdistill_tpu_torch.config import Config
from segdistill_tpu_torch.convert import state_dict_from_jax
from segdistill_tpu_torch.models import build_segmentor

from torch_port_fixtures import (ATOL, RTOL, nhwc_to_nchw,
                                 random_jax_variables, segformer_cfg)


def _port(jax_model, seed):
    model = build_segmentor(segformer_cfg())
    model.load_state_dict(
        state_dict_from_jax(random_jax_variables(jax_model, seed=seed)),
        strict=True)
    return model.eval()


@pytest.fixture(scope='module')
def jax_model():
    return build_jax_segmentor(segformer_cfg())


@pytest.fixture(scope='module')
def source(jax_model):
    return _port(jax_model, seed=3)


def _save_backbone(source, path, prefixed):
    state = {(k if prefixed else k[len('backbone.'):]): v
             for k, v in source.state_dict().items()
             if k.startswith('backbone.')}
    # what an ImageNet file carries and a segmentor lacks
    state[('backbone.' if prefixed else '') + 'head.weight'] = \
        torch.zeros(10, 256)
    torch.save({'state_dict': state}, path)
    return len(state) - 1


@pytest.mark.parametrize('prefixed', [True, False],
                         ids=['with-prefix', 'bare-keys'])
def test_backbone_checkpoint_matches_jax_loader(jax_model, source, tmp_path,
                                                prefixed, caplog):
    path = str(tmp_path / 'mit_b0.pth')
    n = _save_backbone(source, path, prefixed)
    target = _port(jax_model, seed=4)
    head_before = {k: v.clone() for k, v in target.state_dict().items()
                   if k.startswith('decode_head.')}
    with caplog.at_level(logging.INFO):
        matched, missing, unexpected = load_backbone_checkpoint(target, path)
    assert len(matched) == n
    assert all(k.startswith('backbone.') for k in matched)
    assert unexpected == ['backbone.head.weight']
    assert missing and all(k.startswith('decode_head.') for k in missing)
    assert f'{n} tensors matched' in caplog.text
    assert 'backbone.head.weight' in caplog.text
    for k, v in target.state_dict().items():
        if k.startswith('decode_head.'):
            assert torch.equal(v, head_before[k]), k
        else:
            assert torch.equal(v, source.state_dict()[k]), k

    variables = load_pth_into_variables(
        random_jax_variables(jax_model, seed=4), path, strict=False,
        backbone_only=True)
    x = np.random.RandomState(5).randn(2, 64, 96, 3).astype(np.float32)
    want = jax_model.net.apply(variables, jnp.asarray(x), train=False,
                               method=jax_model.net.extract_feat)
    with torch.no_grad():
        got = target.extract_feat(
            torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    for s, (f, t) in enumerate(zip(want, got)):
        np.testing.assert_allclose(t.numpy(), nhwc_to_nchw(f), rtol=RTOL,
                                   atol=ATOL, err_msg=f'stage {s + 1}')


def test_backbone_checkpoint_skips_a_wrong_shape(jax_model, source, tmp_path):
    state = {k: v for k, v in source.state_dict().items()
             if k.startswith('backbone.')}
    state['backbone.norm4.weight'] = torch.ones(7)
    path = str(tmp_path / 'odd.pth')
    torch.save(state, path)
    target = _port(jax_model, seed=4)
    before = target.state_dict()['backbone.norm4.weight'].clone()
    _, missing, unexpected = load_backbone_checkpoint(target, path)
    assert unexpected == ['backbone.norm4.weight']
    assert 'backbone.norm4.weight' in missing
    assert torch.equal(target.state_dict()['backbone.norm4.weight'], before)


def _sd_config(pretrained):
    student = segformer_cfg()
    student['pretrained'] = pretrained
    return Config(dict(model=dict(
        type='SDModule', cfg_s=student, cfg_t=segformer_cfg(),
        distillation=[], s_pretrain=None, t_pretrain=None)))


@pytest.mark.parametrize('kind', ['student-of-a-distiller', 'segmentor'])
def test_init_segmentor_state_loads_pretrained(source, tmp_path, kind):
    path = str(tmp_path / 'mit_b0.pth')
    _save_backbone(source, path, prefixed=False)
    if kind == 'segmentor':
        cfg = Config(dict(model=dict(segformer_cfg(), pretrained=path)))
    else:
        cfg = _sd_config(path)
    model = init_segmentor_state(cfg, seed=1, device='cpu')
    net = getattr(model, 'student', model)
    for k, v in source.state_dict().items():
        if k.startswith('backbone.'):
            assert torch.equal(net.state_dict()[k], v), k
    missing = str(tmp_path / 'nowhere.pth')
    cfg = Config(dict(model=dict(segformer_cfg(), pretrained=missing))) \
        if kind == 'segmentor' else _sd_config(missing)
    with pytest.raises(FileNotFoundError, match='nowhere.pth'):
        init_segmentor_state(cfg, seed=1, device='cpu')


def test_set_random_seed_default_matches_jax():
    default = inspect.signature(set_random_seed).parameters['deterministic']
    want = inspect.signature(jax_set_random_seed).parameters['deterministic']
    assert default.default is want.default is True
