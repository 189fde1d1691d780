"""Backbone options the JAX package takes, in the port, on the CPU: ResNet's
``multi_grid`` (ResNet-18 and a deep-stem ResNet-50 with
``contract_dilation``) and Swin's absolute position embedding (``ape``,
resized from an 8 x 8 to the 16 x 16 token grid), each narrow under an FCN
head, against the JAX package on seeded weights carried across by
``state_dict_from_jax``; and the loaders' resize of a Swin relative
position bias table saved at another window size against the JAX
loader's ``_interp_bias_table`` (cv2 ``INTER_CUBIC``).

Tolerances. The backbone's maps and the logits, fp32: within 1e-5 of the
largest |value| of each (``REL``, as the other backbone parity tests).
The bias table: torch's bicubic and cv2's take the same a = -0.75 kernel
and clamp the same edges; cv2 sums the 16 taps in another order, so the
tables agree to fp32 rounding, within 1e-5 of the largest |value|
(measured 2.5e-6 relative).
"""

import numpy as np
import pytest
import torch

from segdistill_tpu.convert.torch_loader import _interp_bias_table
from segdistill_tpu.models import build_segmentor as build_jax_segmentor
from segdistill_tpu_torch.apis.inference import (load_backbone_checkpoint,
                                                 load_checkpoint,
                                                 resize_bias_table)
from segdistill_tpu_torch.convert import state_dict_from_jax
from segdistill_tpu_torch.models import build_segmentor
from segdistill_tpu_torch.models.backbones import ResNeSt, ResNeXt

from torch_port_fixtures import (CE_LOSS, NORM, nhwc_to_nchw,
                                 random_jax_variables)
from torch_port_zoo_models import one_thread, run_jit  # noqa: F401

REL = 1e-5
HW = (64, 64)


def _fcn(backbone, in_channels, in_index=-1):
    return dict(type='EncoderDecoder', backbone=backbone,
                decode_head=dict(type='FCNHead', in_channels=in_channels,
                                 in_index=in_index, channels=8, num_convs=1,
                                 concat_input=False, dropout_ratio=0.0,
                                 num_classes=5, norm_cfg=dict(NORM),
                                 align_corners=False,
                                 loss_decode=dict(CE_LOSS)),
                test_cfg=dict(mode='whole'))


def _resnet18():
    return _fcn(dict(type='ResNet', depth=18, stem_channels=8,
                     base_channels=8, strides=(1, 2, 1, 1),
                     dilations=(1, 1, 2, 4), multi_grid=(2, 3),
                     out_indices=(3,), norm_cfg=dict(NORM)), 64)


def _resnet50():
    return _fcn(dict(type='ResNetV1c', depth=50, stem_channels=8,
                     base_channels=4, strides=(1, 2, 1, 1),
                     dilations=(1, 1, 2, 4), contract_dilation=True,
                     multi_grid=(1, 2, 4), out_indices=(3,),
                     norm_cfg=dict(NORM)), 128)


def _swin_ape(window_size=4):
    return _fcn(dict(type='SwinTransformer', pretrain_img_size=32,
                     patch_size=4, embed_dim=16, depths=(2, 2),
                     num_heads=(1, 2), window_size=window_size,
                     drop_path_rate=0.0, ape=True, out_indices=(0, 1)), 32)


CASES = {'resnet18_multi_grid': _resnet18,
         'resnet50_v1c_multi_grid': _resnet50, 'swin_ape': _swin_ape}


def _close_rel(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=REL * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize('name', sorted(CASES))
def test_backbone_option_matches_jax(name):
    cfg = CASES[name]()
    jax_model = build_jax_segmentor(cfg)
    variables = random_jax_variables(jax_model, seed=5)
    img = np.random.RandomState(6).randn(2, *HW, 3).astype(np.float32)

    def outputs(v, x):
        outs, inter = jax_model.net.apply(
            v, x, train=False, with_aux=True, mutable=['intermediates'],
            capture_intermediates=lambda mdl, method: (
                mdl.name == 'backbone' and method == '__call__'))
        return inter['intermediates']['backbone']['__call__'][0], outs
    feats, outs = run_jit(outputs, variables, img)
    port = build_segmentor(cfg)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    port.eval()
    with torch.no_grad():
        got = port.extract_feat(torch.from_numpy(nhwc_to_nchw(img)))
        logits = port.decode_head(got)
    assert len(got) == len(feats)
    for i, (g, w) in enumerate(zip(got, feats)):
        _close_rel(g.numpy(), nhwc_to_nchw(w), f'{name} level {i}')
    _close_rel(logits.numpy(), nhwc_to_nchw(outs['decode']), f'{name} logits')
    if name == 'swin_ape':
        assert tuple(port.backbone.absolute_pos_embed.shape) == (1, 64, 16)


@pytest.mark.parametrize('backbone', [
    lambda mg: ResNeXt(depth=50, groups=4, base_width=4, stem_channels=16,
                       base_channels=8, strides=(1, 2, 2, 1),
                       dilations=(1, 1, 1, 2), multi_grid=mg),
    lambda mg: ResNeSt(depth=50, stem_channels=16, base_channels=8,
                       strides=(1, 2, 2, 1), dilations=(1, 1, 1, 2),
                       multi_grid=mg),
], ids=['resnext', 'resnest'])
def test_multi_grid_reaches_the_variants(backbone):
    """ResNeXt and ResNeSt take ``multi_grid`` through ResNet: block i of
    the last stage dilates its 3x3 conv by 2 * multi_grid[i]."""
    net = backbone((1, 2, 4))
    for i, block in enumerate(net.layer4):
        conv = next(m for m in block.modules()
                    if isinstance(m, torch.nn.Conv2d)
                    and m.kernel_size == (3, 3))
        assert conv.dilation == (2 * (1, 2, 4)[i],) * 2


def test_swin_refuses_frozen_stages():
    cfg = _swin_ape()['backbone']
    with pytest.raises(NotImplementedError, match='frozen'):
        build_segmentor(_fcn(dict(cfg, frozen_stages=1), 32))


@pytest.mark.parametrize('s1,s2,heads', [(7, 13, 3), (13, 7, 2),
                                         (5, 5, 1)])
def test_bias_table_resize_matches_jax(s1, s2, heads):
    table = np.random.RandomState(s1).randn((2 * s1 - 1) ** 2, heads) \
        .astype(np.float32)
    rows = (2 * s2 - 1) ** 2
    want = _interp_bias_table(table, (rows, heads))
    got = resize_bias_table(torch.from_numpy(table), rows)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close_rel(got.numpy(), want, f'{s1} -> {s2}')


def test_loaders_fit_swin_tensors(tmp_path):
    """A window-4 Swin checkpoint into a window-7 model: the lenient
    loaders resize every bias table (and read an ``absolute_pos_embed``
    saved as the reference model holds it, (1, C, H, W)); the strict one
    still refuses the shapes."""
    torch.manual_seed(0)
    small = build_segmentor(_swin_ape(window_size=4))
    small.init_weights(torch.Generator().manual_seed(1))
    state = small.state_dict()
    ape = state['backbone.absolute_pos_embed']
    state['backbone.absolute_pos_embed'] = ape.reshape(1, 8, 8, 16) \
        .permute(0, 3, 1, 2).clone()
    path = str(tmp_path / 'w4.pth')
    torch.save({'state_dict': state}, path)
    tables = {k: v for k, v in state.items()
              if k.endswith('relative_position_bias_table')}
    assert tables and all(v.shape[0] == 49 for v in tables.values())

    big = build_segmentor(_swin_ape(window_size=7))
    load_checkpoint(big, path, strict=False)
    got = big.state_dict()
    for k, v in tables.items():
        assert got[k].shape[0] == 169
        want = _interp_bias_table(v.numpy(), (169, v.shape[1]))
        _close_rel(got[k].numpy(), want, k)
    assert torch.equal(got['backbone.absolute_pos_embed'], ape)

    backbone_only = {k[len('backbone.'):]: v for k, v in state.items()
                     if k.startswith('backbone.')}
    torch.save(backbone_only, str(tmp_path / 'bb.pth'))
    fresh = build_segmentor(_swin_ape(window_size=7))
    matched, _, unexpected = load_backbone_checkpoint(
        fresh, str(tmp_path / 'bb.pth'))
    assert set(tables) <= set(matched) and not unexpected
    for k in tables:
        assert torch.equal(fresh.state_dict()[k], got[k])

    with pytest.raises(RuntimeError, match='size mismatch'):
        load_checkpoint(build_segmentor(_swin_ape(window_size=7)), path)
