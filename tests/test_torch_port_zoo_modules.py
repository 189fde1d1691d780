"""This slice's modules alone against the JAX package, fp32 on the CPU, on
seeded random weights (every leaf, BN statistics included) and N(0, 1)
inputs, at the fixtures' ``RTOL, ATOL`` (gradients: ``ATOL`` of the
largest): ``build_activation`` for each type (HSigmoid at mmcv 1.2.2's
defaults and at SELayer's 3 / 6), ``DepthwiseSeparableConvModule`` with
its ``dw_*`` / ``pw_*`` overrides, SELayer, the two inverted residuals
(V3's stride-2 TF-SAME pad on even and odd sizes), the self-attention
block in four forms, and LRASPPHead with its coarsest map under 49 on a
side (the clamped pool window) and at least 49 (the true 49 x 49 window).
Then the Cityscapes recipes of ``segdistill_tpu_torch.recipes`` at full
width: the schedule and data they compose, and the port's state
dict, which the JAX loader places onto the JAX model's variables with
nothing missing or left over. Last, HRNet's fuse upsample against the
reference's (scale factor, then a resize to the target's size).
"""

from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from segdistill_tpu.convert.torch_loader import translate_state_dict
from segdistill_tpu.models import build_head as build_jax_head
from segdistill_tpu.models import build_segmentor as build_jax_segmentor
from segdistill_tpu.models import utils as jax_utils
from segdistill_tpu.models.utils.activation import PReLU as JaxPReLU
from segdistill_tpu.models.utils.activation import \
    build_activation as jax_activation
from segdistill_tpu.models.utils.self_attention_block import \
    SelfAttentionBlock as JaxSelfAttentionBlock
from segdistill_tpu_torch.convert import state_dict_from_jax
from segdistill_tpu_torch.models import build_head, build_segmentor
from segdistill_tpu_torch.models import utils
from segdistill_tpu_torch.models.utils.activation import (
    HSigmoid, PReLU, build_activation)
from segdistill_tpu_torch.models.utils.self_attention_block import \
    SelfAttentionBlock
from segdistill_tpu_torch.ops import resize
from segdistill_tpu_torch.recipes import RECIPES, cityscapes_recipe

from torch_port_fixtures import (ATOL, CE_LOSS, NORM, NUM_CLASSES, RTOL,
                                 _randomize_leaf, nhwc_to_nchw)
from torch_port_zoo_models import one_thread, run_jit  # noqa: F401


def _close(got, want, what, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=atol, err_msg=what)


def _nchw(x):
    return torch.from_numpy(nhwc_to_nchw(x).copy())


def _variables(module, *args, seed=1, **kw):
    """Seeded values for every leaf of a flax module's variables."""
    shapes = jax.eval_shape(lambda: module.init(
        {'params': jax.random.key(0)}, *args, **kw))
    rng = np.random.RandomState(seed)

    def walk(tree, path):
        return {k: walk(v, path + (k,)) if isinstance(v, Mapping) else
                _randomize_leaf(path + (k,), v.shape, rng).astype(np.float32)
                for k, v in tree.items()}
    return {c: walk(shapes[c], (c,)) for c in ('params', 'batch_stats')
            if c in shapes}


def _state_dict(variables, under=None):
    """``state_dict_from_jax`` of a module's variables; ``under`` names the
    module within a backbone (an MNv2 block, ``layer2_0``: its Sequential
    slots depend on the name)."""
    if under is None:
        return state_dict_from_jax(variables)
    state = state_dict_from_jax({c: {under: t} for c, t in variables.items()})
    prefix = under.replace('_', '.') + '.'
    assert all(k.startswith(prefix) for k in state)
    return {k[len(prefix):]: v for k, v in state.items()}


def _module_pair(jax_module, port_module, x, train, under=None):
    """The JAX module's and the port's outputs on ``x`` (NHWC), the port
    on the JAX variables (its state dict from ``state_dict_from_jax``)."""
    xj = jnp.asarray(x)
    variables = _variables(jax_module, xj)
    port_module.load_state_dict(_state_dict(variables, under), strict=True)
    want = run_jit(lambda v, x: jax_module.apply(
        v, x, train=train, mutable=['batch_stats'] if train else False),
        variables, xj)
    want = want[0] if train else want
    with torch.no_grad():
        got = port_module.train(train)(_nchw(x))
    return got.numpy(), nhwc_to_nchw(want)


ACTIVATIONS = {
    'ReLU': dict(type='ReLU'), 'ReLU6': dict(type='ReLU6'),
    'GELU': dict(type='GELU'),
    'LeakyReLU': dict(type='LeakyReLU', negative_slope=0.2),
    'Sigmoid': dict(type='Sigmoid'), 'HSigmoid': dict(type='HSigmoid'),
    'HSigmoid 3/6': dict(type='HSigmoid', bias=3.0, divisor=6.0),
    'HSwish': dict(type='HSwish'), 'Swish': dict(type='Swish'),
    'Tanh': dict(type='Tanh')}


@pytest.mark.parametrize('name', sorted(ACTIVATIONS))
def test_build_activation_matches_jax(name):
    x = np.random.RandomState(0).randn(2, 5, 6, 7).astype(np.float32) * 4
    want = jax_activation(dict(ACTIVATIONS[name]))(jnp.asarray(x))
    got = build_activation(dict(ACTIVATIONS[name]))(torch.from_numpy(x))
    _close(got.numpy(), want, name)


def test_prelu_matches_jax():
    x = np.random.RandomState(0).randn(2, 5, 6, 7).astype(np.float32)
    variables = {'params': {'weight': np.linspace(
        -0.5, 0.5, 7).astype(np.float32)}}
    want = JaxPReLU().apply(variables, jnp.asarray(x))
    port = PReLU(7)
    port.load_state_dict(state_dict_from_jax(
        {'params': {'activate': variables['params']}}), strict=False)
    port.weight.data = torch.from_numpy(variables['params']['weight'])
    with torch.no_grad():
        got = port(_nchw(x))
    _close(got.numpy(), nhwc_to_nchw(want), 'prelu')


def test_hsigmoid_defaults_and_the_se_layer_gate():
    """mmcv 1.2.2's HSigmoid is clamp((x + 1) / 2, 0, 1); SELayer's gate
    passes bias 3, divisor 6 (clamp((x + 3) / 6, 0, 1))."""
    x = torch.tensor([-4.0, -1.0, 0.0, 0.5, 1.0, 3.0])
    assert HSigmoid()(x).tolist() == [0.0, 0.0, 0.5, 0.75, 1.0, 1.0]
    gate = utils.SELayer(16, ratio=4).conv2.activate
    assert (gate.bias, gate.divisor) == (3.0, 6.0)
    assert torch.allclose(gate(x), ((x + 3) / 6).clamp(0, 1))
    assert isinstance(utils.SELayer(16).conv1.activate,
                      type(build_activation(dict(type='ReLU'))))


# (overrides, whether the depthwise / pointwise ConvModules have a norm
# and an activation)
DSCONV = {
    'defaults': ({}, (True, True), (True, True)),
    'dw act None': (dict(dw_act_cfg=None), (True, False), (True, True)),
    'pw norm None': (dict(pw_norm_cfg=None), (True, True), (False, True)),
    'dw norm None, pw HSwish': (
        dict(dw_norm_cfg=None, pw_act_cfg=dict(type='HSwish')),
        (False, True), (True, True)),
}


@pytest.mark.parametrize('name', sorted(DSCONV))
@pytest.mark.parametrize('train', [False, True])
def test_depthwise_separable_conv_module_matches_jax(name, train):
    overrides, dw, pw = DSCONV[name]
    kw = dict(kernel_size=3, padding=2, dilation=2, norm_cfg=dict(NORM),
              **overrides)
    port = utils.DepthwiseSeparableConvModule(6, 10, **kw)
    for part, (norm, act) in ((port.depthwise_conv, dw),
                              (port.pointwise_conv, pw)):
        assert (part.with_norm, part.with_act) == (norm, act)
        assert (part.conv.bias is None) == norm
    assert port.depthwise_conv.conv.groups == 6
    x = np.random.RandomState(1).randn(2, 9, 11, 6).astype(np.float32)
    got, want = _module_pair(
        jax_utils.DepthwiseSeparableConvModule(out_channels=10, **kw),
        port, x, train)
    _close(got, want, name)


def test_se_layer_matches_jax():
    x = np.random.RandomState(2).randn(2, 7, 5, 24).astype(np.float32)
    got, want = _module_pair(jax_utils.SELayer(channels=24, ratio=4),
                             utils.SELayer(24, ratio=4), x, False)
    _close(got, want, 'se')


# (JAX module, port module, input side, train)
def _residuals():
    norm = dict(NORM)
    se = dict(channels=24, ratio=4)
    return {
        'v2 expand 1': (
            jax_utils.InvertedResidual(out_channels=8, expand_ratio=1,
                                       norm_cfg=norm),
            utils.InvertedResidual(8, 8, 1, 1, norm_cfg=norm), 9, True),
        'v2 stride 2': (
            jax_utils.InvertedResidual(out_channels=12, stride=2,
                                       expand_ratio=6, norm_cfg=norm),
            utils.InvertedResidual(8, 12, 2, 6, norm_cfg=norm), 9, True),
        'v2 dilation 2 residual': (
            jax_utils.InvertedResidual(out_channels=8, expand_ratio=6,
                                       dilation=2, norm_cfg=norm),
            utils.InvertedResidual(8, 8, 1, 6, dilation=2, norm_cfg=norm),
            9, False),
        'v3 stride 2 even': (
            jax_utils.InvertedResidualV3(out_channels=12, mid_channels=24,
                                         kernel_size=5, stride=2,
                                         se_cfg=se, norm_cfg=norm,
                                         act_cfg=dict(type='HSwish')),
            utils.InvertedResidualV3(8, 12, 24, 5, 2, se_cfg=se,
                                     norm_cfg=norm,
                                     act_cfg=dict(type='HSwish')), 10, True),
        'v3 stride 2 odd': (
            jax_utils.InvertedResidualV3(out_channels=12, mid_channels=24,
                                         kernel_size=3, stride=2,
                                         norm_cfg=norm),
            utils.InvertedResidualV3(8, 12, 24, 3, 2, norm_cfg=norm), 11,
            True),
        'v3 dilated, no expand, residual': (
            jax_utils.InvertedResidualV3(
                out_channels=8, mid_channels=8, kernel_size=5, dilation=2,
                with_expand_conv=False, se_cfg=dict(channels=8, ratio=4),
                norm_cfg=norm),
            utils.InvertedResidualV3(
                8, 8, 8, 5, 1, dilation=2, with_expand_conv=False,
                se_cfg=dict(channels=8, ratio=4), norm_cfg=norm), 9, False),
    }


@pytest.mark.parametrize('name', sorted(_residuals()))
def test_inverted_residual_matches_jax(name):
    jax_module, port, side, train = _residuals()[name]
    x = np.random.RandomState(3).randn(2, side, side + 2, 8).astype(
        np.float32)
    got, want = _module_pair(jax_module, port, x, train,
                             'layer2_0' if name.startswith('v2') else None)
    assert got.shape == want.shape
    _close(got, want, name)


# (JAX / port keyword arguments) for the self-attention block on a 6 x 7
# query map of 12 channels and a 4 x 5 key map of 12
ATTENTION = {
    'ocr-like': dict(channels=8, out_channels=12, key_query_num_convs=2,
                     key_query_norm=True, value_out_norm=True),
    'bare, zero out': dict(channels=8, out_channels=12),
    'shared key/query, pyramid keys': dict(
        channels=8, out_channels=12, share_key_query=True,
        key_query_norm=True, key_pool_scales=(1, 3)),
    'no matmul norm, no out': dict(channels=8, out_channels=10,
                                   matmul_norm=False, with_out=False),
}


@pytest.mark.parametrize('name', sorted(ATTENTION))
def test_self_attention_block_matches_jax(name):
    kw = dict(ATTENTION[name], norm_cfg=dict(NORM))
    rng = np.random.RandomState(4)
    q = rng.randn(2, 6, 7, 12).astype(np.float32)
    k = rng.randn(2, 4, 5, 12).astype(np.float32)
    jax_block = JaxSelfAttentionBlock(**kw)
    variables = _variables(jax_block, jnp.asarray(q), jnp.asarray(k))
    want = run_jit(jax_block.apply, variables, jnp.asarray(q),
                   jnp.asarray(k))
    port = SelfAttentionBlock(12, 12, **kw).eval()
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        got = port(_nchw(q), _nchw(k))
    _close(got.numpy(), nhwc_to_nchw(want), name)
    port.init_weights(torch.Generator().manual_seed(0))
    if not kw.get('value_out_norm') and kw.get('with_out', True):
        assert not port.out_project.weight.any()  # the residual starts at 0


LRASPP = dict(type='LRASPPHead', in_channels=(4, 6, 10), in_index=(0, 1, 2),
              channels=8, input_transform='multiple_select',
              dropout_ratio=0.0, num_classes=NUM_CLASSES,
              norm_cfg=dict(NORM, eps=0.001), act_cfg=dict(type='ReLU'),
              align_corners=False, loss_decode=dict(CE_LOSS))


@pytest.mark.parametrize('coarsest', [(9, 12), (50, 70)],
                         ids=['clamped window', 'true window'])
def test_lraspp_head_matches_jax(coarsest):
    """Eval logits, the train-mode logits, loss dict and the gradients of
    the loss in every parameter and input map. A coarsest map of 50 x 70
    pools to 1 x 2 windows of 49 x 49 at stride (16, 20); 9 x 12 pools to
    one window of 9 x 12, where the reference raises."""
    h, w = coarsest
    rng = np.random.RandomState(5)
    xs = [rng.randn(2, h * f, w * f, c).astype(np.float32)
          for f, c in ((4, 4), (2, 6), (1, 10))]
    gt = rng.randint(0, NUM_CLASSES, (2, 8 * h, 8 * w)).astype(np.int32)
    gt[1, :3] = 255
    jax_head = build_jax_head(dict(LRASPP))
    variables = _variables(jax_head, [jnp.asarray(x) for x in xs])
    port = build_head(dict(LRASPP))
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    assert tuple(port.image_pool(torch.zeros(1, 10, h, w)).shape[2:]) == \
        ((1, 1) if h < 49 else (1, 2))
    want = run_jit(jax_head.apply, variables, [jnp.asarray(x) for x in xs])
    with torch.no_grad():
        got = port.eval()([_nchw(x) for x in xs])
    assert got.shape == (2, NUM_CLASSES, 4 * h, 4 * w)
    _close(got.numpy(), nhwc_to_nchw(want), 'eval logits')

    def loss(params, maps):
        out, _ = jax_head.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            maps, train=True, mutable=['batch_stats'])
        losses = jax_head.losses(out, jnp.asarray(gt))
        return losses['loss_seg'], (out, losses)
    (dp, dxs), (out, want) = run_jit(
        jax.grad(loss, argnums=(0, 1), has_aux=True), variables['params'],
        [jnp.asarray(x) for x in xs])
    ts = [_nchw(x).requires_grad_() for x in xs]
    logits = port.train()(ts)
    got = port.losses(logits, torch.from_numpy(gt.astype(np.int64)))
    _close(logits.detach().numpy(), nhwc_to_nchw(out), 'train logits')
    for k in ('loss_seg', 'acc_seg'):
        _close(got[k].item(), float(want[k]), k)
    got['loss_seg'].backward()
    grads = state_dict_from_jax({'params': jax.tree.map(np.asarray, dp)})
    scale = max(float(g.abs().max()) for g in grads.values())
    named = dict(port.named_parameters())
    assert named.keys() == grads.keys()
    for k, g in grads.items():
        _close(named[k].grad.numpy(), g.numpy(), k, atol=ATOL * scale)
    for i, (t, d) in enumerate(zip(ts, dxs)):
        _close(t.grad.numpy(), nhwc_to_nchw(d), f'input {i}',
               atol=ATOL * np.abs(d).max())


def test_make_divisible():
    from segdistill_tpu.models.utils import make_divisible as jax_md
    for value, divisor in ((3, 8), (12, 8), (37.5, 8), (16 * 0.35, 8),
                           (960 // 4, 8), (90, 16), (20, 16)):
        assert utils.make_divisible(value, divisor) == \
            jax_md(value, divisor)
    assert utils.make_divisible(30, 8, min_value=40) == 40


# recipe -> (segmentor, decode head(s), backbone)
RECIPE_MODELS = {
    'deeplabv3_r50-d8': ('EncoderDecoder', ('ASPPHead',), 'ResNet'),
    'deeplabv3plus_r50-d8': ('EncoderDecoder',
                             ('DepthwiseSeparableASPPHead',), 'ResNet'),
    'deeplabv3plus_m-v2-d8': ('EncoderDecoder',
                              ('DepthwiseSeparableASPPHead',),
                              'MobileNetV2'),
    'fcn_hr18': ('EncoderDecoder', ('FCNHead',), 'HRNet'),
    'ocrnet_hr18': ('CascadeEncoderDecoder', ('FCNHead', 'OCRHead'),
                    'HRNet'),
    'ocrnet_r50-d8': ('CascadeEncoderDecoder', ('FCNHead', 'OCRHead'),
                      'ResNet'),
    'lraspp_m-v3-d8': ('EncoderDecoder', ('LRASPPHead',), 'MobileNetV3'),
    'fast_scnn': ('EncoderDecoder', ('DepthwiseSeparableFCNHead',),
                  'FastSCNN'),
    'cgnet': ('EncoderDecoder', ('FCNHead',), 'CGNet'),
    'pspnet_s101-d8': ('EncoderDecoder', ('PSPHead',), 'ResNeSt'),
    'nonlocal_r50-d8': ('EncoderDecoder', ('NLHead',), 'ResNet'),
    'gcnet_r50-d8': ('EncoderDecoder', ('GCHead',), 'ResNet'),
    'dnl_r50-d8': ('EncoderDecoder', ('DNLHead',), 'ResNet'),
    'ccnet_r50-d8': ('EncoderDecoder', ('CCHead',), 'ResNet'),
    'ann_r50-d8': ('EncoderDecoder', ('ANNHead',), 'ResNet'),
    'apcnet_r50-d8': ('EncoderDecoder', ('APCHead',), 'ResNet'),
    'dmnet_r50-d8': ('EncoderDecoder', ('DMHead',), 'ResNet'),
    'danet_r50-d8': ('EncoderDecoder', ('DAHead',), 'ResNet'),
    'emanet_r50-d8': ('EncoderDecoder', ('EMAHead',), 'ResNet'),
    'encnet_r50-d8': ('EncoderDecoder', ('EncHead',), 'ResNet'),
}


def test_the_recipes_are_listed():
    assert sorted(RECIPES) == sorted(RECIPE_MODELS)


@pytest.mark.parametrize('name', sorted(RECIPE_MODELS))
def test_recipe_builds_with_the_reference_layout(name):
    """The recipe's schedule and data, and its model at full width: the
    JAX loader takes every tensor of the port's state dict onto the JAX
    model's variables (``jax.eval_shape``: nothing is computed) and leaves
    none of them missing. FCN-HR18 is OCRNet-HR18's first stage: its
    layout is that one's, tensor for tensor. Fast-SCNN's two auxiliary
    heads (a list) are the tensors that loader has no rule for (ROADMAP,
    known faults on the reference side)."""
    cfg = cityscapes_recipe(name)
    assert cfg.optimizer == dict(type='SGD', lr=0.01, momentum=0.9,
                                 weight_decay=0.0005)
    assert cfg.lr_config['policy'] == 'poly'
    assert cfg.runner['max_iters'] == int(RECIPES[name][1][:-1]) * 1000
    assert cfg.data['samples_per_gpu'] == 2
    assert cfg.crop_size == (512, 1024)
    assert cfg.data['test']['pipeline'][1]['img_scale'] == (2048, 1024)
    segmentor, heads, backbone = RECIPE_MODELS[name]
    model = build_segmentor(dict(cfg.model))
    assert type(model).__name__ == segmentor and model.num_classes == 19
    decode = model.decode_head if segmentor.startswith('Cascade') \
        else [model.decode_head]
    assert tuple(type(h).__name__ for h in decode) == heads
    assert type(model.backbone).__name__ == backbone
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    if name == 'fcn_hr18':
        # OCRNet-HR18's first stage, which its own case holds to JAX
        ocr = build_segmentor(dict(cityscapes_recipe('ocrnet_hr18').model))
        want = {k.replace('decode_head.0.', 'decode_head.'): tuple(v.shape)
                for k, v in ocr.state_dict().items()
                if not k.startswith('decode_head.1.')}
        assert {k: v.shape for k, v in state.items()} == want
        return
    jax_model = build_jax_segmentor(dict(cfg.model))
    shapes = jax.eval_shape(lambda: jax_model.net.init(
        {'params': jax.random.key(0)}, jnp.zeros((1, 64, 64, 3)),
        train=False, with_aux=True))
    variables = {c: jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                 shapes[c]) for c in ('params',
                                                      'batch_stats')}
    _, matched, missing, unexpected = translate_state_dict(state, variables)
    lost = sorted(k for k in state if k.startswith('auxiliary_head.')
                  and name == 'fast_scnn'
                  and not k.endswith('num_batches_tracked'))
    assert sorted(unexpected) == lost and len(missing) == len(lost)
    assert len(matched) == sum(1 for k in state
                               if not k.endswith('num_batches_tracked')) \
        - len(lost)


@pytest.mark.parametrize('size,agree', [((16, 32), True), ((15, 25), False)])
def test_hrnet_fuse_resize_against_the_reference(size, agree):
    """HRNet's fuse layer upsamples a branch j > i to branch i's size. The
    reference upsamples by 2^(j - i) (``Upsample(scale_factor)``), then
    resizes that to branch i's size; the port and the JAX package resize
    once. The two agree where branch i is exactly 2^(j - i) times branch j
    (any /32-divisible input) and differ elsewhere (a 15 x 25 branch over
    its 8 x 13 neighbour: ROADMAP, known faults on the reference side)."""
    x = torch.randn(1, 3, -(-size[0] // 2), -(-size[1] // 2),
                    generator=torch.Generator().manual_seed(6))
    port = resize(x, size=size, mode='bilinear', align_corners=False)
    ref = F.interpolate(F.interpolate(x, scale_factor=2, mode='bilinear',
                                      align_corners=False),
                        size=size, mode='bilinear', align_corners=False)
    assert torch.allclose(port, ref, atol=1e-6) == agree
