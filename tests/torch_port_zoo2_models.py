"""The checks that hold the last A10 backbones in the port to the JAX
package on the CPU, run as tests by one file a family
(``test_torch_port_zoo2_{resnet,fast_scnn,cgnet,unet}.py``, on a module
fixture ``case`` from :func:`make_case`): ResNeXt-50 with an FCN head,
ResNeSt-50 (d8, PSPHead and the FCN auxiliary head: the
``pspnet_s101-d8`` recipe's layout), Fast-SCNN with
``DepthwiseSeparableFCNHead`` (``concat_input``) and the fragment's two
FCN auxiliary heads (sigmoid CE), CGNet with the fragment's class-weighted
FCN head of no convs, and UNet under an FCN decode head and an FCN
auxiliary head (2 classes) in two layouts: the fragments' (every stage
pooled, every decoder an InterpConv) and one whose stage 3 strides and
stage 4 neither strides nor pools (a plain 1x1 ConvModule upsample),
with dilated stages. All narrow, dropout 0 (JAX's PRNG cannot be matched),
on the same seeded weights and inputs.

Each model, in fp32: the backbone's maps and the eval logits of every
head within 1e-5 of the largest |value| of each (``REL``), and the
train-mode loss dict against JAX's step 0 (in float64) at the fixtures'
``RTOL, ATOL`` (an accuracy within one pixel). In float64 on both sides:
every step-0 gradient within 5e-7 of the largest (``GRAD_REL``), and a
3-step trajectory of the port's train step against the JAX optimizer on
its own gradients (SGD, momentum 0.9, the heads at 10x, lr 1e-4; CGNet:
Adam at lr 1e-4, as mmseg's CGNet recipe trains Adam), each parameter and
BN running mean after each step within ``RTOL64`` of its largest value.
The JAX loader reads the port's state dict back onto the variables, bit
for bit, with nothing unmatched.

Narrow: ResNeXt and ResNeSt cut to their first two (ResNeSt: three)
stages, stem 16, base 8 (ResNeXt 4 groups of base width 4: 3x3 convs of
16, 32 channels); Fast-SCNN at widths (8, 12), 16, (16, 24, 32), 32 on
96 x 96 inputs (the first conv's padding 0 makes 47 x 47); CGNet at
(8, 16, 32) with (1, 2) blocks; UNet of base 8 on 64 x 64.
"""

import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from segdistill_tpu.convert.torch_loader import translate_state_dict
from segdistill_tpu.engine import build_lr_schedule as jax_lr_schedule
from segdistill_tpu.engine import build_optimizer as jax_build_optimizer
from segdistill_tpu.models import build_segmentor as build_jax_segmentor
from segdistill_tpu.models.decode_heads import psp_head as jax_psp_head
from segdistill_tpu_torch.convert import state_dict_from_jax
from segdistill_tpu_torch.engine import (TrainState, build_lr_schedule,
                                         build_optimizer, build_train_step)
from segdistill_tpu_torch.models import build_segmentor
from segdistill_tpu_torch.models.segmentors import parse_losses

import torch_port_extra_models as extra
from torch_port_fixtures import (ATOL, CE_LOSS, NORM, RTOL, float64_kept,
                                 nhwc_to_nchw, random_jax_variables)
from torch_port_zoo_models import (XLA_OPTIONS, _close_rel, _Float64Numpy,
                                   one_thread, run_jit)  # noqa: F401

GRAD_REL = 5e-7  # float64 step-0 gradients, of the largest
RTOL64 = 1e-5  # float64 trajectories, of each tensor's largest value
SGD = extra.OPTIMIZER
ADAM = dict(type='Adam', lr=1e-4, betas=(0.9, 0.999), weight_decay=0.0)
CITY_CLASSES, VESSEL_CLASSES = 19, 2
SIGMOID_CE = dict(CE_LOSS, use_sigmoid=True, loss_weight=0.4)
# the cgnet fragment's class weights (Cityscapes)
CGNET_WEIGHTS = [2.5959933, 6.7415504, 3.5354059, 9.8663225, 9.690899,
                 9.369352, 10.289121, 9.953208, 4.3097677, 9.490387,
                 7.674431, 9.396905, 10.347791, 6.3927646, 10.226669,
                 10.241062, 10.280587, 10.396974, 10.055647]
NORM_EPS3 = dict(NORM, eps=0.001)


def _head(type_, in_channels, in_index, channels, classes=CITY_CLASSES,
          loss=None, norm=None, **kw):
    return dict(type=type_, in_channels=in_channels, in_index=in_index,
                channels=channels, dropout_ratio=0.0, num_classes=classes,
                norm_cfg=dict(norm or NORM), align_corners=False,
                loss_decode=dict(loss or CE_LOSS), **kw)


def _segmentor(backbone, decode_head, aux=None):
    cfg = dict(type='EncoderDecoder', backbone=backbone,
               decode_head=decode_head, test_cfg=dict(mode='whole'))
    if aux is not None:
        cfg['auxiliary_head'] = aux
    return cfg


def resnext():
    return dict(type='ResNeXt', depth=50, groups=4, base_width=4,
                stem_channels=16, base_channels=8, num_stages=2,
                out_indices=(0, 1), strides=(1, 2), dilations=(1, 1),
                norm_cfg=dict(NORM), norm_eval=False, style='pytorch')


def resnest():
    """The recipe's ResNeSt (deep stem, average-pool shortcuts and stride),
    d8 over three stages: stage 2 strides (the 3x3 average pool), stage 3
    dilates by 2 after a first block at 1 (contract_dilation)."""
    return dict(type='ResNeSt', depth=50, stem_channels=16, base_channels=8,
                num_stages=3, out_indices=(0, 1, 2), strides=(1, 2, 1),
                dilations=(1, 1, 2), contract_dilation=True,
                norm_cfg=dict(NORM), norm_eval=False, style='pytorch')


def fast_scnn():
    return dict(type='FastSCNN', downsample_dw_channels=(8, 12),
                global_in_channels=16, global_block_channels=(16, 24, 32),
                global_block_strides=(2, 2, 1), global_out_channels=32,
                higher_in_channels=16, lower_in_channels=32,
                fusion_out_channels=32, out_indices=(0, 1, 2),
                norm_cfg=dict(NORM, momentum=0.01), align_corners=False)


def cgnet():
    return dict(type='CGNet', norm_cfg=dict(NORM_EPS3), in_channels=3,
                num_channels=(8, 16, 32), num_blocks=(1, 2),
                dilations=(2, 4), reductions=(8, 16))


def unet(**kw):
    return dict(dict(type='UNet', in_channels=3, base_channels=8,
                     num_stages=5, strides=(1, 1, 1, 1, 1),
                     enc_num_convs=(2, 2, 2, 2, 2), dec_num_convs=(2, 2, 2, 2),
                     downsamples=(True, True, True, True),
                     enc_dilations=(1, 1, 1, 1, 1),
                     dec_dilations=(1, 1, 1, 1), norm_cfg=dict(NORM),
                     act_cfg=dict(type='ReLU'),
                     upsample_cfg=dict(type='InterpConv'), norm_eval=False),
                **kw)


def _unet_fcn(backbone):
    return _segmentor(
        backbone, _head('FCNHead', 8, 4, 8, VESSEL_CLASSES, num_convs=1,
                        concat_input=False),
        _head('FCNHead', 16, 3, 8, VESSEL_CLASSES, num_convs=1,
              concat_input=False, loss=dict(CE_LOSS, loss_weight=0.4)))


MODELS = {
    'resnext': lambda: _segmentor(
        resnext(), _head('FCNHead', 64, 1, 16, num_convs=2,
                         concat_input=True)),
    'resnest': lambda: _segmentor(
        resnest(), _head('PSPHead', 128, 2, 16, pool_scales=(1, 2, 3, 6)),
        _head('FCNHead', 64, 1, 8, num_convs=1, concat_input=False,
              loss=dict(CE_LOSS, loss_weight=0.4))),
    'fast_scnn': lambda: _segmentor(
        fast_scnn(), _head('DepthwiseSeparableFCNHead', 32, -1, 16,
                           concat_input=True, loss=SIGMOID_CE),
        [_head('FCNHead', 32, -2, 8, num_convs=1, concat_input=False,
               loss=SIGMOID_CE),
         _head('FCNHead', 16, -3, 8, num_convs=1, concat_input=False,
               loss=SIGMOID_CE)]),
    'cgnet': lambda: _segmentor(
        cgnet(), _head('FCNHead', 64, 2, 64, num_convs=0,
                       concat_input=False, norm=NORM_EPS3,
                       loss=dict(CE_LOSS, class_weight=CGNET_WEIGHTS))),
    'unet': lambda: _unet_fcn(unet()),
    'unet_strided': lambda: _unet_fcn(unet(
        strides=(1, 1, 1, 2, 1), downsamples=(True, True, True, False),
        enc_dilations=(1, 1, 2, 1, 2), dec_dilations=(1, 2, 1, 1))),
}
HW = {'fast_scnn': (96, 96)}
# ResNeSt's split-attention bn1 normalises a 1x1 map: over the batch's
# values alone, so its trajectory at batch 2 (two values a channel, one
# difference) is chaotic: two float64 runs 1e-9 apart after one step are
# 7e-2 apart after three
BATCH = {'resnest': 4}
OPTIMIZERS = {'cgnet': ADAM}
CLASSES = {'unet': VESSEL_CLASSES, 'unet_strided': VESSEL_CLASSES}
MAX_ITERS = extra.MAX_ITERS
STEPS = 3


def _batch(name):
    hw = HW.get(name, (64, 64))
    classes = CLASSES.get(name, CITY_CLASSES)
    batch = BATCH.get(name, 2)
    rng = np.random.RandomState(0)
    img = rng.randn(batch, *hw, 3).astype(np.float32)
    gt = rng.randint(0, classes, (batch,) + hw).astype(np.int32)
    gt[0, :4] = 255
    return img, gt


def _jax_run(model, variables, img, gt, optimizer):
    """float64: ``STEPS`` steps of the JAX optimizer on the JAX gradients,
    the gradient and the update in one jitted step: per step the log vars,
    the gradients, and the params and BN statistics after it."""
    tx = jax_build_optimizer(optimizer, variables['params'],
                             jax_lr_schedule(extra.LR_CONFIG,
                                             optimizer['lr'], MAX_ITERS))

    def step(params, bstats, opt_state, key):
        grads, (log_vars, bstats) = jax.grad(
            extra._loss_fn(model, bstats, img, gt, key), has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return (grads, log_vars, optax.apply_updates(params, updates),
                bstats, opt_state)

    params, bstats = variables['params'], variables['batch_stats']
    opt_state = tx.init(params)
    step = jax.jit(step).lower(params, bstats, opt_state,
                               jax.random.key(11)).compile(
                                   compiler_options=XLA_OPTIONS)
    steps = []
    for i in range(STEPS):
        grads, log_vars, params, bstats, opt_state = step(
            params, bstats, opt_state, jax.random.key(11 + i))
        steps.append(dict(
            log_vars={k: float(v) for k, v in log_vars.items()},
            grads=jax.tree.map(np.asarray, grads),
            variables=jax.tree.map(np.asarray, {'params': params,
                                                'batch_stats': bstats})))
    return steps


def _pool_matrix64(in_size, out_size):
    """The JAX PSP pooling's averaging matrix (torch's bins) in float64:
    its float32 weights (1/3 and the like) start two float64 runs ~4e-8
    apart, which train-mode BN over two values a channel (ResNeSt's
    split-attention ``bn1`` on a 1x1 map at batch 2) magnifies ~400x a
    step."""
    mat = np.zeros((out_size, in_size), np.float64)
    for o in range(out_size):
        start, end = o * in_size // out_size, -(-(o + 1) * in_size
                                                 // out_size)
        mat[o, start:end] = 1.0 / (end - start)
    return mat


def make_case(name):
    """The model's JAX variables, its fp32 eval outputs (backbone maps,
    every head's logits) and its float64 3-step trajectory, each one jit.
    The float64 run traces the PSP pooling's float32 island in float64
    (:func:`_pool_matrix64`)."""
    make = MODELS[name]
    jax_model = build_jax_segmentor(make())
    variables = random_jax_variables(jax_model, seed=3)
    img, gt = _batch(name)

    def outputs(v, i):
        outs, inter = jax_model.net.apply(
            v, i, train=False, with_aux=True, mutable=['intermediates'],
            capture_intermediates=lambda mdl, method: (
                mdl.name == 'backbone' and method == '__call__'))
        return inter['intermediates']['backbone']['__call__'][0], outs
    feats, outs = jax.tree.map(np.asarray, run_jit(outputs, variables,
                                                   jnp.asarray(img)))
    optimizer = OPTIMIZERS.get(name, SGD)
    with jax.enable_x64(True), \
            mock.patch.object(jax_psp_head, 'jnp', _Float64Numpy()), \
            mock.patch.object(jax_psp_head, '_adaptive_pool_matrix',
                              _pool_matrix64):
        cfg64 = make()
        cfg64['backbone']['dtype'] = 'float64'
        steps = _jax_run(
            build_jax_segmentor(cfg64),
            jax.tree.map(lambda a: np.asarray(a, np.float64), variables),
            jnp.asarray(img, jnp.float64), jnp.asarray(gt), optimizer)
    return dict(name=name, make=make, jax_model=jax_model,
                variables=variables, img=img, gt=gt, steps=steps,
                feats=feats, outs=outs, optimizer=optimizer)


def port_model(case, float64=False):
    """The port's model on the JAX variables (``keys`` settle the
    shortcut and UNet slots)."""
    model = build_segmentor(case['make']())
    model.load_state_dict(state_dict_from_jax(
        case['variables'], keys=model.state_dict().keys()), strict=True)
    if float64:
        model.double()
        model.backbone.dtype = torch.float64
    return model


def _tensors(case, dtype=torch.float32):
    return (torch.from_numpy(nhwc_to_nchw(case['img']).copy()).to(dtype),
            torch.from_numpy(case['gt'].astype(np.int64)))


def _heads(port, feats):
    got = {'decode': port.decode_head(feats)}
    for prefix, head in port._aux_heads():
        got[prefix] = head(feats)
    return got


def check_feature_maps_and_logits(case):
    """The backbone's maps and the eval logits of every head, fp32."""
    want_feats, outs = case['feats'], case['outs']
    x, _ = _tensors(case)
    port = port_model(case).eval()
    with torch.no_grad():
        got_feats = port.extract_feat(x)
        got = _heads(port, got_feats)
    assert len(got_feats) == len(want_feats)
    for i, (g, w) in enumerate(zip(got_feats, want_feats)):
        _close_rel(g.numpy(), nhwc_to_nchw(w), f'level {i}')
    assert set(got) == set(outs), (sorted(got), sorted(outs))
    for k, g in got.items():
        _close_rel(g.numpy(), nhwc_to_nchw(outs[k]), f'{k} logits')


def check_losses(case):
    """The train-mode loss dict in fp32 against JAX's step 0 (in
    float64)."""
    want = case['steps'][0]['log_vars']
    port = port_model(case).train()
    x, y = _tensors(case)
    losses, _ = port.forward_train(x, y, generator=torch.Generator())
    _, got = parse_losses(losses)
    assert set(got) == set(want)
    for k in want:
        if '.acc_' in k:  # an argmax near-tie may flip: one pixel
            assert abs(got[k].item() - want[k]) <= 100.0 / \
                case['gt'].size * 1.001, k
        else:
            np.testing.assert_allclose(got[k].item(), want[k], rtol=RTOL,
                                       atol=ATOL, err_msg=k)


def check_step0_gradients_float64(case):
    """Every parameter's gradient, both packages in float64, within
    ``GRAD_REL`` of the largest."""
    step = case['steps'][0]
    port = port_model(case, float64=True).train()
    x, y = _tensors(case, torch.float64)
    with float64_kept():
        losses, _ = port.forward_train(x, y, generator=torch.Generator())
        total, got = parse_losses(losses)
        total.backward()
    for k, v in step['log_vars'].items():
        np.testing.assert_allclose(got[k].item(), v, rtol=GRAD_REL, err_msg=k)
    grads = state_dict_from_jax({'params': step['grads']},
                                keys=port.state_dict().keys())
    named = dict(port.named_parameters())
    assert named.keys() == grads.keys()
    scale = max(float(g.abs().max()) for g in grads.values())
    for k, g in grads.items():
        assert named[k].grad is not None, k
        np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(), rtol=0,
                                   atol=GRAD_REL * scale, err_msg=k)


def check_trajectory_float64(case):
    """Three steps of the port's train step and optimizer against the JAX
    package's optimizer on its own gradients, float64 on both sides: the
    loss terms, the learning rate, and every parameter and BN running mean
    after each step (SGD without weight decay, where the two packages'
    updates agree; CGNet's Adam likewise)."""
    port = port_model(case, float64=True)
    optimizer = build_optimizer(case['optimizer'], port)
    assert type(optimizer).__name__ == case['optimizer']['type']
    schedule = build_lr_schedule(extra.LR_CONFIG, case['optimizer']['lr'],
                                 MAX_ITERS)
    step_fn = build_train_step(port, optimizer, schedule)
    state = TrainState(model=port, optimizer=optimizer, seed=0)
    x, y = _tensors(case, torch.float64)
    keys = port.state_dict().keys()
    for i, ref in enumerate(case['steps']):
        with float64_kept():
            log_vars = step_fn(state, x, y)
        assert log_vars['lr'] == pytest.approx(schedule(i))
        for k, v in ref['log_vars'].items():
            extra._close64(float(log_vars[k]), v, abs(v), f'step {i + 1} {k}')
        want = state_dict_from_jax(ref['variables'], keys=keys)
        got = port.state_dict()
        for k, w in want.items():
            if not k.endswith(('running_var', 'num_batches_tracked')):
                extra._close64(got[k].numpy(), w.numpy(),
                               float(w.abs().max()), f'step {i + 1} {k}')


def check_the_jax_loader_reads_the_port_state_dict(case):
    """The port's state dict (the reference layout) through the JAX
    package's loader gives back the variables, bit for bit: every tensor
    but those of a list of auxiliary heads (Fast-SCNN's
    ``auxiliary_head.{i}.*``), which that loader has no rule for (ROADMAP,
    known faults on the reference side); nothing else is left unmatched
    on either side."""
    state = {k: v.numpy() for k, v in port_model(case).state_dict().items()}
    fresh = random_jax_variables(case['jax_model'], seed=9)
    loaded, _, missing, unexpected = translate_state_dict(state, fresh)
    lost = sorted(k for k in state if re.match(r'auxiliary_head\.\d+\.', k)
                  and not k.endswith('num_batches_tracked'))
    assert sorted(unexpected) == lost
    assert (case['name'] == 'fast_scnn') == bool(lost)
    assert all(path[1].startswith('auxiliary_head_') for path in missing)
    assert len(missing) == len(lost)
    skip = {'/'.join(k) for k in missing}
    want = dict(extra._leaves(case['variables']))
    got = dict(extra._leaves(loaded))
    assert want.keys() == got.keys()
    for k, w in want.items():
        if k not in skip:
            assert np.array_equal(got[k], w), k


CHECKS = ['feature_maps_and_logits', 'losses', 'step0_gradients_float64',
          'trajectory_float64', 'the_jax_loader_reads_the_port_state_dict']
