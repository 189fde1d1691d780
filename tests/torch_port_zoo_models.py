"""The checks that hold this slice's Cityscapes models in the port to the
JAX package on the CPU, run as tests by one file a family
(``test_torch_port_zoo_{deeplab,hrnet_ocr,mobilenet}.py``, on a module
fixture ``case`` from :func:`make_case`): DeepLabV3 and DeepLabV3+ on a
ResNetV1c-d8, each with the FCN auxiliary head; FCN and OCRNet (a
cascade: FCN at weight 0.4, then OCR) on HRNet, and OCRNet on the
ResNetV1c-d8; DeepLabV3+ on MobileNetV2-d8 with the FCN auxiliary head
and LRASPP on MobileNetV3-small. All
narrow, 19 classes, dropout 0 (JAX's PRNG cannot be matched), on the same
seeded weights and 64 x 64 inputs (the MobileNets 32 x 32).

Each model, in fp32: the backbone's maps and the logits of every head
within 1e-5 of the largest |value| of each (``REL``), and the train-mode
loss dict against JAX's step 0 (in float64) at the fixtures' ``RTOL,
ATOL`` (an accuracy within one pixel). In float64 on both sides: every
step-0 gradient within 5e-7 of the largest (``GRAD_REL``; the JAX
package's float32 islands traced in float64, :func:`_float64_islands`),
and the 3-step SGD trajectory of ``torch_port_extra_models`` (momentum
0.9, the heads at 10x, lr 1e-4, ``RTOL64``). The JAX loader reads the
port's state dict with nothing unmatched, bit for bit.

Narrow: a ResNetV1c-18-d8 (``torch_port_fixtures.resnet_v1c`` at depth
18: basic blocks, widths 8, 16, 32, 64; the fragments' depth 50 is held
in the Tab5 and configs/extra tests); HRNet with one module a stage and
branch widths (4, 8, 16, 32) (stage 1: two bottlenecks of 8, stage 2 two
blocks a branch); ASPP heads of 16 channels at dilations (1, 2, 3, 4), so
that every tap of the 3x3 branches reads the 8 x 8 map (the fragments'
12, 24, 36 would read padding alone there); OCR 32 channels and
``ocr_channels`` 16; MobileNetV2 at widen factor 0.25; MobileNetV3-small
with the LRASPP fragment's BN eps 0.001.
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from segdistill_tpu.engine import build_lr_schedule as jax_lr_schedule
from segdistill_tpu.engine import build_optimizer as jax_build_optimizer
from segdistill_tpu.models import build_segmentor as build_jax_segmentor
from segdistill_tpu.models.decode_heads import ocr_head as jax_ocr_head
from segdistill_tpu.models.utils import self_attention_block as jax_attention
from segdistill_tpu_torch.convert import state_dict_from_jax
from segdistill_tpu_torch.models.segmentors import parse_losses

import torch_port_extra_models as extra
from torch_port_fixtures import (ATOL, CE_LOSS, NORM, NUM_CLASSES, RTOL,
                                 float64_kept, fcn_aux, nhwc_to_nchw,
                                 random_jax_variables, resnet_v1c)

HW = (64, 64)
# the MobileNets at 32 x 32 (stride-8 maps of 4 x 4; their JAX float64
# steps are the slowest to run)
SMALL_HW = {'deeplabv3plus_mnv2': (32, 32), 'lraspp_mnv3': (32, 32)}
REL = 1e-5  # fp32 maps and logits, of the largest |value|
GRAD_REL = 5e-7  # float64 step-0 gradients, of the largest
DILATIONS = (1, 2, 3, 4)
NORM_EPS3 = dict(NORM, eps=0.001)


def _head(type_, in_channels, in_index, channels, weight=1.0, norm=None,
          **kw):
    return dict(type=type_, in_channels=in_channels, in_index=in_index,
                channels=channels, dropout_ratio=0.0,
                num_classes=NUM_CLASSES, norm_cfg=dict(norm or NORM),
                align_corners=False,
                loss_decode=dict(CE_LOSS, loss_weight=weight), **kw)


def _segmentor(backbone, decode_head, aux=None):
    cfg = dict(type='CascadeEncoderDecoder' if isinstance(decode_head, list)
               else 'EncoderDecoder', backbone=backbone,
               decode_head=decode_head, test_cfg=dict(mode='whole'))
    if isinstance(decode_head, list):
        cfg['num_stages'] = len(decode_head)
    if aux is not None:
        cfg['auxiliary_head'] = aux
    return cfg


def resnet18_d8():
    """ResNetV1c-18, d8, stem 16, base 8: stage widths 8, 16, 32, 64."""
    return dict(resnet_v1c(), depth=18)


def fcn_aux18():
    """The fragments' FCN auxiliary head on stage 3 (32 channels)."""
    return dict(fcn_aux(), in_channels=32)


def hrnet(widths=(4, 8, 16, 32)):
    def stage(n, block, blocks):
        return dict(num_modules=1, num_branches=n, block=block,
                    num_blocks=(blocks,) * n, num_channels=widths[:n])
    return dict(type='HRNet', norm_cfg=dict(NORM), norm_eval=False,
                extra=dict(stage1=dict(num_modules=1, num_branches=1,
                                       block='BOTTLENECK', num_blocks=(2,),
                                       num_channels=(8,)),
                           stage2=stage(2, 'BASIC', 2),
                           stage3=stage(3, 'BASIC', 1),
                           stage4=stage(4, 'BASIC', 1)))


def hr_fcn(weight=1.0):
    return _head('FCNHead', [4, 8, 16, 32], (0, 1, 2, 3), 60, weight,
                 input_transform='resize_concat', kernel_size=1,
                 num_convs=1, concat_input=False)


def hr_ocr():
    return _head('OCRHead', [4, 8, 16, 32], (0, 1, 2, 3), 32,
                 input_transform='resize_concat', ocr_channels=16)


def mobilenet_v2():
    return dict(type='MobileNetV2', widen_factor=0.25,
                strides=(1, 2, 2, 1, 1, 1, 1),
                dilations=(1, 1, 1, 2, 2, 4, 4), out_indices=(1, 2, 4, 6),
                norm_cfg=dict(NORM))


MODELS = {
    'deeplabv3': lambda: _segmentor(
        resnet18_d8(), _head('ASPPHead', 64, 3, 16, dilations=DILATIONS),
        fcn_aux18()),
    'deeplabv3plus': lambda: _segmentor(
        resnet18_d8(), _head('DepthwiseSeparableASPPHead', 64, 3, 16,
                             dilations=DILATIONS, c1_in_channels=8,
                             c1_channels=8), fcn_aux18()),
    'deeplabv3plus_mnv2': lambda: _segmentor(
        mobilenet_v2(), _head('DepthwiseSeparableASPPHead', 80, 3, 16,
                              dilations=DILATIONS, c1_in_channels=8,
                              c1_channels=8),
        dict(fcn_aux(), in_channels=24)),
    'fcn_hr': lambda: _segmentor(hrnet(), hr_fcn()),
    'ocrnet_hr': lambda: _segmentor(hrnet(), [hr_fcn(0.4), hr_ocr()]),
    'ocrnet_r': lambda: _segmentor(
        resnet18_d8(), [fcn_aux18(),
                        _head('OCRHead', 64, 3, 16, ocr_channels=16)]),
    'lraspp_mnv3': lambda: _segmentor(
        dict(type='MobileNetV3', arch='small', out_indices=(0, 1, 12),
             norm_cfg=dict(NORM_EPS3)),
        _head('LRASPPHead', (16, 16, 576), (0, 1, 2), 16, norm=NORM_EPS3,
              input_transform='multiple_select', act_cfg=dict(type='ReLU'))),
}


def _batch(hw):
    rng = np.random.RandomState(0)
    img = rng.randn(2, *hw, 3).astype(np.float32)
    gt = rng.randint(0, NUM_CLASSES, (2,) + hw).astype(np.int32)
    gt[0, :4] = 255
    return img, gt


# The JAX runs compile with a single-threaded runtime and the port runs on
# one torch thread (``one_thread``): the tier-1 command runs six test
# processes on the CPU's cores, where XLA's and torch's own thread pools
# would take the cores from each other (these files took 13x their time
# alone there).
XLA_OPTIONS = {'xla_cpu_multi_thread_eigen': False}


def run_jit(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with :data:`XLA_OPTIONS`."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options=XLA_OPTIONS)(*args)


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """Torch on one thread while the module's tests run (a test module
    that imports this fixture uses it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def _float64_islands():
    """Within the block, the JAX package's float32 islands on these paths
    (OCR's spatial gather, the attention block's similarity and softmax:
    ``.astype(jnp.float32)``) trace in float64: a float64 run then rounds
    nothing to float32 (their rounding, magnified by train-mode BN over a
    few values a channel, lies up to 1.2e-6 of the largest gradient from
    float64). The fp32 checks hold the islands as they are."""
    with mock.patch.object(jax_ocr_head, 'jnp', _Float64Numpy()), \
            mock.patch.object(jax_attention, 'jnp', _Float64Numpy()):
        yield


def _jax_run(model, variables, img, gt):
    """float64: ``extra.STEPS`` steps of the JAX optimizer on the JAX
    gradients, the gradient and the update in one jitted step: per step
    the log vars, the gradients, and the params and BN statistics after
    it."""
    tx = jax_build_optimizer(extra.OPTIMIZER, variables['params'],
                             jax_lr_schedule(extra.LR_CONFIG,
                                             extra.OPTIMIZER['lr'],
                                             extra.MAX_ITERS))

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
    for i in range(extra.STEPS):
        grads, log_vars, params, bstats, opt_state = step(
            params, bstats, opt_state, jax.random.key(11 + i))
        steps.append(dict(
            log_vars={k: float(v) for k, v in log_vars.items()},
            grads=jax.tree.map(np.asarray, grads), points=None,
            variables=jax.tree.map(np.asarray, {'params': params,
                                                'batch_stats': bstats})))
    return steps


def make_case(name):
    """The model's JAX variables, its fp32 eval outputs (backbone maps,
    every head's logits) and its float64 3-step trajectory, each one jit."""
    make = MODELS[name]
    jax_model = build_jax_segmentor(make())
    variables = random_jax_variables(jax_model, seed=3)
    img, gt = _batch(SMALL_HW.get(name, HW))

    def outputs(v, i):
        outs, inter = jax_model.net.apply(
            v, i, train=False, with_aux=True, mutable=['intermediates'],
            capture_intermediates=lambda mdl, method: (
                mdl.name == 'backbone' and method == '__call__'))
        return inter['intermediates']['backbone']['__call__'][0], outs
    feats, outs = jax.tree.map(np.asarray, run_jit(outputs, variables,
                                                   jnp.asarray(img)))
    with jax.enable_x64(True), _float64_islands():
        cfg64 = make()
        cfg64['backbone']['dtype'] = 'float64'
        steps = _jax_run(
            build_jax_segmentor(cfg64),
            jax.tree.map(lambda a: np.asarray(a, np.float64), variables),
            jnp.asarray(img, jnp.float64), jnp.asarray(gt))
    return dict(name=name, make=make, jax_model=jax_model,
                variables=variables, img=img, gt=gt, steps=steps,
                feats=feats, outs=outs)


def _close_rel(got, want, what, rel=REL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=what)


def check_feature_maps_and_logits(case):
    """The backbone's maps and the eval logits of every head (each stage of
    a cascade, the auxiliary head), fp32."""
    want_feats, outs = case['feats'], case['outs']
    x, _ = extra._tensors(case)
    port = extra._port(case).eval()
    with torch.no_grad():
        got_feats = port.extract_feat(x)
        if isinstance(port.decode_head, torch.nn.ModuleList):
            got = dict(zip(('decode_0', 'decode_1'),
                           port._stages(got_feats, None)))
        else:
            got = {'decode': port.decode_head(got_feats)}
        if port.auxiliary_head is not None:
            got['aux'] = port.auxiliary_head(got_feats)
    assert len(got_feats) == len(want_feats)
    for i, (g, w) in enumerate(zip(got_feats, want_feats)):
        _close_rel(g.numpy(), nhwc_to_nchw(w), f'level {i}')
    assert set(got) <= set(outs) and got
    for k, g in got.items():
        _close_rel(g.numpy(), nhwc_to_nchw(outs[k]), f'{k} logits')


def check_losses(case):
    """The train-mode loss dict in fp32 against JAX's step 0 (in
    float64)."""
    want = case['steps'][0]['log_vars']
    port = extra._port(case).train()
    x, y = extra._tensors(case)
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
    ``GRAD_REL`` of the largest (train-mode BN over a few values a channel
    magnifies fp32 rounding, so fp32 would hide a real difference)."""
    step = case['steps'][0]
    port = extra._port(case, float64=True).train()
    x, y = extra._tensors(case, torch.float64)
    with float64_kept():
        losses, _ = port.forward_train(x, y, generator=torch.Generator())
        total, got = parse_losses(losses)
        total.backward()
    for k, v in step['log_vars'].items():
        np.testing.assert_allclose(got[k].item(), v, rtol=GRAD_REL, err_msg=k)
    grads = state_dict_from_jax({'params': step['grads']})
    named = dict(port.named_parameters())
    assert named.keys() == grads.keys()
    scale = max(float(g.abs().max()) for g in grads.values())
    for k, g in grads.items():
        assert named[k].grad is not None, k
        np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(), rtol=0,
                                   atol=GRAD_REL * scale, err_msg=k)


check_sgd_trajectory_float64 = extra.check_sgd_trajectory_float64
check_the_jax_loader_reads_the_port_state_dict = \
    extra.check_the_jax_loader_reads_the_port_state_dict
