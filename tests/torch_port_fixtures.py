"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_port_*).

A small Segformer (MiT-b0 widths, head embed_dim 64, 19 classes) is built
on both sides. The JAX variables are seeded random values in every tensor,
BN running statistics included, so that a mis-mapped or mis-transposed
tensor shows up as a mismatch; the port gets them through
``state_dict_from_jax``.
"""

import contextlib
import copy
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_port_threads  # noqa: F401  (torch threads a test worker)

NUM_CLASSES = 19
EMBED_DIM = 64
NORM = dict(type='SyncBN', requires_grad=True)
IMG_NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
                to_rgb=True)
# fp32 parity tolerance, as the torch-oracle parity tests use
RTOL, ATOL = 1e-4, 1e-5


def segformer_cfg(fused_attention=False, gelu_approximate=True,
                  test_cfg=None, dropout_ratio=0.1, drop_path_rate=0.0,
                  **backbone):
    return dict(
        type='EncoderDecoder',
        backbone=dict(type='mit_b0', gelu_approximate=gelu_approximate,
                      drop_path_rate=drop_path_rate,
                      fused_attention=fused_attention, **backbone),
        decode_head=dict(
            type='SegFormerHead', in_channels=[32, 64, 160, 256],
            in_index=[0, 1, 2, 3], feature_strides=[4, 8, 16, 32],
            channels=128, dropout_ratio=dropout_ratio,
            num_classes=NUM_CLASSES,
            norm_cfg=dict(NORM), align_corners=False,
            decoder_params=dict(embed_dim=EMBED_DIM)),
        test_cfg=copy.deepcopy(test_cfg) or dict(mode='whole'))


def narrow_segformer_cfg(fused_attention=False):
    """MiT-b0 + SegFormerHead with head embed 32 and 4 classes, dropout 0
    (the export and tool tests' model)."""
    cfg = segformer_cfg(fused_attention=fused_attention, dropout_ratio=0.0)
    cfg['decode_head'].update(num_classes=4, channels=32,
                              decoder_params=dict(embed_dim=32))
    return cfg


def pipeline_cfg(img_scale=(96, 64), img_ratios=None, flip=False):
    return [
        dict(type='LoadImageFromFile'),
        dict(type='MultiScaleFlipAug', img_scale=img_scale,
             img_ratios=img_ratios, flip=flip,
             transforms=[
                 dict(type='AlignedResize', keep_ratio=True,
                      size_divisor=32),
                 dict(type='RandomFlip'),
                 dict(type='Normalize', **IMG_NORM),
                 dict(type='ImageToTensor', keys=['img']),
                 dict(type='Collect', keys=['img']),
             ]),
    ]


def _randomize_leaf(path, shape, rng):
    leaf = path[-1]
    if leaf == 'var':
        return 0.5 + rng.rand(*shape)
    if leaf == 'mean':
        return 0.1 * rng.randn(*shape)
    if leaf == 'scale':
        return 1.0 + 0.2 * rng.rand(*shape)
    if leaf == 'bias':
        return 0.02 * rng.randn(*shape)
    fan_in = int(np.prod(shape[:-1]))
    return rng.randn(*shape) / np.sqrt(fan_in)


def random_jax_variables(jax_model, seed=0):
    """Seeded values for every leaf of the JAX model's 'params' and
    'batch_stats', shaped by an abstract init (``jax.eval_shape``: nothing
    is computed). -> nested dict of float32 numpy arrays."""
    img = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda: jax_model.net.init({'params': jax.random.key(0)}, img,
                                   train=False, with_aux=True))
    rng = np.random.RandomState(seed)

    def walk(tree, path):
        return {k: walk(v, path + (k,)) if isinstance(v, Mapping) else
                np.asarray(_randomize_leaf(path + (k,), v.shape, rng),
                           np.float32)
                for k, v in tree.items()}
    return {col: walk(shapes[col], (col,))
            for col in ('params', 'batch_stats')}


def nhwc_to_nchw(a):
    return np.asarray(a, np.float32).transpose(0, 3, 1, 2)


CE_LOSS = dict(type='CrossEntropyLoss', use_sigmoid=False, loss_weight=1.0)


def psp_cfg(depth=50, dropout_ratio=0.1, test_cfg=None, **backbone):
    """A narrow ResNetV1c-d8 + PSPHead (the Tab5 PSP student's layout at
    stem 16, base 8, head 16 channels): logits at stride 8."""
    expansion = 4 if depth >= 50 else 1
    return dict(
        type='EncoderDecoder',
        backbone=dict(type='ResNetV1c', depth=depth, stem_channels=16,
                      base_channels=8, num_stages=4,
                      out_indices=(0, 1, 2, 3), dilations=(1, 1, 2, 4),
                      strides=(1, 2, 1, 1), norm_cfg=dict(NORM),
                      norm_eval=False, style='pytorch',
                      contract_dilation=True, **backbone),
        decode_head=dict(type='PSPHead', in_channels=64 * expansion,
                         in_index=3, channels=16, pool_scales=(1, 2, 3, 6),
                         dropout_ratio=dropout_ratio,
                         num_classes=NUM_CLASSES, norm_cfg=dict(NORM),
                         align_corners=False, loss_decode=dict(CE_LOSS)),
        test_cfg=copy.deepcopy(test_cfg) or dict(mode='whole'))


SWIN_DIMS = (24, 48, 96, 192)


def swin_cfg(dropout_ratio=0.1, drop_path_rate=0.0, test_cfg=None,
             **backbone):
    """A narrow Swin (embed 24, depths (2, 2, 2, 2), window 7) + UPerHead
    of 16 channels: logits at stride 4."""
    backbone = dict(dict(type='SwinTransformer', embed_dim=SWIN_DIMS[0],
                         depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24),
                         window_size=7, mlp_ratio=4.0, qkv_bias=True,
                         drop_rate=0.0, attn_drop_rate=0.0,
                         drop_path_rate=drop_path_rate, ape=False,
                         patch_norm=True, out_indices=(0, 1, 2, 3)),
                    **backbone)
    return dict(
        type='EncoderDecoder',
        backbone=backbone,
        decode_head=dict(type='UPerHead', in_channels=list(SWIN_DIMS),
                         in_index=[0, 1, 2, 3], pool_scales=(1, 2, 3, 6),
                         channels=16, dropout_ratio=dropout_ratio,
                         num_classes=NUM_CLASSES, norm_cfg=dict(NORM),
                         align_corners=False, loss_decode=dict(CE_LOSS)),
        test_cfg=copy.deepcopy(test_cfg) or dict(mode='whole'))


def leaves(tree, prefix=''):
    """(path, numpy array) of every leaf of a nested dict."""
    for k, v in tree.items():
        if hasattr(v, 'items'):
            yield from leaves(v, f'{prefix}{k}/')
        else:
            yield f'{prefix}{k}', np.asarray(v)


# The configs/extra models, narrow: a ResNetV1c of stem 16 and base 8
# (stage widths 32, 64, 128, 256), d8 (PSANet, PSPNet) or d32 with the FPN
# neck (PointRend), 19 classes, dropout 0 (JAX's PRNG cannot be matched).
def resnet_v1c(d8=True):
    return dict(type='ResNetV1c', depth=50, stem_channels=16, base_channels=8,
                num_stages=4, out_indices=(0, 1, 2, 3),
                dilations=(1, 1, 2, 4) if d8 else (1, 1, 1, 1),
                strides=(1, 2, 1, 1) if d8 else (1, 2, 2, 2),
                norm_cfg=dict(NORM), norm_eval=False, style='pytorch',
                contract_dilation=True)


def fcn_aux():
    """The configs' FCN auxiliary head on stage 3, loss weight 0.4."""
    return dict(type='FCNHead', in_channels=128, in_index=2, channels=8,
                num_convs=1, concat_input=False, dropout_ratio=0.0,
                num_classes=NUM_CLASSES, norm_cfg=dict(NORM),
                align_corners=False,
                loss_decode=dict(CE_LOSS, loss_weight=0.4))


def psanet_cfg(mask_size=(5, 5), test_cfg=None):
    """PSANet (``configs/extra/psanet_r50_ade.py``), narrow: a 5 x 5 window
    on the shrunk stride-8 map, so positions see part of the map."""
    return dict(
        type='EncoderDecoder', backbone=resnet_v1c(),
        decode_head=dict(type='PSAHead', in_channels=256, in_index=3,
                         channels=16, mask_size=mask_size,
                         psa_type='bi-direction', compact=False,
                         shrink_factor=2, normalization_factor=1.0,
                         psa_softmax=True, dropout_ratio=0.0,
                         num_classes=NUM_CLASSES, norm_cfg=dict(NORM),
                         align_corners=False, loss_decode=dict(CE_LOSS)),
        auxiliary_head=fcn_aux(),
        test_cfg=copy.deepcopy(test_cfg) or dict(mode='whole'))


POINT_HEAD = dict(type='PointHead', in_channels=[16], in_index=[0],
                  channels=16, num_fcs=3, coarse_pred_each_layer=True,
                  dropout_ratio=-1, num_classes=NUM_CLASSES,
                  align_corners=False, loss_decode=dict(CE_LOSS),
                  num_points=48, oversample_ratio=3,
                  importance_sample_ratio=0.75, subdivision_steps=2,
                  subdivision_num_points=100, scale_factor=2)


def pointrend_cfg(test_cfg=None):
    """PointRend (``configs/extra/pointrend_r50_ade.py``), narrow: FPN of
    16 channels, FPNHead of 8, PointHead of 16 with 48 training points and
    100 refined points a subdivision step."""
    return dict(
        type='CascadeEncoderDecoder', num_stages=2,
        backbone=resnet_v1c(d8=False),
        neck=dict(type='FPN', in_channels=[32, 64, 128, 256],
                  out_channels=16, num_outs=4),
        decode_head=[
            dict(type='FPNHead', in_channels=[16, 16, 16, 16],
                 in_index=[0, 1, 2, 3], feature_strides=[4, 8, 16, 32],
                 channels=8, dropout_ratio=-1, num_classes=NUM_CLASSES,
                 norm_cfg=dict(NORM), align_corners=False,
                 loss_decode=dict(CE_LOSS)),
            dict(POINT_HEAD)],
        test_cfg=copy.deepcopy(test_cfg) or dict(mode='whole'))


def psp_city_cfg(test_cfg=None):
    """PSPNet with the FCN auxiliary head
    (``configs/extra/pspnet_r50_cityscapes_slide.py``), narrow."""
    cfg = psp_cfg(50, dropout_ratio=0.0, test_cfg=test_cfg)
    cfg['auxiliary_head'] = fcn_aux()
    return cfg


@contextlib.contextmanager
def float64_kept():
    """Within the block, ``Tensor.float()`` leaves a float64 tensor as it
    is, so that a port model moved to float64 (``.double()``, its
    backbone's ``dtype`` float64) computes in float64 throughout: its norms,
    losses and plain kernel versions upcast with ``.float()``."""
    upcast = torch.Tensor.float
    torch.Tensor.float = lambda t, *a, **k: t if t.dtype == torch.float64 \
        else upcast(t, *a, **k)
    try:
        yield
    finally:
        torch.Tensor.float = upcast
