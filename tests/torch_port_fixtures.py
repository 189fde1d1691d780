"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_port_*).

A small Segformer (MiT-b0 widths, head embed_dim 64, 19 classes) is built
on both sides. The JAX variables are seeded random values in every tensor,
BN running statistics included, so that a mis-mapped or mis-transposed
tensor shows up as a mismatch; the port gets them through
``state_dict_from_jax``.
"""

import copy
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np

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
                _randomize_leaf(path + (k,), v.shape, rng).astype(np.float32)
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
