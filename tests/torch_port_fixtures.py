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
                  test_cfg=None):
    return dict(
        type='EncoderDecoder',
        backbone=dict(type='mit_b0', gelu_approximate=gelu_approximate,
                      drop_path_rate=0.0, fused_attention=fused_attention),
        decode_head=dict(
            type='SegFormerHead', in_channels=[32, 64, 160, 256],
            in_index=[0, 1, 2, 3], feature_strides=[4, 8, 16, 32],
            channels=128, dropout_ratio=0.1, num_classes=NUM_CLASSES,
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
