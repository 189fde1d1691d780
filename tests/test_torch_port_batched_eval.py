"""Shape-bucketed batched evaluation of the port (``single_device_test``
with ``batch_size`` 2) against the port's per-image path and the JAX
package's ``single_device_test(batch_size=2)``, on the CPU, on a narrow
SegFormer (MiT at one block a stage, widths 16-32, 5 classes, seeded
weights carried across by ``state_dict_from_jax``): six single-view
images in three shapes (buckets of 3 and 2 and a singleton) and two
test-time-augmented ones (a view and its flip). Both packages get the
same pipeline outputs (the JAX pipeline's).

Tolerances. The label maps are equal but for argmax near-ties: a batch
of another size sums the same products in another order, and the JAX
package runs other kernels (the rule of ``tests/test_batched_eval.py``,
which holds the JAX batched path to its per-image one): at least 99.9%
of the pixels equal the port's per-image map and 99% the JAX map
(measured: all of them, and 99.8%).
"""

import numpy as np
import pytest
import torch

from segdistill_tpu.apis.inference import _LoadImage as JaxLoadImage
from segdistill_tpu.apis.test import single_device_test as jax_test
from segdistill_tpu.datasets.pipelines import Compose as JaxCompose
from segdistill_tpu.models import build_segmentor as build_jax_segmentor
from segdistill_tpu_torch.apis import single_device_test
from segdistill_tpu_torch.convert import state_dict_from_jax
from segdistill_tpu_torch.models import build_segmentor

from torch_port_fixtures import (pipeline_cfg, random_jax_variables,
                                 segformer_cfg)

PER_IMAGE_AGREE = 0.999
JAX_AGREE = 0.99
# (seed, (h, w)) of the single-view images: 3 + 2 of two shapes and one
SINGLE = [(0, (64, 96)), (1, (64, 96)), (2, (100, 60)), (3, (64, 96)),
          (4, (100, 60)), (5, (50, 70))]
TTA = [(6, (64, 96)), (7, (64, 96))]


def _model_cfg():
    cfg = segformer_cfg(dropout_ratio=0.0)
    cfg['backbone'] = dict(
        type='MixVisionTransformer', embed_dims=(16, 16, 32, 32),
        num_heads=(1, 1, 1, 1), mlp_ratios=(2, 2, 2, 2), qkv_bias=True,
        depths=(1, 1, 1, 1), sr_ratios=(8, 4, 2, 1), drop_path_rate=0.0)
    cfg['decode_head'].update(in_channels=[16, 16, 32, 32], channels=16,
                              num_classes=5,
                              decoder_params=dict(embed_dim=16))
    return cfg


def _data(images, flip):
    pipe = JaxCompose([JaxLoadImage()] + pipeline_cfg(
        img_scale=(96, 64), flip=flip)[1:])
    return [pipe(dict(img=np.random.RandomState(seed).randint(
        0, 256, hw + (3,)).astype(np.uint8))) for seed, hw in images]


@pytest.fixture(scope='module')
def models():
    jax_model = build_jax_segmentor(_model_cfg())
    variables = random_jax_variables(jax_model, seed=8)
    port = build_segmentor(_model_cfg())
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jax_model, variables, port.eval()


def _agree(a, b):
    assert a.shape == b.shape
    return float(np.mean(a == b))


@pytest.mark.parametrize('images,flip', [(SINGLE, False), (TTA, True)],
                         ids=['single_view', 'tta_flip'])
def test_batched_matches_per_image_and_jax(models, images, flip):
    jax_model, variables, port = models
    data = _data(images, flip)
    sizes = []
    forward = port.inference_logits

    def counted(img, *args, **kw):
        sizes.append(img.shape[0])
        return forward(img, *args, **kw)
    port.inference_logits = counted
    try:
        batched = single_device_test(port, data, batch_size=2)
    finally:
        del port.inference_logits
    per_image = single_device_test(port, data)
    want = jax_test(jax_model, variables, data, progress=False,
                    batch_size=2)
    assert len(batched) == len(per_image) == len(want) == len(images)
    for (_, hw), got, one, ref in zip(images, batched, per_image, want):
        assert got.shape == hw and got.dtype == np.int64
        assert _agree(got, one) >= PER_IMAGE_AGREE
        assert _agree(got, np.asarray(ref)) >= JAX_AGREE
    # buckets of 3 and 2 in chunks of 2, the tail not padded; the
    # singleton and the two views of each augmented sample one at a time
    assert sizes == ([2, 1, 2, 1] if not flip else [1] * 4)
    assert not port.training
