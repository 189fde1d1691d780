"""The three ``configs/extra`` files at full width in the port, on the CPU
(``device='cpu'``): PSANet-R50 and PointRend-R50/FPN on ADE20K, PSPNet-R50
on Cityscapes with slide inference.

Each builds through ``build_segmentor`` with the reference ``.pth``
layout, which ``torch_loader.translate_state_dict`` places onto the JAX
model's variables (``jax.eval_shape``: nothing is computed) at their
shapes, save the point head's MLP (ROADMAP, known faults on the reference
side); takes 3 training steps of its own SGD at batch 2 and 64 x 64 (the
losses finite, the first CE near ln(classes)); and serves a request
through ``inference_segmentor``: whole for PSANet and PointRend (the
subdivision refinement), slide for the Cityscapes PSPNet. To keep the CPU
time small the test pipelines scale a request to 64 x 128 (ADE20K) or
128 x 256 (Cityscapes) rather than 512 x 1024 and 1024 x 2048, and the
slide windows are 97 x 97 at stride 65 (eight of them) rather than the
config's 769 at 513, which the test checks the config states.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segdistill_tpu.config import Config as JaxConfig
from segdistill_tpu.convert.torch_loader import translate_state_dict
from segdistill_tpu.models import build_segmentor as build_jax_segmentor
from segdistill_tpu_torch.apis import (inference_segmentor, init_segmentor,
                                       init_segmentor_state, prepare_training)
from segdistill_tpu_torch.config import Config
from segdistill_tpu_torch.models import build_segmentor

import torch_port_threads  # noqa: F401  (torch threads a test worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXTRA = os.path.join(ROOT, 'configs', 'extra')
CONFIGS = {'psanet_r50_ade.py': ('EncoderDecoder', 'PSAHead', 150),
           'pointrend_r50_ade.py': ('CascadeEncoderDecoder', 'FPNHead', 150),
           'pspnet_r50_cityscapes_slide.py': ('EncoderDecoder', 'PSPHead',
                                              19)}


def test_the_three_are_listed():
    assert sorted(CONFIGS) == sorted(
        f for f in os.listdir(EXTRA) if f.endswith('.py'))


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_builds_with_the_reference_layout(name):
    segmentor, head, classes = CONFIGS[name]
    model = build_segmentor(dict(Config.fromfile(
        os.path.join(EXTRA, name)).model))
    assert type(model).__name__ == segmentor and model.num_classes == classes
    first = model.decode_head[0] if segmentor.startswith('Cascade') \
        else model.decode_head
    assert type(first).__name__ == head
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    jax_model = build_jax_segmentor(dict(JaxConfig.fromfile(
        os.path.join(EXTRA, name)).model))
    shapes = jax.eval_shape(lambda: jax_model.net.init(
        {'params': jax.random.key(0)}, jnp.zeros((1, 64, 64, 3)),
        train=False, with_aux=True))
    variables = {c: jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                 shapes[c]) for c in ('params',
                                                      'batch_stats')}
    _, matched, missing, unexpected = translate_state_dict(state, variables)
    lost = sorted(k for k, v in state.items()
                  if v.ndim == 3 or '.fcs.' in k)
    assert sorted(unexpected) == lost and len(missing) == len(lost)
    assert bool(lost) == (name == 'pointrend_r50_ade.py')
    assert len(matched) == sum(1 for k in state if not k.endswith(
        'num_batches_tracked')) - len(lost)


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_three_sgd_steps_on_the_cpu(name):
    _, _, classes = CONFIGS[name]
    model = init_segmentor_state(os.path.join(EXTRA, name), device='cpu')
    state, step = prepare_training(model)
    assert type(state.optimizer) is torch.optim.SGD
    gen = torch.Generator().manual_seed(0)
    img = torch.randn(2, 3, 64, 64, generator=gen)
    gt = torch.randint(0, classes, (2, 64, 64), generator=gen)
    logs = [step(state, img, gt) for _ in range(3)]
    assert state.step == 3
    ce = 'decode_0.loss_seg' if 'pointrend' in name else 'decode.loss_seg'
    assert abs(float(logs[0][ce]) - math.log(classes)) < 0.1
    if 'pointrend' in name:
        assert 'decode_1.loss_point' in logs[0]
    else:
        assert float(logs[0]['aux.loss_seg']) == pytest.approx(
            0.4 * math.log(classes), abs=0.1)
    assert all(math.isfinite(float(v)) for lv in logs for v in lv.values())


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_serves_a_request_on_the_cpu(name):
    _, _, classes = CONFIGS[name]
    cfg = Config.fromfile(os.path.join(EXTRA, name))
    if 'cityscapes' in name:
        assert cfg.model.test_cfg == dict(mode='slide', crop_size=(769, 769),
                                          stride=(513, 513))
        cfg.model.test_cfg.update(crop_size=(97, 97), stride=(65, 65))
        cfg.data.test.pipeline[1]['img_scale'] = (256, 128)
    else:
        cfg.data.test.pipeline[1]['img_scale'] = (128, 64)
    model = init_segmentor(cfg, device='cpu')
    img = np.random.RandomState(1).randint(0, 256, (48, 96, 3), np.uint8)
    pred = inference_segmentor(model, img)[0]
    assert pred.shape == (48, 96)
    assert 0 <= pred.min() and pred.max() < classes
