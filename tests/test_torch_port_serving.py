"""The port's serving side against the JAX package, on the CPU: the test
pipeline (AlignedResize, RandomFlip, Normalize, ImageToTensor, Collect
under MultiScaleFlipAug), ``inference_segmentor``, ``single_device_test``
and the mIoU metrics.

The port's pipeline resizes without OpenCV; cv2's uint8 bilinear uses
11-bit fixed-point weights, so each uint8 resize may land one intensity
level away from cv2's (a level is 1 / std <= 1 / 57.12 after Normalize).
AlignedResize resizes twice (keep-ratio rescale, then snap to /32), so the
pipeline holds to two levels.
"""

import numpy as np
import pytest
import torch

from segdistill_tpu.apis.inference import _LoadImage as JaxLoadImage
from segdistill_tpu.apis.inference import (
    inference_segmentor as jax_inference_segmentor)
from segdistill_tpu.config import Config
from segdistill_tpu.core.evaluation import metrics as jax_metrics
from segdistill_tpu.datasets.pipelines import Compose as JaxCompose
from segdistill_tpu.models import build_segmentor as build_jax_segmentor
from segdistill_tpu_torch.apis import (inference_segmentor, init_segmentor,
                                       single_device_test, serving_pipeline)
from segdistill_tpu_torch.convert import state_dict_from_jax
from segdistill_tpu_torch.core.evaluation import metrics
from segdistill_tpu_torch.models import build_segmentor
from segdistill_tpu_torch.ops import resize
from segdistill_tpu_torch.utils import image as imutil

from torch_port_fixtures import (IMG_NORM, pipeline_cfg,
                                 random_jax_variables, segformer_cfg)

TWO_LEVELS = 2.0 / min(IMG_NORM['std']) + 1e-5


def _image(seed, hw):
    return np.random.RandomState(seed).randint(0, 256, hw + (3,)) \
        .astype(np.uint8)


def _cfg(**pipeline_kw):
    return Config(dict(model=segformer_cfg(),
                       data=dict(test=dict(
                           pipeline=pipeline_cfg(**pipeline_kw)))))


@pytest.mark.parametrize('pipeline_kw', [
    dict(),
    dict(img_scale=(96, 64), img_ratios=[0.75, 1.25], flip=True),
], ids=['single', 'multiscale_flip'])
@pytest.mark.parametrize('hw', [(64, 96), (50, 70), (100, 60)])
def test_pipeline_matches_jax(pipeline_kw, hw):
    cfg = _cfg(**pipeline_kw)
    img = _image(0, hw)
    got = serving_pipeline(cfg)(dict(img=img))
    want = JaxCompose([JaxLoadImage()] + list(
        cfg.data['test']['pipeline'][1:]))(dict(img=img))
    assert len(got['img']) == len(want['img'])
    for g, w in zip(got['img'], want['img']):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.abs(g - w).max() <= TWO_LEVELS
    for g, w in zip(got['img_metas'], want['img_metas']):
        assert g.keys() == w.keys()
        for key in w:
            if key == 'img_norm_cfg':
                for k in ('mean', 'std'):
                    np.testing.assert_array_equal(g[key][k], w[key][k])
                assert g[key]['to_rgb'] == w[key]['to_rgb']
            elif key == 'scale_factor':
                np.testing.assert_allclose(g[key], w[key], rtol=1e-6)
            else:
                assert g[key] == w[key], key


@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
@pytest.mark.parametrize('interpolation', ['bilinear', 'nearest'])
def test_imresize_matches_cv2(dtype, interpolation):
    import cv2
    img = (np.random.RandomState(1).rand(37, 53, 3) * 255).astype(dtype)
    cv_interp = cv2.INTER_LINEAR if interpolation == 'bilinear' \
        else cv2.INTER_NEAREST
    for size in ((80, 60), (20, 15), (53, 101), (53, 37)):
        want = cv2.resize(img, size, interpolation=cv_interp)
        got = imutil.imresize(img, size, interpolation=interpolation)
        assert got.shape == want.shape and got.dtype == want.dtype
        tol = 1 if dtype == np.uint8 and interpolation == 'bilinear' \
            else 1e-3
        assert np.abs(got.astype(np.float64) - want).max() <= tol


@pytest.fixture(scope='module')
def models():
    cfg = _cfg(img_scale=(96, 64))
    jax_model = build_jax_segmentor(segformer_cfg())
    variables = random_jax_variables(jax_model, seed=4)
    jax_model.cfg = cfg
    port = build_segmentor(segformer_cfg())
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    port.cfg = cfg
    return jax_model, variables, port.eval()


def _port_logit_gap(port, img):
    """Top-2 logit gap per pixel of the port's prediction at the image's
    resolution: where it is tiny, an argmax may flip on rounding."""
    data = serving_pipeline(port.cfg)(dict(img=img))
    x = torch.from_numpy(data['img'][0]).permute(2, 0, 1)[None]
    with torch.no_grad():
        logits = resize(port.inference_logits(x), size=img.shape[:2])
    top2 = logits[0].topk(2, dim=0).values
    return (top2[0] - top2[1]).numpy()


def test_inference_segmentor_matches_jax(models):
    jax_model, variables, port = models
    img = _image(2, (64, 96))
    got = inference_segmentor(port, img)[0]
    want = jax_inference_segmentor(jax_model, variables, img)[0]
    assert got.shape == want.shape == (64, 96)
    assert got.dtype == np.int64
    differ = got != want
    assert np.all(_port_logit_gap(port, img)[differ] < 1e-4)
    assert differ.mean() < 0.01


def test_inference_segmentor_reads_a_path(models, tmp_path):
    _, _, port = models
    img = _image(3, (50, 70))
    path = str(tmp_path / 'img.npy')
    np.save(path, img)
    np.testing.assert_array_equal(inference_segmentor(port, path)[0],
                                  inference_segmentor(port, img)[0])


def test_single_device_test(models):
    _, _, port = models
    pipe = serving_pipeline(port.cfg)
    imgs = [_image(s, hw) for s, hw in ((5, (64, 96)), (6, (40, 60)))]
    dataset = [pipe(dict(img=img)) for img in imgs]
    preds = single_device_test(port, dataset)
    assert [p.shape for p in preds] == [(64, 96), (40, 60)]
    for p, img in zip(preds, imgs):
        np.testing.assert_array_equal(p, inference_segmentor(port, img)[0])


@pytest.mark.parametrize('kw', [
    dict(),
    dict(reduce_zero_label=True),
    dict(label_map={3: 5, 7: 0}),
])
def test_metrics_match_jax(kw):
    rng = np.random.RandomState(7)
    num_classes = 9
    preds = [rng.randint(0, num_classes, (20, 30)) for _ in range(3)]
    gts = [np.where(rng.rand(20, 30) < 0.1, 255,
                    rng.randint(0, num_classes, (20, 30))) for _ in range(3)]
    for g, w in zip(metrics.intersect_and_union(preds[0], gts[0],
                                                num_classes, 255, **kw),
                    jax_metrics.intersect_and_union(preds[0], gts[0],
                                                    num_classes, 255, **kw)):
        np.testing.assert_array_equal(g, w)
    totals = metrics.total_intersect_and_union(preds, gts, num_classes, 255,
                                               **kw)
    want = jax_metrics.total_intersect_and_union(preds, gts, num_classes,
                                                 255, **kw)
    for g, w in zip(totals, want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(
            metrics.metrics_from_histograms(*totals, ('mIoU', 'mDice')),
            jax_metrics.metrics_from_histograms(*want, ('mIoU', 'mDice'))):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(metrics.mean_iou(preds, gts, num_classes, 255, **kw),
                    jax_metrics.mean_iou(preds, gts, num_classes, 255,
                                         **kw)):
        np.testing.assert_array_equal(g, w)


def test_init_segmentor_loads_reference_checkpoint(models, tmp_path):
    """A reference-layout checkpoint (wrapped in 'state_dict', DDP
    'module.' prefixes, the unused conv_seg classifier of the reference
    BaseDecodeHead) fills every tensor of the port."""
    _, _, port = models
    sd = {f'module.{k}': v for k, v in port.state_dict().items()}
    sd['module.decode_head.conv_seg.weight'] = torch.zeros(19, 128, 1, 1)
    sd['module.decode_head.conv_seg.bias'] = torch.zeros(19)
    path = tmp_path / 'reference.pth'
    torch.save({'state_dict': sd, 'meta': {'CLASSES': ['a', 'b']}}, path)
    loaded = init_segmentor(port.cfg, checkpoint=str(path), device='cpu',
                            seed=1)
    want = port.state_dict()
    got = loaded.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert not loaded.training


def test_resize_needs_a_scale_at_test_time():
    """A single fixed ``img_scale`` needs no draw; with a ``ratio_range``
    the scale is drawn from the sample's generator (the training-time
    mode), the same draw for the same seed."""
    from segdistill_tpu_torch.datasets.pipelines import Resize
    img = _image(8, (20, 30))
    out = Resize(img_scale=(15, 10))(dict(img=img))
    assert out['img'].shape == (10, 15, 3)
    resize = Resize(img_scale=(64, 32), ratio_range=(0.5, 2.0))
    a = resize(dict(img=img, rng=np.random.RandomState(3)))
    b = resize(dict(img=img, rng=np.random.RandomState(3)))
    ratio = np.random.RandomState(3).random_sample() * 1.5 + 0.5
    assert a['scale'] == b['scale'] == (int(64 * ratio), int(32 * ratio))
    assert a['img'].shape == b['img'].shape
