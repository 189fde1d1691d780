"""The port's datasets, training transforms, host loader and device
histograms against the JAX package, on the committed miniature dataset
``tests/data/convergence/`` (64x64 JPEG images, PNG labels 0..4 with 0
unlabeled) and on seeded arrays, with the same seeds on both sides.

Tolerances. Label maps, crops, flips, pads and every random draw are
exact. Images: the port resizes without OpenCV, whose uint8 bilinear uses
11-bit fixed-point weights, so a resized pixel may sit one intensity level
away (``utils/image.py``; nearest-neighbour resizing of label maps is
exact); its HSV -> BGR conversion differs from OpenCV 5's by one level in
about 2 values of 10^4. PhotoMetricDistortion after a resize can amplify
a one-level difference (contrast scales it by up to 1.5, and a hue
computed from a nearly grey pixel is ill-conditioned), so a batch of whole
training samples is held to: at most 5% of the values more than 2 levels
away, a mean absolute difference under 0.6 levels and no value more than
16 levels away (measured over 24 batches: 3.2%, 0.45 and 9).
"""

import os.path as osp

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segdistill_tpu.core.evaluation import metrics as jax_metrics
from segdistill_tpu.datasets import build_dataloader as jax_build_dataloader
from segdistill_tpu.datasets import build_dataset as jax_build_dataset
from segdistill_tpu.datasets.pipelines import transforms as jax_tf
from segdistill_tpu.datasets.pipelines.loading import \
    LoadAnnotations as JaxLoadAnnotations
from segdistill_tpu.datasets.pipelines.loading import \
    LoadImageFromFile as JaxLoadImageFromFile
from segdistill_tpu_torch.core.evaluation import (confusion_histograms,
                                                  intersect_and_union)
from segdistill_tpu_torch.datasets import (DeviceAugDataLoader,
                                           RepeatDataset, build_dataloader,
                                           build_dataset)
from segdistill_tpu_torch.datasets import pipelines as tf
from segdistill_tpu_torch.utils import image as imutil

from torch_port_fixtures import IMG_NORM

DATA = osp.join(osp.dirname(osp.abspath(__file__)), 'data', 'convergence')
STD = np.asarray(IMG_NORM['std'], np.float32)
CLASSES = ('a', 'b', 'c', 'd')


def _train_pipeline(photometric=True):
    return [
        dict(type='LoadImageFromFile'),
        dict(type='LoadAnnotations', reduce_zero_label=True),
        dict(type='Resize', img_scale=(128, 64), ratio_range=(0.5, 2.0)),
        dict(type='RandomCrop', crop_size=(48, 48), cat_max_ratio=0.75),
        dict(type='RandomFlip', prob=0.5),
    ] + ([dict(type='PhotoMetricDistortion')] if photometric else []) + [
        dict(type='Normalize', **IMG_NORM),
        dict(type='Pad', size=(48, 48), pad_val=0, seg_pad_val=255),
        dict(type='DefaultFormatBundle'),
        dict(type='Collect', keys=['img', 'gt_semantic_seg']),
    ]


def _dataset_cfg(split, pipeline, repeat=None):
    cfg = dict(type='CustomDataset', data_root=DATA,
               img_dir=f'img/{split}', ann_dir=f'ann/{split}',
               classes=CLASSES, reduce_zero_label=True, pipeline=pipeline)
    if repeat:
        cfg = dict(type='RepeatDataset', times=repeat, dataset=cfg)
    return cfg


def _sample(seed=0, hw=(40, 56)):
    rs = np.random.RandomState(seed)
    img = rs.randint(0, 256, hw + (3,)).astype(np.uint8)
    blocks = rs.randint(0, 5, (-(-hw[0] // 8), -(-hw[1] // 8)))
    gt = np.kron(blocks, np.ones((8, 8), np.int64))[:hw[0], :hw[1]]
    gt = np.where(gt == 4, 255, gt).astype(np.uint8)
    return img, gt


def _both(jax_t, port_t, seed, img, gt):
    out = []
    for t in (jax_t, port_t):
        out.append(t(dict(img=img.copy(), gt_semantic_seg=gt.copy(),
                          seg_fields=['gt_semantic_seg'],
                          rng=np.random.RandomState(seed))))
    return out


def _levels(a, b):
    return np.abs(a.astype(np.int64) - b.astype(np.int64))


@pytest.mark.parametrize('kwargs', [
    dict(img_scale=(128, 64), ratio_range=(0.5, 2.0)),
    dict(ratio_range=(0.5, 2.0)),
    dict(img_scale=[(64, 48), (96, 80)], multiscale_mode='range'),
    dict(img_scale=[(64, 48), (96, 80), (40, 30)], multiscale_mode='value'),
    dict(img_scale=(50, 70), keep_ratio=False),
], ids=['ratio', 'ratio-of-image', 'range', 'value', 'fixed-no-ratio'])
@pytest.mark.parametrize('seed', [0, 1])
def test_random_resize_matches_jax(kwargs, seed):
    """The drawn scale and the label map are exact; the image is within
    one level of cv2's."""
    img, gt = _sample(seed)
    want, got = _both(jax_tf.Resize(**kwargs), tf.Resize(**kwargs), seed,
                      img, gt)
    assert tuple(got['scale']) == tuple(want['scale'])
    assert got['scale_idx'] == want['scale_idx']
    assert got['img_shape'] == want['img_shape']
    np.testing.assert_allclose(got['scale_factor'], want['scale_factor'])
    assert np.array_equal(got['gt_semantic_seg'], want['gt_semantic_seg'])
    assert _levels(got['img'], want['img']).max() <= 1


@pytest.mark.parametrize('cat_max_ratio', [1.0, 0.75, 0.3])
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_random_crop_matches_jax(cat_max_ratio, seed):
    img, gt = _sample(seed, (70, 90))
    kw = dict(crop_size=(32, 48), cat_max_ratio=cat_max_ratio)
    want, got = _both(jax_tf.RandomCrop(**kw), tf.RandomCrop(**kw), seed,
                      img, gt)
    assert np.array_equal(got['img'], want['img'])
    assert np.array_equal(got['gt_semantic_seg'], want['gt_semantic_seg'])
    assert got['img_shape'] == want['img_shape'] == (32, 48, 3)


@pytest.mark.parametrize('kw', [dict(size=(64, 80)), dict(size_divisor=32),
                                dict(size=(40, 56))],
                         ids=['size', 'divisor', 'no-op'])
def test_pad_matches_jax(kw):
    img, gt = _sample(3)
    want, got = _both(jax_tf.Pad(**kw), tf.Pad(**kw), 0, img, gt)
    for key in ('img', 'gt_semantic_seg'):
        assert np.array_equal(got[key], want[key]), key
    for key in ('pad_shape', 'pad_fixed_size', 'pad_size_divisor'):
        assert got[key] == want[key], key


@pytest.mark.parametrize('seed', range(8))
def test_photometric_distortion_matches_jax(seed):
    """The same draws; at least 99.5% of the uint8 values equal and none
    more than 3 levels away (measured over 200 seeds: 0.2% and 3). One HSV
    -> BGR value in ~10^4 sits a level off; a second HSV round trip or a
    contrast factor up to 1.5 after it can widen that."""
    img, gt = _sample(seed, (48, 64))
    want, got = _both(jax_tf.PhotoMetricDistortion(),
                      tf.PhotoMetricDistortion(), seed, img, gt)
    diff = _levels(got['img'], want['img'])
    assert got['img'].dtype == np.uint8
    assert diff.max() <= 3 and (diff > 0).mean() <= 5e-3


def test_hsv_conversions_match_cv2():
    rs = np.random.RandomState(0)
    bgr = rs.randint(0, 256, (64, 96, 3)).astype(np.uint8)
    bgr[:8] = bgr[:8, :, :1]  # grey pixels: saturation 0
    assert np.array_equal(imutil.bgr2hsv(bgr),
                          cv2.cvtColor(bgr, cv2.COLOR_BGR2HSV))
    hsv = rs.randint(0, 256, (64, 96, 3)).astype(np.uint8)
    hsv[..., 0] %= 180
    diff = _levels(imutil.hsv2bgr(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_loading_matches_jax(tmp_path):
    """JPEG/PNG files through OpenCV as the JAX loaders read them,
    ``reduce_zero_label``, and ``.npy`` files with numpy alone."""
    info = dict(img_info=dict(filename='s3.jpg'),
                ann_info=dict(seg_map='s3.png'),
                img_prefix=osp.join(DATA, 'img/train'),
                seg_prefix=osp.join(DATA, 'ann/train'))
    want = JaxLoadAnnotations(reduce_zero_label=True)(
        JaxLoadImageFromFile()(dict(info)))
    got = tf.LoadAnnotations(reduce_zero_label=True)(
        tf.LoadImageFromFile()(dict(info)))
    assert np.array_equal(got['img'], want['img'])
    assert np.array_equal(got['gt_semantic_seg'], want['gt_semantic_seg'])
    assert set(np.unique(got['gt_semantic_seg'])) <= {0, 1, 2, 3, 255}
    for key in ('filename', 'ori_filename', 'img_shape', 'ori_shape',
                'pad_shape', 'scale_factor', 'seg_fields'):
        assert got[key] == want[key], key
    np.save(tmp_path / 'a.npy', want['img'])
    np.save(tmp_path / 'b.npy', np.arange(12, dtype=np.uint8).reshape(3, 4))
    assert np.array_equal(imutil.imread(str(tmp_path / 'a.npy')), want['img'])
    assert imutil.imread(str(tmp_path / 'b.npy'),
                         flag='unchanged').shape == (3, 4)
    with pytest.raises(FileNotFoundError):
        imutil.imread(str(tmp_path / 'missing.npy'))


@pytest.mark.parametrize('photometric', [False, True],
                         ids=['geometric', 'photometric'])
def test_loader_first_batches_match_jax(photometric):
    """The first five batches of both loaders from one seed: the epoch
    order, the per-sample seeds and so every draw agree; labels are exact,
    images within the stated limits (one level without
    PhotoMetricDistortion)."""
    cfg = _dataset_cfg('train', _train_pipeline(photometric), repeat=3)
    jax_loader = jax_build_dataloader(jax_build_dataset(cfg), 4, 2,
                                      dist=False, seed=7)
    loader = build_dataloader(build_dataset(cfg), 4, 2, seed=7)
    assert len(loader) == len(jax_loader) == 12
    it, jit = iter(loader), iter(jax_loader)
    for _ in range(5):
        got, want = next(it), next(jit)
        assert got['img'].shape == want['img'].shape == (4, 48, 48, 3)
        assert got['img'].dtype == np.float32
        assert got['gt_semantic_seg'].dtype == np.int32
        assert np.array_equal(got['gt_semantic_seg'],
                              want['gt_semantic_seg'])
        levels = np.abs(got['img'] - want['img']) * STD
        if photometric:
            assert (levels > 2.01).mean() <= 0.05 and levels.mean() <= 0.6
            assert levels.max() <= 16.01
        else:
            assert levels.max() <= 1.01
        for a, b in zip(got['img_metas'], want['img_metas']):
            assert a['ori_filename'] == b['ori_filename']
            assert a['flip'] == b['flip']


def test_loader_resumes_its_stream():
    """``start_batch=n`` gives the batches a fresh loader gives from its
    n-th on, across an epoch boundary."""
    cfg = _dataset_cfg('train', _train_pipeline())
    dataset = build_dataset(cfg)
    fresh = iter(build_dataloader(dataset, 4, 2, seed=3))
    want = [next(fresh) for _ in range(7)][5:]   # 4 batches an epoch
    resumed = iter(build_dataloader(dataset, 4, 2, seed=3, start_batch=5))
    for w in want:
        g = next(resumed)
        assert np.array_equal(g['img'], w['img'])
        assert np.array_equal(g['gt_semantic_seg'], w['gt_semantic_seg'])


def test_dataset_wrappers_and_build_dataset():
    cfg = _dataset_cfg('train', _train_pipeline(), repeat=50)
    dataset = build_dataset(cfg)
    assert isinstance(dataset, RepeatDataset)
    assert len(dataset) == 50 * 16 and len(dataset.dataset) == 16
    assert list(dataset.CLASSES) == list(CLASSES)
    a = dataset.__getitem__(3, rng=np.random.RandomState(0))
    b = dataset.__getitem__(16 * 7 + 3, rng=np.random.RandomState(0))
    assert np.array_equal(a['img'], b['img'])
    concat = build_dataset([_dataset_cfg('train', _train_pipeline()),
                            _dataset_cfg('val', _train_pipeline())])
    assert len(concat) == 20
    assert concat.__getitem__(17, rng=np.random.RandomState(0))[
        'img_metas']['ori_filename'] == 's1.jpg'
    ade = build_dataset(dict(type='ADE20KDataset', data_root=DATA,
                             img_dir='img/val', ann_dir='ann/val',
                             pipeline=[]))
    assert len(ade.CLASSES) == 150 and ade.reduce_zero_label
    loader = build_dataloader(dataset, 2, 1, loader_backend='device',
                              device='cpu')
    assert isinstance(loader, DeviceAugDataLoader)
    assert len(loader.dataset) == len(dataset)
    with pytest.raises(ValueError, match='loader_backend'):
        build_dataloader(dataset, 2, 1, loader_backend='gpu')
    with pytest.raises(ValueError, match='no full batch'):
        iter(build_dataloader(build_dataset(
            _dataset_cfg('val', _train_pipeline())), 8, 1))


def test_custom_dataset_evaluate_matches_jax():
    """``evaluate`` over seeded predictions, and the label maps it reads,
    against the JAX dataset."""
    test_pipe = [dict(type='LoadImageFromFile'),
                 dict(type='Collect', keys=['img'])]
    cfg = _dataset_cfg('val', test_pipe)
    port = build_dataset(cfg, dict(test_mode=True))
    ref = jax_build_dataset(cfg, dict(test_mode=True))
    assert len(port) == len(ref) == 4
    for a, b in zip(port.get_gt_seg_maps(), ref.get_gt_seg_maps()):
        assert np.array_equal(a, b)
    assert 'gt_semantic_seg' not in port[0]
    rs = np.random.RandomState(5)
    gts = list(ref.get_gt_seg_maps())
    # right two times in three, so that no metric is 0 or 1
    preds = [np.where(rs.rand(*g.shape) < 0.67, np.maximum(g, 1) - 1,
                      rs.randint(0, 4, g.shape)) for g in gts]
    for metric in ('mIoU', 'mDice'):
        got = port.evaluate(preds, metric=metric)
        want = ref.evaluate(preds, metric=metric)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12), (metric, k)
        assert 0.3 < got['aAcc'] < 1.0


@pytest.mark.parametrize('ignore_share', [0.0, 0.2, 1.0])
def test_confusion_histograms_match_jax(ignore_share):
    """The torch histograms against the JAX device histograms and the
    numpy host path: integers, exact."""
    rs = np.random.RandomState(6)
    pred = rs.randint(0, 19, (2, 40, 50))
    label = rs.randint(0, 19, (2, 40, 50))
    label[rs.rand(2, 40, 50) < ignore_share] = 255
    got = confusion_histograms(torch.from_numpy(pred),
                               torch.from_numpy(label), 19)
    want = jax_metrics.confusion_histograms(jnp.asarray(pred),
                                            jnp.asarray(label), 19)
    host = intersect_and_union(pred, label, 19, 255)
    for g, w, h in zip(got, want, host):
        assert g.dtype == torch.int64 and g.shape == (19,)
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert np.array_equal(g.numpy(), h)
