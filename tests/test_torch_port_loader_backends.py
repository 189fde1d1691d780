"""The port's native and device loader backends against the JAX package, on
the CPU: ``PrepareCanvas``; ``DeviceAugPipeline.apply`` with the JAX
pipeline's own draws injected (rebuilt here from its key's split tree,
``segdistill_tpu/data/device_aug.py``); the native core ``FastAugBatch``;
and ``build_dataloader(loader_backend='native' | 'device')`` on the
committed miniature dataset ``tests/data/convergence/`` (64x64 JPEGs,
labels 0..4 with 0 unlabelled) with ``device='cpu'``.

Tolerances. Label maps, ``valid_hw`` and the native core's batches are
exact (the core is the same C++ built with the same flags). PrepareCanvas'
image: within one intensity level of cv2's (the port resizes without
OpenCV, as its host pipeline). The device augmentation's normalised image:
within 1e-4 absolute of the JAX package's (an intensity level is 1/57 ~
0.0175 after Normalize; the JAX package samples with two fp32 matmuls and
the port with gathers and a lerp of the same weights, so the two differ by
fp32 rounding, ~1e-5 measured, which the HSV round trip can only move
by a few ulps of 255).
"""

import functools
import json
import os.path as osp

import jax
import numpy as np
import pytest
import torch

from segdistill_tpu.data import DeviceAugPipeline as JaxDeviceAugPipeline
from segdistill_tpu.data import PrepareCanvas as JaxPrepareCanvas
from segdistill_tpu.datasets import build_dataloader as jax_build_dataloader
from segdistill_tpu.datasets import build_dataset as jax_build_dataset
from segdistill_tpu.native import FastAugBatch as JaxFastAugBatch
from segdistill_tpu_torch.data import DeviceAugPipeline, PrepareCanvas
from segdistill_tpu_torch.datasets import (DeviceAugDataLoader,
                                           NativeAugDataLoader,
                                           build_dataloader, build_dataset)
from segdistill_tpu_torch.native import FastAugBatch

from torch_port_fixtures import IMG_NORM

DATA = osp.join(osp.dirname(osp.abspath(__file__)), 'data', 'convergence')
IMAGE_TOL = 1e-4
CROP = (48, 48)
NATIVE_AUG = dict(crop_size=CROP, img_scale=(128, 64), ratio_range=(0.5, 2.0),
                  cat_max_ratio=0.75)
DEVICE_AUG = dict(NATIVE_AUG, canvas=(64, 128), num_classes=4)


def jax_draws(aug, key, batch):
    """The random values ``aug`` (the JAX DeviceAugPipeline) draws from
    ``key`` for a batch, in the port's :meth:`DeviceAugPipeline.draw`
    layout (the split tree of ``_one``, ``_crop_one`` and
    ``_photometric_one``)."""
    lo, hi = aug.ratio_range
    rows = []
    for rng in jax.random.split(key, batch):
        crop_rng, flip_rng, photo_rng = jax.random.split(rng, 3)
        r_rng, off_rng = jax.random.split(crop_rng)
        k = jax.random.split(photo_rng, 9)

        def uniform(key, lo, hi):
            return jax.random.uniform(key, (), minval=lo, maxval=hi)
        rows.append({
            'ratio': uniform(r_rng, lo, hi),
            'offsets': jax.random.uniform(off_rng, (aug.max_cat_tries, 2)),
            'flip': jax.random.bernoulli(flip_rng, aug.flip_prob),
            'brightness': jax.random.bernoulli(k[1]),
            'brightness_delta': uniform(k[0], -aug.brightness_delta,
                                        aug.brightness_delta),
            'contrast_first': jax.random.bernoulli(k[2]),
            'contrast': jax.random.bernoulli(k[3]),
            'contrast_alpha': uniform(k[4], *aug.contrast_range),
            'saturation': jax.random.bernoulli(k[6]),
            'saturation_alpha': uniform(k[5], *aug.saturation_range),
            'hue': jax.random.bernoulli(k[8]),
            'hue_delta': uniform(k[7], -aug.hue_delta, aug.hue_delta)})
    return {name: torch.from_numpy(np.stack([np.asarray(r[name])
                                             for r in rows]))
            for name in rows[0]}


def _photometric_on(draws):
    """Which photometric steps run in at least one sample."""
    c = draws['contrast']
    return {'brightness': bool(draws['brightness'].any()),
            'contrast first': bool((c & draws['contrast_first']).any()),
            'contrast last': bool((c & ~draws['contrast_first']).any()),
            'saturation': bool(draws['saturation'].any()),
            'hue': bool(draws['hue'].any())}


def _canvases(batch=4, hw=(24, 32), seed=0):
    """Canvases of ``hw`` with valid extents of several sizes; the left
    half of each valid area is one class, so that a crop there fails
    ``cat_max_ratio`` and another candidate is taken."""
    rng = np.random.RandomState(seed)
    img = np.zeros((batch, *hw, 3), np.uint8)
    gt = np.full((batch, *hw), 255, np.uint8)
    valid = np.array([(24, 32), (20, 30), (16, 32), (24, 20)],
                     np.int32)[:batch]
    for b, (vh, vw) in enumerate(valid):
        img[b, :vh, :vw] = rng.randint(0, 256, (vh, vw, 3))
        labels = rng.randint(0, 5, (vh, vw))
        labels[:, :vw // 2] = 1
        gt[b, :vh, :vw] = labels
    return img, gt, valid


@pytest.mark.parametrize('hw', [(40, 56), (100, 60), (30, 130)],
                         ids=['landscape', 'portrait', 'wide'])
def test_prepare_canvas_matches_jax(hw):
    rng = np.random.RandomState(hw[0])
    results = dict(img=rng.randint(0, 256, hw + (3,)).astype(np.uint8),
                   gt_semantic_seg=rng.randint(0, 6, hw).astype(np.uint8))
    kw = dict(img_scale=(128, 64), canvas=(64, 128))
    want = JaxPrepareCanvas(**kw)({k: v.copy() for k, v in results.items()})
    got = PrepareCanvas(**kw)({k: v.copy() for k, v in results.items()})
    assert got['img'].shape == want['img'].shape == (64, 128, 3)
    assert got['img'].dtype == np.uint8
    np.testing.assert_array_equal(got['valid_hw'], want['valid_hw'])
    np.testing.assert_array_equal(got['gt_semantic_seg'],
                                  want['gt_semantic_seg'])
    levels = np.abs(got['img'].astype(int) - want['img'].astype(int))
    assert levels.max() <= 1
    if hw[0] > hw[1]:  # the portrait image was turned onto the canvas
        assert got['valid_hw'][0] < got['valid_hw'][1]


def _aug_kw(cat_max_ratio):
    return dict(crop_size=(16, 16), cat_max_ratio=cat_max_ratio,
                num_classes=5)


@functools.lru_cache(maxsize=None)
def _jax_aug(cat_max_ratio):
    """One JAX pipeline a ratio: its jit is keyed by the instance, so the
    seeds share one compile."""
    return JaxDeviceAugPipeline(**_aug_kw(cat_max_ratio))


@pytest.mark.parametrize('cat_max_ratio', [0.75, 1.0])
@pytest.mark.parametrize('seed', [1, 3])
def test_device_aug_apply_matches_jax(cat_max_ratio, seed):
    """``apply`` on the JAX pipeline's draws: labels equal, images within
    ``IMAGE_TOL``; the draws of seed 1 run every photometric step, and at
    0.75 a candidate other than the first is taken."""
    jax_aug = _jax_aug(cat_max_ratio)
    aug = DeviceAugPipeline(**_aug_kw(cat_max_ratio))
    img, gt, valid = _canvases()
    key = jax.random.key(seed)
    want_img, want_gt = (np.asarray(a) for a in jax_aug(key, img, gt,
                                                        valid))
    draws = jax_draws(jax_aug, key, len(img))
    got_img, got_gt = aug.apply(draws, torch.from_numpy(img),
                                torch.from_numpy(gt),
                                torch.from_numpy(valid))
    assert got_img.dtype == torch.float32 and got_gt.dtype == torch.int32
    np.testing.assert_array_equal(got_gt.numpy(), want_gt)
    np.testing.assert_allclose(got_img.numpy(), want_img, rtol=0,
                               atol=IMAGE_TOL)
    if seed == 1:
        assert all(_photometric_on(draws).values())
    if cat_max_ratio < 1.0:
        ratio = draws['ratio']
        margins = torch.stack([
            (torch.from_numpy(valid[:, 0]) * ratio - 16).clamp_min(0),
            (torch.from_numpy(valid[:, 1]) * ratio - 16).clamp_min(0)], -1)
        pick = aug._pick(torch.from_numpy(gt).long(), ratio,
                         draws['offsets'] * margins[:, None])
        assert pick.max() > 0


def test_device_aug_draw_is_seeded():
    aug = DeviceAugPipeline(crop_size=(16, 16))
    a = aug.draw(torch.Generator().manual_seed(4), 3)
    b = aug.draw(torch.Generator().manual_seed(4), 3)
    assert set(a) == set(DeviceAugPipeline.DRAW_KEYS)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a['offsets'].shape == (3, 10, 2)
    lo, hi = aug.ratio_range
    assert ((a['ratio'] >= lo) & (a['ratio'] < hi)).all()


@pytest.mark.parametrize('seed', [5, 2 ** 32 + 9])
def test_fastaug_bitwise_equal_to_jax(seed):
    rng = np.random.RandomState(0)
    samples = []
    for _ in range(3):
        h, w = rng.randint(40, 90), rng.randint(50, 120)
        samples.append((rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
                        rng.randint(0, 19, (h, w)).astype(np.uint8)))
    kw = dict(crop_size=(32, 40), img_scale=(128, 64))
    got = FastAugBatch(**kw)(samples, seed=seed)
    want = JaxFastAugBatch(**kw)(samples, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _dataset_cfg():
    pipeline = [
        dict(type='LoadImageFromFile'),
        dict(type='LoadAnnotations', reduce_zero_label=True),
        dict(type='Resize', img_scale=(128, 64), ratio_range=(0.5, 2.0)),
        dict(type='RandomCrop', crop_size=CROP, cat_max_ratio=0.75),
        dict(type='RandomFlip', prob=0.5),
        dict(type='PhotoMetricDistortion'),
        dict(type='Normalize', **IMG_NORM),
        dict(type='Pad', size=CROP, pad_val=0, seg_pad_val=255),
        dict(type='DefaultFormatBundle'),
        dict(type='Collect', keys=['img', 'gt_semantic_seg']),
    ]
    return dict(type='RepeatDataset', times=2, dataset=dict(
        type='CustomDataset', data_root=DATA, img_dir='img/train',
        ann_dir='ann/train', classes=('a', 'b', 'c', 'd'),
        reduce_zero_label=True, pipeline=pipeline))


@pytest.fixture(scope='module')
def dataset():
    return build_dataset(_dataset_cfg())


def _loader(dataset, backend, rank=0, world=1, **kw):
    aug = NATIVE_AUG if backend == 'native' else DEVICE_AUG
    return build_dataloader(dataset, 2, 2, seed=7, loader_backend=backend,
                            aug_cfg=dict(aug), device='cpu',
                            process_index=rank, process_count=world, **kw)


def _batches(loader, n):
    it = iter(loader)
    try:
        return [{k: v.numpy() for k, v in next(it).items()}
                for _ in range(n)]
    finally:
        it.close()


def _equal(a, b):
    return all(np.array_equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


@pytest.mark.parametrize('backend', ['native', 'device'])
def test_backend_batches_and_stream(dataset, backend):
    """Shapes and dtypes; the same seed gives the same stream; a loader
    resumed at ``start_batch=2`` gives the batches from the third on."""
    loader = _loader(dataset, backend)
    assert isinstance(loader, {'native': NativeAugDataLoader,
                               'device': DeviceAugDataLoader}[backend])
    first = _batches(loader, 4)
    for b in first:
        assert b['img'].shape == (2, *CROP, 3)
        assert b['img'].dtype == np.float32
        assert b['gt_semantic_seg'].shape == (2, *CROP)
        assert b['gt_semantic_seg'].dtype == np.int32
        assert set(np.unique(b['gt_semantic_seg'])) <= {0, 1, 2, 3, 255}
        assert np.abs(b['img']).max() < 3.0
    assert _equal(first, _batches(_loader(dataset, backend), 4))
    assert not _equal(first[:1], first[1:2])
    assert _equal(first[2:], _batches(_loader(dataset, backend,
                                              start_batch=2), 2))


@pytest.mark.parametrize('world', [1, 2])
def test_native_loader_bitwise_equal_to_jax(dataset, world):
    """The native loader against the JAX package's on the same files,
    seed and rank shards: the same order, batch seeds and core, so the
    same batches bit for bit; at two ranks (given explicitly, no process
    group) each rank takes its own half of every global batch."""
    jax_dataset = jax_build_dataset(_dataset_cfg())
    shards = []
    for rank in range(world):
        want = jax_build_dataloader(
            jax_dataset, 2, 2, dist=False, seed=7, loader_backend='native',
            aug_cfg=dict(NATIVE_AUG), process_index=rank,
            process_count=world)
        it = iter(want)
        want = [{k: np.asarray(v) for k, v in next(it).items()}
                for _ in range(3)]
        got = _batches(_loader(dataset, 'native', rank, world), 3)
        assert _equal(got, want)
        shards.append(got)
    if world == 2:
        assert not _equal(shards[0][:1], shards[1][:1])


def test_device_loader_rank_shards(dataset):
    """At two ranks each device loader augments its own half of the global
    batch, drawn from the seed of its first sample (the host loader's
    shard and seeds)."""
    from segdistill_tpu_torch.datasets.builder import _load_only_view
    for rank in (0, 1):
        loader = _loader(dataset, 'device', rank, 2)
        got = _batches(loader, 1)[0]
        idx = loader._epoch_indices(0)[0]
        other = _loader(dataset, 'device', 1 - rank, 2)._epoch_indices(0)[0]
        assert len(idx) == 2 and not set(idx) & set(other)
        view = _load_only_view(dataset)
        samples = [loader.canvas(view[int(i)]) for i in idx]
        seed = int(np.random.SeedSequence((7, rank, 0)).generate_state(1)[0])
        draws = loader.aug.draw(torch.Generator().manual_seed(seed),
                                len(samples))
        img, gt = loader.aug.apply(
            draws, *[torch.from_numpy(np.stack([s[k] for s in samples]))
                     for k in ('img', 'gt_semantic_seg', 'valid_hw')])
        np.testing.assert_array_equal(got['img'], img.numpy())
        np.testing.assert_array_equal(got['gt_semantic_seg'], gt.numpy())


def test_backend_errors(dataset):
    with pytest.raises(ValueError, match='loader_backend'):
        build_dataloader(dataset, 2, 2, loader_backend='gpu')
    with pytest.raises(ValueError, match='train-only'):
        build_dataloader(dataset, 2, 2, shuffle=False,
                         loader_backend='native', aug_cfg=dict(NATIVE_AUG))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            build_dataloader(dataset, 2, 2, loader_backend='device')
    bare = build_dataset(dict(_dataset_cfg()['dataset'], pipeline=[
        dict(type='LoadImageFromFile')]))
    with pytest.raises(ValueError, match='LoadAnnotations'):
        build_dataloader(bare, 2, 2, loader_backend='device', device='cpu')


class _Broken:
    """A dataset whose third sample cannot be read."""

    def __len__(self):
        return 8

    def __getitem__(self, idx):
        if idx == 2:
            raise OSError('unreadable sample')
        return {'img': np.zeros((2, 2, 3), np.float32)}


def test_loader_raises_what_its_producer_raised():
    """An error on the loader's threads reaches the consumer as a
    RuntimeError caused by it, rather than leaving it waiting for a
    batch."""
    from segdistill_tpu_torch.datasets import DataLoader
    loader = DataLoader(_Broken(), samples_per_gpu=2, shuffle=False,
                        drop_last=False)
    it = iter(loader)
    next(it)
    with pytest.raises(RuntimeError, match='data loader failed') as err:
        next(it)
    assert isinstance(err.value.__cause__, OSError)


def test_bench_loader_tool(capsys):
    """``tools/bench_loader.py`` on the CPU at a small crop: one JSON line
    a run, the backends in turn in each of two rounds, each with its
    images/s and the device it ran on."""
    from segdistill_tpu_torch.tools import bench_loader
    bench_loader.main(['--device', 'cpu', '--num-images', '4', '--batch',
                       '2', '--batches', '1', '--repeats', '2', '--workers',
                       '2', '--crop', '32'])
    lines = [json.loads(line)
             for line in capsys.readouterr().out.strip().splitlines()]
    assert [(ln['backend'], ln['repeat']) for ln in lines] == [
        (b, r) for r in (0, 1) for b in ('host', 'native', 'device')]
    assert all(ln['images_per_s'] > 0 and ln['images'] == 2
               and ln['device'] == 'cpu' for ln in lines)


def test_packed_buffer_round_trip():
    """The batch loaders' one host buffer a batch: every part 64-byte
    aligned and apart from the others, and each read back bitwise through
    its typed view (uint8, int32, float32, bool)."""
    from segdistill_tpu_torch.datasets.builder import _layout, _views
    rng = np.random.RandomState(0)
    parts = {'img': torch.from_numpy(rng.randint(0, 256, (2, 5, 7, 3))
                                     .astype(np.uint8)),
             'valid_hw': torch.tensor([[5, 7], [3, 6]], dtype=torch.int32),
             'offsets': torch.from_numpy(rng.rand(2, 10, 2)
                                         .astype(np.float32)),
             'flip': torch.tensor([True, False])}
    layout, nbytes = _layout([(k, v.dtype, v.shape)
                              for k, v in parts.items()])
    ends = 0
    for _, _, _, off, n in layout:
        assert off % 64 == 0 and off >= ends
        ends = off + n
    assert ends <= nbytes
    buf = torch.zeros(nbytes, dtype=torch.uint8)
    for k, v in _views(buf, layout).items():
        v.copy_(parts[k])
    for k, v in _views(buf.clone(), layout).items():
        assert v.dtype == parts[k].dtype and torch.equal(v, parts[k])


@pytest.mark.parametrize('backend', ['native', 'device'])
def test_profile_loader_hooks(dataset, backend):
    """``tools/profile_loader.py``'s wrappers time the loader's hooks on
    the CPU (a train thread's ``_deliver`` numbered from 1) and leave the
    class as it was; its options point the CLI at the backend's recipe."""
    import ast
    from segdistill_tpu_torch.datasets import LOADER_BACKENDS
    from segdistill_tpu_torch.tools import bench_loader, profile_loader
    cls = LOADER_BACKENDS[backend]
    before = dict(cls.__dict__)
    spans, seen = profile_loader.Spans(), []
    with profile_loader.instrumented(cls, spans, seen.append):
        got = _batches(_loader(dataset, backend), 3)
    assert dict(cls.__dict__) == before
    assert seen == [1, 2, 3] and len(spans.ms('_deliver')) == 3
    assert len(spans.ms('_collate')) >= 3 and len(spans.ms('_load')) >= 6
    assert _equal(got, _batches(_loader(dataset, backend), 3))
    opts = dict(o.split('=', 1) for o in profile_loader.options(
        '/data', 14, 6, backend))
    assert opts['data.loader_backend'] == backend
    assert ast.literal_eval(opts['data.aug_cfg']) == \
        bench_loader.aug_cfg(backend)
