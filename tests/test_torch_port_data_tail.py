"""The rest of the port's data layer against the JAX package on the CPU:
the PNG codec (``utils/png.py``) against OpenCV and pillow, the image ops
(``bgr2gray``, ``rgb2gray``, ``clahe``, ``imrotate``), the eight
transforms added with them, the Pascal VOC, Pascal Context, COCO-Stuff and
Mapillary datasets, the Cityscapes submission writer, result painting and
``tools.test --show-dir``, ``mean_dice``, the runner's TensorBoard option
and the two Pascal recipes.

Exact where the JAX package computes in integers (gray, CLAHE, the
transforms' labels, the datasets' label maps, the written files, the
painting); ``imrotate`` images within one level with at most
``ROTATE_SHARE`` of the values off by one (OpenCV 5.0 warps in float32 and
rounds a position differently in its vector and scalar loops), its labels
(nearest) equal. One difference is intended: a palette PNG label map reads
as its indices in the port (as pillow and the reference read it) and as
the palette's blue channel in the JAX package.
"""

import copy
import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from segdistill_tpu_torch.utils import image as P
from segdistill_tpu_torch.utils import png

import torch_port_threads  # noqa: F401  (torch threads a test worker)

ROOT = Path(__file__).resolve().parent.parent
# share of imrotate's bilinear values that may sit one level from OpenCV's
ROTATE_SHARE = 1e-3
VOC_PALETTE = np.array([
    [0, 0, 0], [128, 0, 0], [0, 128, 0], [128, 128, 0], [0, 0, 128],
    [128, 0, 128], [0, 128, 128], [128, 128, 128], [64, 0, 0], [192, 0, 0],
    [64, 128, 0], [192, 128, 0], [64, 0, 128], [192, 0, 128],
    [64, 128, 128], [192, 128, 128], [0, 64, 0], [128, 64, 0], [0, 192, 0],
    [128, 192, 0], [0, 64, 128]] + [[224, 224, 192]] * 235, np.uint8)


def _jax_image():
    from segdistill_tpu.utils import image
    return image


def _smooth(rng, h, w, c):
    """A photo-like uint8 image (adaptive PNG filters pick Paeth / Sub)."""
    base = rng.randint(0, 256, (h // 8 + 2, w // 8 + 2, c)).astype(
        np.float32)
    out = cv2.resize(base, (w, h))
    out = out.reshape(h, w, c) if c > 1 else out.reshape(h, w)
    return np.clip(out + rng.randint(0, 6, out.shape), 0, 255).astype(
        np.uint8)


FLAGS = {'color': cv2.IMREAD_COLOR, 'grayscale': cv2.IMREAD_GRAYSCALE,
         'unchanged': cv2.IMREAD_UNCHANGED}


def _same(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


# (name, an array as OpenCV holds it, pillow mode, the array pillow takes)
def _codec_cases():
    rng = np.random.RandomState(0)
    gray = _smooth(rng, 37, 53, 1)
    bgr = _smooth(rng, 41, 29, 3)
    bgra = np.concatenate([_smooth(rng, 23, 31, 3),
                           rng.randint(0, 256, (23, 31, 1)).astype(np.uint8)],
                          -1)
    g16 = rng.randint(0, 65536, (19, 27)).astype(np.uint16)
    return {'gray8': (gray, 'L', gray),
            'rgb8': (bgr, 'RGB', bgr[..., ::-1]),
            'rgba8': (bgra, 'RGBA', bgra[..., [2, 1, 0, 3]]),
            'gray16': (g16, 'I;16', g16)}


@pytest.mark.parametrize('case', ['gray8', 'rgb8', 'rgba8', 'gray16'])
def test_png_codec_against_opencv_and_pillow(tmp_path, case):
    """Files OpenCV and pillow write (pillow with adaptive filters) decode
    as OpenCV reads them under each flag; the port's files read back in
    OpenCV and pillow as the array written."""
    cv_img, mode, pil_img = _codec_cases()[case]
    cv_path, pil_path = tmp_path / 'cv.png', tmp_path / 'pil.png'
    cv2.imwrite(str(cv_path), cv_img)
    Image.fromarray(np.ascontiguousarray(pil_img)).save(pil_path)
    assert Image.open(pil_path).mode == mode
    for path in (cv_path, pil_path):
        data = path.read_bytes()
        for flag, cv_flag in FLAGS.items():
            assert _same(png.decode_png(data, flag),
                         cv2.imread(str(path), cv_flag)), (path.name, flag)
            assert _same(P.imread(str(path), flag),
                         cv2.imread(str(path), cv_flag)), (path.name, flag)
    ours = tmp_path / 'ours.png'
    assert P.imwrite(cv_img, str(ours)) is True
    assert _same(cv2.imread(str(ours), cv2.IMREAD_UNCHANGED), cv_img)
    assert np.array_equal(np.array(Image.open(ours)), pil_img)
    assert _same(P.imread(str(ours), 'unchanged'), cv_img)


def test_png_gray_alpha_and_palettes(tmp_path):
    """Gray + alpha (pillow 'LA'), 8-bit and 4-bit palette files: OpenCV's
    arrays under each flag; a palette's indices with the pillow backend
    (pillow's own array); a palette written by the port reads back in
    pillow as its indices and in OpenCV as its colours."""
    rng = np.random.RandomState(1)
    la = np.stack([_smooth(rng, 20, 30, 1),
                   rng.randint(0, 256, (20, 30)).astype(np.uint8)], -1)
    Image.fromarray(la, 'LA').save(tmp_path / 'la.png')
    idx = rng.randint(0, 21, (45, 61)).astype(np.uint8)
    idx[:3] = 255
    pal = Image.fromarray(idx, 'P')
    pal.putpalette(VOC_PALETTE.ravel().tolist())
    pal.save(tmp_path / 'pal8.png')
    pal4 = Image.fromarray(idx % 16, 'P')
    pal4.putpalette(VOC_PALETTE[:16].ravel().tolist())
    pal4.save(tmp_path / 'pal4.png', bits=4)
    for name in ('la.png', 'pal8.png', 'pal4.png'):
        path = str(tmp_path / name)
        for flag, cv_flag in FLAGS.items():
            assert _same(P.imread(path, flag), cv2.imread(path, cv_flag)), \
                (name, flag)
    for name in ('pal8.png', 'pal4.png'):
        path = str(tmp_path / name)
        assert _same(P.imread(path, 'unchanged', backend='pillow'),
                     np.array(Image.open(path)))
    P.imwrite(idx, str(tmp_path / 'ours.png'), palette=VOC_PALETTE)
    assert np.array_equal(np.array(Image.open(tmp_path / 'ours.png')), idx)
    assert _same(cv2.imread(str(tmp_path / 'ours.png'), cv2.IMREAD_COLOR),
                 VOC_PALETTE[idx][..., ::-1])


def _filtered_png(img, kinds):
    """8-bit gray (H, W) or BGR (H, W, 3) as PNG bytes, row i filtered
    with filter type ``kinds[i]`` (PNG spec, section 9)."""
    ch = 1 if img.ndim == 2 else 3
    x = (img if ch == 1 else img[..., ::-1]).reshape(len(img), -1)
    x = x.astype(np.int16)
    a, b, c = (np.zeros_like(x) for _ in range(3))
    a[:, ch:], b[1:], c[1:, ch:] = x[:, :-ch], x[:-1], x[:-1, :-ch]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = np.choose(np.asarray(kinds)[:, None],
                     [np.zeros_like(x), a, b, (a + b) // 2, paeth])
    raw = np.concatenate([np.asarray(kinds, np.uint8)[:, None],
                          ((x - pred) & 255).astype(np.uint8)], axis=1)
    ihdr = struct.pack('>IIBBBBB', img.shape[1], len(img), 8,
                       0 if ch == 1 else 2, 0, 0, 0)
    return (png.SIGNATURE + png._chunk(b'IHDR', ihdr)
            + png._chunk(b'IDAT', zlib.compress(raw.tobytes()))
            + png._chunk(b'IEND', b''))


@pytest.mark.parametrize('channels', [1, 3], ids=['gray', 'bgr'])
@pytest.mark.parametrize('rows', ['paeth', 'average', 'mixed', 'sparse'])
def test_png_filters_both_ways_of_undoing(monkeypatch, rows, channels):
    """Every row filter, alone, mixed, and as a few Average / Paeth rows
    among Sub and Up rows: the decoded pixels equal the image and OpenCV's
    reading, whether Average and Paeth rows are undone byte by byte or all
    along anti-diagonals."""
    rng = np.random.RandomState(4)
    h, w = 45, 38
    img = _smooth(rng, h, w, channels)
    if channels == 1:
        img = img.reshape(h, w)
    kinds = {'paeth': np.full(h, 4), 'average': np.full(h, 3),
             'mixed': rng.randint(0, 5, h),
             'sparse': np.where(rng.rand(h) < 0.1, rng.randint(3, 5, h),
                                rng.randint(1, 3, h))}[rows]
    data = _filtered_png(img, kinds)
    assert _same(cv2.imdecode(np.frombuffer(data, np.uint8),
                              cv2.IMREAD_UNCHANGED), img)
    for diagonal in (False, True):
        monkeypatch.setattr(png, "_DIAGONAL_BYTES", 0 if diagonal else 1e9)
        assert _same(png.decode_png(data, 'unchanged'), img), diagonal


def test_imread_tells_the_format_by_content(tmp_path):
    """PNG bytes under a ``.jpg`` name, an ``.npy`` array, and a JPEG
    (through OpenCV); an interlaced PNG raises and says so."""
    rng = np.random.RandomState(2)
    img = _smooth(rng, 33, 47, 3)
    (tmp_path / 'a.jpg').write_bytes(png.encode_png(img))
    assert _same(P.imread(str(tmp_path / 'a.jpg')), img)
    np.save(tmp_path / 'b.npy', img)
    assert _same(P.imread(str(tmp_path / 'b.npy')), img)
    cv2.imwrite(str(tmp_path / 'c.jpg'), img)
    assert _same(P.imread(str(tmp_path / 'c.jpg')),
                 cv2.imread(str(tmp_path / 'c.jpg')))
    # pillow writes no interlaced file: set the flag of an IHDR by hand
    ihdr = struct.pack('>IIBBBBB', 4, 4, 8, 0, 0, 0, 1)
    (tmp_path / 'i.png').write_bytes(
        png.SIGNATURE + png._chunk(b'IHDR', ihdr)
        + png._chunk(b'IDAT', zlib.compress(bytes(20)))
        + png._chunk(b'IEND', b''))
    with pytest.raises(ValueError, match='interlaced'):
        P.imread(str(tmp_path / 'i.png'))


@pytest.mark.parametrize('hw', [(37, 53), (64, 64), (101, 77)])
def test_gray_and_clahe_equal_jax(hw):
    """uint8 gray conversions and CLAHE on odd sizes, with grids that do
    and do not divide them and clip limits low and high: equal."""
    J = _jax_image()
    rng = np.random.RandomState(hw[0])
    img = _smooth(rng, *hw, 3)
    assert _same(P.bgr2gray(img), J.bgr2gray(img))
    assert _same(P.rgb2gray(img, keepdim=True), J.rgb2gray(img, keepdim=True))
    for clip, grid in ((40.0, (8, 8)), (2.0, (3, 5)), (0.5, (4, 4)),
                       (4.0, (7, 6))):
        assert _same(P.clahe(img[..., 1], clip, grid),
                     J.clahe(img[..., 1], clip, grid)), (clip, grid)


@pytest.mark.parametrize('auto_bound', [False, True], ids=['fixed', 'auto'])
def test_imrotate_against_jax(auto_bound):
    """Images within one level (at most ROTATE_SHARE of the values off by
    one), labels (nearest, 255 borders) equal, over sizes, angles, scales
    and a given centre."""
    J = _jax_image()
    rng = np.random.RandomState(3 + auto_bound)
    off, total = 0, 0
    for h, w in ((37, 53), (64, 64), (101, 77)):
        img = _smooth(rng, h, w, 3)
        lab = rng.randint(0, 21, (h, w)).astype(np.uint8)
        for angle in rng.uniform(-180, 180, 3):
            kw = dict(angle=angle, auto_bound=auto_bound)
            got, want = P.imrotate(img, **kw), J.imrotate(img, **kw)
            assert got.shape == want.shape
            diff = np.abs(got.astype(int) - want)
            assert diff.max() <= 1
            off, total = off + int((diff > 0).sum()), total + diff.size
            kw = dict(kw, border_value=255, interpolation='nearest')
            assert _same(P.imrotate(lab, **kw), J.imrotate(lab, **kw))
        kw = dict(angle=33.3, center=(10, 5), scale=1.2)
        diff = np.abs(P.imrotate(img, **kw).astype(int)
                      - J.imrotate(img, **kw))
        assert diff.max() <= 1
        off, total = off + int((diff > 0).sum()), total + diff.size
    assert off <= ROTATE_SHARE * total, off / total


def _transform_results(seed, transform):
    rng = np.random.RandomState(100 + seed)
    h, w = 57, 71
    img = _smooth(rng, h, w, 3)
    if transform == 'Rerange':
        img = img.astype(np.float32) * 0.5 + 3.0
    gt = rng.randint(0, 66 if transform == 'MaillaryHack' else 21,
                     (h, w)).astype(np.uint8)
    return dict(img=img, gt_semantic_seg=gt, seg_fields=['gt_semantic_seg'],
                img_shape=img.shape, rng=np.random.RandomState(seed))


TRANSFORMS = {
    'Rerange': dict(min_value=-1.0, max_value=2.0),
    'CLAHE': dict(clip_limit=3.0, tile_grid_size=(5, 6)),
    'CenterCrop': dict(crop_size=(40, 50)),
    'RandomRotate': dict(prob=0.8, degree=(-30, 45), pad_val=7,
                         seg_pad_val=255, auto_bound=True),
    'RGB2Gray': dict(out_channels=1),
    'AdjustGamma': dict(gamma=1.7),
    'MaillaryHack': dict(),
    'SegRescale': dict(scale_factor=0.5),
}


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('name', sorted(TRANSFORMS))
def test_transform_against_jax(name, seed):
    """Each added transform against its JAX twin on the same inputs and
    per-sample RNG: labels equal, images equal (RandomRotate: within one
    level), and the RNG left in the same state (the draws align)."""
    from segdistill_tpu.datasets.pipelines import transforms as jt
    from segdistill_tpu_torch.datasets.pipelines import transforms as pt
    base = _transform_results(seed, name)
    got = getattr(pt, name)(**TRANSFORMS[name])(copy.deepcopy(base))
    want = getattr(jt, name)(**TRANSFORMS[name])(copy.deepcopy(base))
    assert _same(np.asarray(got['gt_semantic_seg']),
                 np.asarray(want['gt_semantic_seg']))
    a, b = np.asarray(got['img']), np.asarray(want['img'])
    assert a.shape == b.shape and a.dtype == b.dtype
    if name == 'RandomRotate':
        assert np.abs(a.astype(int) - b).max() <= 1
    else:
        assert np.array_equal(a, b)
    assert got['rng'].randint(1 << 30) == want['rng'].randint(1 << 30)


def _palette_png(path, idx):
    im = Image.fromarray(idx, 'P')
    im.putpalette(VOC_PALETTE.ravel().tolist())
    im.save(path)


def test_palette_labels_read_as_indices_unlike_jax(tmp_path):
    """The one intended difference: Pascal VOC's palette label maps. The
    port's LoadAnnotations (pillow backend, the reference's default) reads
    the indices; the JAX package's reads OpenCV's BGR expansion and keeps
    channel 0, the palette's blue."""
    from segdistill_tpu.datasets.pipelines.loading import \
        LoadAnnotations as JaxLoad
    from segdistill_tpu_torch.datasets.pipelines.loading import \
        LoadAnnotations
    idx = np.array([[0, 1, 2], [15, 255, 20]], np.uint8)
    _palette_png(tmp_path / 'a.png', idx)
    results = dict(seg_prefix=str(tmp_path), ann_info=dict(seg_map='a.png'))
    got = LoadAnnotations()(copy.deepcopy(results))['gt_semantic_seg']
    want = JaxLoad()(copy.deepcopy(results))['gt_semantic_seg']
    assert np.array_equal(got, idx)
    assert np.array_equal(want, VOC_PALETTE[idx][..., 2])
    assert not np.array_equal(got, want)
    # a gray label map reads the same in both
    cv2.imwrite(str(tmp_path / 'g.png'), idx)
    results['ann_info'] = dict(seg_map='g.png')
    assert np.array_equal(
        LoadAnnotations()(copy.deepcopy(results))['gt_semantic_seg'],
        JaxLoad()(copy.deepcopy(results))['gt_semantic_seg'])


def write_voc(root, rng, n=6, palette_png=None):
    """A VOC 2012 tree: PNG-encoded images under ``.jpg`` names, palette
    label maps in SegmentationClass (255 borders), gray SBD-style maps in
    SegmentationClassAug, train / val / aug splits; -> (names, {name: class
    indices})."""
    voc = root / 'VOC2012'
    for d in ('JPEGImages', 'SegmentationClass', 'SegmentationClassAug',
              'ImageSets/Segmentation'):
        (voc / d).mkdir(parents=True, exist_ok=True)
    names, labels = [f'2007_{i:06d}' for i in range(n)], {}
    for i, name in enumerate(names):
        h, w = 40 + 4 * i, 52 - 2 * i
        (voc / 'JPEGImages' / f'{name}.jpg').write_bytes(
            png.encode_png(_smooth(rng, h, w, 3)))
        idx = rng.randint(0, 21, (h, w)).astype(np.uint8)
        idx[0], idx[:, -1] = 255, 255
        labels[name] = idx
        (palette_png or _palette_png)(voc / 'SegmentationClass' /
                                      f'{name}.png', idx)
        cv2.imwrite(str(voc / 'SegmentationClassAug' / f'{name}.png'),
                    np.where(idx == 255, 0, idx).astype(np.uint8))
    sets = voc / 'ImageSets' / 'Segmentation'
    sets.joinpath('train.txt').write_text('\n'.join(names[:3]) + '\n')
    sets.joinpath('val.txt').write_text('\n'.join(names[3:5]) + '\n')
    sets.joinpath('aug.txt').write_text('\n'.join(names[:3] + names[5:])
                                        + '\n')
    return names, labels


def _pair(kind, **kw):
    """The dataset class ``kind`` built in both packages with ``kw``."""
    import segdistill_tpu.datasets as jd
    import segdistill_tpu_torch.datasets as pd
    return getattr(pd, kind)(**kw), getattr(jd, kind)(**kw)


LOAD = [dict(type='LoadImageFromFile'), dict(type='LoadAnnotations')]


def _same_samples(port, jax_ds, label_key='gt_semantic_seg'):
    assert len(port) == len(jax_ds)
    assert port.img_infos == jax_ds.img_infos
    for i in range(len(port)):
        a, b = port[i], jax_ds[i]
        assert _same(a['img'], b['img'])
        assert _same(a[label_key], b[label_key])


def test_voc_datasets_and_the_aug_concat(tmp_path):
    """PascalVOCDataset: the gray SBD labels read alike in both packages;
    the palette labels read as the indices written (the port); the
    augmented set's two ann_dir / split build a ConcatDataset whose parts
    are the two splits."""
    from segdistill_tpu_torch.datasets import ConcatDataset, build_dataset
    names, labels = write_voc(tmp_path, np.random.RandomState(4))
    voc = str(tmp_path / 'VOC2012')
    common = dict(pipeline=LOAD, data_root=voc, img_dir='JPEGImages')
    port, jax_ds = _pair('PascalVOCDataset', ann_dir='SegmentationClassAug',
                         split='ImageSets/Segmentation/aug.txt', **common)
    _same_samples(port, jax_ds)
    assert len(port) == 4 and port.CLASSES == jax_ds.CLASSES
    port_val, _ = _pair('PascalVOCDataset', ann_dir='SegmentationClass',
                        split='ImageSets/Segmentation/val.txt', **common)
    maps = list(port_val.get_gt_seg_maps())
    assert all(np.array_equal(m, labels[n])
               for m, n in zip(maps, names[3:5]))
    assert np.array_equal(port_val[0]['gt_semantic_seg'], labels[names[3]])
    cfg = dict(type='PascalVOCDataset', **common,
               ann_dir=['SegmentationClass', 'SegmentationClassAug'],
               split=['ImageSets/Segmentation/train.txt',
                      'ImageSets/Segmentation/aug.txt'])
    both = build_dataset(cfg)
    assert isinstance(both, ConcatDataset)
    assert [len(d) for d in both.datasets] == [3, 4] and len(both) == 7
    assert np.array_equal(both[1]['gt_semantic_seg'], labels[names[1]])
    assert np.array_equal(both[6]['gt_semantic_seg'],
                          np.where(labels[names[5]] == 255, 0,
                                   labels[names[5]]))


def test_context_cocostuff_mapillary_datasets(tmp_path):
    """PascalContextDataset (split file), CocoStuffDataset (scanned,
    ``_labelTrainIds`` maps, reduce_zero_label) and MapillaryDataset with
    the MaillaryHack pipeline: the same lists, images and label maps in
    both packages."""
    rng = np.random.RandomState(5)
    ctx = tmp_path / 'VOC2010'
    for d in ('JPEGImages', 'SegmentationClassContext',
              'ImageSets/SegmentationContext'):
        (ctx / d).mkdir(parents=True)
    for i in range(3):
        (ctx / 'JPEGImages' / f'c{i}.jpg').write_bytes(
            png.encode_png(_smooth(rng, 30, 38, 3)))
        cv2.imwrite(str(ctx / 'SegmentationClassContext' / f'c{i}.png'),
                    rng.randint(0, 60, (30, 38)).astype(np.uint8))
    (ctx / 'ImageSets/SegmentationContext/train.txt').write_text(
        'c0\nc2\n')
    _same_samples(*_pair(
        'PascalContextDataset', pipeline=LOAD, data_root=str(ctx),
        img_dir='JPEGImages', ann_dir='SegmentationClassContext',
        split='ImageSets/SegmentationContext/train.txt'))

    coco = tmp_path / 'coco'
    for d in ('images/train2014', 'annotations/train2014'):
        (coco / d).mkdir(parents=True)
    for i in range(3):
        (coco / 'images/train2014' / f'k{i}.jpg').write_bytes(
            png.encode_png(_smooth(rng, 26, 34, 3)))
        cv2.imwrite(str(coco / 'annotations/train2014' /
                        f'k{i}_labelTrainIds.png'),
                    rng.randint(0, 172, (26, 34)).astype(np.uint8))
    pipe = [dict(type='LoadImageFromFile'),
            dict(type='LoadAnnotations', reduce_zero_label=True)]
    port, jax_ds = _pair('CocoStuffDataset', pipeline=pipe,
                         data_root=str(coco), img_dir='images/train2014',
                         ann_dir='annotations/train2014')
    _same_samples(port, jax_ds)
    assert len(port) == 3 and len(port.CLASSES) == 171

    mapi = tmp_path / 'mapillary'
    for d in ('img', 'ann'):
        (mapi / d).mkdir(parents=True)
    for i in range(2):
        (mapi / 'img' / f'm{i}.jpg').write_bytes(
            png.encode_png(_smooth(rng, 22, 30, 3)))
        cv2.imwrite(str(mapi / 'ann' / f'm{i}.png'),
                    rng.randint(0, 66, (22, 30)).astype(np.uint8))
    pipe = LOAD + [dict(type='MaillaryHack')]
    port, jax_ds = _pair('MapillaryDataset', pipeline=pipe,
                         data_root=str(mapi), img_dir='img', ann_dir='ann')
    _same_samples(port, jax_ds)
    assert port[0]['gt_semantic_seg'].max() <= 255
    assert set(np.unique(port[0]['gt_semantic_seg'])) <= set(range(19)) | \
        {255}


def test_cityscapes_results2img_equals_jax(tmp_path):
    """The submission PNGs (label ids) of the same results: the same
    names, and the same maps decoded."""
    rng = np.random.RandomState(6)
    city = tmp_path / 'city'
    (city / 'img' / 'aachen').mkdir(parents=True)
    (city / 'ann' / 'aachen').mkdir(parents=True)
    for i in range(3):
        stem = f'aachen_{i:06d}_000019'
        (city / 'img' / 'aachen' / f'{stem}_leftImg8bit.png').write_bytes(
            png.encode_png(_smooth(rng, 16, 32, 3)))
        cv2.imwrite(str(city / 'ann' / 'aachen' /
                        f'{stem}_gtFine_labelTrainIds.png'),
                    rng.randint(0, 19, (16, 32)).astype(np.uint8))
    port, jax_ds = _pair('CityscapesDataset', pipeline=LOAD,
                         data_root=str(city), img_dir='img', ann_dir='ann')
    results = [np.where(rng.rand(16, 32) < 0.1, 255,
                        rng.randint(0, 19, (16, 32))) for _ in range(3)]
    got = port.results2img(results, str(tmp_path / 'port'))
    want = jax_ds.results2img(results, str(tmp_path / 'jax'))
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        assert _same(cv2.imread(a, cv2.IMREAD_UNCHANGED),
                     cv2.imread(b, cv2.IMREAD_UNCHANGED))
        assert _same(P.imread(a, 'unchanged'), P.imread(b, 'unchanged'))
    files, tmp_dir = port.format_results(results, to_label_id=False)
    assert np.array_equal(P.imread(files[1], 'unchanged'),
                          results[1].astype(np.uint8))
    tmp_dir.cleanup()


def test_show_result_and_mean_dice_equal_jax():
    """Painting with the seeded palette and with a given one, and
    mean_dice, against the JAX functions."""
    from segdistill_tpu.core.evaluation import metrics as jm
    from segdistill_tpu.models.segmentors.base import \
        BaseSegmentor as JaxBase
    from segdistill_tpu_torch.apis import show_result_pyplot
    from segdistill_tpu_torch.core.evaluation import mean_dice
    from segdistill_tpu_torch.models.segmentors.base import BaseSegmentor
    rng = np.random.RandomState(7)
    img = _smooth(rng, 31, 45, 3)
    seg = rng.randint(0, 5, (31, 45))
    port, jax_model = BaseSegmentor(), JaxBase()
    for n in (None, 5):
        port.num_classes = jax_model.num_classes = n
        assert _same(port.show_result(img, seg),
                     jax_model.show_result(img, seg))
    pal = VOC_PALETTE[:5]
    assert _same(port.show_result(img, seg, palette=pal, opacity=0.3),
                 jax_model.show_result(img, seg, palette=pal, opacity=0.3))
    assert _same(show_result_pyplot(port, img, [seg], palette=pal),
                 port.show_result(img, seg, palette=pal))
    preds = [rng.randint(0, 6, (20, 20)) for _ in range(3)]
    gts = [np.where(rng.rand(20, 20) < 0.1, 255, rng.randint(0, 6, (20, 20)))
           for _ in range(3)]
    for a, b in zip(mean_dice(preds, gts, 6, 255),
                    jm.mean_dice(preds, gts, 6, 255)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


class _Step:
    """A train step that only counts: loss 1 / step."""

    def __call__(self, state, img, gt):
        state.step += 1
        return {'loss': torch.tensor(1.0 / state.step),
                'decode.acc_seg': torch.tensor(50.0)}


def _runner_state():
    from segdistill_tpu_torch.engine import TrainState
    model = torch.nn.Linear(2, 2)
    return TrainState(model=model, optimizer=torch.optim.SGD(
        model.parameters(), lr=0.1))


def _batches():
    while True:
        yield {'img': np.zeros((1, 3, 4, 4), np.float32),
               'gt_semantic_seg': np.zeros((1, 4, 4), np.int64)}


def test_runner_tensorboard_scalars(tmp_path):
    """With ``tensorboard`` the runner writes, at every log line, each log
    var as ``train/<key>`` and the step's time as ``train/iter_time`` (the
    JAX runner's scalars) to an event file under ``work_dir/tf_logs``."""
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    from segdistill_tpu_torch.engine import IterBasedRunner
    runner = IterBasedRunner(_Step(), _runner_state(), max_iters=4,
                             log_interval=2, work_dir=str(tmp_path),
                             checkpoint_interval=100, tensorboard=True)
    runner.run(_batches())
    events = EventAccumulator(str(tmp_path / 'tf_logs'))
    events.Reload()
    tags = sorted(events.Tags()['scalars'])
    assert tags == ['train/decode.acc_seg', 'train/iter_time', 'train/loss']
    loss = events.Scalars('train/loss')
    assert [e.step for e in loss] == [2, 4]
    assert [e.value for e in loss] == pytest.approx([0.5, 0.25])


def test_runner_goes_on_without_tensorboard(tmp_path, monkeypatch, caplog):
    """Where ``torch.utils.tensorboard`` cannot be imported the runner
    warns and trains to the end, writing no event file."""
    from segdistill_tpu_torch.engine import IterBasedRunner
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    runner = IterBasedRunner(_Step(), _runner_state(), max_iters=3,
                             log_interval=1, work_dir=str(tmp_path),
                             checkpoint_interval=100, tensorboard=True)
    assert runner.tb_writer is None
    assert runner.run(_batches()).step == 3
    assert not (tmp_path / 'tf_logs').exists()
    assert (tmp_path / 'checkpoints' / 'iter_3.pth').is_file()


def test_pascal_recipes():
    """The two recipes compose as mmseg's configs: classes in both heads,
    the datasets and their splits, optimizer, schedule, test mode."""
    from segdistill_tpu_torch.recipes import ALL_RECIPES, recipe
    voc = recipe('pspnet_r50-d8_voc12aug')
    assert voc.model.decode_head.num_classes == 21
    assert voc.model.auxiliary_head.num_classes == 21
    assert voc.model.backbone.type == 'ResNetV1c'
    assert voc.data.train.type == 'PascalVOCDataset'
    assert voc.data.train.ann_dir == ['SegmentationClass',
                                      'SegmentationClassAug']
    assert voc.data.train.split[1] == 'ImageSets/Segmentation/aug.txt'
    assert voc.data.samples_per_gpu == 4
    assert voc.optimizer == dict(type='SGD', lr=0.01, momentum=0.9,
                                 weight_decay=0.0005)
    assert voc.runner.max_iters == 20000
    assert voc.model.test_cfg == dict(mode='whole')
    ctx = recipe('pspnet_r50-d8_pascal_context')
    assert ctx.model.decode_head.num_classes == 60
    assert ctx.model.auxiliary_head.num_classes == 60
    assert ctx.data.train.type == 'PascalContextDataset'
    assert ctx.optimizer == dict(type='SGD', lr=0.004, momentum=0.9,
                                 weight_decay=0.0001)
    assert ctx.runner.max_iters == 40000
    assert ctx.lr_config.policy == 'poly'
    assert ctx.model.test_cfg == dict(mode='slide', crop_size=(480, 480),
                                      stride=(320, 320))
    crop = [t for t in ctx.data.train.pipeline if t['type'] == 'RandomCrop']
    assert crop[0]['crop_size'] == (480, 480)
    assert {'pspnet_r50-d8_voc12aug',
            'pspnet_r50-d8_pascal_context'} <= set(ALL_RECIPES)


NARROW_VOC = '''
model = dict(
    type='EncoderDecoder',
    backbone=dict(type='ResNetV1c', depth=18, stem_channels=16,
                  base_channels=8, num_stages=4, out_indices=(0, 1, 2, 3),
                  dilations=(1, 1, 2, 4), strides=(1, 2, 1, 1),
                  norm_cfg=dict(type='SyncBN', requires_grad=True),
                  norm_eval=False, style='pytorch', contract_dilation=True),
    decode_head=dict(type='PSPHead', in_channels=64, in_index=3,
                     channels=16, pool_scales=(1, 2, 3, 6),
                     dropout_ratio=0.1, num_classes=21,
                     norm_cfg=dict(type='SyncBN', requires_grad=True),
                     align_corners=False,
                     loss_decode=dict(type='CrossEntropyLoss',
                                      use_sigmoid=False, loss_weight=1.0)),
    auxiliary_head=dict(type='FCNHead', in_channels=32, in_index=2,
                        channels=8, num_convs=1, concat_input=False,
                        dropout_ratio=0.1, num_classes=21,
                        norm_cfg=dict(type='SyncBN', requires_grad=True),
                        align_corners=False,
                        loss_decode=dict(type='CrossEntropyLoss',
                                         use_sigmoid=False,
                                         loss_weight=0.4)),
    train_cfg=dict(), test_cfg=dict(mode='whole'))
for _split in ('train', 'val', 'test'):
    data[_split]['data_root'] = {root!r}
data['test']['pipeline'][1]['img_scale'] = (64, 48)
data['val']['pipeline'][1]['img_scale'] = (64, 48)
'''


def test_tools_test_show_dir_paints_every_image(tmp_path):
    """``tools.test --show-dir`` on a narrow PSPNet under the VOC recipe's
    data (palette labels): one painted PNG an image, at the image's size,
    the prediction's colours blended over the image, and no JAX, OpenCV
    or pillow imported."""
    from segdistill_tpu_torch.recipes import recipe
    write_voc(tmp_path, np.random.RandomState(8))
    cfg = tmp_path / 'voc.py'
    recipe('pspnet_r50-d8_voc12aug').dump(str(cfg))
    with open(cfg, 'a') as f:
        f.write(NARROW_VOC.format(root=str(tmp_path / 'VOC2012')))
    show = tmp_path / 'painted'
    code = f'''
import sys
from segdistill_tpu_torch.tools import test
metrics = test.main([{str(cfg)!r}, '--eval', 'mIoU', '--device', 'cpu',
                     '--show-dir', {str(show)!r}])
assert set(metrics) >= {{'mIoU', 'mAcc', 'aAcc'}}, metrics
bad = [m for m in sys.modules if m.split('.')[0] in
       ('jax', 'flax', 'cv2', 'PIL', 'segdistill_tpu')]
assert not bad, bad
print('clean')
'''
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert 'clean' in res.stdout
    voc = tmp_path / 'VOC2012'
    names = (voc / 'ImageSets/Segmentation/val.txt').read_text().split()
    assert sorted(p.name for p in show.iterdir()) == \
        sorted(f'{n}.png' for n in names)
    for n in names:
        painted = P.imread(str(show / f'{n}.png'))
        img = P.imread(str(voc / 'JPEGImages' / f'{n}.jpg'))
        assert painted.shape == img.shape
        # half the image, half a palette colour: never more than ~half a
        # level plus the colour's half away from the image's half
        assert np.abs(painted.astype(int) - img // 2).max() <= 129
