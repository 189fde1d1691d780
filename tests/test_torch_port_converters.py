"""The port's dataset converters (``segdistill_tpu_torch/tools/
convert_datasets/``) against the JAX package's (``tools/convert_datasets/``)
on the same seeded inputs, on the CPU: every file each writes, decoded,
must equal the other's (the port writes PNG with its own encoder, the JAX
package with OpenCV or pillow). ``pascal_context`` runs on a fake
``detail`` module put into ``sys.modules`` for both; ``coco_stuff10k``
with its 10000-image count patched to the fake set's size. The one
intended difference: ``voc_aug`` names its split ``aug.txt`` (the file the
config reads), the JAX package ``trainaug.txt``; their lines are equal.
"""

import importlib.util
import shutil
import subprocess
import sys
import types
from pathlib import Path

import cv2
import numpy as np
import pytest
from scipy.io import loadmat, savemat

from segdistill_tpu_torch.tools.convert_datasets import (cityscapes,
                                                         coco_stuff10k,
                                                         medical,
                                                         pascal_context,
                                                         voc_aug)
from segdistill_tpu_torch.utils import image as P

import torch_port_threads  # noqa: F401  (torch threads a test worker)

ROOT = Path(__file__).resolve().parent.parent


def _jax_converter(name):
    """The JAX package's converter script, loaded as a module."""
    path = ROOT / 'tools' / 'convert_datasets' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(f'_jax_convert_{name}',
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_jax(monkeypatch, name, argv, **patch):
    module = _jax_converter(name)
    for key, value in patch.items():
        monkeypatch.setattr(module, key, value)
    monkeypatch.setattr(sys, 'argv', [name] + [str(a) for a in argv])
    module.main()


def _files(root):
    return sorted(p.relative_to(root) for p in Path(root).rglob('*')
                  if p.is_file() and not p.is_symlink())


def _same_png(a, b):
    got = cv2.imread(str(a), cv2.IMREAD_UNCHANGED)
    want = cv2.imread(str(b), cv2.IMREAD_UNCHANGED)
    assert got is not None and want is not None, (a, b)
    assert got.dtype == want.dtype and np.array_equal(got, want), (a, b)
    assert np.array_equal(P.imread(str(a), 'unchanged'), want), a


def _same_tree(port_root, jax_root, rename=None):
    """Every file under both roots (``rename``: port name -> JAX name):
    PNGs equal decoded, other files equal bytewise."""
    rename = rename or {}
    mapped = {Path(rename.get(str(p), str(p))): p for p in _files(port_root)}
    assert sorted(mapped) == _files(jax_root)
    for want, got in mapped.items():
        a, b = Path(port_root) / got, Path(jax_root) / want
        if got.suffix == '.png':
            _same_png(a, b)
        else:
            assert a.read_bytes() == b.read_bytes(), got


def test_cityscapes_converter(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    src = tmp_path / 'src'
    for city in ('aachen', 'bonn'):
        (src / 'gtFine' / 'train' / city).mkdir(parents=True)
        for i in range(2):
            cv2.imwrite(str(src / 'gtFine' / 'train' / city /
                            f'{city}_{i:06d}_000019_gtFine_labelIds.png'),
                        rng.randint(0, 34, (24, 48)).astype(np.uint8))
    port, jax_root = tmp_path / 'port', tmp_path / 'jax'
    shutil.copytree(src, port)
    shutil.copytree(src, jax_root)
    assert cityscapes.main([str(port)]) == 4
    _run_jax(monkeypatch, 'cityscapes', [jax_root])
    _same_tree(port, jax_root)
    out = P.imread(str(next(port.rglob('*_labelTrainIds.png'))), 'unchanged')
    assert set(np.unique(out)) <= set(range(19)) | {255}


def test_medical_converter(tmp_path, monkeypatch):
    rng = np.random.RandomState(1)
    imgs, anns = tmp_path / 'imgs', tmp_path / 'anns'
    imgs.mkdir()
    anns.mkdir()
    for i in range(10):
        cv2.imwrite(str(imgs / f'Image_{i:02d}L.png'),
                    rng.randint(0, 256, (20, 26, 3)).astype(np.uint8))
        cv2.imwrite(str(anns / f'Image_{i:02d}L_1stHO.png'),
                    (rng.rand(20, 26) < 0.3).astype(np.uint8) * 255)
    port, jax_root = tmp_path / 'port', tmp_path / 'jax'
    assert medical.main(['chase_db1', str(imgs), str(anns), '-o',
                         str(port)]) == 10
    _run_jax(monkeypatch, 'medical',
             ['chase_db1', imgs, anns, '-o', jax_root])
    _same_tree(port, jax_root)
    assert len(list((port / 'images' / 'training').iterdir())) == 8
    ann = P.imread(str(port / 'annotations' / 'validation' /
                       'Image_09L.png'), 'unchanged')
    assert set(np.unique(ann)) <= {0, 1}


def _write_sbd(root, rng, names):
    cls = root / 'dataset' / 'cls'
    cls.mkdir(parents=True)
    for name in names:
        seg = rng.randint(0, 21, (18, 22)).astype(np.uint8)
        savemat(str(cls / f'{name}.mat'),
                {'GTcls': {'Segmentation': seg,
                           'CategoriesPresent': np.unique(seg)}})
    (root / 'dataset' / 'train.txt').write_text(
        '\n'.join(names[:4]) + '\n')


def test_voc_aug_converter(tmp_path, monkeypatch):
    rng = np.random.RandomState(2)
    names = [f'2008_{i:06d}' for i in range(6)]
    for side in ('port', 'jax'):
        sets = tmp_path / side / 'VOCdevkit' / 'VOC2012' / 'ImageSets' / \
            'Segmentation'
        sets.mkdir(parents=True)
        (sets / 'train.txt').write_text('2007_000001\n2008_000005\n')
        (sets / 'val.txt').write_text('2008_000003\n')
    _write_sbd(tmp_path / 'sbd', rng, names)
    port = tmp_path / 'port' / 'VOCdevkit'
    jax_root = tmp_path / 'jax' / 'VOCdevkit'
    aug = voc_aug.main([str(port), str(tmp_path / 'sbd')])
    _run_jax(monkeypatch, 'voc_aug', [jax_root, tmp_path / 'sbd'])
    split = 'VOC2012/ImageSets/Segmentation'
    _same_tree(port, jax_root,
               rename={f'{split}/aug.txt': f'{split}/trainaug.txt'})
    assert aug == ['2007_000001', '2008_000000', '2008_000001',
                   '2008_000002', '2008_000005']
    seg = P.imread(str(port / 'VOC2012' / 'SegmentationClassAug' /
                       '2008_000004.png'), 'unchanged')
    assert seg.shape == (18, 22) and seg.max() <= 20


class _Detail:
    """The Detail API's surface the converters call, on seeded masks."""

    def __init__(self, json_path, img_dir, split):
        rng = np.random.RandomState(0 if split == 'train' else 1)
        self.masks = {f'2010_{split}_{i}.jpg': rng.choice(
            pascal_context._MAPPING, (14, 17)) for i in range(3)}

    def getImgs(self):
        return [{'file_name': name} for name in self.masks]

    def getMask(self, img_id):
        return self.masks[img_id['file_name']]


def test_pascal_context_converter(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'detail',
                        types.SimpleNamespace(Detail=_Detail))
    for side in ('port', 'jax'):
        (tmp_path / side / 'VOC2010' / 'JPEGImages').mkdir(parents=True)
    json_path = tmp_path / 'trainval_merged.json'
    json_path.write_text('{}')
    splits = pascal_context.main([str(tmp_path / 'port'), str(json_path)])
    _run_jax(monkeypatch, 'pascal_context', [tmp_path / 'jax', json_path])
    _same_tree(tmp_path / 'port', tmp_path / 'jax')
    assert [len(v) for v in splits.values()] == [3, 3]
    out = P.imread(str(tmp_path / 'port' / 'VOC2010' /
                       'SegmentationClassContext' / '2010_val_2.png'),
                   'unchanged')
    assert out.max() <= 59


def test_coco_stuff10k_converter(tmp_path, monkeypatch):
    rng = np.random.RandomState(3)
    src = tmp_path / 'coco'
    for d in ('images', 'annotations', 'imageLists'):
        (src / d).mkdir(parents=True)
    names = [f'COCO_train2014_{i:012d}' for i in range(5)]
    for name in names:
        cv2.imwrite(str(src / 'images' / f'{name}.jpg'),
                    rng.randint(0, 256, (16, 20, 3)).astype(np.uint8))
        savemat(str(src / 'annotations' / f'{name}.mat'),
                {'S': rng.randint(0, 183, (16, 20)).astype(np.uint16)})
    (src / 'imageLists' / 'train.txt').write_text('\n'.join(names[:3]))
    (src / 'imageLists' / 'test.txt').write_text('\n'.join(names[3:]))
    monkeypatch.setattr(coco_stuff10k, 'COCO_LEN', len(names))
    train, test = coco_stuff10k.main([str(src), '-o', str(tmp_path / 'port')])
    _run_jax(monkeypatch, 'coco_stuff10k', [src, '-o', tmp_path / 'jax'],
             COCO_LEN=len(names))
    _same_tree(tmp_path / 'port', tmp_path / 'jax')
    assert (len(train), len(test)) == (3, 2)
    out = P.imread(str(tmp_path / 'port' / 'annotations' / 'test2014' /
                       f'{names[4]}_labelTrainIds.png'), 'unchanged')
    raw = loadmat(str(src / 'annotations' / f'{names[4]}.mat'))['S']
    assert np.array_equal(out[raw == 182], np.full((raw == 182).sum(), 171))


@pytest.mark.parametrize('module', ['cityscapes', 'medical', 'voc_aug',
                                    'pascal_context', 'coco_stuff10k'])
def test_converter_commands_have_help(module):
    """Each converter is a command: ``--help`` exits 0 and names its
    arguments."""
    res = subprocess.run(
        [sys.executable, '-m',
         f'segdistill_tpu_torch.tools.convert_datasets.{module}', '--help'],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert 'usage' in res.stdout
