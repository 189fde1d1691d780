"""Boundaries of the PyTorch port: it never imports JAX, Flax, OpenCV or
anything of the JAX package (reading a config included: the configs'
``segdistill_tpu.zoo`` import is served by the port's own copy), nor
pillow, and OpenCV only to decode or encode a format other than PNG and
``.npy`` (the data path on PNG files and the dataset converters need
neither); importing
its kernel modules needs no nvcc and builds nothing; the chip smoke script
refuses to run without a GPU or without the repository. The command-line
path has the same check in ``test_torch_port_cli.py``."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import torch_port_threads  # noqa: F401  (torch threads a test worker)

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / 'segdistill_tpu_torch'


def _run(code, env=None, cwd=ROOT, timeout=300):
    return subprocess.run([sys.executable, '-c', code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_serving_path_imports_no_jax():
    """Build the shipped B0 config and run one CPU forward, then check
    which frameworks were loaded."""
    res = _run('''
import sys
import torch
import segdistill_tpu_torch.apis as apis
from segdistill_tpu_torch.convert import state_dict_from_jax  # noqa
model = apis.init_segmentor(
    'configs/segformer/segformer_b0_512x512_ade_160k.py', device='cpu')
with torch.no_grad():
    out = model.encode_decode(torch.randn(1, 3, 64, 64))
assert out.shape == (1, 150, 64, 64), out.shape
bad = [m for m in sys.modules if m.split('.')[0] in
       ('jax', 'flax', 'cv2', 'segdistill_tpu')]
assert not bad, bad
print('clean')
''')
    assert res.returncode == 0, res.stderr
    assert 'clean' in res.stdout


def test_train_path_imports_no_jax():
    """Build the shipped CGD config (B0 student, B3 teacher) with its
    checkpoint paths cleared and take one train step on the CPU, then
    check which frameworks were loaded."""
    res = _run('''
import sys
import torch
from segdistill_tpu_torch.apis import init_segmentor_state, prepare_training
model = init_segmentor_state(
    'configs/exp_tab5/segformer_CGD.py', device='cpu',
    cfg_options={'model.t_pretrain': None, 'model.cfg_s.pretrained': None})
state, train_step = prepare_training(model)
log_vars = train_step(state, torch.randn(1, 3, 64, 64),
                      torch.randint(0, 150, (1, 64, 64)))
assert state.step == 1 and torch.isfinite(log_vars['loss']), log_vars
bad = [m for m in sys.modules if m.split('.')[0] in
       ('jax', 'flax', 'cv2', 'segdistill_tpu')]
assert not bad, bad
print('clean')
''')
    assert res.returncode == 0, res.stderr
    assert 'clean' in res.stdout


def test_pd_train_path_imports_no_jax():
    """Build the shipped PD config (B0 student, B3 teacher) with its
    checkpoint paths cleared and the student's SRA attention through the
    differentiable kernel path, take one train step on the CPU, then check
    which frameworks were loaded."""
    res = _run('''
import sys
import torch
from segdistill_tpu_torch.apis import init_segmentor_state, prepare_training
model = init_segmentor_state(
    'configs/exp_tab5/segformer_PD.py', device='cpu',
    cfg_options={'model.t_pretrain': None, 'model.cfg_s.pretrained': None,
                 'model.cfg_s.backbone.fused_attention': 'train'})
state, train_step = prepare_training(model)
log_vars = train_step(state, torch.randn(1, 3, 64, 64),
                      torch.randint(0, 150, (1, 64, 64)))
key = 'loss_decode_head.linear_pred<->decode_head.linear_pred_other'
assert state.step == 1 and torch.isfinite(log_vars[key]), log_vars
bad = [m for m in sys.modules if m.split('.')[0] in
       ('jax', 'flax', 'cv2', 'segdistill_tpu')]
assert not bad, bad
print('clean')
''')
    assert res.returncode == 0, res.stderr
    assert 'clean' in res.stdout


# an import of jax, flax or the JAX package: its name followed by a dot,
# whitespace or the end of the line (so not segdistill_tpu_torch)
FOREIGN_IMPORT = re.compile(
    r'^\s*(import|from)\s+(jax|flax|segdistill_tpu)(\.|\s|$)', re.M)


def test_no_jax_import_in_sources():
    """No module of the port, and not the smoke script, imports jax, flax
    or anything of the JAX package."""
    sources = list(PACKAGE.rglob('*.py')) + [ROOT / 'chip_smoke.py']
    offenders = [str(p.relative_to(ROOT)) for p in sources
                 if FOREIGN_IMPORT.search(p.read_text())]
    assert not offenders
    for line in ('import segdistill_tpu', 'from segdistill_tpu import x',
                 'from segdistill_tpu.config import Config',
                 '    import segdistill_tpu.registry as r', 'import jax',
                 'from flax import linen'):
        assert FOREIGN_IMPORT.search(line), line
    for line in ('import segdistill_tpu_torch',
                 'from segdistill_tpu_torch.config import Config',
                 '# from segdistill_tpu.zoo import x', 'import jaxtyping'):
        assert not FOREIGN_IMPORT.search(line), line


PIL_IMPORT = re.compile(r'^\s*(import|from)\s+PIL(\.|\s|$)', re.M)
CV2_IMPORT = re.compile(r'^\s*(import|from)\s+cv2(\.|\s|$)', re.M)


def test_no_pil_import_and_cv2_only_for_other_formats():
    """No module of the port, no converter and not the smoke script imports
    pillow; OpenCV is imported only inside ``utils/image.py``'s file
    functions, for formats other than PNG and ``.npy``."""
    sources = list(PACKAGE.rglob('*.py')) + [ROOT / 'chip_smoke.py']
    assert not [p for p in sources if PIL_IMPORT.search(p.read_text())]
    with_cv2 = [str(p.relative_to(ROOT)) for p in sources
                if CV2_IMPORT.search(p.read_text())]
    assert with_cv2 == ['segdistill_tpu_torch/utils/image.py']
    text = (PACKAGE / 'utils' / 'image.py').read_text()
    assert not re.search(r'^(import|from)\s+cv2', text, re.M)


def test_png_data_path_and_converters_import_no_cv2(tmp_path):
    """On PNG files alone: the VOC-aug converter (SBD ``.mat`` -> PNG),
    the other converters' modules, the VOC12-aug recipe's training pipeline
    (palette and gray label maps, PhotoMetricDistortion, the new
    transforms), the Pascal Context, COCO-Stuff and Mapillary datasets, the
    Cityscapes writer and result painting run without JAX, OpenCV, pillow
    or the JAX package loaded."""
    res = _run(f'''
import sys
from pathlib import Path
import numpy as np
from scipy.io import savemat
from segdistill_tpu_torch.datasets import build_dataset
from segdistill_tpu_torch.datasets.pipelines import Compose
from segdistill_tpu_torch.recipes import recipe
from segdistill_tpu_torch.tools.convert_datasets import (  # noqa: F401
    cityscapes, coco_stuff10k, medical, pascal_context, voc_aug)
from segdistill_tpu_torch.utils import image as imutil
root = Path({str(tmp_path)!r})
voc = root / 'VOCdevkit' / 'VOC2012'
sets = voc / 'ImageSets' / 'Segmentation'
for d in (voc / 'JPEGImages', voc / 'SegmentationClass', sets,
          root / 'sbd' / 'dataset' / 'cls'):
    d.mkdir(parents=True)
rng = np.random.RandomState(0)
names = [f'n{{i}}' for i in range(4)]
palette = rng.randint(0, 256, (21, 3))
for n in names:
    imutil.imwrite(rng.randint(0, 256, (40, 56, 3)).astype(np.uint8),
                   str(voc / 'JPEGImages' / f'{{n}}.jpg.png'))
    (voc / 'JPEGImages' / f'{{n}}.jpg.png').rename(
        voc / 'JPEGImages' / f'{{n}}.jpg')
    idx = rng.randint(0, 21, (40, 56)).astype(np.uint8)
    imutil.imwrite(idx, str(voc / 'SegmentationClass' / f'{{n}}.png'),
                   palette=palette)
    savemat(str(root / 'sbd' / 'dataset' / 'cls' / f'{{n}}.mat'),
            {{'GTcls': {{'Segmentation': idx}}}})
(sets / 'train.txt').write_text('n0\\nn1\\n')
(sets / 'val.txt').write_text('n2\\n')
(root / 'sbd' / 'dataset' / 'train.txt').write_text('n3\\n')
voc_aug.main([str(root / 'VOCdevkit'), str(root / 'sbd')])
cfg = recipe('pspnet_r50-d8_voc12aug')
train = dict(cfg.data['train'], data_root=str(voc))
train['pipeline'] = [dict(t, crop_size=(32, 32)) if t['type'] in
                     ('RandomCrop', 'Pad') and 'crop_size' in t else t
                     for t in train['pipeline']]
data = build_dataset(train)
assert len(data) == 2 + 3, len(data)
for i in range(len(data)):
    sample = data.__getitem__(i, np.random.RandomState(i))
    assert sample['img'].shape[-1] == 3
pipe = Compose([dict(type='CLAHE'), dict(type='RandomRotate', prob=1.0,
                                         degree=20),
                dict(type='SegRescale', scale_factor=0.5)])
out = pipe(dict(img=rng.randint(0, 256, (40, 56, 3)).astype(np.uint8),
                gt_semantic_seg=idx, seg_fields=['gt_semantic_seg']))
from segdistill_tpu_torch.datasets import (CityscapesDataset,  # noqa: F401
    CocoStuffDataset, MapillaryDataset, PascalContextDataset)
from segdistill_tpu_torch.models.segmentors.base import BaseSegmentor
assert out['gt_semantic_seg'].shape == (20, 28)
painted = BaseSegmentor().show_result(out['img'],
                                      np.zeros(out['img'].shape[:2], int))
imutil.imwrite(painted, str(root / 'painted.png'))
assert imutil.imread(str(root / 'painted.png')).shape == painted.shape
bad = [m for m in sys.modules if m.split('.')[0] in
       ('jax', 'flax', 'cv2', 'PIL', 'segdistill_tpu')]
assert not bad, bad
print('clean')
''')
    assert res.returncode == 0, res.stderr
    assert 'clean' in res.stdout


def test_kernel_modules_import_without_nvcc(tmp_path):
    """With no CUDA toolkit in sight, the kernel modules import, nothing
    is built, and asking for a kernel says why it cannot be built."""
    env = dict(os.environ, CUDA_HOME=str(tmp_path / 'no-cuda'),
               PATH=str(tmp_path))
    res = _run('''
from segdistill_tpu_torch.ops import (cuda_kernel, group_kl, layer_norm,
                                      pixel_kl, resize_sum, seg_ce, sra_attn)
existed = cuda_kernel.BUILD_DIR.exists()
for k in (resize_sum.KERNEL, sra_attn.KERNEL, group_kl.FWD_KERNEL,
          group_kl.BWD_KERNEL, seg_ce.FWD_KERNEL, seg_ce.BWD_KERNEL,
          pixel_kl.FWD_KERNEL, pixel_kl.BWD_KERNEL, sra_attn.BWD_KERNEL,
          layer_norm.FWD_KERNEL, layer_norm.BWD_KERNEL):
    assert not k.loaded and k.launches == 0
    try:
        k.function()
    except (RuntimeError, FileNotFoundError) as e:
        print('refused:', e)
    else:
        raise AssertionError('built without nvcc')
assert cuda_kernel.BUILD_DIR.exists() == existed
''', env=env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.count('refused:') == 11


@pytest.mark.parametrize('alone', [False, True], ids=['repo', 'alone'])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """No CUDA device here: the script exits non-zero and prints no
    result, in the repository and in a directory holding only itself."""
    script = ROOT / 'chip_smoke.py'
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / 'chip_smoke.py')
        script, cwd = tmp_path / 'chip_smoke.py', tmp_path
    res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout


def test_package_calls_no_library_attention():
    """The SRA attention kernels are the port's own: PyTorch's fused
    attention is a yardstick that only the chip smoke script times, and no
    module of the package names it."""
    named = [str(p.relative_to(ROOT)) for p in PACKAGE.rglob('*.py')
             if 'scaled_dot_product' in p.read_text()]
    assert not named, named
    assert 'scaled_dot_product_attention' in (ROOT /
                                              'chip_smoke.py').read_text()


def test_sra_sources_use_the_tensor_cores():
    """K2 and K9 feed bf16 operands to the matrix unit with fp32 sums, and
    share their pieces through one header that the build hash covers."""
    csrc = PACKAGE / 'csrc'
    header = (csrc / 'sra_common.cuh').read_text()
    assert 'mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32' in header
    for name in ('sra_attn.cu', 'sra_attn_bwd.cu'):
        text = (csrc / name).read_text()
        assert '#include "sra_common.cuh"' in text and 'mma_bf16(' in text
        assert 'atomicAdd' not in text  # fixed-order sums only
