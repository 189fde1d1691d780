"""Boundaries of the PyTorch port: it never imports JAX, Flax or OpenCV;
importing its kernel modules needs no nvcc and builds nothing; the chip
smoke script refuses to run without a GPU or without the repository."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

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
bad = [m for m in ('jax', 'flax', 'cv2') if m in sys.modules]
assert not bad, bad
print('clean')
''')
    assert res.returncode == 0, res.stderr
    assert 'clean' in res.stdout


def test_no_jax_import_in_sources():
    pattern = re.compile(r'^\s*(import|from)\s+(jax|flax)\b', re.M)
    offenders = [str(p.relative_to(ROOT)) for p in PACKAGE.rglob('*.py')
                 if pattern.search(p.read_text())]
    # the smoke script depends on the port alone, not on the JAX package
    smoke = re.compile(r'^\s*(import|from)\s+(jax|flax|segdistill_tpu)\b',
                       re.M)
    offenders += ['chip_smoke.py'] * bool(
        smoke.search((ROOT / 'chip_smoke.py').read_text()))
    assert not offenders


def test_kernel_modules_import_without_nvcc(tmp_path):
    """With no CUDA toolkit in sight, the kernel modules import, nothing
    is built, and asking for a kernel says why it cannot be built."""
    env = dict(os.environ, CUDA_HOME=str(tmp_path / 'no-cuda'),
               PATH=str(tmp_path))
    res = _run('''
from segdistill_tpu_torch.ops import cuda_kernel, resize_sum, sra_attn
existed = cuda_kernel.BUILD_DIR.exists()
for k in (resize_sum.KERNEL, sra_attn.KERNEL):
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
    assert res.stdout.count('refused:') == 2


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
