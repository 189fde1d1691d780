"""Boundaries of the PyTorch port: it never imports JAX, Flax, OpenCV or
anything of the JAX package (reading a config included: the configs'
``segdistill_tpu.zoo`` import is served by the port's own copy); importing
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
