"""The port's miniature convergence run (``docs/convergence.md``, the
counterpart of ``tests/test_convergence.py``): ``python -m
segdistill_tpu_torch.tools.convergence --device cpu`` trains the baseline
MiT-b0 + SegFormerHead for 240 iterations on ``tests/data/convergence/``
through ``tools.train``, then the +CGD student against the trained
baseline loaded through ``t_pretrain``, then evaluates it with
``tools.test``; held here to the doc's criteria on the run's JSON summary:
(a) ``decode.loss_seg`` falls more than 2x in each run, (b) each run's final
val mIoU is above 0.40 (4-class chance 0.25) and above its first
evaluation's, (c) the CGD distillation loss decreases. About a minute on 4
CPU threads; slow tier, as the JAX package's run.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import torch_port_threads  # noqa: F401  (torch threads a test worker)

pytestmark = pytest.mark.slow

ROOT = Path(__file__).resolve().parent.parent


def _ordered(series):
    return [series[k] for k in sorted(series, key=int)]


def test_baseline_converges_then_cgd_aligns(tmp_path):
    res = subprocess.run(
        [sys.executable, '-m', 'segdistill_tpu_torch.tools.convergence',
         '--device', 'cpu', '--work-dir', str(tmp_path)], cwd=ROOT,
        capture_output=True, text=True, timeout=2400,
        env=dict(os.environ, OMP_NUM_THREADS='4'))
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    for name in ('baseline', 'cgd'):
        seg = _ordered(out[name]['seg'])
        miou = _ordered(out[name]['miou'])
        assert len(seg) == 12 and len(miou) == 2, out[name]
        assert min(seg[-3:]) < 0.5 * seg[0], (name, seg)
        assert miou[-1] > 0.40 and miou[-1] > miou[0], (name, miou)
    dist = _ordered(out['cgd']['distill'])
    assert sum(dist[-3:]) / 3 < sum(dist[:3]) / 3, dist
    assert out['test_miou'] == pytest.approx(
        _ordered(out['cgd']['miou'])[-1], abs=1e-6)
