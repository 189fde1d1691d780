"""The port's serving export (``segdistill_tpu_torch/tools/export.py``) on the
CPU: the three serving kernels as ``torch.library`` custom operators, a
narrow MiT-b0 + SegFormerHead (head embed 32, 4 classes) at 64x64 exported
with ``torch.export``, saved and loaded, and held to the JAX package's
``tools/export_stablehlo.export_model`` on the same weights.

Limits: the exported logits within 1e-5 of the largest |logit| of the JAX
export's (both fp32 on the CPU; the two frameworks sum in other orders);
labels equal wherever the JAX logits' top two differ by more than that.
The loaded program runs in a fresh process that imports ``torch`` and
``segdistill_tpu_torch.ops`` alone (which registers the operators).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.library import opcheck

from segdistill_tpu.models import build_segmentor as build_jax_segmentor
from segdistill_tpu_torch.convert import state_dict_from_jax
from segdistill_tpu_torch.models import build_segmentor
from segdistill_tpu_torch.ops import layer_norm, resize_sum, sra_attn
from segdistill_tpu_torch.tools.export import export_model

from torch_port_fixtures import narrow_segformer_cfg, random_jax_variables

ROOT = Path(__file__).resolve().parent.parent
HW = (64, 64)
LOGIT_TOL = 1e-5  # of the largest |logit|


def _image(seed):
    return np.random.RandomState(seed).randn(1, 3, *HW).astype(np.float32)


@pytest.fixture(scope='module')
def models():
    """(JAX model, its variables, the port model on those weights, and the
    same port model with ``fused_attention=True``)."""
    jax_model = build_jax_segmentor(narrow_segformer_cfg())
    variables = random_jax_variables(jax_model, seed=11)
    state = state_dict_from_jax(variables)
    ports = []
    for fused in (False, True):
        port = build_segmentor(narrow_segformer_cfg(fused))
        port.load_state_dict(state, strict=True)
        ports.append(port.eval())
    return jax_model, variables, ports[0], ports[1]


def _case(name):
    g = torch.Generator().manual_seed(0)
    if name == 'resize_sum':
        parts = [torch.randn(2, s, s, 8, generator=g) for s in (4, 8)]
        return resize_sum.RESIZE_SUM, (parts, 16, 12)
    if name == 'layer_norm':
        x = torch.randn(3, 5, 16, generator=g)
        return layer_norm.LAYER_NORM, (x, torch.randn(16, generator=g),
                                       torch.randn(16, generator=g), 1e-6)
    q = torch.randn(2, 2, 10, 8, generator=g)
    kv = torch.randn(2, 2, 5, 16, generator=g)[..., :8]  # strided views
    return sra_attn.SRA_ATTENTION, (q, kv, kv * 2, 0.3)


@pytest.mark.parametrize('name', ['resize_sum', 'layer_norm',
                                  'sra_attention'])
def test_opcheck(name):
    """Schema, fake implementation (shape, dtype and strides against the
    CPU implementation), autograd registration and tracing."""
    op, args = _case(name)
    result = opcheck(op, args)
    assert set(result.values()) == {'SUCCESS'}, result


def test_ops_dispatch_by_device():
    """The dispatcher takes the plain version on the CPU (nothing is
    launched) and the fake on the meta device."""
    op, (parts, h, w) = _case('resize_sum')
    np.testing.assert_array_equal(
        op(parts, h, w).numpy(),
        resize_sum.resize_sum_plain(parts, (h, w)).numpy())
    op, (q, k, v, scale) = _case('sra_attention')
    out = op(q, k, v, scale)
    assert out.stride() == (10 * 2 * 8, 8, 2 * 8, 1)
    torch.testing.assert_close(out, sra_attn.sra_attention_plain(q, k, v,
                                                                 scale))
    meta = op(q.to('meta'), k.to('meta'), v.to('meta'), scale)
    assert meta.device.type == 'meta' and meta.stride() == out.stride()
    assert resize_sum.KERNEL.launches == sra_attn.KERNEL.launches == 0


@pytest.mark.parametrize('fused', [False, True], ids=['plain', 'fused'])
def test_export_holds_the_ops_and_round_trips(models, fused, tmp_path):
    port = models[3 if fused else 2]
    program = export_model(port, (1, 3, *HW))
    code = program.graph_module.code
    assert code.count('torch.ops.segdistill.resize_sum') == 1
    # MiT-b0: 8 blocks x 2 norms, 4 stage norms, 6 spatial-reduction norms,
    # 4 patch-embedding norms
    assert code.count('torch.ops.segdistill.layer_norm') == 30
    assert code.count('torch.ops.segdistill.sra_attention') == (8 if fused
                                                                else 0)
    path = tmp_path / 'model.pt2'
    torch.export.save(program, path)
    loaded = torch.export.load(path).module()
    for seed in range(2):
        img = torch.from_numpy(_image(seed))
        with torch.no_grad():
            want = port.encode_decode(img).argmax(dim=1).to(torch.int32)
            got = loaded(img)
        assert got.dtype == torch.int32 and got.shape == (1, *HW)
        assert torch.equal(got, want)


def test_export_matches_jax_export(models, tmp_path):
    """The JAX tool's export of the same weights, serialised and read
    back, against the port's program saved and loaded."""
    sys.path.insert(0, str(ROOT / 'tools'))
    try:
        from export_stablehlo import export_model as jax_export_model
    finally:
        sys.path.remove(str(ROOT / 'tools'))
    from jax import export as jexport
    jax_model, variables, port, _ = models
    exp = jax_export_model(jax_model, variables, (1, *HW, 3), logits=True)
    back = jexport.deserialize(exp.serialize())
    img = _image(5)
    want = np.asarray(back.call(jnp.asarray(img.transpose(0, 2, 3, 1))))
    want = want.transpose(0, 3, 1, 2)
    for logits in (True, False):
        path = tmp_path / f'model_{logits}.pt2'
        torch.export.save(export_model(port, (1, 3, *HW), logits=logits),
                          path)
        with torch.no_grad():
            got = torch.export.load(path).module()(torch.from_numpy(img))
        if logits:
            err = np.abs(got.numpy() - want).max()
            assert err <= LOGIT_TOL * np.abs(want).max(), err
            continue
        top2 = np.sort(want, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > LOGIT_TOL * np.abs(want).max()
        assert clear.mean() > 0.99
        np.testing.assert_array_equal(got.numpy()[clear],
                                      want.argmax(axis=1)[clear])


LOADER = '''
import sys
import numpy as np
import torch
import segdistill_tpu_torch.ops
program = torch.export.load(sys.argv[1]).module()
img = torch.from_numpy(np.load(sys.argv[2]))
with torch.no_grad():
    np.save(sys.argv[3], program(img).numpy())
port = sorted(m for m in sys.modules if m.startswith('segdistill_tpu'))
assert all(m == 'segdistill_tpu_torch' or
           m.startswith('segdistill_tpu_torch.ops') for m in port), port
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax')]
assert not bad, bad
from segdistill_tpu_torch.tools import (benchmark, convert_checkpoint,  # noqa
    export, get_flops, image_demo, profile_train, publish_model)
bad = [m for m in sys.modules if m.split('.')[0] in
       ('jax', 'jaxlib', 'flax', 'segdistill_tpu')]
assert not bad, bad
print('clean')
'''


def test_program_loads_with_the_ops_alone(models, tmp_path):
    """A fresh process that imports torch and the port's ``ops`` package
    loads the saved program and gives the eager labels; importing the tool
    modules afterwards loads nothing of JAX or of the JAX package."""
    port = models[3]
    path = tmp_path / 'model.pt2'
    torch.export.save(export_model(port, (1, 3, *HW)), path)
    img = _image(9)
    np.save(tmp_path / 'img.npy', img)
    res = subprocess.run(
        [sys.executable, '-c', LOADER, str(path), str(tmp_path / 'img.npy'),
         str(tmp_path / 'out.npy')], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS='2'))
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.strip().endswith('clean')
    with torch.no_grad():
        want = port.encode_decode(torch.from_numpy(img)).argmax(dim=1)
    np.testing.assert_array_equal(np.load(tmp_path / 'out.npy'),
                                  want.numpy())
