"""The port's ops against the JAX package's, fp32 on the CPU: ``resize``,
``fused_resize_sum`` (K1) and ``fused_sra_attention`` (K2).

On the CPU the port's kernel wrappers run their plain PyTorch versions;
the JAX kernels run in Pallas interpret mode, as the JAX package's own
tests run them. Inputs are seeded numpy arrays given to both sides.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from segdistill_tpu.ops import resize as jax_resize
from segdistill_tpu.ops.pallas.resize_sum import (
    _resize_sum_ref, fused_resize_sum as jax_fused_resize_sum)
from segdistill_tpu.ops.pallas.sra_attn import (
    fused_sra_attention as jax_fused_sra_attention)
from segdistill_tpu_torch.ops import (fused_resize_sum, fused_sra_attention,
                                      resize)
from segdistill_tpu_torch.ops import resize_sum as resize_sum_mod
from segdistill_tpu_torch.ops import sra_attn as sra_attn_mod

TOL = 1e-5


def _arrays(shapes, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * 2).astype(np.float32) for s in shapes]


@pytest.mark.parametrize('shapes,out_hw', [
    # the SegFormer head's pyramid below a stride-4 base
    ([(2, 8, 8, 64), (2, 4, 4, 64), (2, 2, 2, 64)], (16, 16)),
    ([(1, 2, 2, 128)], (16, 16)),                    # single 8x part
    ([(1, 4, 8, 128)], (16, 16)),                    # anisotropic (4x, 2x)
    ([(2, 16, 16, 32), (2, 4, 4, 32)], (32, 32)),    # mixed base grid
])
def test_resize_sum_matches_jax_kernel(shapes, out_hw):
    parts = _arrays(shapes, seed=0)
    want = jax_fused_resize_sum(tuple(jnp.asarray(p) for p in parts),
                                out_hw, True)
    got = fused_resize_sum([torch.from_numpy(p) for p in parts], out_hw)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL


@pytest.mark.parametrize('shapes,out_hw', [
    ([(2, 5, 7, 24), (2, 9, 13, 24)], (23, 31)),     # non-integer ratios
    ([(1, 6, 6, 16)], (4, 5)),                        # a downsample
])
def test_resize_sum_non_integer_ratio(shapes, out_hw):
    """The JAX kernel takes integer ratios only; its unfused reference
    (identical math) takes any."""
    parts = _arrays(shapes, seed=1)
    want = _resize_sum_ref(tuple(jnp.asarray(p) for p in parts), out_hw)
    got = fused_resize_sum([torch.from_numpy(p) for p in parts], out_hw)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL


def test_resize_sum_keeps_dtype():
    parts = [torch.randn(1, 4, 4, 8, dtype=torch.bfloat16)]
    assert fused_resize_sum(parts, (8, 8)).dtype == torch.bfloat16


@pytest.mark.parametrize('parts,match', [
    ([torch.zeros(2, 4, 4)], '4D'),
    ([torch.zeros(2, 4, 4, 8), torch.zeros(1, 2, 2, 8)], 'share'),
    ([torch.zeros(2, 4, 4, 8), torch.zeros(2, 2, 2, 4)], 'share'),
    ([torch.zeros(2, 8, 4, 4).permute(0, 2, 3, 1)], 'contiguous'),
    ([], 'at least one'),
])
def test_resize_sum_rejects(parts, match):
    with pytest.raises(ValueError, match=match):
        fused_resize_sum(parts, (8, 8))


@pytest.mark.parametrize('heads,n,m,d', [
    (1, 256, 128, 32),
    (2, 256, 64, 64),
    (2, 200, 50, 32),      # ragged N (not a multiple of 128) and M
])
def test_sra_attention_matches_jax_kernel(heads, n, m, d):
    q, k, v = _arrays([(2, heads, n, d), (2, heads, m, d),
                       (2, heads, m, d)], seed=2)
    scale = d ** -0.5
    qtile = 128 if n % 128 == 0 else n
    want = jax_fused_sra_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), scale, interpret=True,
                                   qtile=qtile)
    got = fused_sra_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), scale)
    assert got.shape == (2, heads, n, d)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL


def test_sra_attention_takes_strided_views():
    """The model hands in head-split views of the q and kv projections."""
    B, N, M, h, d = 2, 40, 10, 2, 16
    q_lin = torch.randn(B, N, h * d)
    kv_lin = torch.randn(B, M, 2 * h * d)
    q = q_lin.reshape(B, N, h, d).permute(0, 2, 1, 3)
    kv = kv_lin.reshape(B, M, 2, h, d).permute(2, 0, 3, 1, 4)
    got = fused_sra_attention(q, kv[0], kv[1], 0.25)
    want = fused_sra_attention(q.contiguous(), kv[0].contiguous(),
                               kv[1].contiguous(), 0.25)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_sra_attention_rejects_mismatch():
    with pytest.raises(ValueError, match='mismatch'):
        fused_sra_attention(torch.zeros(1, 2, 8, 16), torch.zeros(1, 2, 4, 8),
                            torch.zeros(1, 2, 4, 8), 1.0)


def test_cpu_tensors_never_launch():
    """A CPU tensor takes the plain version: no build, no launch."""
    fused_resize_sum([torch.zeros(1, 2, 2, 8)], (4, 4))
    fused_sra_attention(*(torch.zeros(1, 1, 4, 8),) * 3, 1.0)
    for kernel in (resize_sum_mod.KERNEL, sra_attn_mod.KERNEL):
        assert kernel.launches == 0
        assert not kernel.loaded


@pytest.mark.parametrize('mode,align_corners', [
    ('bilinear', False), ('bilinear', True), ('nearest', False)])
@pytest.mark.parametrize('size', [(32, 48), (7, 5), (13, 29)])
def test_resize_matches_jax(mode, align_corners, size):
    x = _arrays([(2, 11, 17, 3)], seed=3)[0]
    want = jax_resize(jnp.asarray(x), size=size, mode=mode,
                      align_corners=align_corners)
    got = resize(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                 size=size, mode=mode, align_corners=align_corners)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=TOL, atol=TOL)


def test_resize_scale_factor_and_3d():
    x = _arrays([(2, 10, 6)], seed=4)[0]
    want = jax_resize(jnp.asarray(x), scale_factor=1.5, mode='nearest')
    got = resize(torch.from_numpy(x), scale_factor=1.5, mode='nearest')
    assert got.shape == (2, 15, 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match='align_corners'):
        resize(torch.from_numpy(x), size=4, mode='nearest',
               align_corners=True)
