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

import torch_port_threads  # noqa: F401  (torch threads a test worker)

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


# bf16 inputs: both sides compute the scores and the softmax in fp32 from the
# same bf16 values, round the normalised probabilities to bf16 and sum the
# product with v in fp32; what is left is the order of the fp32 sums, which
# can move a probability or the result across one bf16 rounding boundary:
# one bf16 step of the result, 2^-7 of its magnitude, plus a probability's
# step (2^-8 of it) times |v|, summed over the keys as noise: 2^-9 of the
# output's rms, generously.
BF16_TOL_REL = 2.0 ** -7
BF16_TOL_RMS = 2.0 ** -9


def _bf16_pair(a):
    """A float32 numpy array rounded to bfloat16, for torch and for JAX."""
    t = torch.from_numpy(a).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize('heads,n,m,d', [(1, 256, 128, 32),
                                         (2, 256, 64, 64)])
def test_sra_attention_bf16_matches_jax_kernel(heads, n, m, d):
    """The plain version on bf16 inputs rounds the normalised P to bf16
    before the product with v, as the JAX kernel does (interpret mode, bf16
    operands, fp32 sums)."""
    q, k, v = _arrays([(2, heads, n, d), (2, heads, m, d),
                       (2, heads, m, d)], seed=5)
    (qt, qj), (kt, kj), (vt, vj) = map(_bf16_pair, (q / 2, k / 2, v / 2))
    scale = d ** -0.5
    want = jax_fused_sra_attention(qj, kj, vj, scale, interpret=True,
                                   qtile=128)
    assert want.dtype == jnp.bfloat16
    got = fused_sra_attention(qt, kt, vt, scale)
    assert got.dtype == torch.bfloat16 and got.shape == (2, heads, n, d)
    want = np.asarray(want.astype(jnp.float32))
    diff = np.abs(got.float().numpy() - want)
    tol = BF16_TOL_REL * np.abs(want) + BF16_TOL_RMS * np.sqrt(
        np.mean(want ** 2))
    assert (diff <= tol).all(), (diff / tol).max()
    # and the rounding is there: the fp32-probability product differs
    exact = torch.matmul(
        (torch.matmul(qt.float(), kt.float().transpose(-1, -2)) * scale)
        .softmax(-1), vt.float()).bfloat16()
    assert not torch.equal(exact, got)


_MIT_HEADS = (1, 2, 5, 8)
_MIT_HEAD_DIMS = {'b0': 32, 'b1': 64, 'b2': 64, 'b3': 64, 'b4': 64, 'b5': 64}
_PLAN_CASES = [(name, b * h, (128 // 2 ** s) ** 2, 256, d)
               for name, d in _MIT_HEAD_DIMS.items() for b in (1, 8)
               for s, h in enumerate(_MIT_HEADS)]
_PLAN_CASES += [('M 300 (640x480)', 1, 19200, 300, 32),
                ('M 2048 (2048x1024)', 1, 131072, 2048, 32),
                ('M 2048 d64', 8, 131072, 2048, 64),
                ('d128', 2, 300, 70, 128), ('d128 long', 8, 16384, 256, 128),
                ('one row', 1, 1, 1, 8), ('d24', 3, 1000, 100, 24)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', _PLAN_CASES,
                         ids=lambda c: f'{c[0]}-{c[1]}x{c[2]}'.replace(' ', '_'))
def test_sra_launch_plans(case, dtype):
    """The launch planning of K2 and K9, pure Python: every MiT b0-b5 stage
    at 512^2 (batch 1 and 8), M = 300, M = 2048 and d = 128 get an
    instantiated kernel variant, shared memory that an SM can give, splits
    that cover every query row in whole tiles, and key chunks that cover
    every key."""
    _, heads, n, m, d = case
    fwd = sra_attn_mod.forward_plan(dtype, heads, n, m, d)
    bwd = sra_attn_mod.backward_plan(dtype, heads, n, m, d)
    family = {torch.float32: 'f32', torch.bfloat16: 'mma'}[dtype]
    dp = 32 if d <= 32 else (64 if d <= 64 else 128)
    assert fwd['variant'] == (f'fwd_{family}', dp)
    assert bwd['variant'] == (f'bwd_{family}', dp)
    for plan in (fwd, bwd):
        assert plan['variant'] in sra_attn_mod.VARIANTS
        assert 0 < plan['shared_bytes'] <= sra_attn_mod.MAX_SHARED_BYTES
        assert plan['keys'] >= 16
    assert fwd['blocks'] * fwd['rows'] >= n > (fwd['blocks'] - 1) * fwd['rows']
    # 128-row blocks only for bf16 at d = 64 where they fill the card
    assert fwd['rows'] == 64 or (
        fwd['rows'] == 128 and dtype == torch.bfloat16 and dp == 64
        and fwd['blocks'] * heads >= 132)
    assert bwd['rows'] % bwd['tile'] == 0 and bwd['rows'] >= bwd['tile']
    assert bwd['splits'] * bwd['rows'] >= n > (bwd['splits'] - 1) * bwd['rows']
    assert bwd['key_chunks'] * bwd['keys'] >= m \
        > (bwd['key_chunks'] - 1) * bwd['keys']
    # where the tiles could fill the card's 132 SMs, the blocks fill at
    # least half of them
    blocks = bwd['splits'] * bwd['key_chunks'] * heads
    if -(-n // bwd['tile']) * bwd['key_chunks'] * heads >= 132:
        assert blocks >= 66


def test_sra_launch_plan_refuses_head_dims():
    for d in (4, 12, 136, 256):
        with pytest.raises(ValueError, match='multiple of 8'):
            sra_attn_mod.backward_plan(torch.bfloat16, 1, 64, 64, d)
        with pytest.raises(ValueError, match='multiple of 8'):
            sra_attn_mod.forward_plan(torch.float32, 1, 64, 64, d)


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
