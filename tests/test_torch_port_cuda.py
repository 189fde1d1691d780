"""The hand-written kernels on the card against their plain versions, and
the port's CUDA forward against its CPU forward.

Marked ``cuda``: they skip without a CUDA device. On the card (which has
no JAX, so the repository's conftest is not loaded):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Each kernel is held against its plain version in fp32 on the same inputs.
fp32: the same formula with sums in other orders, max abs error <= 2e-5.
bf16, per element: the kernel rounds its fp32 result once, at most half a
bf16 step (2^-8 of the magnitude) away, plus 2^-12 of the output's rms for
the fp32 order error.
"""

import numpy as np
import pytest
import torch

from segdistill_tpu_torch.ops.resize_sum import (fused_resize_sum,
                                                 resize_sum_plain)
from segdistill_tpu_torch.ops.sra_attn import (fused_sra_attention,
                                               sra_attention_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _close(got, want32):
    diff = (got.float() - want32).abs()
    if got.dtype == torch.float32:
        assert diff.max().item() <= 2e-5, diff.max().item()
    else:
        tol = 2.0 ** -8 * want32.abs() \
            + 2.0 ** -12 * want32.square().mean().sqrt()
        assert bool((diff <= tol).all()), (diff / tol).max().item()


def _head_split(rng, b, rows, heads, d, n_maps, device, dtype):
    """Views of one (b, rows, n_maps*heads*d) linear output, split into
    (b, heads, rows, d) maps as the MiT attention splits q and kv."""
    mem = torch.from_numpy(rng.randn(b, rows, n_maps * heads * d)
                           .astype(np.float32)).to(device, dtype)
    return mem.view(b, rows, n_maps, heads, d).permute(2, 0, 3, 1, 4)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shapes,out_hw', [
    ([(2, 16, 16, 256), (2, 32, 32, 256), (2, 64, 64, 256)], (128, 128)),
    ([(2, 15, 20, 64), (2, 23, 31, 64)], (61, 83)),
    ([(1, 9, 9, 8)], (40, 33)),
])
def test_resize_sum_kernel(cuda, dtype, shapes, out_hw):
    rng = np.random.RandomState(0)
    parts = [torch.from_numpy(rng.randn(*s).astype(np.float32))
             .to(cuda, dtype) for s in shapes]
    got = fused_resize_sum(parts, out_hw)
    torch.cuda.synchronize()
    _close(got, resize_sum_plain([p.float() for p in parts], out_hw))


def test_resize_sum_kernel_refuses_odd_channels(cuda):
    """16-byte channel vectors: C = 100 is not a multiple of 8 bf16."""
    parts = [torch.zeros(1, 9, 9, 100, device=cuda, dtype=torch.bfloat16)]
    with pytest.raises(ValueError, match='multiple of 8'):
        fused_resize_sum(parts, (40, 33))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,h,n,m,d', [
    (2, 1, 4096, 64, 32), (1, 2, 1000, 100, 32), (1, 2, 300, 70, 64),
    (1, 1, 130, 17, 128)])
def test_sra_attn_kernel(cuda, dtype, b, h, n, m, d):
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(b, h, r, d).astype(np.float32))
               .to(cuda, dtype) for r in (n, m, m))
    got = fused_sra_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    _close(got, sra_attention_plain(q.float(), k.float(), v.float(),
                                    d ** -0.5))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,h,n,m,d', [
    (2, 2, 4096, 256, 32), (1, 5, 1000, 49, 32), (2, 8, 256, 256, 32)])
def test_sra_attn_kernel_head_split_views(cuda, dtype, b, h, n, m, d):
    """q and k/v as the model hands them over: strided views of the q and
    kv linear outputs, never copied."""
    rng = np.random.RandomState(2)
    q = _head_split(rng, b, n, h, d, 1, cuda, dtype)[0]
    k, v = _head_split(rng, b, m, h, d, 2, cuda, dtype)
    assert not (q.is_contiguous() or k.is_contiguous())
    got = fused_sra_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    _close(got, sra_attention_plain(q.float(), k.float(), v.float(),
                                    d ** -0.5))


def test_model_cuda_matches_cpu(cuda):
    from segdistill_tpu_torch.models import build_segmentor
    from segdistill_tpu.zoo import segformer
    cfg = segformer('b0', num_classes=19, embed_dim=64)
    cfg['backbone']['fused_attention'] = True
    model = build_segmentor(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    model.eval()
    x = torch.randn(2, 3, 96, 128, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model.encode_decode(x)
        got = model.to(cuda).encode_decode(x.to(cuda)).cpu()
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), \
        (err, want.abs().max().item())
