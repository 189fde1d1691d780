"""K3/K4 and K7/K8 with a student and a teacher of different sizes, and
K10/K11 at C = 1536, on the card against their plain versions.

Marked ``cuda``: they skip without a CUDA device. On the card (which has
no JAX, so the repository's conftest is not loaded):

    python -m pytest --noconftest -m cuda tests/test_torch_port_tab5_cuda.py

The limits are ``tests/test_torch_port_cuda.py``'s: losses 2e-5 relative;
fp32 results within 2e-5; bf16 per element within 2^-8 of the magnitude
plus 2^-12 of the rms; gradients relative to their own scale. A two-size
pair plans the variants its case names (K3/K4: the two-geometry tiles or
the gather variants; K7/K8: the gather variants), and its calls launch the
kernels (the counters move): a CUDA tensor never falls back to the plain
version.
"""

import pytest
import torch

from segdistill_tpu_torch.ops import group_kl, layer_norm, pixel_kl
from segdistill_tpu_torch.tools import kernel_cases

import torch_port_threads  # noqa: F401  (torch threads a test worker)
from test_torch_port_cuda import _check_kl_backward, _close, cuda  # noqa

pytestmark = pytest.mark.cuda

TWO_GKL = kernel_cases.GROUP_KL_TWO_SIZE_CASES
TWO_PKL = kernel_cases.PIXEL_KL_TWO_SIZE_CASES


def _maps(shape, teacher_hw, dtype, device):
    gen = torch.Generator(device=device).manual_seed(0)
    xs = torch.randn(shape, device=device, generator=gen).to(dtype)
    xt = torch.randn(tuple(shape[:2]) + tuple(teacher_hw), device=device,
                     generator=gen).to(dtype)
    return xs, xt


def _launches(mod):
    return mod.FWD_KERNEL.launches, mod.BWD_KERNEL.launches


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('name,shape,thw,out_hw,g,shuffle,oh,tile', TWO_GKL,
                         ids=[c[0] for c in TWO_GKL])
def test_group_kl_two_sizes(cuda, dtype, name, shape, thw, out_hw, g,
                            shuffle, oh, tile):
    assert group_kl.forward_plan(*shape[2:], *out_hw, thw)['oh'] == oh
    assert group_kl.backward_plan(*shape, *out_hw, 132, thw)['tile'] == tile
    xs, xt = _maps(shape, thw, dtype, cuda)
    perm = torch.randperm(shape[1], device=cuda) if shuffle else None
    before = _launches(group_kl)
    _check_kl_backward(
        group_kl,
        lambda a, t: group_kl.fused_group_kl_shuffled(a, t, perm, out_hw, g,
                                                      2.0)
        if shuffle else group_kl.fused_group_kl(a, t, out_hw, g, 2.0),
        lambda a, t: group_kl.group_kl_plain(a, t, perm, out_hw, g, 2.0),
        xs, xt)
    after = _launches(group_kl)
    assert after[0] > before[0] and after[1] > before[1], name


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('name,shape,thw,out_hw', TWO_PKL,
                         ids=[c[0] for c in TWO_PKL])
def test_pixel_kl_two_sizes(cuda, dtype, name, shape, thw, out_hw):
    assert pixel_kl.forward_plan(*shape[2:], *out_hw, thw)['oh'] == 0
    assert pixel_kl.backward_plan(*shape, *out_hw, 132, thw)['tile'] == 0
    xs, xt = _maps(shape, thw, dtype, cuda)
    before = _launches(pixel_kl)
    _check_kl_backward(
        pixel_kl, lambda a, t: pixel_kl.fused_pixel_kl(a, t, out_hw, 1.0),
        lambda a, t: pixel_kl.pixel_kl_plain(a, t, out_hw, 1.0), xs, xt)
    after = _launches(pixel_kl)
    assert after[0] > before[0] and after[1] > before[1], name


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('rows', [512, 64, 7])
def test_layer_norm_1536(cuda, dtype, rows):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(rows, 1536, device=cuda, generator=gen).to(dtype)
    w = 1 + 0.1 * torch.randn(1536, device=cuda, generator=gen)
    b = 0.1 * torch.randn(1536, device=cuda, generator=gen)
    g = torch.randn(rows, 1536, device=cuda, generator=gen).to(dtype)
    ins = [t.clone().requires_grad_() for t in (x, w, b)]
    before = layer_norm.FWD_KERNEL.launches, layer_norm.BWD_KERNEL.launches
    y = layer_norm.fused_layer_norm(*ins, 1e-5)
    got = torch.autograd.grad(y, ins, g)
    assert (layer_norm.FWD_KERNEL.launches - before[0],
            layer_norm.BWD_KERNEL.launches - before[1]) == (1, 1)
    ref = [t.detach().float().requires_grad_() for t in (x, w, b)]
    want = layer_norm.layer_norm_plain(*ref, 1e-5)
    dwant = torch.autograd.grad(want, ref, g.float())
    _close(y.detach(), want.detach(), dtype)
    for a, d in zip(got, dwant):
        peak = d.abs().max()
        _close(a.float() / peak, d / peak, a.dtype)
