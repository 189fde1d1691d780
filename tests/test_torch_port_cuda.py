"""The hand-written kernels on the card against their plain versions, and
the port's CUDA forward and train step against the CPU's.

Marked ``cuda``: they skip without a CUDA device. On the card (which has
no JAX, so the repository's conftest is not loaded):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Each kernel is held against its plain version in fp32 on the same inputs.
fp32: the same formula with sums in other orders, max abs error <= 2e-5.
bf16, per element: the kernel rounds its fp32 result once, at most half a
bf16 step (2^-8 of the magnitude) away, plus 2^-12 of the output's rms for
the fp32 order error. Gradients are held to the same limits relative to
their own scale (a backward is linear in its incoming gradient, which is
chosen to make the plain gradient's max |value| 1); loss values to 2e-5
relative (sums of up to 10^6 fp32 terms in other orders).

The SRA attention kernels (K2, K9) under bf16 feed the tensor cores bf16
probabilities P (and dS), so every term of a sum carries a rounding of
2^-9: they are held (a) to the plain version run in bf16, which rounds P
and dS the same way (independently: not bitwise), within 2^-7 of the
magnitude plus 2^-5.5 of the rms of the element's row (or of the tensor,
if larger), and (b) to the plain version in fp32 within 2^-8 of the
magnitude plus 2^-6 of that rms, and their error must have no bias (its
mean, and its mean along the sign of the plain value, within 0.05 + 4 /
sqrt(n) of its rms). ``chip_smoke.py`` states the reasons.
"""

import numpy as np
import pytest
import torch

from segdistill_tpu_torch.ops import (cuda_kernel, group_kl, layer_norm,
                                      pixel_kl, resize_sum, seg_ce, sra_attn)
from segdistill_tpu_torch.ops.group_kl import (fused_group_kl,
                                               fused_group_kl_shuffled,
                                               group_kl_plain)
from segdistill_tpu_torch.ops.layer_norm import (fused_layer_norm,
                                                 layer_norm_plain)
from segdistill_tpu_torch.ops.pixel_kl import fused_pixel_kl, pixel_kl_plain
from segdistill_tpu_torch.ops.resize_sum import (fused_resize_sum,
                                                 resize_sum_plain)
from segdistill_tpu_torch.ops.seg_ce import fused_seg_ce, seg_ce_plain
from segdistill_tpu_torch.ops.sra_attn import (
    fused_sra_attention, sra_attention_backward_plain, sra_attention_plain,
    sra_attention_train)
from segdistill_tpu_torch.tools import kernel_cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _close(got, want32, dtype=None):
    """``got``, computed in ``dtype`` (by default its own), against the
    plain version in fp32."""
    diff = (got.float() - want32).abs()
    if (dtype or got.dtype) == torch.float32:
        assert diff.max().item() <= 2e-5, diff.max().item()
    else:
        tol = 2.0 ** -8 * want32.abs() \
            + 2.0 ** -12 * want32.square().mean().sqrt()
        assert bool((diff <= tol).all()), (diff / tol).max().item()


def _close_sra_bf16(got, plain_bf16, want32):
    """A bf16 result of K2 or K9 against the plain version in bf16 and in
    fp32 (the module docstring's limits (a) and (b)), and its bias."""
    g = got.float()
    rms = torch.maximum(want32.square().mean(dim=-1, keepdim=True).sqrt(),
                        want32.square().mean().sqrt())
    for ref, rel, share in ((plain_bf16.float(), 2.0 ** -7, 2.0 ** -5.5),
                            (want32, 2.0 ** -8, 2.0 ** -6)):
        tol = rel * ref.abs() + share * rms
        assert bool(((g - ref).abs() <= tol).all()), \
            ((g - ref).abs() / tol).max().item()
    err = g - want32
    bias_max = (0.05 + 4.0 / err.numel() ** 0.5) \
        * err.square().mean().sqrt().item()
    assert abs(err.mean().item()) <= bias_max
    assert abs((err * want32.sign()).mean().item()) <= bias_max


def _check_sra_forward(q, k, v, scale):
    got = fused_sra_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    want = sra_attention_plain(q.float(), k.float(), v.float(), scale)
    if q.dtype == torch.float32:
        _close(got, want)
    else:
        _close_sra_bf16(got, sra_attention_plain(q, k, v, scale), want)


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
    (1, 1, 130, 17, 128), (1, 2, 520, 600, 24), (2, 3, 70, 3, 8),
    (1, 1, 2048, 2048, 128), (2, 2, 8200, 100, 64)])
def test_sra_attn_kernel(cuda, dtype, b, h, n, m, d):
    """Ragged N and M, more keys than a block keeps in shared memory, fewer
    keys than a row has key lanes, head dims that need zero padding, a
    d = 64 grid large enough for the 32-rows-a-warp variant."""
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(b, h, r, d).astype(np.float32))
               .to(cuda, dtype) for r in (n, m, m))
    _check_sra_forward(q, k, v, d ** -0.5)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_sra_attn_kernel_copies_unaligned_views(cuda, dtype):
    """Rows that do not start at a multiple of 16 bytes (a view shifted by
    one element) are copied by the wrapper, not refused."""
    rng = np.random.RandomState(4)
    mem = torch.from_numpy(rng.randn(3, 1, 2, 200 * 32 + 1)
                           .astype(np.float32)).to(cuda, dtype)
    q, k, v = (mem[i, :, :, 1:].view(1, 2, 200, 32) for i in range(3))
    assert q.data_ptr() % 16 != 0
    _check_sra_forward(q, k[:, :, :50], v[:, :, :50], 32 ** -0.5)


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
    _check_sra_forward(q, k, v, d ** -0.5)


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


LOSS_RTOL = 2e-5


def _scaled(loss, x):
    """The plain gradient of ``loss`` in ``x`` scaled to max |value| 1, and
    the incoming gradient that does it."""
    (g,) = torch.autograd.grad(loss, x)
    peak = g.abs().max()
    gbar = 1.0 / peak if peak > 0 else torch.ones_like(peak)
    return g * gbar, gbar


def _planned_tile(module, shape, out_hw, cuda):
    return module.backward_plan(
        *shape, *out_hw, sms=torch.cuda.get_device_properties(cuda)
        .multi_processor_count)['tile']


def _check_kl_backward(module, fused, plain, xs, xt):
    """A KL kernel pair against its plain version: the loss, the gradient
    scaled to max |plain| = 1, two backward runs bitwise equal, and one
    launch of the backward kernel each."""
    a = xs.float().requires_grad_()
    want = plain(a, xt.float())
    dwant, gbar = _scaled(want, a)
    k = xs.clone().requires_grad_()
    loss = fused(k, xt)
    before = module.BWD_KERNEL.launches
    (dxs,) = torch.autograd.grad(loss, k, gbar, retain_graph=True)
    (again,) = torch.autograd.grad(loss, k, gbar)
    torch.cuda.synchronize()
    assert module.BWD_KERNEL.launches == before + 2
    assert torch.equal(dxs, again)  # one owner per element, a fixed order
    assert loss.item() == pytest.approx(want.item(), rel=LOSS_RTOL)
    assert dxs.dtype == xs.dtype
    _close(dxs, dwant)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('name,shape,out_hw,g,shuffle,tile',
                         kernel_cases.GROUP_KL_CASES,
                         ids=[c[0] for c in kernel_cases.GROUP_KL_CASES])
def test_group_kl_kernels(cuda, dtype, name, shape, out_hw, g, shuffle, tile):
    """Every variant of K4 (source tiles of edge 16, 8 and 4, and the
    gather variant), with and without a permutation and with -1e9 pad
    channels, against the plain version's gradient."""
    assert _planned_tile(group_kl, shape, out_hw, cuda) == tile, name
    gen = torch.Generator(device=cuda).manual_seed(0)
    xs, xt = (torch.randn(shape, device=cuda, generator=gen).to(dtype)
              for _ in range(2))
    perm = torch.randperm(shape[1], device=cuda, generator=gen) \
        if shuffle else None
    _check_kl_backward(
        group_kl,
        lambda a, t: fused_group_kl_shuffled(a, t, perm, out_hw, g, 2.0)
        if shuffle else fused_group_kl(a, t, out_hw, g, 2.0),
        lambda a, t: group_kl_plain(a, t, perm, out_hw, g, 2.0), xs, xt)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape,out_hw,ignored,tile', [
    ((2, 7, 8, 8), (16, 16), 0.05, 16),
    ((2, 150, 30, 40), (125, 161), 0.05, 16),   # non-integer ratio
    ((1, 150, 32, 32), (128, 128), 0.05, 16),
    ((2, 7, 8, 8), (16, 16), 1.0, 16),          # every label ignored
    ((2, 150, 128, 128), (512, 512), 0.05, 16),  # 16 x 16 tiles, two chunks
    ((2, 21, 31, 33), (97, 130), 0.05, 16),     # odd sizes
    ((2, 19, 64, 48), (24, 20), 0.05, 16),      # downsampling
    ((2, 19, 40, 40), (40, 40), 0.05, 16),      # ratio 1
    ((1, 19, 16, 16), (128, 128), 0.05, 8),     # ratio 8: 8 x 8 tiles
    ((2, 19, 21, 19), (190, 150), 0.05, 8),     # the same, tiles cut, odd
    ((1, 19, 24, 24), (300, 300), 0.05, 4),     # ratio 12.5: 4 x 4 tiles
    ((2, 19, 18, 22), (217, 231), 0.05, 4),     # the same, tiles cut, odd
    ((1, 19, 8, 8), (256, 256), 0.05, 0),       # ratio 32: the gather variant
    ((2, 19, 10, 9), (300, 270), 0.05, 0),      # ratio 30, odd: gather
])
def test_seg_ce_kernels(cuda, dtype, shape, out_hw, ignored, tile):
    """Every variant of K6 (source tiles of edge 16, 8 and 4, and the
    gather variant) against the plain version's gradient."""
    assert seg_ce.backward_plan(
        *shape, *out_hw, sms=torch.cuda.get_device_properties(cuda)
        .multi_processor_count)['tile'] == tile
    gen = torch.Generator(device=cuda).manual_seed(1)
    z = torch.randn(shape, device=cuda, generator=gen).to(dtype)
    labels = torch.randint(0, shape[1], (shape[0],) + out_hw, device=cuda,
                           generator=gen)
    labels[torch.rand(labels.shape, device=cuda, generator=gen)
           < ignored] = 255
    a = z.float().requires_grad_()
    want, want_correct = seg_ce_plain(a, labels, out_hw, shape[1])
    dwant, gbar = _scaled(want, a)
    k = z.clone().requires_grad_()
    ce, correct = fused_seg_ce(k, labels, out_hw, shape[1])
    before = seg_ce.BWD_KERNEL.launches
    (dz,) = torch.autograd.grad(ce, k, gbar, retain_graph=True)
    (again,) = torch.autograd.grad(ce, k, gbar)
    torch.cuda.synchronize()
    assert seg_ce.BWD_KERNEL.launches == before + 2
    assert torch.equal(dz, again)  # one owner per element, a fixed order
    assert ce.item() == pytest.approx(want.item(), rel=LOSS_RTOL)
    # exact but for argmax near-ties, which another summation order may
    # break the other way
    assert abs(correct.item() - want_correct.item()) \
        <= 1e-4 * labels.numel()
    assert dz.dtype == dtype
    _close(dz, dwant)


_GKL_FWD = [c + (1.0,) for c in kernel_cases.GROUP_KL_CASES] \
    + [c + (kernel_cases.SPREAD,) for c in kernel_cases.GROUP_KL_SPREAD_CASES]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('name,shape,out_hw,g,shuffle,tile,scale', _GKL_FWD,
                         ids=[c[0] for c in _GKL_FWD])
def test_group_kl_forward(cuda, dtype, name, shape, out_hw, g, shuffle, tile,
                          scale):
    """K3 (its output tile or its gather variant, as planned) on N(0, 1)
    and N(0, 30²) maps: two runs give the same loss and stats bitwise; the
    stats are each group's source maxima and sums of exp((u - m) / tau)
    over the plain upsample (1e-5: float32 sums of up to 2.6 M terms); K4
    runs on them. The sums carry the kernel's and F.interpolate's roundings
    of the upsampled values, ~2^-22 of their size each, in the exponent:
    2^-20 of the largest |value| relative, plus 2^-20."""
    del tile
    gen = torch.Generator(device=cuda).manual_seed(5)
    xs, xt = ((scale * torch.randn(shape, device=cuda, generator=gen))
              .to(dtype) for _ in range(2))
    perm = torch.randperm(shape[1], device=cuda, generator=gen) \
        if shuffle else None
    args = group_kl._prepare(xs, xt, perm, out_hw, g, 2.0)
    loss, stats = group_kl._launch_fwd(*args)
    again = group_kl._launch_fwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(loss, again[0]) and torch.equal(stats, again[1])
    B, C = shape[:2]
    order = args[2].long()
    for i, x in enumerate((xs, xt)):
        up = torch.nn.functional.interpolate(
            x.float(), size=out_hw, mode='bilinear', align_corners=False)
        for k in range(-(-C // g)):
            chans = order[k * g:(k + 1) * g]
            m = x[:, chans].float().amax(dim=(1, 2, 3))
            z = torch.exp((up[:, chans] - m[:, None, None, None]) / 2.0) \
                .sum(dim=(1, 2, 3))
            st = stats.view(B, -1, 4)[:, k]
            assert torch.equal(st[:, i], m)
            rtol = 2.0 ** -20 * (1.0 + up.abs().max().item())
            torch.testing.assert_close(st[:, 2 + i], z, rtol=rtol, atol=0)
    _check_kl_backward(
        group_kl,
        lambda a, t: fused_group_kl_shuffled(a, t, perm, out_hw, g, 2.0),
        lambda a, t: group_kl_plain(a, t, perm, out_hw, g, 2.0), xs, xt)


_CE_FWD = [c + ('N(0,1)',) for c in kernel_cases.SEG_CE_CASES] \
    + [c + ('spread',) for c in kernel_cases.SEG_CE_SPREAD_CASES] \
    + [c + ('ties',) for c in kernel_cases.SEG_CE_TIE_CASES]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('name,shape,out_hw,ignored,tile,kind', _CE_FWD,
                         ids=[c[0] for c in _CE_FWD])
def test_seg_ce_forward(cuda, dtype, name, shape, out_hw, ignored, tile,
                        kind):
    """K5 (its output tile or its gather variant, as planned) on N(0, 1),
    N(0, 30²) and exactly tying logits: two runs give the same ce_sum,
    correct, m and se bitwise; m is each pixel's maximum over the plain
    upsample (2^-20 of the largest |logit| + 1: the two upsamples round
    differently, a few ulps of their operands) and se its sum of exp(z - m)
    (those roundings in the exponent: 2^-20 of the largest |upsampled
    logit| + 1, relative); ce_sum to 2e-5 and correct
    exactly where every lerp is exact (ties), within 1e-4 of the pixels
    elsewhere (near-ties); K6 runs on them."""
    del name, tile
    gen = torch.Generator(device=cuda).manual_seed(6)
    classes = shape[1]
    labels = torch.randint(0, classes, (shape[0],) + out_hw, device=cuda,
                           generator=gen)
    labels[torch.rand(labels.shape, device=cuda, generator=gen)
           < ignored] = 255
    if kind == 'ties':
        z = kernel_cases.tie_logits(shape, labels, gen).to(dtype)
    else:
        z = (torch.randn(shape, device=cuda, generator=gen)
             * (kernel_cases.SPREAD if kind == 'spread' else 1.0)).to(dtype)
    lab32 = labels.to(torch.int32)
    first = seg_ce._launch_fwd(z, lab32, classes, 255)
    again = seg_ce._launch_fwd(z, lab32, classes, 255)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    ce, correct, m, se = first
    up = torch.nn.functional.interpolate(
        z.float(), size=out_hw, mode='bilinear', align_corners=False)
    # each side's lerps round to a few ulps of the largest source value
    scale = 1.0 + z.float().abs().max().item()
    torch.testing.assert_close(m, up.amax(dim=1), rtol=0,
                               atol=2.0 ** -20 * scale)
    torch.testing.assert_close(
        se, torch.exp(up - m[:, None]).sum(dim=1), atol=0,
        rtol=2.0 ** -20 * (1.0 + up.abs().max().item()))
    want, want_correct = seg_ce_plain(z.float(), labels, out_hw, classes)
    assert ce.item() == pytest.approx(want.item(), rel=LOSS_RTOL)
    miss = abs(correct.item() - want_correct.item())
    assert miss == 0 if kind == 'ties' else miss <= 1e-4 * labels.numel()
    a = z.float().requires_grad_()
    dwant, gbar = _scaled(seg_ce_plain(a, labels, out_hw, classes)[0], a)
    k = z.clone().requires_grad_()
    (dz,) = torch.autograd.grad(fused_seg_ce(k, labels, out_hw, classes)[0],
                                k, gbar)
    _close(dz, dwant)


def test_forward_plans_are_the_sources_and_k5_gives_its_ticket_up(
        cuda, monkeypatch):
    """A forward plan other than the source's is refused (K3, K5 and K7);
    the ticket K5 and K7 share on a stream is 0 after every launch, and a
    launch that raised drops it, so the next one gets a zeroed ticket and
    the same sums."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    shape, out_hw = (2, 19, 32, 32), (128, 128)
    z = torch.randn(shape, device=cuda, generator=gen)
    labels = torch.randint(0, 19, (2,) + out_hw, device=cuda, generator=gen,
                           dtype=torch.int32)
    xs, xt = (torch.randn(shape, device=cuda, generator=gen) for _ in range(2))
    want = seg_ce._launch_fwd(z, labels, 19, 255)
    want_kl = pixel_kl._launch_fwd(xs, xt, out_hw, 1.0)
    stream = torch.cuda.current_stream().cuda_stream
    mine = [k for k in cuda_kernel.TICKETS if k[1] == stream]
    assert len(mine) == 1 and not cuda_kernel.TICKETS[mine[0]].item()
    for mod, launch in (
            (seg_ce, lambda: seg_ce._launch_fwd(z, labels, 19, 255)),
            (pixel_kl, lambda: pixel_kl._launch_fwd(xs, xt, out_hw, 1.0)),
            (group_kl, lambda: group_kl._launch_fwd(*group_kl._prepare(
                xs, xt, None, out_hw, 10, 2.0)))):
        launch()  # a ticket again, left at 0
        plan = mod.forward_plan(*shape[2:], *out_hw)
        with monkeypatch.context() as patch:
            patch.setattr(mod, 'forward_plan', lambda *a, p=plan: dict(
                p, wy=p['wy'] + 1))
            with pytest.raises(RuntimeError, match='launch failed'):
                launch()
        assert not [k for k in cuda_kernel.TICKETS if k[1] == stream]
    again = seg_ce._launch_fwd(z, labels, 19, 255)
    assert all(torch.equal(a, b) for a, b in zip(again, want))
    again = pixel_kl._launch_fwd(xs, xt, out_hw, 1.0)
    assert all(torch.equal(a, b) for a, b in zip(again, want_kl))
    mine = [k for k in cuda_kernel.TICKETS if k[1] == stream]
    assert len(mine) == 1 and not cuda_kernel.TICKETS[mine[0]].item()


_PKL_FWD = [c + (1.0, 1.0) for c in kernel_cases.PIXEL_KL_CASES] \
    + [c + (kernel_cases.SPREAD,)
       for c in kernel_cases.PIXEL_KL_SPREAD_CASES] \
    + [c + (1.0,) for c in kernel_cases.PIXEL_KL_TAU_CASES]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('name,shape,out_hw,tile,oh,tau,scale', _PKL_FWD,
                         ids=[c[0] for c in _PKL_FWD])
def test_pixel_kl_forward(cuda, dtype, name, shape, out_hw, tile, oh, tau,
                          scale):
    """K7 (its output tile or its gather variant, as the case names it) on
    N(0, 1) and N(0, 30²) maps at tau 1, 0.5 and 4: two runs give the same
    loss and log-sum-exps bitwise; the log-sum-exps of each map are those
    of the plain upsample, in float64, within 2^-19 of (1 + max |z / tau|)
    (both upsamples round a value to a few ulps of the largest source; the
    kernel's ex2.approx, fp32 sums and log add ~2^-21); the loss is the
    plain version's (2e-5); K8 runs on them."""
    del tile
    assert pixel_kl.forward_plan(*shape[2:], *out_hw)['oh'] == oh, name
    gen = torch.Generator(device=cuda).manual_seed(9)
    xs, xt = ((scale * torch.randn(shape, device=cuda, generator=gen))
              .to(dtype) for _ in range(2))
    before = pixel_kl.FWD_KERNEL.launches
    kl, lse = pixel_kl._launch_fwd(xs, xt, out_hw, tau)
    again = pixel_kl._launch_fwd(xs, xt, out_hw, tau)
    torch.cuda.synchronize()
    assert pixel_kl.FWD_KERNEL.launches == before + 2
    assert torch.equal(kl, again[0]) and torch.equal(lse, again[1])
    assert lse.shape == (2, shape[0]) + out_hw and lse.dtype == torch.float32
    for i, x in enumerate((xs, xt)):
        u = torch.nn.functional.interpolate(
            x.float(), size=out_hw, mode='bilinear',
            align_corners=False).double() / tau
        torch.testing.assert_close(
            lse[i].double(), torch.logsumexp(u, dim=1), rtol=0,
            atol=2.0 ** -19 * (1.0 + u.abs().max().item()))
    want = pixel_kl_plain(xs.float(), xt.float(), out_hw, tau)
    assert kl.item() == pytest.approx(want.item(), rel=LOSS_RTOL)
    _check_kl_backward(pixel_kl,
                       lambda a, t: fused_pixel_kl(a, t, out_hw, tau),
                       lambda a, t: pixel_kl_plain(a, t, out_hw, tau), xs, xt)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('name,shape,out_hw,tile,oh',
                         kernel_cases.PIXEL_KL_CASES,
                         ids=[c[0] for c in kernel_cases.PIXEL_KL_CASES])
def test_pixel_kl_kernels(cuda, dtype, name, shape, out_hw, tile, oh):
    """Every variant of K8 (source tiles of edge 16, 8 and 4, and the
    gather variant) against the plain version's gradient."""
    del oh
    assert _planned_tile(pixel_kl, shape, out_hw, cuda) == tile, name
    gen = torch.Generator(device=cuda).manual_seed(2)
    xs, xt = (torch.randn(shape, device=cuda, generator=gen).to(dtype)
              for _ in range(2))
    _check_kl_backward(pixel_kl,
                       lambda a, t: fused_pixel_kl(a, t, out_hw, 1.0),
                       lambda a, t: pixel_kl_plain(a, t, out_hw, 1.0), xs, xt)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,h,n,m,d', [
    (2, 1, 4096, 256, 32), (1, 2, 1000, 100, 32), (2, 5, 1024, 49, 32),
    (1, 2, 300, 70, 64), (1, 1, 130, 17, 128), (1, 2, 4096, 256, 64),
    (1, 1, 700, 300, 32), (1, 1, 520, 600, 128), (2, 3, 70, 3, 8),
    (2, 2, 8200, 100, 64)])
def test_sra_attention_train_kernels(cuda, dtype, b, h, n, m, d):
    """K2 keeping the row log-sum-exp and K9 on strided head views, with a
    dO that is the transposed view the model's backward hands over: the
    output and dq, dk, dv, each with its plain version divided by the plain
    one's max |value|; heads whose keys are cut into chunks (dq through
    partials) among them. Two runs of K9 give the same bits."""
    rng = np.random.RandomState(3)
    q = _head_split(rng, b, n, h, d, 1, cuda, dtype)[0].requires_grad_()
    k, v = (t.requires_grad_()
            for t in _head_split(rng, b, m, h, d, 2, cuda, dtype))
    g = _head_split(rng, b, n, h, d, 1, cuda, dtype)[0]
    scale = d ** -0.5
    out = sra_attention_train(q, k, v, scale)
    got = torch.autograd.grad(out, (q, k, v), g, retain_graph=True)
    again = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want_out = sra_attention_plain(*ref, scale)
    want = torch.autograd.grad(want_out, ref, g.float())
    for t, a in zip((q, k, v), got):
        assert a.shape == t.shape and a.dtype == dtype
    if dtype == torch.float32:
        _close(out, want_out.detach())
        for a, w in zip(got, want):
            peak = w.abs().max()
            _close(a / peak, w / peak)
        return
    with torch.no_grad():
        plain = (sra_attention_plain(q, k, v, scale),
                 *sra_attention_backward_plain(q, k, v, g, scale))
    for a, pb, w in zip((out.detach(), *got), plain,
                        (want_out.detach(), *want)):
        _close_sra_bf16(a, pb, w)


def _small_segformer(**backbone):
    from segdistill_tpu.zoo import segformer
    from segdistill_tpu_torch.models import build_segmentor
    cfg = segformer('b0', num_classes=19, embed_dim=64)
    cfg['backbone'].update(drop_path_rate=0.0, **backbone)
    cfg['decode_head']['dropout_ratio'] = 0.0
    model = build_segmentor(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    return model


def _layer_norm_case(cuda, dtype, shape, eps, seed=0):
    """K10 and K11 against the plain version and its autograd in fp32;
    each gradient and its plain version divided by the plain one's max
    |value|. -> (x, w, b, g) on the card."""
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 2 + 1) \
        .to(cuda, dtype)
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(cuda, dtype)
    w = torch.from_numpy((1 + 0.1 * rng.randn(c)).astype(np.float32)).to(cuda)
    b = torch.from_numpy((0.1 * rng.randn(c)).astype(np.float32)).to(cuda)
    return x, w, b, g


def _check_layer_norm(x, w, b, g, eps):
    ref = [t.detach().float().requires_grad_() for t in (x, w, b)]
    want = layer_norm_plain(*ref, eps)
    dwant = torch.autograd.grad(want, ref, g.float())
    ins = [t.detach().requires_grad_() for t in (x, w, b)]
    y = fused_layer_norm(*ins, eps)
    got = torch.autograd.grad(y, ins, g)
    torch.cuda.synchronize()
    assert y.dtype == x.dtype and y.shape == x.shape and y.is_contiguous()
    _close(y.detach(), want.detach())
    for a, d, dt in zip(got, dwant, (x.dtype, torch.float32, torch.float32)):
        assert a.dtype == dt and a.shape == d.shape
        peak = d.abs().max()
        _close(a.float() / peak, d / peak, dt)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape,eps', [
    ((8 * 16384, 32), 1e-6), ((8, 4096, 64), 1e-5), ((8, 1024, 160), 1e-6),
    ((8, 256, 256), 1e-5), ((8 * 16384, 64), 1e-5), ((8, 1024, 320), 1e-6),
    ((8, 256, 512), 1e-6), ((1001, 160), 1e-5), ((1, 8), 1e-6),
    ((3, 7, 1024), 1e-6), ((5, 640), 1e-6), ((70000, 24), 1e-5),
])
def test_layer_norm_kernels(cuda, dtype, shape, eps):
    """Every MiT width of B0 and B3 at batch 8, 512x512, a row count no
    tile divides, one row, the widest supported row and widths that need
    the masked tail."""
    before = layer_norm.FWD_KERNEL.launches, layer_norm.BWD_KERNEL.launches
    _check_layer_norm(*_layer_norm_case(cuda, dtype, shape, eps), eps)
    assert (layer_norm.FWD_KERNEL.launches - before[0],
            layer_norm.BWD_KERNEL.launches - before[1]) == (1, 1)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_layer_norm_kernels_strided(cuda, dtype):
    """Strided rows go to the kernels by their row stride; a strided last
    axis (the token view of an NCHW map, for x and for the incoming
    gradient) is copied first. The same numbers either way."""
    x, w, b, g = _layer_norm_case(cuda, dtype, (4, 96, 64), 1e-6)
    # every other token: rows 128 elements apart
    _check_layer_norm(x[:, ::2], w, b, g[:, ::2], 1e-6)
    # columns 8..40 of each row: aligned (16 or 32 bytes in), row stride 64
    _check_layer_norm(x[..., 8:40], w[:32].clone(), b[:32].clone(),
                      g[..., 8:40], 1e-6)
    # NCHW memory viewed as tokens: the last axis has stride H*W
    nchw = x.permute(0, 2, 1).contiguous()          # (4, 64, 96)
    tokens = nchw.permute(0, 2, 1)                  # (4, 96, 64) view
    assert tokens.stride(-1) != 1
    gview = g.permute(0, 2, 1).contiguous().permute(0, 2, 1)
    _check_layer_norm(tokens, w, b, gview, 1e-6)
    # no gradient needed: the same launch without an autograd node
    before = layer_norm.FWD_KERNEL.launches
    with torch.no_grad():
        y = fused_layer_norm(x, w.requires_grad_(), b, 1e-6)
    assert not y.requires_grad
    assert layer_norm.FWD_KERNEL.launches == before + 1


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('cut,folds', [
    (lambda t: t[:, 1:], False), (lambda t: t[1:, 2:-1], False),
    (lambda t: t[:, ::2], True), (lambda t: t[::2, 1:], False)],
    ids=['[:,1:]', '[1:,2:-1]', '[:,::2]', '[::2,1:]'])
def test_layer_norm_rows_that_do_not_fold(cuda, dtype, cut, folds):
    """A slice with a unit last stride whose leading axes have no one row
    stride: K10 reads a copy of the rows, and K11 reads that copy too, not
    the memory behind the slice. The gradient reaches the whole tensor
    through the slice. ``[:, ::2]`` of an even token count folds and is
    read in place."""
    base, w, b, _ = _layer_norm_case(cuda, dtype, (4, 34, 64), 1e-6)
    assert (layer_norm._rows_of('x', cut(base), 64)[0]
            == cut(base).data_ptr()) == folds
    g = _layer_norm_case(cuda, dtype, tuple(cut(base).shape), 1e-6, seed=1)[3]
    ref = [t.detach().float().requires_grad_() for t in (base, w, b)]
    dwant = torch.autograd.grad(
        layer_norm_plain(cut(ref[0]), ref[1], ref[2], 1e-6), ref, g.float())
    ins = [t.detach().requires_grad_() for t in (base, w, b)]
    x = cut(ins[0])
    assert x.stride(-1) == 1 and not x.is_contiguous()
    before = layer_norm.FWD_KERNEL.launches, layer_norm.BWD_KERNEL.launches
    y = fused_layer_norm(x, ins[1], ins[2], 1e-6)
    _close(y.detach(), layer_norm_plain(cut(ref[0]), ref[1], ref[2],
                                        1e-6).detach())
    got = torch.autograd.grad(y, ins, g)
    torch.cuda.synchronize()
    assert (layer_norm.FWD_KERNEL.launches - before[0],
            layer_norm.BWD_KERNEL.launches - before[1]) == (1, 1)
    for a, d, dt in zip(got, dwant, (dtype, torch.float32, torch.float32)):
        assert a.dtype == dt and a.shape == d.shape
        peak = d.abs().max()
        _close(a.float() / peak, d / peak, dt)


def test_layer_norm_failed_launch_gives_its_workspace_up(cuda, monkeypatch):
    """A K11 launch that raises may leave its ticket counters anywhere:
    the workspace is dropped, and the next backward gets a zeroed one and
    the right sums."""
    x, w, b, g = _layer_norm_case(cuda, torch.float32, (4096, 32), 1e-6)
    ins = [t.detach().requires_grad_() for t in (x, w, b)]
    y = fused_layer_norm(*ins, 1e-6)
    want = torch.autograd.grad(y, ins, g, retain_graph=True)
    mine = [k for k in layer_norm.WORKSPACES if k[2] == 32]
    assert mine
    for key in mine:
        ws = layer_norm.WORKSPACES[key]
        assert not layer_norm.workspace_tickets(ws, key[2], key[3]).any()
    with monkeypatch.context() as patch:
        # more blocks than the rows need: the source refuses the launch
        patch.setattr(layer_norm, 'bwd_blocks', lambda rows, C, cap: cap)
        small = [t.detach().requires_grad_() for t in (x[:8], w, b)]
        with pytest.raises(RuntimeError, match='launch failed'):
            torch.autograd.grad(fused_layer_norm(*small, 1e-6), small, g[:8])
    stream = torch.cuda.current_stream().cuda_stream
    assert not [k for k in layer_norm.WORKSPACES
                if k[1] == stream and k[2] == 32]
    again = torch.autograd.grad(y, ins, g)
    assert all(torch.equal(a, c) for a, c in zip(again, want))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [(8 * 16384, 32), (10, 32), (8, 256, 256),
                                   (3, 7, 1024), (1001, 160)])
def test_layer_norm_backward_is_one_reproducible_launch(cuda, dtype, shape):
    """K11 sums its per-block partials in the block that finishes last, in
    block order: the same bits on every run, with more row groups than
    blocks and with fewer rows than one block; frozen parameters get None
    and leave dx as it is; the workspace is kept per (device, stream, C)."""
    x, w, b, g = _layer_norm_case(cuda, dtype, shape, 1e-6)
    ins = [t.detach().requires_grad_() for t in (x, w, b)]
    y = fused_layer_norm(*ins, 1e-6)
    before = layer_norm.BWD_KERNEL.launches
    runs = [torch.autograd.grad(y, ins, g, retain_graph=True)
            for _ in range(5)]
    assert layer_norm.BWD_KERNEL.launches == before + 5
    for run in runs[1:]:
        assert all(torch.equal(a, c) for a, c in zip(run, runs[0]))
    held = len(layer_norm.WORKSPACES)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # a backward runs on its forward's stream
        other = torch.autograd.grad(fused_layer_norm(*ins, 1e-6), ins, g)
    side.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(other, runs[0]))
    assert len(layer_norm.WORKSPACES) == held + 1  # the side stream's own
    y2 = fused_layer_norm(ins[0], w, b, 1e-6)
    assert y2.grad_fn.apply(g)[1:3] == (None, None)
    (dx,) = torch.autograd.grad(y2, ins[:1], g)
    assert torch.equal(dx, runs[0][0])
    assert len(layer_norm.WORKSPACES) == held + 1


def test_layer_norm_kernels_refuse(cuda):
    x = torch.zeros(4, 32, device=cuda)
    w, b = torch.ones(32, device=cuda), torch.zeros(32, device=cuda)
    with pytest.raises(ValueError, match='multiple of 8'):
        fused_layer_norm(torch.zeros(4, 12, device=cuda), w[:12], b[:12])
    with pytest.raises(ValueError, match='up to 1024'):
        fused_layer_norm(torch.zeros(2, 2048, device=cuda),
                         torch.ones(2048, device=cuda),
                         torch.zeros(2048, device=cuda))
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        fused_layer_norm(x.half(), w, b)
    with pytest.raises(ValueError, match='weight must be'):
        fused_layer_norm(x, w.bfloat16(), b)
    with pytest.raises(ValueError, match='bias must be'):
        fused_layer_norm(x, w, b.cpu())
    with pytest.raises(ValueError, match='16-byte'):
        fused_layer_norm(torch.zeros(4, 40, device=cuda)[:, 1:33], w, b)
    with pytest.raises(ValueError, match='empty'):
        fused_layer_norm(torch.zeros(0, 32, device=cuda), w, b)
    before = layer_norm.FWD_KERNEL.launches
    assert fused_layer_norm(x, w, b).shape == (4, 32)
    assert layer_norm.FWD_KERNEL.launches == before + 1


def _k10(x, w, b, plan, pdl=False, eps=1e-6):
    """One K10 launch on (rows, C) ``x`` with the given plan."""
    rows, c = x.shape
    y = torch.empty_like(x)
    layer_norm.FWD_KERNEL.launch(
        x.device, x.data_ptr(), c, w.data_ptr(), b.data_ptr(), rows, c, eps,
        layer_norm.DTYPE_CODES[x.dtype], y.data_ptr(), *plan, pdl)
    return y


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('rows,c', [(1001, 160), (4099, 32), (300, 320),
                                    (77, 1000), (129, 1024), (9, 8)])
def test_layer_norm_forward_every_instance(cuda, dtype, rows, c):
    """K10 under every instance that covers the width, at 64-256 threads a
    block, the two-row instances also on grids smaller than the rows need
    (a group walks several rows), and as a programmatic dependent launch:
    the plain version's values, and the same bits whatever the grid."""
    from segdistill_tpu_torch.ops.ln_plan import INSTANCES, VEC, Plan
    x, w, b, _ = _layer_norm_case(cuda, dtype, (rows, c), 1e-6)
    want = layer_norm_plain(x.float(), w, b, 1e-6)
    code = layer_norm.DTYPE_CODES[dtype]
    runs = 0
    for lanes, nch, rif in INSTANCES[code]:
        if lanes * nch * VEC[code] < c:
            continue
        first = None
        for threads in (64, 128, 256):
            need = -(-rows // (threads // lanes))
            grids = {need} if rif == 1 else {1, max(1, need // 3), need}
            for blocks in sorted(grids):
                for pdl in (False, True):
                    y = _k10(x, w, b, Plan(lanes, nch, rif, threads, blocks),
                             pdl)
                    torch.cuda.synchronize()
                    _close(y, want)
                    first = y if first is None else first
                    assert torch.equal(y, first), (lanes, nch, rif, threads,
                                                   blocks)
                    runs += 1
    assert runs > 0


@pytest.mark.parametrize('plan', [
    (3, 1, 1, 64, 48),      # no instance of 3 lanes
    (64, 1, 1, 64, 1000),   # more lanes than a warp
    (4, 1, 1, 512, 8),      # a block above 256 threads
    (4, 1, 1, 48, 84),      # not whole warps
    (4, 3, 1, 64, 63),      # no instance holds 3 vectors a lane
    (4, 1, 1, 64, 10),      # one row a group: the grid must cover the rows
    (4, 1, 2, 64, 200),     # blocks without a row: 64 / 4 rows a block
    (4, 2, 2, 64, 10),      # no two-row instance of 2 vectors
])
def test_layer_norm_forward_refuses_a_bad_plan(cuda, plan):
    x, w, b, _ = _layer_norm_case(cuda, torch.bfloat16, (1000, 32), 1e-6)
    with pytest.raises(RuntimeError, match='launch failed'):
        _k10(x, w, b, plan)


@pytest.mark.parametrize('pdl', [False, True])
def test_layer_norm_forward_after_its_producer(cuda, pdl, monkeypatch):
    """x made by the kernel just before K10 (x = a + b_i, b_i other random
    rows each time), twenty times: a launch that read x before its
    producer ended (the memory of the round before, which the allocator
    hands out again) would differ."""
    monkeypatch.setattr(layer_norm, 'PDL', pdl)
    a, w, b, _ = _layer_norm_case(cuda, torch.bfloat16, (8192, 320), 1e-6)
    adds = [_layer_norm_case(cuda, torch.bfloat16, (8192, 320), 1e-6,
                             seed=i + 1)[0] for i in range(20)]
    torch.cuda.synchronize()
    for add in adds:
        x = a + add
        y = fused_layer_norm(x, w, b, 1e-6)
        _close(y, layer_norm_plain(x.float(), w, b, 1e-6))


def test_resize_sum_gradient_on_the_card(cuda):
    """K1 is differentiable: the head's parameter gradients on the card
    (K1 forward, torch's upsample adjoint backward) against the same head
    on the CPU. Eval-mode BN: in train mode it removes the embeddings'
    biases, whose gradient is then float noise."""
    model = _small_segformer()
    x = torch.randn(2, 3, 96, 128, generator=torch.Generator().manual_seed(1))
    w = torch.randn(2, 19, 24, 32, generator=torch.Generator().manual_seed(2))
    grads = {}
    for dev in ('cpu', cuda):
        m = model.to(dev).eval()
        m.zero_grad(set_to_none=True)
        (m(x.to(dev)) * w.to(dev)).sum().backward()
        grads[str(dev)] = {n: None if p.grad is None
                           else p.grad.detach().cpu().clone()
                           for n, p in m.decode_head.named_parameters()}
    for name, want in grads['cpu'].items():
        got = grads['cuda'][name]
        assert got is not None, f'{name} got no gradient on the card'
        err = ((got - want).norm() / want.norm()).item()
        assert err <= 1e-5, (name, err)


def test_fused_attention_refuses_gradients_on_the_card(cuda):
    model = _small_segformer(fused_attention=True).to(cuda).train()
    x = torch.randn(1, 3, 64, 64, device=cuda)
    with pytest.raises(NotImplementedError, match='backward'):
        model(x)
    with torch.no_grad():
        assert model(x).shape == (1, 19, 16, 16)


def test_fused_attention_train_gradients_on_the_card(cuda):
    """``fused_attention='train'`` on the card (K2 + K9) against the
    unfused model on the CPU, same weights, eval-mode BN: the backbone's
    gradients, relative L2 over all of them (some true gradients are 0,
    the key half of each kv bias, and hold float noise)."""
    model = _small_segformer(fused_attention='train')
    unfused = _small_segformer()
    x = torch.randn(2, 3, 96, 128, generator=torch.Generator().manual_seed(1))
    w = torch.randn(2, 19, 24, 32, generator=torch.Generator().manual_seed(2))
    grads = []
    for m, dev in ((unfused, 'cpu'), (model.to(cuda), cuda)):
        m.eval().zero_grad(set_to_none=True)
        (m(x.to(dev)) * w.to(dev)).sum().backward()
        grads.append(torch.cat([p.grad.flatten().cpu() for p in
                                m.backbone.parameters()]))
    want, got = grads
    assert ((got - want).norm() / want.norm()).item() <= 1e-5


def test_cuda_tensors_never_take_the_plain_versions(cuda, monkeypatch):
    """On CUDA tensors every wrapper launches its kernel, forward and
    backward: the plain versions are never called."""
    def refuse(*args, **kwargs):
        raise AssertionError('a plain version ran on CUDA tensors')
    for mod, name in ((group_kl, 'group_kl_plain'),
                      (seg_ce, 'seg_ce_plain'),
                      (resize_sum, 'resize_sum_plain'),
                      (sra_attn, 'sra_attention_plain'),
                      (pixel_kl, 'pixel_kl_plain'),
                      (layer_norm, 'layer_norm_plain')):
        monkeypatch.setattr(mod, name, refuse)
    kernels = (group_kl.FWD_KERNEL, group_kl.BWD_KERNEL, seg_ce.FWD_KERNEL,
               seg_ce.BWD_KERNEL, resize_sum.KERNEL, pixel_kl.FWD_KERNEL,
               pixel_kl.BWD_KERNEL, sra_attn.KERNEL, sra_attn.BWD_KERNEL,
               layer_norm.FWD_KERNEL, layer_norm.BWD_KERNEL)
    before = [k.launches for k in kernels]
    xs = torch.randn(1, 12, 8, 8, device=cuda, requires_grad=True)
    group_kl.fused_group_kl(xs, torch.randn_like(xs), (16, 16), 5,
                            2.0).backward()
    z = torch.randn(1, 12, 8, 8, device=cuda, requires_grad=True)
    labels = torch.randint(0, 12, (1, 16, 16), device=cuda)
    seg_ce.fused_seg_ce(z, labels, (16, 16), 12)[0].backward()
    fused_resize_sum([torch.randn(1, 4, 4, 8, device=cuda)], (8, 8))
    xs = torch.randn(1, 12, 8, 8, device=cuda, requires_grad=True)
    fused_pixel_kl(xs, torch.randn_like(xs), (16, 16), 1.0).backward()
    q, k, v = (torch.randn(1, 2, 40, 16, device=cuda, requires_grad=True)
               for _ in range(3))
    sra_attention_train(q, k, v, 0.25).sum().backward()
    x = torch.randn(3, 5, 32, device=cuda, requires_grad=True)
    w, b = (torch.randn(32, device=cuda, requires_grad=True)
            for _ in range(2))
    layer_norm.fused_layer_norm(x, w, b).sum().backward()
    assert [k.launches - b for k, b in zip(kernels, before)] == [1] * 11


def test_train_step_cuda_matches_cpu(cuda):
    """One fp32 CGD step of a small SDModule on the card (K1, K3-K6)
    against the same model on the CPU (plain versions): the loss terms and
    the student's gradients."""
    from segdistill_tpu.zoo import distill_entry, sd_model, segformer
    from segdistill_tpu_torch.models import build_segmentor
    from segdistill_tpu_torch.models.segmentors import parse_losses
    cfgs = [segformer('b0', num_classes=19, embed_dim=64) for _ in range(2)]
    for cfg in cfgs:
        cfg['backbone']['drop_path_rate'] = 0.0
        cfg['decode_head']['dropout_ratio'] = 0.0
    model = build_segmentor(sd_model(*cfgs, [distill_entry('CGDLoss')],
                                     t_pretrain=None))
    model.init_weights(torch.Generator().manual_seed(0))
    img = torch.randn(2, 3, 96, 128, generator=torch.Generator().manual_seed(1))
    gt = torch.randint(0, 19, (2, 96, 128),
                       generator=torch.Generator().manual_seed(2))
    perm = torch.randperm(19, generator=torch.Generator().manual_seed(3))
    out = {}
    for dev in ('cpu', cuda):
        m = model.to(dev).train()
        m.zero_grad(set_to_none=True)
        total, log_vars = parse_losses(m.forward_train(
            img.to(dev), gt.to(dev), 1000, perm=perm.to(dev)))
        total.backward()
        out[str(dev)] = ({k: v.item() for k, v in log_vars.items()},
                         torch.cat([p.grad.flatten().cpu() for p in
                                    m.student.parameters()]))
    (lc, gc), (lg, gg) = out['cpu'], out['cuda']
    # fp32 losses that are a log-sum-exp over ~10^5 values carry an
    # absolute error of ~1e-6; the untrained pair's KL is ~1e-3
    for k in lc:
        assert lg[k] == pytest.approx(lc[k], rel=1e-5, abs=1e-5), k
    assert ((gg - gc).norm() / gc.norm()).item() <= 1e-4


def test_pd_train_step_cuda_matches_cpu(cuda):
    """One fp32 PD step of a small SDModule, the student's attention with
    ``fused_attention='train'``, on the card (K1, K2, K5-K9) against the
    same model on the CPU (plain versions): the loss terms and the
    student's gradients."""
    from segdistill_tpu.zoo import distill_entry, sd_model, segformer
    from segdistill_tpu_torch.models import build_segmentor
    from segdistill_tpu_torch.models.segmentors import parse_losses
    cfgs = [segformer('b0', num_classes=19, embed_dim=64) for _ in range(2)]
    for cfg in cfgs:
        cfg['backbone']['drop_path_rate'] = 0.0
        cfg['decode_head']['dropout_ratio'] = 0.0
    cfgs[0]['backbone']['fused_attention'] = 'train'
    model = build_segmentor(sd_model(*cfgs, [distill_entry('PDLoss')],
                                     t_pretrain=None))
    model.init_weights(torch.Generator().manual_seed(0))
    img = torch.randn(2, 3, 96, 128, generator=torch.Generator().manual_seed(1))
    gt = torch.randint(0, 19, (2, 96, 128),
                       generator=torch.Generator().manual_seed(2))
    launches = sra_attn.BWD_KERNEL.launches
    out = {}
    for dev in ('cpu', cuda):
        m = model.to(dev).train()
        m.zero_grad(set_to_none=True)
        total, log_vars = parse_losses(m.forward_train(img.to(dev),
                                                       gt.to(dev), 1))
        total.backward()
        out[str(dev)] = ({k: v.item() for k, v in log_vars.items()},
                         torch.cat([p.grad.flatten().cpu() for p in
                                    m.student.parameters()]))
    assert sra_attn.BWD_KERNEL.launches == launches + 8  # 8 MiT blocks
    (lc, gc), (lg, gg) = out['cpu'], out['cuda']
    for k in lc:
        assert lg[k] == pytest.approx(lc[k], rel=1e-5, abs=1e-5), k
    assert ((gg - gc).norm() / gc.norm()).item() <= 1e-4
