"""K4's and K8's launch planning (``ops/tile_plan.py`` through
``group_kl.backward_plan`` and ``pixel_kl.backward_plan``) and a model of
their tile arithmetic, on the CPU.

K4 (group-KL backward) and K8 (pixel-KL backward) are the tile kernel of
``csrc/common.cuh`` that K6 runs too, with their own losses: K8 keeps two
per-output maps (the log-sum-exps) and reads two source maps, K4 keeps no
per-output map (its group stats are scalars a position) and reads two.
Here (a) the plan at every shape of ``tools/kernel_cases.py`` and a few
more, for 132 and 108 SMs, is the largest tile that fits the budget, its
rectangle holds every tile's readers, and its blocks cover every source
element of every channel exactly once (K4: through the permutation); (b)
the constants the planner and the sources share are read from the sources;
(c) a float64 numpy model of the kernels' backward, tile by tile as the
plan cuts it (the rectangle's upsampled values from the tile and its halo
with the source's local indices and clamps, the probabilities from the
saved log-sum-exps or group stats, the separable transposed sum), equals
``torch.autograd.grad`` of ``group_kl_plain`` / ``pixel_kl_plain``.

The limit of (c): the plain versions run in float32, whose softmax over
10^3-10^5 values and bilinear taps carry ~1e-6 of the largest gradient,
so the model, in float64 with the source's float32 tap fractions, is held
to 1e-5 of the largest |plain gradient|, plus what the float32 rounding of
a tap's fraction allows at a ratio that is not a power of two (as in
``test_torch_port_seg_ce_plan.py``). A wrong stats index, group, position
or halo moves the gradient by a sizeable share of its scale.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from segdistill_tpu_torch.ops import group_kl as gk
from segdistill_tpu_torch.ops import pixel_kl as pk
from segdistill_tpu_torch.ops import seg_ce as sc
from segdistill_tpu_torch.ops import tile_plan
from segdistill_tpu_torch.tools import kernel_cases
from test_torch_port_seg_ce_plan import _weights, readers, taps, tile_axis

CSRC = Path(tile_plan.__file__).resolve().parent.parent / 'csrc'
KERNELS = {'K4': gk, 'K8': pk}

SHAPES = {
    'K4': [c[1] + c[2] for c in kernel_cases.GROUP_KL_CASES]
    + [(16, 150, 128, 128, 512, 512), (4, 21, 60, 60, 473, 473),
       (1, 3, 4, 4, 512, 512)],
    'K8': [c[1] + c[2] for c in kernel_cases.PIXEL_KL_CASES]
    + [(16, 150, 128, 128, 512, 512), (4, 21, 60, 60, 473, 473),
       (1, 3, 4, 4, 512, 512)]}
PLAN_CASES = [(k, s) for k, shapes in SHAPES.items() for s in shapes]


def _shared(mod, tile, h, w, H, W):
    return tile_plan.shared_bytes(tile, h, w, H, W, mod.RECT_MAPS,
                                  mod.SRC_MAPS)


@pytest.mark.parametrize('kernel,shape', PLAN_CASES,
                         ids=[f'{k}-' + 'x'.join(map(str, s))
                              for k, s in PLAN_CASES])
@pytest.mark.parametrize('sms', [132, 108])
def test_kl_backward_plan(kernel, shape, sms):
    mod = KERNELS[kernel]
    B, C, h, w, H, W = shape
    plan = mod.backward_plan(*shape, sms=sms)
    tile = plan['tile']
    if tile == 0:  # no tile fits: every edge's block is over the budget
        for t in tile_plan.TILE_EDGES:
            assert _shared(mod, t, h, w, H, W) > tile_plan.TILE_BUDGET
        assert (plan['rh'], plan['rw'], plan['shared_bytes']) == (0, 0, 0)
        assert plan['blocks'] == B * C * -(-h * w // 256)
        return
    # the largest edge that fits
    for t in tile_plan.TILE_EDGES:
        if t > tile:
            assert _shared(mod, t, h, w, H, W) > tile_plan.TILE_BUDGET
    assert plan['shared_bytes'] == _shared(mod, tile, h, w, H, W) \
        <= tile_plan.TILE_BUDGET
    assert (plan['rh'], plan['rw']) == (tile_plan.tile_reach(tile, h, H),
                                        tile_plan.tile_reach(tile, w, W))
    # the rectangle holds every tile's readers along both axes
    for n_in, n_out, reach in ((h, H, plan['rh']), (w, W, plan['rw'])):
        for index in range(-(-n_in // tile)):
            lo, n, _, on = tile_axis(index, tile, n_in, n_out)
            assert on == readers(lo, n, n_in, n_out).size <= reach
    cpc, chunks = plan['cpc'], plan['chunks']
    assert 1 <= cpc <= C and (chunks - 1) * cpc < C <= chunks * cpc
    assert plan['blocks'] == B * -(-h // tile) * -(-w // tile) * chunks


def test_the_case_lists_plan_the_tiles_they_name():
    """Each variant (tile 16, 8, 4 and the gather) at least twice per
    kernel, once with tiles cut by the map's edge."""
    for kernel, mod, cases in (
            ('K4', gk, [(c[1], c[2], c[5])
                        for c in kernel_cases.GROUP_KL_CASES]),
            ('K8', pk, [(c[1], c[2], c[3])
                        for c in kernel_cases.PIXEL_KL_CASES]),
            ('K6', sc, [(c[1], c[2], c[4])
                        for c in kernel_cases.SEG_CE_CASES])):
        seen = {t: [] for t in (16, 8, 4, 0)}
        for shape, out_hw, tile in cases:
            for sms in (132, 108):
                assert mod.backward_plan(*shape, *out_hw, sms=sms)['tile'] \
                    == tile, (kernel, shape, out_hw)
            cut = tile and (shape[2] % tile or shape[3] % tile)
            seen[tile].append(bool(cut))
        for tile, cuts in seen.items():
            assert len(cuts) >= 2, (kernel, tile)
            assert tile == 0 or any(cuts), (kernel, tile)


def _owners(mod, B, C, h, w, H, W, perm):
    """How often the blocks of the plan write each element of dx: the
    kernel's block index -> (image, tile row, tile column, chunk), a chunk's
    positions -> their source channels, a tile -> its sources."""
    plan = mod.backward_plan(B, C, h, w, H, W)
    count = np.zeros((B, C, h, w), np.int64)
    tile, cpc, chunks = plan['tile'], plan['cpc'], plan['chunks']
    if tile == 0:  # a thread per source element
        count[...] = 1
        return count
    tiles_y, tiles_x = -(-h // tile), -(-w // tile)
    for blk in range(plan['blocks']):
        t, chunk = divmod(blk, chunks)
        t, tile_x = divmod(t, tiles_x)
        b, tile_y = divmod(t, tiles_y)
        for pos in range(chunk * cpc, min(chunk * cpc + cpc, C)):
            c = perm[pos]
            count[b, c, tile_y * tile:(tile_y + 1) * tile,
                  tile_x * tile:(tile_x + 1) * tile] += 1
    return count


@pytest.mark.parametrize('kernel,shape', [
    ('K4', (2, 7, 8, 8, 16, 16)), ('K4', (2, 19, 21, 19, 190, 150)),
    ('K4', (2, 19, 18, 22, 217, 231)), ('K4', (2, 19, 10, 9, 300, 270)),
    ('K4', (2, 150, 31, 33, 97, 130)), ('K8', (2, 150, 30, 40, 125, 161)),
    ('K8', (2, 19, 21, 19, 190, 150)), ('K8', (2, 19, 18, 22, 217, 231)),
    ('K8', (2, 19, 64, 48, 24, 20))])
def test_every_source_element_has_one_owner(kernel, shape):
    C = shape[1]
    perm = np.random.RandomState(C).permutation(C) if kernel == 'K4' \
        else np.arange(C)
    assert (_owners(KERNELS[kernel], *shape, perm) == 1).all()


def _constant(src, name):
    return int(re.search(rf'{name} = (\d+)', src).group(1))


@pytest.mark.parametrize('kernel,source,loss', [
    ('K4', 'group_kl.cu', 'gkl_tile'), ('K8', 'pixel_kl.cu', 'pkl_tile')])
def test_plan_constants_mirror_the_sources(kernel, source, loss):
    mod = KERNELS[kernel]
    src = (CSRC / source).read_text()
    body = src[src.index(f'struct {loss} {{'):]
    assert _constant(body, 'kRectMaps') == mod.RECT_MAPS
    assert _constant(body, 'kSrcMaps') == mod.SRC_MAPS
    assert _constant(body, 'kResident') == mod.BLOCKS_PER_SM
    # the source checks the wrapper's plan with its loss's counts
    assert f'tile_plan_ok<{loss}>(B, C, h, w, H, W, tile, rh, rw, smem, cpc)' \
        in src
    # the entry point takes the arguments the wrapper passes, and a stream
    entry = ' '.join(re.search(
        rf'extern "C" int {mod.BWD_KERNEL.symbol}\(([^)]*)\)',
        src).group(1).split())
    assert entry.count(',') + 1 == len(mod.BWD_KERNEL.argtypes) + 1
    assert entry.endswith('int tile, int rh, int rw, int smem, int cpc, '
                          'void* stream')
    common = (CSRC / 'common.cuh').read_text()
    assert _constant(common, 'kThreads') == tile_plan.GATHER_THREADS
    assert int(re.search(r'kTileBudget = (\d+) \* 1024;', common).group(1)) \
        * 1024 == tile_plan.TILE_BUDGET
    assert re.search(r'for \(int tile = 16; tile >= 4; tile /= 2\)', common)
    assert tile_plan.TILE_EDGES == (16, 8, 4)
    assert '4 * ((rect_maps + 1) * rh * (rw | 1) + tile * (rh | 1) +\n' \
        '              2 * src_maps * (tile + 2) * (tile + 2) + 2 * rh + ' \
        '2 * rw +\n              tile * (4 + ny + nx));' in common


def test_plans_at_the_bench_shape():
    """(8, 150, 128, 128) -> 512^2 on 132 SMs: 16 x 16 tiles, 71 x 71
    rectangles, 1536 blocks of 50 channels; K8 keeps two maps more than K4
    over the rectangle, K6 one source map fewer than K8."""
    shape = (8, 150, 128, 128, 512, 512)
    common = dict(tile=16, rh=71, rw=71, cpc=50, chunks=3, blocks=1536)
    assert gk.backward_plan(*shape) == dict(common, shared_bytes=32692)
    assert pk.backward_plan(*shape) == dict(common, shared_bytes=73020)
    # three K8 blocks and their reserved kilobyte fit an SM's 228 KB
    assert 3 * (73020 + 1024) <= tile_plan.SM_SHARED


# ---- the float64 model of the tile backward ---------------------------

def _dense(n_in, n_out):
    return _weights(0, n_in, 0, n_out, n_in, n_out).astype(np.float64)


def _upsample(x, H, W):
    """(B, C, H, W) float64 bilinear upsample with the float32 taps."""
    return np.einsum('yi,bcij,xj->bcyx', _dense(x.shape[2], H), x,
                     _dense(x.shape[3], W))


def _tiled_backward(xs, xt, out_hw, tile, grad_at, perm):
    """dx (B, C, h, w) as the tile kernel computes it: per image, tile and
    position, the rectangle's upsampled values of both maps from the tile
    and its one-element halo (local index i0 - (lo - 1), the second tap
    clamped to the last source), ``grad_at(b, pos, vs, vt, y0, x0)`` at the
    rectangle's outputs, summed back along x and then y with the tile's
    weights, written to source channel perm[pos]."""
    B, C, h, w = xs.shape
    H, W = out_hw
    dx = np.zeros_like(xs)
    pad = [np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1))) for x in (xs, xt)]
    ty_i0, _, ty_f = taps(h, H)
    tx_i0, _, tx_f = taps(w, W)
    for iy in range(-(-h // tile)):
        lo_y, n_y, o0y, on_y = tile_axis(iy, tile, h, H)
        if on_y == 0:
            continue
        wy = _weights(lo_y, n_y, o0y, on_y, h, H).astype(np.float64)
        a0 = ty_i0[o0y:o0y + on_y] - (lo_y - 1)
        a1 = np.minimum(a0 + 1, h - lo_y)
        fy = ty_f[o0y:o0y + on_y].astype(np.float64)[:, None]
        for ix in range(-(-w // tile)):
            lo_x, n_x, o0x, on_x = tile_axis(ix, tile, w, W)
            if on_x == 0:
                continue
            wx = _weights(lo_x, n_x, o0x, on_x, w, W).astype(np.float64)
            b0 = tx_i0[o0x:o0x + on_x] - (lo_x - 1)
            b1 = np.minimum(b0 + 1, w - lo_x)
            fx = tx_f[o0x:o0x + on_x].astype(np.float64)[None, :]
            vals = []
            for p in pad:
                # the tile and its halo (zero outside the map)
                blk = p[:, perm, lo_y:lo_y + tile + 2, lo_x:lo_x + tile + 2]
                top = (1 - fx) * blk[..., a0[:, None], b0[None, :]] \
                    + fx * blk[..., a0[:, None], b1[None, :]]
                bot = (1 - fx) * blk[..., a1[:, None], b0[None, :]] \
                    + fx * blk[..., a1[:, None], b1[None, :]]
                vals.append((1 - fy) * top + fy * bot)  # (B, C, on_y, on_x)
            for b in range(B):
                for pos in range(C):
                    g = grad_at(b, pos, vals[0][b, pos], vals[1][b, pos],
                                o0y, o0x)
                    dx[b, perm[pos], lo_y:lo_y + n_y, lo_x:lo_x + n_x] = \
                        wy.T @ (g @ wx)
    return dx


def _logsumexp(x, axis):
    m = x.max(axis=axis, keepdims=True)
    return (m + np.log(np.exp(x - m).sum(axis=axis, keepdims=True))).squeeze(
        axis)


def pixel_kl_model(xs, xt, out_hw, tau, gbar):
    """K8: the forward's per-pixel log-sum-exps of u / tau, then the tile
    backward of gbar / tau * (p_s - p_t)."""
    H, W = out_hw
    lse = [_logsumexp(_upsample(x, H, W) / tau, 1) for x in (xs, xt)]

    def grad_at(b, pos, vs, vt, y0, x0):
        ny, nx = vs.shape
        ls = lse[0][b, y0:y0 + ny, x0:x0 + nx]
        lt = lse[1][b, y0:y0 + ny, x0:x0 + nx]
        return (np.exp(vs / tau - ls) - np.exp(vt / tau - lt)) * gbar / tau

    tile = pk.backward_plan(*xs.shape, H, W)['tile']
    return _tiled_backward(xs, xt, out_hw, tile, grad_at,
                           np.arange(xs.shape[1]))


def group_kl_model(xs, xt, perm, out_hw, g, tau, gbar):
    """K4: the forward's per-(image, group) stats (the maxima of the
    group's source values, the sums Z of exp((u - m) / tau); -1e9 pad
    channels add nothing), folded into one log-sum-exp L = m / tau + log Z,
    then the tile backward of gbar / (tau B K) * (p_s - p_t) at each
    position, written to its source channel."""
    B, C = xs.shape[:2]
    H, W = out_hw
    K = -(-C // g)
    L = np.zeros((2, B, K))
    for i, x in enumerate((xs, xt)):
        up = _upsample(x, H, W)
        for b in range(B):
            for k in range(K):
                chans = perm[k * g:(k + 1) * g]
                m = x[b, chans].max()
                L[i, b, k] = m / tau + np.log(
                    np.exp((up[b, chans] - m) / tau).sum())

    def grad_at(b, pos, vs, vt, y0, x0):
        ls, lt = L[:, b, pos // g]
        return (np.exp(vs / tau - ls) - np.exp(vt / tau - lt)) * gbar \
            / (tau * B * K)

    tile = gk.backward_plan(*xs.shape, H, W)['tile']
    return _tiled_backward(xs, xt, out_hw, tile, grad_at, perm)


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32).astype(np.float64)
            for _ in range(2)]


def _held(got, want, hw, out_hw):
    exact = all((o / i) == 2 ** round(np.log2(o / i))
                for i, o in zip(hw, out_hw))
    tol = 1e-5 + (0 if exact else 2 * np.finfo(np.float32).eps * max(hw))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, (err, tol)


# (maps' shape, output size, group size): a pad group at ratio 2 (one
# tile), a non-integer ratio with tiles cut by the edge (16 x 16 tiles of
# 30 x 40), ratio ~11 (K4: 8 x 8 tiles, K8: 4 x 4, both cut)
MODEL_CASES = [((2, 7, 8, 8), (16, 16), 3),
               ((2, 6, 30, 40), (125, 161), 4),
               ((1, 5, 18, 22), (217, 231), 2)]


@pytest.mark.parametrize('shape,out_hw,g', MODEL_CASES)
def test_group_kl_tile_model_matches_autograd(shape, out_hw, g):
    xs, xt = _inputs(shape, 7)
    perm = np.random.RandomState(8).permutation(shape[1])
    tau, gbar = 2.0, 3.0
    got = group_kl_model(xs, xt, perm, out_hw, g, tau, gbar)
    a = torch.from_numpy(xs).requires_grad_()
    loss = gk.group_kl_plain(a, torch.from_numpy(xt), torch.from_numpy(perm),
                             out_hw, g, tau)
    (want,) = torch.autograd.grad(loss, a, torch.tensor(gbar))
    _held(got, want.numpy(), shape[2:], out_hw)


@pytest.mark.parametrize('shape,out_hw,g', MODEL_CASES)
def test_pixel_kl_tile_model_matches_autograd(shape, out_hw, g):
    del g
    xs, xt = _inputs(shape, 9)
    tau, gbar = 1.5, 0.5
    got = pixel_kl_model(xs, xt, out_hw, tau, gbar)
    a = torch.from_numpy(xs).requires_grad_()
    loss = pk.pixel_kl_plain(a, torch.from_numpy(xt), out_hw, tau)
    (want,) = torch.autograd.grad(loss, a, torch.tensor(gbar))
    _held(got, want.numpy(), shape[2:], out_hw)


def test_the_model_sees_a_wrong_group_or_position():
    """The limit tells the right indexing from a wrong one: the gradient
    written to the position's index in place of its source channel, or a
    permutation shifted by one group, misses it by far."""
    shape, out_hw, g = MODEL_CASES[1]
    xs, xt = _inputs(shape, 7)
    perm = np.random.RandomState(8).permutation(shape[1])
    a = torch.from_numpy(xs).requires_grad_()
    (want,) = torch.autograd.grad(
        gk.group_kl_plain(a, torch.from_numpy(xt), torch.from_numpy(perm),
                          out_hw, g, 2.0), a)
    want = want.numpy()
    unpermuted = group_kl_model(xs, xt, perm, out_hw, g, 2.0, 1.0)[:, perm]
    assert np.abs(unpermuted - want).max() > 0.1 * np.abs(want).max()
    shifted = group_kl_model(xs, xt, np.roll(perm, g), out_hw, g, 2.0, 1.0)
    assert np.abs(shifted - want).max() > 0.1 * np.abs(want).max()
