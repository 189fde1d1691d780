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
``torch.autograd.grad`` of ``group_kl_plain`` / ``pixel_kl_plain``;
(d) K4's two-geometry tile (a teacher of another size than the student):
its plan, the teacher's window of every rectangle within the plan's bound,
and the model with the teacher's values from that window through the
teacher's own taps, held to ``group_kl_plain``'s autograd and to the JAX
package's unfused ``KLDLoss`` (the limit of (c); the JAX gradient is
float32 as the plain one is), and missing it by far with a wrong teacher
tap.

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
import torch_port_threads  # noqa: F401  (torch threads a test worker)
from segdistill_tpu.distill.losses import KLDLoss as JaxKLDLoss
from test_torch_port_seg_ce_plan import _weights, readers, taps, tile_axis
from test_torch_port_tab5_ops import RESIZE, TWO_SIZES, _jax_loss_and_grad
from test_torch_port_tab5_ops import _maps as _tab5_maps

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
    # the two-geometry form (K4 at two sizes; K8 keeps its gather variant)
    assert _constant(common, 'kTileThreads') == tile_plan.TILE_THREADS
    assert _constant(common, 'kTileWinSlots') == tile_plan.TILE_WINDOW_SLOTS
    assert 'return tile_smem_bytes(tile, rh, rw, ny, nx, rect_maps, ' \
        'src_maps - 1) +\n         4 * (2 * ty * tx + 2 * rh + 2 * rw);' \
        in common
    assert 'const int ty = fwd_reach(rh, ht, H), tx = fwd_reach(rw, wt, W);' \
        '\n    if (ty * tx <= kTileWinSlots * kTileThreads &&' in common
    two = f'tile_plan_two_ok<{loss}>(B, C, h, w, ht, wt, H, W, tile, rh, rw,'
    if kernel == 'K4':
        assert _constant(body, 'kResidentTwo') == mod.BLOCKS_PER_SM_TWO
        assert ' '.join(two.split()) in ' '.join(src.split())
    else:
        assert 'tile_plan_two_ok' not in src and 'kResidentTwo' not in body


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
                     _dense(x.shape[3], W), optimize=True)


def window_axis(o0, on, n_in, n_out):
    """``window_axis`` of csrc/common.cuh: the teacher sources that the
    outputs [o0, o0 + on) read -> (lo, n, hi), hi the local index of the
    map's last source."""
    i0, i1, _ = taps(n_in, n_out)
    lo = int(i0[o0])
    return lo, int(i1[o0 + on - 1]) - lo + 1, n_in - 1 - lo


def _window_values(xt, perm, rect, out_hw, bound, shift=0):
    """(B, C, on_y, on_x) teacher values at the rectangle ``rect`` = (o0y,
    on_y, o0x, on_x) as the two-geometry block computes them: the
    teacher's window of the rectangle staged (within ``bound``, the plan's
    window), each output from the teacher's own taps, local to the window
    (i0 - lo, the second tap clamped to the map's last source). ``shift``
    1: every output reads the row below its own, within the window (a
    wrong teacher tap)."""
    ht, wt = xt.shape[2:]
    o0y, on_y, o0x, on_x = rect
    lo_y, n_y, hi_y = window_axis(o0y, on_y, ht, out_hw[0])
    lo_x, n_x, hi_x = window_axis(o0x, on_x, wt, out_hw[1])
    assert n_y <= bound[0] and n_x <= bound[1]
    win = xt[:, perm, lo_y:lo_y + n_y, lo_x:lo_x + n_x]
    iy, _, fy = taps(ht, out_hw[0])
    ix, _, fx = taps(wt, out_hw[1])
    a0 = np.minimum(iy[o0y:o0y + on_y] - lo_y + shift, n_y - 1)
    a1 = np.minimum(np.minimum(a0 + 1, hi_y), n_y - 1)
    b0 = ix[o0x:o0x + on_x] - lo_x
    b1 = np.minimum(b0 + 1, hi_x)
    fy = fy[o0y:o0y + on_y].astype(np.float64)[:, None]
    fx = fx[o0x:o0x + on_x].astype(np.float64)[None, :]
    top = (1 - fx) * win[..., a0[:, None], b0[None, :]] \
        + fx * win[..., a0[:, None], b1[None, :]]
    bot = (1 - fx) * win[..., a1[:, None], b0[None, :]] \
        + fx * win[..., a1[:, None], b1[None, :]]
    return (1 - fy) * top + fy * bot


def _tiled_backward(xs, xt, out_hw, tile, grad_at, perm, teacher_shift=0):
    """dx (B, C, h, w) as the tile kernel computes it: per image, tile and
    position, the rectangle's upsampled values of both maps from the tile
    and its one-element halo (local index i0 - (lo - 1), the second tap
    clamped to the last source), ``grad_at(b, pos, vs, vt, y0, x0)`` at the
    rectangle's outputs, summed back along x and then y with the tile's
    weights, written to source channel perm[pos]. A teacher of another
    size: its values from its window of the rectangle
    (:func:`_window_values`, ``teacher_shift`` passed on), the two-geometry
    form."""
    B, C, h, w = xs.shape
    H, W = out_hw
    dx = np.zeros_like(xs)
    two = xt.shape[2:] != xs.shape[2:]
    bound = tile_plan.teacher_window(tile, h, w, *xt.shape[2:], H, W)
    pad = [np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)))
           for x in ((xs,) if two else (xs, xt))]
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
            if two:
                vals.append(_window_values(xt, perm, (o0y, on_y, o0x, on_x),
                                           out_hw, bound, teacher_shift))
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


def group_kl_model(xs, xt, perm, out_hw, g, tau, gbar, teacher_shift=0):
    """K4: the forward's per-(image, group) stats (the maxima of the
    group's source values, the sums Z of exp((u - m) / tau); -1e9 pad
    channels add nothing), folded into one log-sum-exp L = m / tau + log Z,
    then the tile backward of gbar / (tau B K) * (p_s - p_t) at each
    position, written to its source channel; with a teacher of another
    size, the two-geometry tile of the plan (``teacher_shift``: see
    :func:`_window_values`)."""
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

    tile = gk.backward_plan(*xs.shape, H, W, teacher_hw=xt.shape[2:])['tile']
    assert tile, 'the model is of the tile variants'
    return _tiled_backward(xs, xt, out_hw, tile, grad_at, perm,
                           teacher_shift)


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


# ---- K4's two-geometry tile: a teacher of another size --------------------

# (B, C, student hw, teacher hw, output hw, group size) of the models: the
# PSP pair's ratios (8 and 4) at a narrow width, one tile; the same ratios
# at the PSP maps' full size with two channels (4 x 4 tiles of 16, 139 x
# 139 rectangles, 39 x 39 windows); and tab5_ops's TWO_SIZES: a pad group,
# odd sizes with the teacher smaller on one axis, a teacher smaller than
# the student
TWO_MODEL_CASES = [(2, 10, (8, 8), (16, 16), (64, 64), 5),
                   (1, 2, (64, 64), (128, 128), (512, 512), 1)] + [
    (B, C, hs, ht, out_hw, 5) for B, C, hs, ht, out_hw in TWO_SIZES]
# ... and downsampling on both maps (tiles no output reads: empty windows)
TWO_PLAN_SHAPES = [(c[1], c[2], c[3]) for c in
                   kernel_cases.GROUP_KL_TWO_SIZE_CASES] + [
    ((B, C) + hs, ht, out_hw) for B, C, hs, ht, out_hw, _ in TWO_MODEL_CASES
] + [((2, 5, 64, 48), (32, 24), (24, 20))]


@pytest.mark.parametrize('shape,thw,out_hw', TWO_PLAN_SHAPES,
                         ids=['x'.join(map(str, s[2:] + t + o))
                              for s, t, o in TWO_PLAN_SHAPES])
def test_two_geometry_backward_plan(shape, thw, out_hw):
    """The largest edge whose teacher window the block stages and whose
    block fits the budget; every tile's rectangle reads a teacher window
    within the plan's; every element has one owner."""
    B, C, h, w = shape
    H, W = out_hw
    plan = gk.backward_plan(*shape, H, W, 132, thw)
    assert plan == gk.backward_plan(*shape, H, W, teacher_hw=thw)

    def fits(t):
        ty, tx = tile_plan.teacher_window(t, h, w, *thw, H, W)
        return ty * tx <= tile_plan.TILE_WINDOW_SLOTS * 512 and \
            tile_plan.two_shared_bytes(t, h, w, *thw, H, W, gk.RECT_MAPS,
                                       gk.SRC_MAPS) <= tile_plan.TILE_BUDGET
    tile = plan['tile']
    assert [t for t in tile_plan.TILE_EDGES if fits(t)][:1] == \
        ([tile] if tile else [])
    if tile == 0:
        assert plan == tile_plan.gather_plan(B, C, h, w)
        return
    assert plan['shared_bytes'] == tile_plan.two_shared_bytes(
        tile, h, w, *thw, H, W, gk.RECT_MAPS, gk.SRC_MAPS)
    ty, tx = tile_plan.teacher_window(tile, h, w, *thw, H, W)
    for n_in, n_out, t_in, reach in ((h, H, thw[0], ty), (w, W, thw[1], tx)):
        for index in range(-(-n_in // tile)):
            _, _, o0, on = tile_axis(index, tile, n_in, n_out)
            if on:
                lo, n, _ = window_axis(o0, on, t_in, n_out)
                i0, i1, _ = taps(t_in, n_out)
                assert n <= reach and lo == i0[o0:o0 + on].min() \
                    and lo + n - 1 == i1[o0:o0 + on].max()
    perm = np.random.RandomState(C).permutation(C)
    count = np.zeros((B, C, h, w), np.int64)
    tiles_y, tiles_x = -(-h // tile), -(-w // tile)
    for blk in range(plan['blocks']):
        t, chunk = divmod(blk, plan['chunks'])
        t, tile_x = divmod(t, tiles_x)
        b, tile_y = divmod(t, tiles_y)
        for pos in range(chunk * plan['cpc'],
                         min(chunk * plan['cpc'] + plan['cpc'], C)):
            count[b, perm[pos], tile_y * tile:(tile_y + 1) * tile,
                  tile_x * tile:(tile_x + 1) * tile] += 1
    assert (count == 1).all()


def test_the_two_size_cases_plan_the_variants_they_name():
    """Each case's K3 rows and K4 edge, on 132 and 108 SMs; the two-geometry
    tiles and each gather variant at least once."""
    cases = kernel_cases.GROUP_KL_TWO_SIZE_CASES
    for name, shape, thw, out_hw, _, _, oh, tile in cases:
        assert gk.forward_plan(*shape[2:], *out_hw, thw)['oh'] == oh, name
        for sms in (132, 108):
            assert gk.backward_plan(*shape, *out_hw, sms, thw)['tile'] \
                == tile, name
    assert any(c[6] and c[7] for c in cases)
    assert any(not c[6] for c in cases) and any(not c[7] for c in cases)


def test_two_geometry_plan_at_the_psp_shape():
    """(2, 150, 64, 64) against a 128 x 128 teacher -> 512²: tiles of 16,
    139 x 139 rectangles, 39 x 39 teacher windows, 256 blocks of 19
    positions at two an SM."""
    plan = gk.backward_plan(2, 150, 64, 64, 512, 512, 132, (128, 128))
    assert plan == dict(tile=16, rh=139, rw=139, shared_bytes=108076,
                        cpc=19, chunks=8, blocks=256)
    assert tile_plan.teacher_window(16, 64, 64, 128, 128, 512, 512) == \
        (39, 39)
    assert 2 * (108076 + 1024) <= tile_plan.SM_SHARED


@pytest.fixture(scope='module')
def two_model_inputs():
    """Per case: the maps (float32 values in float64), the permutation,
    the JAX ``KLDLoss``'s permutation-free loss and gradient and
    ``group_kl_plain``'s autograd gradient; tau 2, gradient 1."""
    import jax
    out = {}
    for case in TWO_MODEL_CASES:
        B, C, hs, ht, out_hw, g = case
        xs, xt = (a.astype(np.float64) for a in _tab5_maps(B, C, hs, ht, 5))
        crit = JaxKLDLoss(alpha=1, tau=2, resize_config=RESIZE,
                          shuffle_config={'interval': 1000},
                          transform_config={'loss_type': 'channel',
                                            'group_size': g})
        key = jax.random.key(4)
        perm = np.asarray(crit._shuffle_idx(C, 1000, key))
        _, djax = _jax_loss_and_grad(crit, xs.astype(np.float32),
                                     xt.astype(np.float32), out_hw, key=key)
        a = torch.from_numpy(xs).requires_grad_()
        loss = gk.group_kl_plain(a, torch.from_numpy(xt),
                                 torch.from_numpy(perm.copy()), out_hw, g,
                                 2.0)
        (dplain,) = torch.autograd.grad(loss, a)
        out[case] = xs, xt, perm, np.asarray(djax, np.float64), \
            dplain.numpy()
    return out


@pytest.mark.parametrize('case', TWO_MODEL_CASES,
                         ids=['x'.join(map(str, c[2] + c[3] + c[4]))
                              for c in TWO_MODEL_CASES])
def test_group_kl_two_geometry_model_matches_plain_and_jax(
        case, two_model_inputs):
    B, C, hs, ht, out_hw, g = case
    xs, xt, perm, djax, dplain = two_model_inputs[case]
    got = group_kl_model(xs, xt, perm, out_hw, g, 2.0, 1.0)
    _held(got, dplain, hs, out_hw)
    _held(got, djax, hs, out_hw)


def test_group_kl_two_geometry_model_sees_a_wrong_teacher_tap(
        two_model_inputs):
    """Each output reading the teacher's row below its own misses the limit
    by far, at the narrow PSP pair and at the PSP maps' size."""
    for case in TWO_MODEL_CASES[:2]:
        B, C, hs, ht, out_hw, g = case
        xs, xt, perm, _, want = two_model_inputs[case]
        wrong = group_kl_model(xs, xt, perm, out_hw, g, 2.0, 1.0,
                               teacher_shift=1)
        assert np.abs(wrong - want).max() > 0.1 * np.abs(want).max(), case
