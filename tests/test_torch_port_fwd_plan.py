"""K3's, K5's and K7's forward on output tiles (``fwd_tile`` in
``csrc/common.cuh`` with the losses ``gkl_fwd_tile``, ``ce_fwd_tile`` and
``pkl_fwd_tile``): the launch planning (``ops/tile_plan.py::forward_plan``
through each module's ``forward_plan``) and a model of the kernels'
arithmetic, on the CPU.

A block owns ``oh`` x 64 outputs; the sources they read form one window an
axis (``fwd_axis``: the first output's first tap to the last output's
second), whose size the plan bounds (``fwd_reach``). Here (a) with the taps
computed in numpy float32 as the source computes them (and as a fused
multiply-add computes the position), every output's four taps lie in its
tile's window, and the window fits the plan's bound, at every shape of
``tools/kernel_cases.py`` and more axes; (b) the plan names the tile where
a step's windows fit the block's staging and the gather variant elsewhere,
each variant at two case shapes or more; (c) the constants the planner and
the sources share are read from the sources; (d) a float64 numpy model of
the kernels, tile by tile as the plan cuts the outputs (the window staged,
a thread walking its column and x-lerping a source row only when the y tap
moves on, K5's channels in chunks of 8 with one rescale a chunk and the
first maximum as argmax, K7's channels of both maps in chunks of 4 with
one rescale of each map's exp-sum and of the cross term a chunk and the pad
units of the last chunk, the partials merged in block order), equals the
plain versions (``group_kl_plain``, ``seg_ce_plain``, ``pixel_kl_plain``:
loss, ce_sum, correct, kl_sum) and a direct float64 evaluation (stats, m,
se, the log-sum-exps), and once the JAX functions in interpret mode.

Limits of (d): the model and the direct evaluation share the float64
upsampled values up to the order of the lerps, 1e-12 relative; the plain
versions run in float32, whose upsample and sums over 10^3-10^5 values
carry ~1e-6, so the loss and ce_sum are held to 1e-5 relative (the JAX
kernels' too). ``correct`` counts argmaxes, which float32 and float64 agree
on but for near-ties: exactly equal at these seeds, and on inputs that are
multiples of 1/8 at ratio 4, where every lerp is exact in both, with many
exact ties, the first maximum must win in both.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segdistill_tpu.ops.pallas import (
    fused_group_kl_shuffled as jax_group_kl_shuffled)
from segdistill_tpu.ops.pallas.pixel_kl import fused_pixel_kl as jax_pixel_kl
from segdistill_tpu.ops.pallas.seg_ce import fused_seg_ce as jax_seg_ce
from segdistill_tpu_torch.ops import group_kl as gk
from segdistill_tpu_torch.ops import pixel_kl as pk
from segdistill_tpu_torch.ops import seg_ce as sc
from segdistill_tpu_torch.ops import tile_plan
from segdistill_tpu_torch.tools import kernel_cases

import torch_port_threads  # noqa: F401  (torch threads a test worker)
from segdistill_tpu.distill.losses import KLDLoss as JaxKLDLoss
from test_torch_port_seg_ce_plan import AXES, taps
from test_torch_port_tab5_ops import RESIZE
from test_torch_port_tab5_ops import _maps as _tab5_maps
from test_torch_port_tile_plan import TWO_MODEL_CASES

CSRC = Path(tile_plan.__file__).resolve().parent.parent / 'csrc'
KERNELS = {'K3': gk, 'K5': sc, 'K7': pk}
LN2 = float(np.log(2.0))
LOG2E = float(np.log2(np.e))

CASE_SHAPES = {
    'K3': [c[1] + c[2] for c in kernel_cases.GROUP_KL_CASES]
    + [c[1] + c[2] for c in kernel_cases.GROUP_KL_SPREAD_CASES],
    'K5': [c[1] + c[2] for c in kernel_cases.SEG_CE_CASES]
    + [c[1] + c[2] for c in kernel_cases.SEG_CE_SPREAD_CASES]
    + [c[1] + c[2] for c in kernel_cases.SEG_CE_TIE_CASES],
    'K7': [c[1] + c[2] for c in kernel_cases.PIXEL_KL_CASES]
    + [c[1] + c[2] for c in kernel_cases.PIXEL_KL_SPREAD_CASES]
    + [c[1] + c[2] for c in kernel_cases.PIXEL_KL_TAU_CASES]}
EXTRA_SHAPES = [(16, 150, 128, 128, 512, 512), (4, 21, 60, 60, 473, 473),
                (1, 3, 4, 4, 512, 512), (2, 19, 256, 256, 512, 512),
                (1, 150, 64, 64, 512, 512)]
PLAN_CASES = [(k, s) for k, shapes in CASE_SHAPES.items()
              for s in shapes + EXTRA_SHAPES]


@functools.lru_cache(maxsize=None)
def _taps(n_in, n_out):
    return taps(n_in, n_out)


def _taps_fma(n_in, n_out):
    """The taps with the position rounded once, as a fused multiply-add
    of (dst + 0.5) * scale - 0.5 gives it."""
    scale = np.float32(n_in) / np.float32(n_out)
    dst = np.arange(n_out, dtype=np.float64)
    src = np.maximum(((dst + 0.5) * np.float64(scale) - 0.5)
                     .astype(np.float32), np.float32(0.0))
    i0 = np.minimum(src.astype(np.int64), n_in - 1)
    return i0, np.minimum(i0 + 1, n_in - 1)


def fwd_axis(o0, on, n_in, n_out):
    """``fwd_axis`` of csrc/common.cuh: -> (lo, n, hi)."""
    i0, i1, _ = _taps(n_in, n_out)
    lo = int(i0[o0])
    return lo, int(i1[o0 + on - 1]) - lo + 1, n_in - 1 - lo


def _starts(n_out, edge):
    return [(o0, min(edge, n_out - o0)) for o0 in range(0, n_out, edge)]


@pytest.mark.parametrize('n_in,n_out', AXES + [(128, 512), (8, 320),
                                               (6, 300), (10, 300)])
@pytest.mark.parametrize('edge', [tile_plan.FWD_COLS, 4 * gk.FWD_ROWS,
                                  4 * sc.FWD_ROWS, 4 * pk.FWD_ROWS])
def test_every_tap_lies_in_its_tiles_window(n_in, n_out, edge):
    reach = tile_plan.fwd_reach(edge, n_in, n_out)
    for i0, i1 in (_taps(n_in, n_out)[:2], _taps_fma(n_in, n_out)):
        for o0, on in _starts(n_out, edge):
            lo, n, hi = fwd_axis(o0, on, n_in, n_out)
            assert 0 <= lo and lo + n <= n_in and hi == n_in - 1 - lo
            assert n <= reach
            sl = slice(o0, o0 + on)
            assert (i0[sl] >= lo).all() and (i1[sl] < lo + n).all()


@pytest.mark.parametrize('kernel,shape', PLAN_CASES,
                         ids=[f'{k}-' + 'x'.join(map(str, s))
                              for k, s in PLAN_CASES])
def test_forward_plan(kernel, shape):
    mod = KERNELS[kernel]
    _, _, h, w, H, W = shape
    plan = mod.forward_plan(h, w, H, W)
    oh = 4 * mod.FWD_ROWS
    wy, wx = tile_plan.fwd_reach(oh, h, H), tile_plan.fwd_reach(64, w, W)
    if wy * wx > mod.FWD_SLOTS * 256:  # the gather variant
        assert plan == dict(oh=0, wy=0, wx=0, shared_bytes=0, tiles=0)
        return
    assert plan == dict(oh=oh, wy=wy, wx=wx, tiles=-(-H // oh) * -(-W // 64),
                        shared_bytes=4 * (2 * mod.FWD_UNITS * wy * wx
                                          + 2 * oh))
    # every tile's window fits the plan's, and the staging slots hold it
    for o0, on in _starts(H, oh):
        assert fwd_axis(o0, on, h, H)[1] <= wy
    for o0, on in _starts(W, 64):
        assert fwd_axis(o0, on, w, W)[1] <= wx
    # no opt-in for more than 48 KB of shared memory is made
    assert plan['shared_bytes'] <= 48 * 1024


def test_plans_at_the_bench_shape():
    """(8, 150, 128, 128) -> 512²: K3 128 x 64 tiles, 36 x 20 windows, 32
    tiles a group (3,840 blocks), three staging slots a map; K5 32 x 64
    tiles, 12 x 20 windows, 128 tiles an image (1,024 blocks), one slot a
    channel."""
    assert gk.forward_plan(128, 128, 512, 512) == dict(
        oh=128, wy=36, wx=20, shared_bytes=12544, tiles=32)
    # the PSP pair, (2, 150, 64, 64) against a 128 x 128 teacher: the
    # student's 20 x 12 window and the teacher's 36 x 20, one slot a map each
    assert gk.forward_plan(64, 64, 512, 512, (128, 128)) == dict(
        oh=128, wy=20, wx=12, shared_bytes=4 * (2 * 240 + 256)
        + 4 * (2 * 720 + 256), tiles=32)
    assert sc.forward_plan(128, 128, 512, 512) == dict(
        oh=32, wy=12, wx=20, shared_bytes=15616, tiles=128)


def test_k7_plan_at_the_bench_shape():
    """K7 at (8, 150, 128, 128) -> 512²: 32 x 64 tiles, 12 x 20 windows,
    128 tiles an image (1,024 blocks), one staging slot a unit (8 units:
    4 channels of both maps)."""
    assert pk.forward_plan(128, 128, 512, 512) == dict(
        oh=32, wy=12, wx=20, shared_bytes=15616, tiles=128)


def test_the_pixel_kl_cases_name_k7s_variant():
    """The K7 cases name the tile rows the plan chooses (0: the gather
    variant), the gather at least twice, a tile cut by the map's edge."""
    cases = kernel_cases.PIXEL_KL_CASES + kernel_cases.PIXEL_KL_SPREAD_CASES \
        + kernel_cases.PIXEL_KL_TAU_CASES
    for name, shape, out_hw, _, oh, *_ in cases:
        assert pk.forward_plan(*shape[2:], *out_hw)['oh'] == oh, name
    assert sum(c[4] == 0 for c in cases) >= 2
    assert any(c[4] and c[2][0] % c[4] for c in cases)


def test_the_case_lists_plan_every_forward_variant():
    """Each forward variant (the tile and the gather) at two case shapes
    or more per kernel, the tile once with tiles cut by the map's edge."""
    for kernel, shapes in CASE_SHAPES.items():
        mod = KERNELS[kernel]
        seen = {True: [], False: []}
        for _, _, h, w, H, W in shapes:
            oh = mod.forward_plan(h, w, H, W)['oh']
            seen[bool(oh)].append(bool(oh) and bool(H % oh or W % 64))
        assert len(seen[True]) >= 2 and any(seen[True]), kernel
        assert len(seen[False]) >= 2, kernel


def _constant(src, name):
    return int(re.search(rf'{name} = (\d+)', src).group(1))


@pytest.mark.parametrize('kernel,source,loss', [
    ('K3', 'group_kl.cu', 'gkl_fwd_tile'), ('K5', 'seg_ce.cu', 'ce_fwd_tile'),
    ('K7', 'pixel_kl.cu', 'pkl_fwd_tile')])
def test_forward_constants_mirror_the_sources(kernel, source, loss):
    mod = KERNELS[kernel]
    src = (CSRC / source).read_text()
    body = src[src.index(f'struct {loss} {{'):]
    assert _constant(body, 'kUnits') == mod.FWD_UNITS
    assert _constant(body, 'kRows') == mod.FWD_ROWS
    assert _constant(body, 'kSlots') == mod.FWD_SLOTS
    # the source checks the wrapper's plan with its loss's counts
    assert f'fwd_plan_ok<{loss}<float>>(h, w, H, W, oh, wy, wx, smem)' in src
    # the entry point takes the arguments the wrapper passes, and a stream
    entry = ' '.join(re.search(
        rf'extern "C" int {mod.FWD_KERNEL.symbol}\(([^)]*)\)',
        src).group(1).split())
    assert entry.count(',') + 1 == len(mod.FWD_KERNEL.argtypes) + 1
    assert 'int oh, int wy, int wx, int smem' in entry
    common = (CSRC / 'common.cuh').read_text()
    assert _constant(common, 'kFwdThreads') == tile_plan.FWD_THREADS
    assert _constant(common, 'kFwdCols') == tile_plan.FWD_COLS
    assert 'static_cast<long long>(on - 1) * in + out - 1) / out + 4;' \
        in common
    assert 'return 4 * (2 * units * wy * wx + 2 * oh);' in common
    assert 'fwd_reach(oh, h, H) * fwd_reach(kFwdCols, w, W) <=\n' \
        '                 slots * kFwdThreads' in common
    # the two-geometry form (K3 at two sizes; K7 keeps its gather variant):
    # both windows must fit, each map's half of the units on its own window
    assert 'return plan_fwd(h, w, H, W, rows, slots) &&\n' \
        '                 plan_fwd(ht, wt, H, W, rows, slots)' in common
    assert 'return fwd_smem_bytes(units / 2, oh, wy, wx) +\n' \
        '         fwd_smem_bytes(units / 2, oh, ty, tx);' in common
    two = f'fwd_plan_two_ok<{loss}<float>>(h, w, ht, wt, H, W, oh, wy,'
    if kernel == 'K3':
        assert ' '.join(two.split()) in ' '.join(src.split())
    else:
        assert 'fwd_plan_two_ok' not in src


# ---- the float64 model of the forward ----------------------------------

def _tiles(H, W, oh):
    """The blocks of one slice in launch order: (oy0, ox0, rows, cols)."""
    return [(oy0, ox0, min(oh, H - oy0), min(64, W - ox0))
            for oy0 in range(0, H, oh) for ox0 in range(0, W, 64)]


def walk(win, a0s, fys, hi, b0, b1, fx):
    """One segment of threads walking down their columns: ``win`` (U, ny,
    nx) the staged windows, (a0s, fys) the segment's rows' y taps (local),
    (b0, b1, fx) each column's x tap. The walk keeps the x-lerped row a0
    (top) and row a1 less it (d); a value is top + fy d. -> values (U,
    rows, cols) and how many source rows were x-lerped: a row only where
    the y tap moved on."""
    def xlerp(a):
        return win[:, a, b0] + fx * (win[:, a, b1] - win[:, a, b0])
    at, top, d, lerps, out = -2, None, None, 0, []
    for a0, fy in zip(a0s, fys):
        a1 = min(a0 + 1, hi)
        if a0 != at:
            if a0 == at + 1:
                top = top + d
            else:
                top, lerps = xlerp(a0), lerps + 1
            d, lerps, at = xlerp(a1) - top, lerps + 1, a0
        out.append(top + fy * d)
    # once per source row the walk stands between (the map's last row,
    # where both taps name it, twice)
    assert lerps <= len(set(a0s) | {min(a + 1, hi) for a in a0s}) + 1
    return np.stack(out, 1), lerps


def _tile_values(maps, h, w, H, W, oh, rows_per_thread, tile, shift=0):
    """The upsampled values of ``maps`` (U, h, w) float64 at one tile, as
    the block computes them: the window staged, each segment of threads
    walking ``rows_per_thread`` rows. -> (U, rows, cols), x-lerps.
    ``shift`` 1: every row reads the source row below its own, within the
    window (a wrong tap)."""
    oy0, ox0, rows, cols = tile
    lo_y, ny, hi_y = fwd_axis(oy0, rows, h, H)
    lo_x, nx, _ = fwd_axis(ox0, cols, w, W)
    assert ny <= tile_plan.fwd_reach(oh, h, H)
    assert nx <= tile_plan.fwd_reach(64, w, W)
    win = maps[:, lo_y:lo_y + ny, lo_x:lo_x + nx]
    ty0, _, tyf = _taps(h, H)
    tx0, tx1, txf = _taps(w, W)
    b0 = tx0[ox0:ox0 + cols] - lo_x
    b1 = tx1[ox0:ox0 + cols] - lo_x
    fx = txf[ox0:ox0 + cols].astype(np.float64)
    hi = min(hi_y, ny - 1) if shift else hi_y
    vals, lerps = [], 0
    for r0 in range(0, rows, rows_per_thread):
        sl = slice(oy0 + r0, oy0 + min(r0 + rows_per_thread, rows))
        a0s = [min(a + shift, hi) for a in ty0[sl] - lo_y]
        v, n = walk(win, a0s, list(tyf[sl].astype(np.float64)), hi, b0, b1,
                    fx)
        vals.append(v)
        lerps += n
    return np.concatenate(vals, 1), lerps


def group_kl_fwd_model(xs, xt, perm, out_hw, g, tau, oh=None,
                       teacher_shift=0):
    """K3 in float64: -> (loss, stats (B, K, 4), x-lerps a value). Per
    (image, group) the source maxima, then per tile (``oh`` rows, by
    default the tile variant's, at any ratio) the window of every
    position's channel of both maps, the walk, and with a = u log2 e / tau
    less the maximum's the sums (2^a_s, 2^a_t, 2^a_t (a_t - a_s)); the
    tiles' partials summed in tile order, the groups' KLs in group
    order. A teacher of another size (the two-geometry form): each map's
    window and walk from its own taps (``teacher_shift``: the teacher's
    rows read one source row low, see :func:`_tile_values`)."""
    B, C, h, w = xs.shape
    ht, wt = xt.shape[2:]
    H, W = out_hw
    K = -(-C // g)
    oh = oh or 4 * gk.FWD_ROWS
    k2 = LOG2E / tau
    stats, kl, lerps = np.zeros((B, K, 4)), np.zeros((B, K)), 0
    for b in range(B):
        for k in range(K):
            chans = perm[k * g:(k + 1) * g]  # the pad positions: skipped
            L = len(chans)
            ms, mt = xs[b, chans].max(), xt[b, chans].max()
            parts = []
            for tile in _tiles(H, W, oh):
                if (ht, wt) == (h, w):
                    maps = np.concatenate([xs[b, chans], xt[b, chans]])
                    v, n = _tile_values(maps, h, w, H, W, oh, gk.FWD_ROWS,
                                        tile)
                    vs, vt = v[:L], v[L:]
                else:
                    vs, n = _tile_values(xs[b, chans], h, w, H, W, oh,
                                         gk.FWD_ROWS, tile)
                    vt, n_t = _tile_values(xt[b, chans], ht, wt, H, W, oh,
                                           gk.FWD_ROWS, tile, teacher_shift)
                    n += n_t
                lerps += n
                a_s, a_t = vs * k2 - ms * k2, vt * k2 - mt * k2
                e_t = np.exp2(a_t)
                parts.append((np.exp2(a_s).sum(), e_t.sum(),
                              (e_t * (a_t - a_s)).sum()))
            zs, zt, w2 = np.sum(parts, 0)
            stats[b, k] = ms, mt, zs, zt
            kl[b, k] = w2 * LN2 / zt - np.log(zt) + np.log(zs)
    return kl.sum() / (B * K), stats, lerps / (2 * C * B * H * W)


def seg_ce_fwd_model(z, labels, out_hw, classes, ignore=255, oh=None):
    """K5 in float64: -> (ce_sum, correct, m, se). Per image and tile the
    windows of all channels (those past C: -1e30) and the walk; per pixel
    the channels in chunks of 8: the chunk's maximum, se rescaled once to
    the new m, 2^(v log2 e - m log2 e) per value, the argmax the chunk's
    first maximum (found from the back) where it beats m strictly; at the
    end the label's logit from its four taps; the blocks' (ce_sum, correct)
    summed in block order."""
    B, C, h, w = z.shape
    H, W = out_hw
    oh = oh or 4 * sc.FWD_ROWS
    U = sc.FWD_UNITS
    m_out, se_out = np.zeros((B, H, W)), np.zeros((B, H, W))
    # the label logit at every pixel, lerped from its four taps
    up = _upsample(z, H, W)
    parts = []
    for b in range(B):
        for tile in _tiles(H, W, oh):
            oy0, ox0, rows, cols = tile
            v, _ = _tile_values(z[b], h, w, H, W, oh, sc.FWD_ROWS, tile)
            lab = labels[b, oy0:oy0 + rows, ox0:ox0 + cols]
            m = np.full((rows, cols), -np.inf)
            se = np.zeros((rows, cols))
            best = np.zeros((rows, cols), np.int64)
            for c0 in range(0, C, U):
                x = np.full((U, rows, cols), -1e30)
                x[:min(U, C - c0)] = v[c0:c0 + U]
                cm = x.max(0)
                first = np.zeros((rows, cols), np.int64)
                for u in range(U - 1, -1, -1):
                    first = np.where(x[u] == cm, u, first)
                m_new = np.maximum(m, cm)
                best = np.where(cm > m, c0 + first, best)
                se = se * np.exp2((m - m_new) * LOG2E) + np.exp2(
                    x * LOG2E - m_new * LOG2E).sum(0)
                m = m_new
            iy, ix = np.ogrid[oy0:oy0 + rows, ox0:ox0 + cols]
            zy = up[b, np.clip(lab, 0, C - 1), iy, ix]
            m_out[b, oy0:oy0 + rows, ox0:ox0 + cols] = m
            se_out[b, oy0:oy0 + rows, ox0:ox0 + cols] = se
            valid = (lab != ignore) & (lab >= 0) & (lab < classes)
            parts.append(((m + np.log(se) - zy)[valid].sum(),
                          (valid & (best == lab)).sum()))
    ce, correct = np.sum(parts, 0)
    return ce, correct, m_out, se_out


def _dense(n_in, n_out):
    """(n_out, n_in) float64 bilinear weights with the float32 taps."""
    i0, i1, f = _taps(n_in, n_out)
    d = np.zeros((n_out, n_in))
    np.add.at(d, (np.arange(n_out), i0), 1 - f.astype(np.float64))
    np.add.at(d, (np.arange(n_out), i1), f.astype(np.float64))
    return d


def _upsample(x, H, W):
    return np.einsum('yi,bcij,xj->bcyx', _dense(x.shape[2], H), x,
                     _dense(x.shape[3], W), optimize=True)


def _maps(shape, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * scale).astype(np.float32).astype(np.float64)
            for _ in range(2)]


# (maps' shape, output size, group size): a pad group (one tile), a
# non-integer ratio with tiles cut by the edge, odd sizes, ratio ~8 and ~30,
# and the tile arithmetic at ratio 1 and under downsampling, where the plan
# names the gather variant
KL_MODEL_CASES = [((2, 7, 8, 8), (16, 16), 3),
                  ((2, 6, 30, 40), (125, 161), 4),
                  ((1, 5, 31, 33), (97, 130), 2),
                  ((2, 5, 21, 19), (190, 150), 3),
                  ((1, 3, 10, 9), (300, 270), 2),
                  ((2, 5, 40, 40), (40, 40), 3),
                  ((2, 5, 64, 48), (24, 20), 2)]


@pytest.mark.parametrize('shape,out_hw,g', KL_MODEL_CASES)
@pytest.mark.parametrize('scale', [1.0, 30.0])
def test_group_kl_forward_model_matches_plain(shape, out_hw, g, scale):
    xs, xt = _maps(shape, 11, scale)
    perm = np.random.RandomState(12).permutation(shape[1])
    tau = 2.0
    loss, stats, _ = group_kl_fwd_model(xs, xt, perm, out_hw, g, tau)
    want = gk.group_kl_plain(torch.from_numpy(xs), torch.from_numpy(xt),
                             torch.from_numpy(perm), out_hw, g, tau).item()
    assert loss == pytest.approx(want, rel=1e-5, abs=1e-7)
    # the stats against the direct sums over the group's upsampled values
    B, C = shape[:2]
    for i, x in enumerate((xs, xt)):
        up = _upsample(x, *out_hw)
        for b in range(B):
            for k in range(-(-C // g)):
                chans = perm[k * g:(k + 1) * g]
                m = x[b, chans].max()
                assert stats[b, k, i] == m
                z = np.exp((up[b, chans] - m) / tau).sum()
                assert stats[b, k, 2 + i] == pytest.approx(z, rel=1e-12)


# (logits' shape, labels' size): as for K3, with 150 channels at odd sizes
CE_MODEL_CASES = [((2, 19, 8, 8), (32, 32)),
                  ((2, 21, 30, 40), (125, 161)),
                  ((1, 150, 31, 33), (97, 130)),
                  ((2, 7, 16, 16), (128, 128)),
                  ((2, 19, 10, 9), (300, 270)),
                  ((2, 19, 40, 40), (40, 40)),
                  ((2, 13, 64, 48), (24, 20))]


def _labels(shape, out_hw, seed, ignored=0.1):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, shape[1], (shape[0],) + out_hw)
    labels[rng.rand(*labels.shape) < ignored] = 255
    return labels


@pytest.mark.parametrize('shape,out_hw', CE_MODEL_CASES)
@pytest.mark.parametrize('scale', [1.0, 30.0])
def test_seg_ce_forward_model_matches_plain(shape, out_hw, scale):
    z, _ = _maps(shape, 13, scale)
    labels = _labels(shape, out_hw, 14)
    ce, correct, m, se = seg_ce_fwd_model(z, labels, out_hw, shape[1])
    want, want_correct = sc.seg_ce_plain(
        torch.from_numpy(z), torch.from_numpy(labels), out_hw, shape[1])
    assert ce == pytest.approx(want.item(), rel=1e-5)
    assert correct == want_correct.item()
    up = _upsample(z, *out_hw)
    np.testing.assert_allclose(m, up.max(1), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        se, np.exp(up - up.max(1, keepdims=True)).sum(1), rtol=1e-10)


def test_seg_ce_forward_model_first_maximum_wins():
    """Logits that are multiples of 1/8 in [-1, 1] at ratio 4: every lerp
    is exact in float32 and float64, so equal channels tie exactly (a
    channel duplicated, and many ties besides); labels name the later of a
    tied pair, so a last-maximum argmax would count other pixels."""
    shape, out_hw = (2, 19, 8, 8), (32, 32)
    rng = np.random.RandomState(15)
    z = rng.randint(-8, 9, shape).astype(np.float64) / 8
    z[:, 11] = z[:, 4]
    labels = _labels(shape, out_hw, 16)
    labels[:, ::2] = 11
    ce, correct, _, _ = seg_ce_fwd_model(z, labels, out_hw, shape[1])
    want, want_correct = sc.seg_ce_plain(
        torch.from_numpy(z), torch.from_numpy(labels), out_hw, shape[1])
    assert ce == pytest.approx(want.item(), rel=1e-5)
    assert correct == want_correct.item()
    # the duplicated channel's pixels count for channel 4, never 11
    up = _upsample(z, *out_hw)
    assert (up.max(1) == up[:, 11]).any()
    last = (up.shape[1] - 1 - up[:, ::-1].argmax(1))
    assert ((last == labels) & (labels != 255)).sum() != correct


def test_forward_models_reuse_the_x_lerps():
    """At ratio 4 a thread x-lerps a source row about once per four output
    rows it walks, plus the two rows it starts between: K3 (8 rows a
    thread) at most 0.5 x-lerps an upsampled value, where a value read
    from its four taps takes 3 lerps and 4 loads."""
    xs, xt = _maps((1, 2, 16, 16), 17)
    _, _, lerps = group_kl_fwd_model(xs, xt, np.arange(2), (64, 64), 2, 2.0)
    assert lerps <= 0.5


@pytest.mark.parametrize('shape,out_hw,g', [((2, 7, 6, 6), (24, 24), 3),
                                            ((2, 6, 6, 6), (12, 12), 2)])
def test_group_kl_forward_model_matches_jax_kernel(shape, out_hw, g):
    """Once against the JAX kernel in interpret mode, fp32 (1e-5)."""
    xs, xt = _maps(shape, 18, 3.0)
    perm = np.random.RandomState(19).permutation(shape[1]).astype(np.int32)
    want = float(jax_group_kl_shuffled(
        jnp.asarray(xs, jnp.float32), jnp.asarray(xt, jnp.float32),
        jnp.asarray(perm), out_hw, g, 2.0, True))
    loss, _, _ = group_kl_fwd_model(xs, xt, perm, out_hw, g, 2.0)
    assert loss == pytest.approx(want, rel=1e-5)


def test_seg_ce_forward_model_matches_jax_kernel():
    """Once against the JAX kernel in interpret mode, fp32: ce_sum to 1e-5,
    correct exactly."""
    shape, out_hw = (2, 7, 8, 8), (32, 32)
    z, _ = _maps(shape, 20, 3.0)
    labels = _labels(shape, out_hw, 21)
    ce_want, correct_want = jax_seg_ce(
        jnp.asarray(z, jnp.float32), jnp.asarray(labels, jnp.int32), out_hw,
        7, 255, True)
    ce, correct, _, _ = seg_ce_fwd_model(z, labels, out_hw, 7)
    assert ce == pytest.approx(float(ce_want), rel=1e-5)
    assert correct == float(correct_want)


def pixel_kl_fwd_model(xs, xt, out_hw, tau, oh=None):
    """K7 in float64: -> (kl_sum, lse (2, B, H, W), x-lerps a value). Per
    image and tile the windows of both maps of every channel and the walk;
    per pixel the channels in chunks of ``FWD_UNITS / 2`` (those past C:
    -1e30 in both maps), with w = z log2 e / tau: each map's chunk maximum,
    its running maximum M and exp-sum Z = sum 2^(w - M), and A = sum
    2^(w_t - M_t) (z_t - z_s), each rescaled once a chunk (A with the
    teacher's factor); at the end lse = M ln 2 + log Z, the pixel's KL A /
    (tau Z_t) - (M_t - M_s) ln 2 + log(Z_s / Z_t), summed per block and the
    blocks' partials in block order."""
    B, C, h, w = xs.shape
    H, W = out_hw
    oh = oh or 4 * pk.FWD_ROWS
    chans = pk.FWD_UNITS // 2
    k2 = LOG2E / tau
    lse = np.zeros((2, B, H, W))
    parts, lerps = [], 0
    for b in range(B):
        for tile in _tiles(H, W, oh):
            oy0, ox0, rows, cols = tile
            v, n = _tile_values(np.concatenate([xs[b], xt[b]]), h, w, H, W,
                                oh, pk.FWD_ROWS, tile)
            lerps += n
            ms = np.full((rows, cols), -np.inf)
            mt = np.full((rows, cols), -np.inf)
            zs, zt, a = (np.zeros((rows, cols)) for _ in range(3))
            for c0 in range(0, C, chans):
                n_c = min(chans, C - c0)
                vs = np.full((chans, rows, cols), -1e30)
                vt = np.full((chans, rows, cols), -1e30)
                vs[:n_c], vt[:n_c] = v[c0:c0 + n_c], v[C + c0:C + c0 + n_c]
                ms_new = np.maximum(ms, vs.max(0) * k2)
                mt_new = np.maximum(mt, vt.max(0) * k2)
                rt = np.exp2(mt - mt_new)
                et = np.exp2(vt * k2 - mt_new)
                zs = zs * np.exp2(ms - ms_new) + np.exp2(
                    vs * k2 - ms_new).sum(0)
                zt = zt * rt + et.sum(0)
                a = a * rt + (et * (vt - vs)).sum(0)
                ms, mt = ms_new, mt_new
            lse[0, b, oy0:oy0 + rows, ox0:ox0 + cols] = ms * LN2 + np.log(zs)
            lse[1, b, oy0:oy0 + rows, ox0:ox0 + cols] = mt * LN2 + np.log(zt)
            parts.append((a / (tau * zt) - (mt - ms) * LN2
                          + np.log(zs / zt)).sum())
    return float(np.sum(parts)), lse, lerps / (2 * C * B * H * W)


# (maps' shape, output size, tau): C not a multiple of K7's chunk (pad
# units), a non-integer ratio with tiles cut by the edge, odd sizes, ratio
# ~8 and ~30, the tile arithmetic at ratio 1 and under downsampling (where
# the plan names the gather variant), and tau 0.5 and 4
PKL_MODEL_CASES = [((2, 7, 8, 8), (32, 32), 1.0),
                   ((2, 6, 30, 40), (125, 161), 1.0),
                   ((1, 5, 31, 33), (97, 130), 0.5),
                   ((2, 5, 21, 19), (190, 150), 4.0),
                   ((1, 3, 10, 9), (300, 270), 1.0),
                   ((2, 5, 40, 40), (40, 40), 1.0),
                   ((2, 9, 64, 48), (24, 20), 2.0)]


@pytest.mark.parametrize('shape,out_hw,tau', PKL_MODEL_CASES)
@pytest.mark.parametrize('scale', [1.0, 30.0])
def test_pixel_kl_forward_model_matches_plain(shape, out_hw, tau, scale):
    xs, xt = _maps(shape, 22, scale)
    kl, lse, _ = pixel_kl_fwd_model(xs, xt, out_hw, tau)
    want = pk.pixel_kl_plain(torch.from_numpy(xs), torch.from_numpy(xt),
                             out_hw, tau).item()
    assert kl == pytest.approx(want, rel=1e-5, abs=1e-7)
    # the log-sum-exps against a direct float64 evaluation
    for i, x in enumerate((xs, xt)):
        u = _upsample(x, *out_hw) / tau
        m = u.max(1)
        direct = m + np.log(np.exp(u - m[:, None]).sum(1))
        np.testing.assert_allclose(lse[i], direct, rtol=1e-12, atol=1e-12)


def test_pixel_kl_forward_model_pads_add_nothing():
    """A map of one channel is one real unit pair and three pad pairs a
    chunk: its KL is 0 and its log-sum-exps are the upsampled values, at
    tau 0.5, 1 and 4. In float32, as the kernel computes them, a pad's
    exponent kFwdPad * k - M stays finite, its 2^x is exactly 0, and its
    z_t - z_s is exactly 0, so it adds exactly 0 to each exp-sum and to A
    (no inf - inf)."""
    xs, xt = _maps((1, 1, 8, 8), 23, 3.0)
    for tau in (0.5, 1.0, 4.0):
        kl, lse, _ = pixel_kl_fwd_model(xs, xt, (32, 32), tau)
        assert abs(kl) <= 1e-12  # one channel: both softmaxes are 1
        for i, x in enumerate((xs, xt)):
            np.testing.assert_allclose(lse[i], _upsample(x, 32, 32)[:, 0]
                                       / tau, rtol=1e-12, atol=1e-12)
        k2 = np.float32(LOG2E / tau)
        pad = np.float32(-1e30)
        for m in np.float32([-200.0, 0.0, 200.0]):
            x = pad * k2 - m
            assert np.isfinite(x) and np.exp2(x) == 0.0
        assert pad - pad == 0.0


def test_pixel_kl_forward_model_reuses_the_x_lerps():
    """At ratio 4 a thread walking 8 rows x-lerps its two starting source
    rows and about two more: at most 0.5 x-lerps an upsampled value (a
    value from its four taps takes 3 lerps and 4 loads)."""
    xs, xt = _maps((1, 4, 16, 16), 24)
    _, _, lerps = pixel_kl_fwd_model(xs, xt, (64, 64), 1.0)
    assert lerps <= 0.5


@pytest.mark.parametrize('shape,out_hw,tau', [((2, 7, 8, 8), (32, 32), 1.0),
                                              ((2, 6, 6, 6), (12, 12), 2.0)])
def test_pixel_kl_forward_model_matches_jax_kernel(shape, out_hw, tau):
    """Once against the JAX kernel in interpret mode, fp32 (1e-5)."""
    xs, xt = _maps(shape, 25, 3.0)
    want = float(jax_pixel_kl(jnp.asarray(xs, jnp.float32),
                              jnp.asarray(xt, jnp.float32), out_hw, tau,
                              True))
    kl, _, _ = pixel_kl_fwd_model(xs, xt, out_hw, tau)
    assert kl == pytest.approx(want, rel=1e-5)


# ---- K3's two-geometry tile: a teacher of another size --------------------

@pytest.fixture(scope='module')
def two_forward_inputs():
    """Per case of ``TWO_MODEL_CASES``: the maps (float32 values in
    float64), the JAX ``KLDLoss``'s permutation and its loss (unfused:
    each map resized to the output, then the KL), tau 2."""
    import jax
    out = {}
    for case in TWO_MODEL_CASES:
        B, C, hs, ht, out_hw, g = case
        xs, xt = _tab5_maps(B, C, hs, ht, 6)
        crit = JaxKLDLoss(alpha=1, tau=2, resize_config=RESIZE,
                          shuffle_config={'interval': 1000},
                          transform_config={'loss_type': 'channel',
                                            'group_size': g})
        key = jax.random.key(5)
        perm = np.array(crit._shuffle_idx(C, 1000, key))
        gt = jnp.zeros((B,) + tuple(out_hw), jnp.int32)
        want = float(crit(jnp.asarray(xs), jnp.asarray(xt), gt, 1000, key))
        out[case] = xs.astype(np.float64), xt.astype(np.float64), perm, want
    return out


@pytest.mark.parametrize('case', TWO_MODEL_CASES,
                         ids=['x'.join(map(str, c[2] + c[3] + c[4]))
                              for c in TWO_MODEL_CASES])
def test_group_kl_two_geometry_forward_model_matches_plain_and_jax(
        case, two_forward_inputs):
    """The plan names the two-geometry tile; the model's loss against
    ``group_kl_plain`` and the JAX loss (1e-5 relative, float32 sums over
    10^3-10^6 values), its stats against direct float64 sums over each
    map's own upsample."""
    B, C, hs, ht, out_hw, g = case
    xs, xt, perm, want_jax = two_forward_inputs[case]
    assert gk.forward_plan(*hs, *out_hw, ht)['oh'] == 4 * gk.FWD_ROWS
    loss, stats, _ = group_kl_fwd_model(xs, xt, perm, out_hw, g, 2.0)
    want = gk.group_kl_plain(torch.from_numpy(xs), torch.from_numpy(xt),
                             torch.from_numpy(perm), out_hw, g, 2.0).item()
    assert loss == pytest.approx(want, rel=1e-5)
    assert loss == pytest.approx(want_jax, rel=1e-5)
    for i, x in enumerate((xs, xt)):
        up = _upsample(x, *out_hw)
        for b in range(B):
            for k in range(-(-C // g)):
                chans = perm[k * g:(k + 1) * g]
                m = x[b, chans].max()
                assert stats[b, k, i] == m
                z = np.exp((up[b, chans] - m) / 2.0).sum()
                assert stats[b, k, 2 + i] == pytest.approx(z, rel=1e-12)


def test_group_kl_two_geometry_forward_model_sees_a_wrong_teacher_tap(
        two_forward_inputs):
    """The teacher's rows read one source row low: the loss misses the
    limit by far (more than 100 times it), at the narrow PSP pair and at
    the PSP maps' size."""
    for case in TWO_MODEL_CASES[:2]:
        _, _, _, _, out_hw, g = case
        xs, xt, perm, want = two_forward_inputs[case]
        loss, _, _ = group_kl_fwd_model(xs, xt, perm, out_hw, g, 2.0,
                                        teacher_shift=1)
        assert abs(loss - want) > 1e-3 * abs(want), case
