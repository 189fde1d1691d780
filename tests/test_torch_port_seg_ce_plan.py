"""K6's launch planning (``ops/seg_ce.py::backward_plan``) and a model of
its tile arithmetic, on the CPU.

The kernel gives a block a tile of source pixels; the outputs whose bilinear
taps (``align_corners=False``) read the tile form one interval an axis,
which the block finds by a short scan (``tile_axis`` in csrc/common.cuh) and
whose length the plan bounds (``tile_reach``) to size the shared memory.
Here the taps are computed in numpy float32 as the source computes them, the
readers of every tile are found by brute force, and (a) the scan's interval
is exactly the readers', (b) the plan's bound holds them, its shared bytes
fit the stated budget, and every source element has exactly one owner; (c)
the transposed upsample done tile by tile and one axis after the other,
with the source's float32 tap weights, equals ``torch.autograd.grad`` of
``F.interpolate``. Both sides sum in float64 there, so that the limit holds
the algorithm (which outputs reach which source, with which weight): 1e-12
of the largest gradient against the dense product with the same weights,
and against autograd 1e-6 plus what the float32 rounding of a tap's
fraction allows, half an ulp of the source position on each axis (nothing
at a power-of-two ratio, where the positions are exact).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from segdistill_tpu_torch.ops import seg_ce as sc

CSRC = Path(sc.__file__).resolve().parent.parent / 'csrc'

# (in, out) of one axis: integer, non-integer and downsampling ratios, odd
# sizes, sizes below a tile, ratio 1
AXES = [(128, 512), (32, 128), (30, 125), (40, 161), (31, 97), (33, 130),
        (64, 24), (48, 20), (40, 40), (7, 50), (1, 9), (5, 5), (16, 17),
        (17, 16), (100, 33), (3, 40)]


def taps(n_in, n_out):
    """(i0, i1, f) of every output index, in float32 as ``tap`` in
    csrc/common.cuh computes them."""
    scale = np.float32(n_in) / np.float32(n_out)
    dst = np.arange(n_out, dtype=np.float32)
    src = np.maximum((dst + np.float32(0.5)) * scale - np.float32(0.5),
                     np.float32(0.0)).astype(np.float32)
    i0 = np.minimum(src.astype(np.int64), n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    return i0, i1, (src - i0.astype(np.float32)).astype(np.float32)


def first_reader(i, n_in, n_out):
    scale = np.float32(n_in) / np.float32(n_out)
    est = (np.float32(i) - np.float32(0.5)) / scale - np.float32(0.5)
    return max(int(np.floor(est)) - 2, 0)


def tile_axis(index, tile, n_in, n_out):
    """``tile_axis`` of csrc/common.cuh: -> (lo, n, o0, on)."""
    i0, i1, _ = taps(n_in, n_out)
    lo = index * tile
    n = min(tile, n_in - lo)
    o = first_reader(lo, n_in, n_out)
    while o < n_out and i1[o] < lo:
        o += 1
    o0 = o
    last = lo + n - 1
    if last + 1 >= n_in:
        o = n_out
    else:
        o = max(first_reader(last + 1, n_in, n_out), o0)
        while o < n_out and i0[o] <= last:
            o += 1
    return lo, n, o0, o - o0


def readers(lo, n, n_in, n_out):
    """Brute force: the outputs whose tap reads a source in [lo, lo + n)."""
    i0, i1, _ = taps(n_in, n_out)
    hit = ((i0 >= lo) & (i0 < lo + n)) | ((i1 >= lo) & (i1 < lo + n))
    return np.flatnonzero(hit)


@pytest.mark.parametrize('n_in,n_out', AXES)
@pytest.mark.parametrize('tile', sc.TILE_EDGES)
def test_tile_interval_holds_exactly_the_readers(n_in, n_out, tile):
    owners = np.zeros(n_in, np.int64)
    for index in range(-(-n_in // tile)):
        lo, n, o0, on = tile_axis(index, tile, n_in, n_out)
        owners[lo:lo + n] += 1
        want = readers(lo, n, n_in, n_out)
        if want.size == 0:
            assert on == 0
            continue
        # the readers are one interval, and the scan finds it
        assert np.array_equal(want, np.arange(want[0], want[-1] + 1))
        assert (o0, on) == (want[0], want.size)
        assert on <= sc.tile_reach(tile, n_in, n_out)
    assert (owners == 1).all()


def test_first_reader_is_at_or_below_the_first_reader():
    """No output below ``first_reader(i)`` reads source i with a weight
    other than 0 (the first outputs, whose position is clamped to 0, name
    source 1 as their second tap with the fraction 0)."""
    for n_in, n_out in AXES:
        i0, i1, f = taps(n_in, n_out)
        for i in range(n_in):
            o = first_reader(i, n_in, n_out)
            assert not (i0[:o] == i).any()
            assert not ((i1[:o] == i) & (f[:o] != 0)).any()


SHAPES = [(8, 150, 128, 128, 512, 512), (2, 150, 128, 128, 512, 512),
          (2, 150, 30, 40, 125, 161), (2, 150, 31, 33, 97, 130),
          (2, 19, 64, 48, 24, 20), (2, 150, 32, 32, 128, 128),
          (2, 19, 40, 40, 40, 40), (1, 19, 8, 8, 256, 256),
          (1, 3, 4, 4, 512, 512), (4, 21, 60, 60, 473, 473),
          (1, 150, 16, 16, 200, 240), (16, 150, 128, 128, 512, 512)]


@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: 'x'.join(map(str, s)))
@pytest.mark.parametrize('sms', [132, 108])
def test_backward_plan(shape, sms):
    B, C, h, w, H, W = shape
    plan = sc.backward_plan(*shape, sms=sms)
    tile = plan['tile']
    if tile == 0:  # no tile fits: every edge's block is over the budget
        for t in sc.TILE_EDGES:
            assert sc.tile_shared_bytes(t, h, w, H, W) > sc.TILE_BUDGET
        assert (plan['rh'], plan['rw'], plan['shared_bytes']) == (0, 0, 0)
        return
    assert tile in sc.TILE_EDGES
    # the largest edge that fits
    for t in sc.TILE_EDGES:
        fits = sc.tile_shared_bytes(t, h, w, H, W) <= sc.TILE_BUDGET
        if t > tile:
            assert not fits
    assert plan['shared_bytes'] == sc.tile_shared_bytes(tile, h, w, H, W)
    assert (plan['rh'], plan['rw']) == (sc.tile_reach(tile, h, H),
                                        sc.tile_reach(tile, w, W))
    assert plan['shared_bytes'] <= sc.TILE_BUDGET
    # two blocks and their reserved kilobyte fit an SM
    assert 2 * (plan['shared_bytes'] + 1024) <= 228 * 1024
    # the rectangle holds every tile's readers along both axes
    for n_in, n_out, reach in ((h, H, plan['rh']), (w, W, plan['rw'])):
        for index in range(-(-n_in // tile)):
            lo, n, _, _ = tile_axis(index, tile, n_in, n_out)
            assert readers(lo, n, n_in, n_out).size <= reach
    # the chunks cover the channels, none is empty
    cpc, chunks = plan['cpc'], plan['chunks']
    assert 1 <= cpc <= C and (chunks - 1) * cpc < C <= chunks * cpc
    assert plan['blocks'] == B * -(-h // tile) * -(-w // tile) * chunks


def test_plan_fills_the_card_at_the_bench_shape():
    """(8, 150, 128, 128) -> 512^2 on 132 SMs: 16 x 16 tiles, three blocks
    an SM, 1536 blocks of 50 channels in four waves of 396."""
    plan = sc.backward_plan(8, 150, 128, 128, 512, 512, sms=132)
    assert plan == dict(tile=16, rh=71, rw=71, shared_bytes=70428, cpc=50,
                        chunks=3, blocks=1536)
    small = sc.backward_plan(2, 150, 128, 128, 512, 512, sms=132)
    assert small['chunks'] == 3 and small['blocks'] == 384


def test_plan_constants_mirror_the_source():
    """K6 is the tile kernel of csrc/common.cuh with the loss ce_tile of
    csrc/seg_ce.cu: the budget, edges and shared bytes live in the former,
    K6's maps and blocks an SM in the latter."""
    common = (CSRC / 'common.cuh').read_text()
    budget = re.search(r'kTileBudget = (\d+) \* 1024;', common)
    assert int(budget.group(1)) * 1024 == sc.TILE_BUDGET
    edges = re.search(r'for \(int tile = (\d+); tile >= (\d+); tile /= 2\)',
                      common)
    assert (int(edges.group(1)), int(edges.group(2))) == (
        sc.TILE_EDGES[0], sc.TILE_EDGES[-1])
    assert all(a == 2 * b for a, b in zip(sc.TILE_EDGES, sc.TILE_EDGES[1:]))
    assert '__launch_bounds__(kTileThreads, Loss::kResident)' in common
    loss = (CSRC / 'seg_ce.cu').read_text()
    loss = loss[loss.index('struct ce_tile {'):]
    resident = re.search(r'kResident = (\d+);', loss)
    assert int(resident.group(1)) == sc._MAX_BLOCKS_PER_SM
    assert re.search(r'kRectMaps = (\d+);', loss).group(1) == \
        str(sc.RECT_MAPS)
    assert re.search(r'kSrcMaps = (\d+);', loss).group(1) == str(sc.SRC_MAPS)
    assert 'return 4 * ((rect_maps + 1) * rh * (rw | 1) + tile * (rh | 1) +' \
        in common
    assert 'tile * (4 + ny + nx));' in common
    assert '(static_cast<long long>(tile + 1) * out + in - 1) / in + 3' \
        in common


def _weights(lo, n, o0, on, n_in, n_out):
    """(on, n) float32: the weight of tile element k in output o0 + t's tap
    (``tile_weight``)."""
    i0, i1, f = taps(n_in, n_out)
    t = np.arange(o0, o0 + on)
    k = np.arange(lo, lo + n)
    w = np.where(i0[t, None] == k[None], (np.float32(1) - f[t])[:, None],
                 np.float32(0))
    return (w + np.where(i1[t, None] == k[None], f[t][:, None],
                         np.float32(0))).astype(np.float32)


def tiled_transposed_upsample(g, h, w, tile):
    """dz (h, w) = the transposed bilinear upsample of g (H, W), done as K6
    does it: per tile, over the rectangle of its readers, first along x,
    then along y; float32 weights, float64 sums."""
    H, W = g.shape
    dz = np.zeros((h, w), np.float64)
    for ty in range(-(-h // tile)):
        lo_y, n_y, o0y, on_y = tile_axis(ty, tile, h, H)
        wy = _weights(lo_y, n_y, o0y, on_y, h, H)
        for tx in range(-(-w // tile)):
            lo_x, n_x, o0x, on_x = tile_axis(tx, tile, w, W)
            wx = _weights(lo_x, n_x, o0x, on_x, w, W)
            rect = g[o0y:o0y + on_y, o0x:o0x + on_x]
            tmp = rect @ wx.astype(np.float64)   # (on_y, n_x)
            dz[lo_y:lo_y + n_y, lo_x:lo_x + n_x] = \
                wy.T.astype(np.float64) @ tmp
    return dz


def _dense_weights(n_in, n_out):
    return _weights(0, n_in, 0, n_out, n_in, n_out).astype(np.float64)


@pytest.mark.parametrize('hw,out_hw', [
    ((32, 32), (128, 128)), ((30, 40), (125, 161)), ((31, 33), (97, 130)),
    ((64, 48), (24, 20)), ((40, 40), (40, 40)), ((7, 5), (50, 61)),
    ((17, 16), (16, 17))])
@pytest.mark.parametrize('tile', sc.TILE_EDGES)
def test_separable_transposed_upsample_matches_autograd(hw, out_hw, tile):
    rng = np.random.RandomState(hash((hw, out_hw, tile)) % 2 ** 31)
    g = rng.randn(*out_hw)
    got = tiled_transposed_upsample(g, *hw, tile)
    dense = _dense_weights(hw[0], out_hw[0]).T @ g \
        @ _dense_weights(hw[1], out_hw[1])
    assert np.abs(got - dense).max() <= 1e-12 * np.abs(dense).max()
    z = torch.zeros(1, 1, *hw, dtype=torch.float64, requires_grad=True)
    up = F.interpolate(z, size=out_hw, mode='bilinear', align_corners=False)
    (want,) = torch.autograd.grad(up, z, torch.from_numpy(g)[None, None])
    want = want[0, 0].numpy()
    exact = all((o / i) == 2 ** round(np.log2(o / i))
                for i, o in zip(hw, out_hw))
    tol = 1e-6 + (0 if exact else 2 * np.finfo(np.float32).eps * max(hw))
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
