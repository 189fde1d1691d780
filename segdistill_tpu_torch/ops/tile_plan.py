"""The launch plans of the kernels on shared-memory tiles of
``csrc/common.cuh``: the backward through a bilinear upsample on a source
tile (``tile_bwd``: K4 group KL, K6 seg CE, K8 pixel KL), and the forward
on an output tile (``fwd_tile``: K3 group KL, K5 seg CE, K7 pixel KL).

The backward.

A block owns one image's ``tile`` x ``tile`` source pixels and a chunk of
``cpc`` channels (K4: positions of the permutation). The outputs whose taps
read the tile form one rectangle of at most ``rh`` x ``rw``; the block
keeps the loss's per-output maps (``rect_maps``: K6 2, K8 2, K4 0) and the
gradient over it, and the tile with its halo of each map read
(``src_maps``: K6 1, K4 and K8 2), double-buffered, in shared memory.
:func:`plan` is this planning in pure Python; the source computes the tile,
the rectangle and the bytes again (``plan_tile``, ``tile_plan_ok``) and
refuses a plan that is not its own. Where no tile fits (upsampling ratios
above ~15; ~30 for K4, which keeps no per-output map) the plan names tile
0, the loss's gather variant: one thread per source element.

The forward. A block owns ``oh`` x 64 outputs of one slice (K3: an image's
channel group; K5, K7: an image); each of its 256 threads walks ``rows``
rows of one column (``oh`` = 4 ``rows``). The sources those outputs read
form a window of at most ``wy`` x ``wx`` (:func:`fwd_reach`), which the
block stages in shared memory for the ``units`` maps of a step (K3: both
maps of one position; K5: a chunk of 8 channels; K7: both maps of 4
channels), double-buffered, each thread ``slots`` elements a unit.
:func:`forward_plan` is that planning; the source computes it again
(``plan_fwd``, ``fwd_plan_ok``) and refuses a plan that is not its own.
Where a window is larger than ``slots`` x 256 elements (upsampling ratios
near 1 and downsampling) the plan names ``oh`` 0, the loss's gather
variant.
"""

import functools

# the edges tried, largest first; the shared memory a block may take
# (kTileBudget: two blocks fit an SM's 228 KB, 1 KB of it reserved per
# block); threads of a gather block (kThreads); what setting a block up
# costs, in channels (the rectangle's maps, the tap tables)
TILE_EDGES = (16, 8, 4)
TILE_BUDGET = 113 * 1024
GATHER_THREADS = 256
SM_SHARED = 228 * 1024
SETUP_CHANNELS = 4
PLAN_KEYS = ('tile', 'rh', 'rw', 'shared_bytes', 'cpc', 'chunks', 'blocks')


def tile_reach(tile, n_in, n_out):
    """The most outputs along one axis whose taps can read ``tile``
    neighbouring sources (``tile_reach`` in csrc/common.cuh): those whose
    source position falls into a window of ``tile + 1`` source steps, and 3
    for the window's ends and the rounding of the positions."""
    return min(-(-(tile + 1) * n_out // n_in) + 3, n_out)


def shared_bytes(tile, h, w, H, W, rect_maps, src_maps):
    """Dynamic shared memory of a tile block (``tile_smem_bytes`` in
    csrc/common.cuh): ``rect_maps`` per-output maps and the gradient over
    the rectangle of the tile's readers (odd pitch), the x-summed buffer,
    two buffers of ``src_maps`` source tiles with their halo, the taps of
    the rectangle's rows and columns, and for each row and column of the
    tile its first reader, their count and their weights."""
    rh, rw = tile_reach(tile, h, H), tile_reach(tile, w, W)
    ny, nx = tile_reach(1, h, H), tile_reach(1, w, W)
    return 4 * ((rect_maps + 1) * rh * (rw | 1) + tile * (rh | 1)
                + 2 * src_maps * (tile + 2) ** 2 + 2 * rh + 2 * rw
                + tile * (4 + ny + nx))


def plan(B, C, h, w, H, W, sms, rect_maps, src_maps, resident):
    """The launch for (B, C, h, w) maps upsampled to (H, W) on a card of
    ``sms`` SMs, for a loss with ``rect_maps`` per-output maps and
    ``src_maps`` maps read, compiled for ``resident`` blocks an SM -> dict:
    ``tile`` (the edge of a block's source tile; 0: the gather variant),
    ``rh, rw`` (the rectangle of outputs a block holds), ``shared_bytes``,
    ``cpc`` (channels per block), ``chunks`` and ``blocks``.

    The tile is the largest edge whose block fits :data:`TILE_BUDGET`. The
    channels are cut into the number of chunks that costs the least: waves
    of blocks over the card's slots times the channels (and the set-up) of
    one block."""
    return dict(zip(PLAN_KEYS, _plan(B, C, h, w, H, W, sms, rect_maps,
                                     src_maps, resident)))


@functools.lru_cache(maxsize=128)
def _plan(B, C, h, w, H, W, sms, rect_maps, src_maps, resident):
    for tile in TILE_EDGES:
        shared = shared_bytes(tile, h, w, H, W, rect_maps, src_maps)
        if shared <= TILE_BUDGET:
            break
    else:
        return 0, 0, 0, 0, 1, C, B * C * -(-h * w // GATHER_THREADS)
    tiles = B * -(-h // tile) * -(-w // tile)
    slots = sms * min(SM_SHARED // (shared + 1024), resident)
    best = None
    for k in range(1, C + 1):
        cpc = -(-C // k)
        chunks = -(-C // cpc)
        cost = -(-tiles * chunks // slots) * (cpc + SETUP_CHANNELS)
        if best is None or cost < best[0]:
            best = (cost, cpc, chunks)
    _, cpc, chunks = best
    return (tile, tile_reach(tile, h, H), tile_reach(tile, w, W), shared,
            cpc, chunks, tiles * chunks)


def plan_args(plan_):
    """The plan as the sources' ``*_bwd`` entry points take it: tile, rh,
    rw, shared bytes, channels per block."""
    return (plan_['tile'], plan_['rh'], plan_['rw'], plan_['shared_bytes'],
            plan_['cpc'])


# threads of a forward block (kFwdThreads), the columns of its tile
# (kFwdCols): one a thread, so a tile has 4 segments of rows
FWD_THREADS = 256
FWD_COLS = 64
FWD_SEGS = FWD_THREADS // FWD_COLS
FWD_KEYS = ('oh', 'wy', 'wx', 'shared_bytes', 'tiles')


def fwd_reach(n, n_in, n_out):
    """The most sources along one axis that ``n`` neighbouring outputs read
    (``fwd_reach`` in csrc/common.cuh): their positions span (n - 1) *
    n_in / n_out source steps, whose floors differ by at most its ceiling,
    one more for the last output's second tap and two for the float32
    rounding of either end's position; never more than the map."""
    return min(-(-(n - 1) * n_in // n_out) + 4, n_in)


def fwd_shared_bytes(units, oh, wy, wx):
    """Dynamic shared memory of a forward block (``fwd_smem_bytes``): two
    buffers of ``units`` windows and the tile rows' y taps."""
    return 4 * (2 * units * wy * wx + 2 * oh)


def forward_plan(h, w, H, W, units, rows, slots):
    """The forward's launch for (h, w) maps upsampled to (H, W), for a loss
    whose steps read ``units`` maps, whose threads walk ``rows`` rows and
    stage ``slots`` window elements a unit -> dict: ``oh`` (the tile's rows;
    0: the gather variant), ``wy, wx`` (the window), ``shared_bytes`` and
    ``tiles`` (blocks a slice)."""
    oh = FWD_SEGS * rows
    wy, wx = fwd_reach(oh, h, H), fwd_reach(FWD_COLS, w, W)
    if wy * wx > slots * FWD_THREADS:
        return dict(zip(FWD_KEYS, (0, 0, 0, 0, 0)))
    return dict(zip(FWD_KEYS, (oh, wy, wx, fwd_shared_bytes(units, oh, wy, wx),
                               -(-H // oh) * -(-W // FWD_COLS))))


def forward_plan_args(plan_):
    """The forward plan as the sources' ``*_fwd`` entry points take it:
    tile rows, window rows and columns, shared bytes."""
    return plan_['oh'], plan_['wy'], plan_['wx'], plan_['shared_bytes']
