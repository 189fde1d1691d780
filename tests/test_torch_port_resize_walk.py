"""K1's column walker (``csrc/resize_sum.cu``), modelled in float64 on the
CPU.

A thread owns one channel vector at one output column and walks ``kRows``
output rows; per part it keeps the x-lerped values of the two source rows
it stands between (top, and the next row less top) and loads and x-lerps
a source row only when that part's y tap moves on, so that a value is one
FMA. Here the model of that walk, with the float32 taps the source
computes, equals the plain version (``resize_sum_plain``, float32: 1e-5,
its lerps' roundings over parts of N(0, 1) values) and once the JAX kernel
in interpret mode at integer ratios; at the heads' ratios (2, 4 and 8) it
loads about 2.5 sixteen-byte vectors a stored one in all, where a thread
per stored vector loaded 4 a part; and ``kRows`` is read from the source.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segdistill_tpu.ops.pallas.resize_sum import (
    fused_resize_sum as jax_resize_sum)
from segdistill_tpu_torch.ops import resize_sum as rs
import torch_port_threads  # noqa: F401  (torch threads a test worker)
from test_torch_port_seg_ce_plan import taps

SOURCE = Path(rs.__file__).resolve().parent.parent / 'csrc' / 'resize_sum.cu'
ROWS = int(re.search(r'constexpr int kRows = (\d+);',
                     SOURCE.read_text()).group(1))


def walk_model(parts, out_hw, rows=ROWS):
    """K1 in float64 over NHWC ``parts``: -> (out (B, H, W, C), loads a
    stored vector). Per group of ``rows`` output rows and part: the walk
    down each column (the x taps fixed), a source row x-lerped where the y
    tap moves on (two vector loads: its two x taps), the value top + fy d
    added to the row's sum."""
    B, _, _, C = parts[0].shape
    H, W = out_hw
    out = np.zeros((B, H, W, C))
    loads = 0
    for p in parts:
        h, w = p.shape[1:3]
        x0, x1, fx = taps(w, W)
        fx = fx.astype(np.float64)[None, :, None]
        y0s, y1s, fys = taps(h, H)

        def xlerp(a):
            row = p[:, a]  # (B, w, C)
            return row[:, x0] + fx * (row[:, x1] - row[:, x0])
        for g in range(0, H, rows):
            at, top, d = -2, None, None
            for y in range(g, min(g + rows, H)):
                a0, a1, fy = int(y0s[y]), int(y1s[y]), float(fys[y])
                if a0 != at:
                    if a0 == at + 1:
                        top = top + d
                    else:
                        top, loads = xlerp(a0), loads + 2
                    d, loads, at = xlerp(a1) - top, loads + 2, a0
                out[:, y] += top + fy * d
    # a row's x-lerp stands for every column's: loads per stored vector
    return out, loads / H


def _parts(shapes, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32).astype(np.float64)
            for s in shapes]


# the B0 head's three parts (ratios 8, 4, 2) at a narrow width; a
# non-integer ratio with rows past the last group; downsampling; one part
# of one row
WALK_CASES = [([(1, 4, 4, 8), (1, 8, 8, 8), (1, 16, 16, 8)], (32, 32)),
              ([(2, 15, 20, 4), (2, 23, 31, 4)], (61, 83)),
              ([(1, 20, 18, 4)], (7, 9)),
              ([(1, 1, 5, 4)], (13, 11))]


@pytest.mark.parametrize('shapes,out_hw', WALK_CASES)
def test_walk_model_matches_plain(shapes, out_hw):
    parts = _parts(shapes, 31)
    got, _ = walk_model(parts, out_hw)
    want = rs.resize_sum_plain([torch.from_numpy(p).float() for p in parts],
                               out_hw).double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # and the port's public function on the CPU, which is the plain version
    cpu = rs.fused_resize_sum([torch.from_numpy(p).float() for p in parts],
                              out_hw)
    np.testing.assert_array_equal(cpu.numpy(), want.astype(np.float32))


@pytest.mark.parametrize('rows', [4, 8, 16])
def test_walk_model_does_not_depend_on_the_rows(rows):
    parts = _parts(WALK_CASES[1][0], 32)
    got, _ = walk_model(parts, WALK_CASES[1][1], rows)
    want, _ = walk_model(parts, WALK_CASES[1][1], 1)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_walk_loads_at_the_heads_ratios():
    """The B0 head's ratios 8, 4, 2 into 128 rows: with kRows rows a walk,
    each part loads 2 vectors for each source row it x-lerps, at most
    (kRows / r + 2) of them a walk; in all about 2.5 loads a stored vector
    at kRows = 16 (3.2 at 8), against the 12 of a thread per stored
    vector."""
    parts = _parts([(1, 16, 16, 8), (1, 32, 32, 8), (1, 64, 64, 8)], 33)
    _, loads = walk_model(parts, (128, 128))
    bound = sum(2 * (ROWS / r + 2) for r in (8, 4, 2)) / ROWS
    assert loads <= bound <= 12
    assert loads <= 3.5 if ROWS >= 8 else loads <= 5.0


def test_walk_model_matches_jax_kernel():
    """Once against the JAX kernel in interpret mode (integer ratios,
    fp32): 1e-5."""
    shapes, out_hw = [(2, 4, 4, 128), (2, 8, 8, 128), (2, 16, 16, 128)], \
        (32, 32)
    parts = _parts(shapes, 34)
    want = jax_resize_sum(tuple(jnp.asarray(p, jnp.float32) for p in parts),
                          out_hw, True)
    got, _ = walk_model(parts, out_hw)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
