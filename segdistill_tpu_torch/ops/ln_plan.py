"""K10's launch plan: how the LayerNorm forward (``csrc/layer_norm.cu``,
``ln_fwd``) lays (rows, C) over lanes, blocks and the grid.

A row of ``C`` values is ``C / V`` sixteen-byte vectors (V = 8 in bf16, 4
in fp32). A group of ``lanes`` neighbouring lanes of one warp holds a row,
each lane ``nch`` vectors: lane l holds vectors l, l + lanes, ... (so the
lanes of a group read neighbouring 16-byte vectors), and the group sums
over its lanes by ``log2(lanes)`` shuffles. ``lanes``, ``nch`` and
``rows_in_flight`` are template arguments, one instance for each entry of
:data:`INSTANCES`.

The rules (:func:`forward_plan`), from device times measured on an H100
(``tools/bench_kernels.py --only ln`` sweeps the alternatives; PERF.md):

- **No idle lane where the width allows it, the most vectors a lane**:
  among the one-row instances that cover the row, the fewest idle vector
  slots, then the fewest lanes (bf16 C = 160 is 20 vectors: 4 lanes x 5;
  C = 320 is 40: 8 x 5; C = 64: 4 x 2). A lane loads its weight and bias
  with its row and holds at most :data:`MAX_VALUES` values.
- **Fill the card at small row counts**: one row a group, and the largest
  block of 256, 128 or 64 threads whose grid still covers every SM.
- **Rows in flight at large row counts**: where the launch's vectors
  outnumber the threads the card holds at once and a row is at most 32
  vectors, one vector a lane and a persistent grid of
  :data:`PERSISTENT_BLOCKS_PER_SM` blocks of 256 threads an SM, each group
  walking its rows with the next row's loads issued before the current
  row's sums and store (``rows_in_flight`` 2).

The source checks what it is given (``dispatch_fwd``): a plan that names
no instance, does not cover the row, leaves rows without a group at one
row a group, or has a block without a row is refused (the launch returns
an error, never a wrong result).
"""

import collections
import functools

# values of one 16-byte vector, by the C interface's dtype code (0 float32,
# 1 bfloat16)
VEC = {0: 4, 1: 8}
# values a lane holds at most (kFwdMaxValues in the source)
MAX_VALUES = 40
# the (lanes, nch, rows_in_flight) instances of ln_fwd, by dtype code
# (LN_FWD_INSTANCES in the source): those the rules take at some width
INSTANCES = {
    1: ((4, 1, 1), (4, 2, 1), (4, 5, 1), (8, 2, 1), (8, 5, 1), (16, 2, 1),
        (16, 4, 1), (32, 4, 1), (4, 1, 2), (8, 1, 2), (16, 1, 2), (32, 1, 2)),
    0: ((4, 1, 1), (8, 1, 1), (8, 2, 1), (8, 5, 1), (16, 2, 1), (16, 4, 1),
        (16, 5, 1), (32, 4, 1), (32, 8, 1), (8, 1, 2), (16, 1, 2))}
BLOCK_THREADS = (256, 128, 64)
# threads an SM holds at once (Hopper: 2048)
SM_THREADS = 2048
# the persistent grid's blocks of 256 threads an SM: a lane of the
# rows-in-flight instance keeps two rows, the weight and the bias in
# registers (under 64 a thread), so four fit
PERSISTENT_BLOCKS_PER_SM = 4

Plan = collections.namedtuple('Plan',
                              'lanes nch rows_in_flight threads blocks')


def lanes_and_vectors(C, code):
    """-> (lanes, nch) of one row a group at width ``C`` (a multiple of 8 up
    to 1024) in the dtype of ``code``: the fewest idle vector slots, then
    the fewest lanes."""
    nvec = C // VEC[code]
    pairs = [(g, n) for g, n, r in INSTANCES[code] if r == 1 and g * n >= nvec]
    return min(pairs, key=lambda p: (p[0] * p[1] - nvec, p[0]))


@functools.lru_cache(maxsize=None)
def forward_plan(rows, C, code, sms):
    """-> the :class:`Plan` of K10 for ``rows`` rows of width ``C`` in the
    dtype of ``code`` on a card of ``sms`` SMs."""
    nvec = C // VEC[code]
    if rows * nvec > sms * SM_THREADS and (nvec, 1, 2) in INSTANCES[code]:
        return Plan(nvec, 1, 2, 256,
                    min(-(-rows // (256 // nvec)),
                        sms * PERSISTENT_BLOCKS_PER_SM))
    lanes, nch = lanes_and_vectors(C, code)
    threads = next((t for t in BLOCK_THREADS if -(-rows * lanes // t) >= sms),
                   BLOCK_THREADS[-1])
    return Plan(lanes, nch, 1, threads, -(-rows // (threads // lanes)))
