"""The shapes at which the LayerNorm kernels (K10, K11) and the seg-CE
kernels (K5, K6) are checked and timed on the card, and the least time the
card could take for them: one list for ``chip_smoke.py``, which holds the
kernels to their limits, and ``tools/bench_ln_ce.py``, which only times
them.
"""

import torch

# NVIDIA H100 SXM: HBM3 bytes/s, fp32 FLOP/s outside the tensor cores, dense
# bf16 FLOP/s on them
PEAK_BYTES, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 989e12

# (name, rows, C) of the MiT LayerNorms at batch 8, 512x512: the B0
# student's four stages (stage 1: four times more row groups than K11 has
# blocks), three of the B3 teacher's, a row count no tile divides, and
# fewer rows than one block holds
LN_CASES = [('B0 stage1', 8 * 16384, 32), ('B0 stage2', 8 * 4096, 64),
            ('B0 stage3', 8 * 1024, 160), ('B0 stage4', 8 * 256, 256),
            ('B3 stage1', 8 * 16384, 64), ('B3 stage3', 8 * 1024, 320),
            ('B3 stage4', 8 * 256, 512), ('odd rows', 1001, 160),
            ('few rows', 10, 32)]

# (name, logits' shape, labels' size, share of labels ignored, the edge of
# the source tile K6 must plan there: 0 is the gather variant). Each of
# K6's variants at least twice, once with tiles cut by the map's edge.
SEG_CE_CASES = [
    ('head CE bench', (8, 150, 128, 128), (512, 512), 0.05, 16),
    ('train-vs-CPU batch', (2, 150, 128, 128), (512, 512), 0.05, 16),
    ('non-integer ratio', (2, 150, 30, 40), (125, 161), 0.05, 16),
    ('odd sizes', (2, 150, 31, 33), (97, 130), 0.05, 16),
    ('downsampling', (2, 19, 64, 48), (24, 20), 0.05, 16),
    ('ratio 1', (2, 19, 40, 40), (40, 40), 0.05, 16),
    ('all ignored', (2, 150, 32, 32), (128, 128), 1.0, 16),
    ('ratio 8', (1, 19, 16, 16), (128, 128), 0.05, 8),
    ('ratio ~8, odd', (2, 19, 21, 19), (190, 150), 0.05, 8),
    ('ratio 12.5', (1, 19, 24, 24), (300, 300), 0.05, 4),
    ('ratio ~11, odd', (2, 19, 18, 22), (217, 231), 0.05, 4),
    ('ratio 32 (gather)', (1, 19, 8, 8), (256, 256), 0.05, 0)]


def bound(nbytes, ops, mm_ops=0.0, mm_peak=PEAK_F32):
    """-> (bound_ms, bound_by): the larger of bytes over the memory rate
    and operations over the peak rate of their type."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = ops / PEAK_F32 + mm_ops / mm_peak
    return max(t_bytes, t_ops) * 1e3, \
        'bytes' if t_bytes >= t_ops else 'operations'


def _size(dtype):
    return 2 if dtype == torch.bfloat16 else 4


def ln_bounds(rows, c, dtype):
    """(K10's, K11's) bound on (rows, c): x read and y written (K11: x and
    dy read, dx written) in ``dtype``, the fp32 parameters (their gradients)
    beside them; 8 (17) operations per element."""
    size = _size(dtype)
    return (bound(2 * size * rows * c + 2 * 4 * c, 8 * rows * c),
            bound(3 * size * rows * c + 3 * 4 * c, 17 * rows * c))


def seg_ce_bounds(shape, out_hw, dtype):
    """(K5's, K6's) bound on (B, C, h, w) logits and (H, W) labels: the
    logits read in ``dtype``, the int32 labels read and the pixels' fp32
    maximum and exp-sum written (K6: read, and dz written); 10 (21)
    operations per upsampled value."""
    b, c, h, w = shape
    src = _size(dtype) * b * c * h * w
    px = b * out_hw[0] * out_hw[1]
    return (bound(src + 4 * px + 2 * 4 * px, 10 * c * px),
            bound(src + 4 * px + 2 * 4 * px + src, 21 * c * px))
