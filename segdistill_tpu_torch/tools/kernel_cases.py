"""The shapes at which the group-KL (K3, K4), seg-CE (K5, K6), pixel-KL
(K7, K8) and LayerNorm (K10, K11) kernels are checked and timed on the
card, and the least time the card could take for them: one list for
``chip_smoke.py`` and ``tests/test_torch_port_cuda.py``, which hold the
kernels to their limits, and ``tools/bench_kernels.py``, which only times
them (and K1 at its own shapes, :data:`RESIZE_SUM_CASES`). K3's, K5's and
K7's forward variants (the output tile, or the gather variant where a
window is larger than the block stages: ratios near 1 and downsampling)
follow from the same shapes (the K7 cases name theirs);
``tests/test_torch_port_fwd_plan.py`` checks that each runs at two of them
or more.
"""

import torch

# NVIDIA H100 SXM: HBM3 bytes/s, fp32 FLOP/s outside the tensor cores, dense
# bf16 FLOP/s on them
PEAK_BYTES, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 989e12
# exponentials a second on the special-function units: 16 a clock an SM, 132
# SMs at 1.98 GHz (a floor beside the bound, which counts an exponential as
# one fp32 operation)
PEAK_EXP2 = 16 * 132 * 1.98e9

# (name, NHWC parts' shapes, output size) of K1: the B0 head (three stage
# maps upsampled to the first stage's grid and summed) at serving batch 1
# and train batch 8, the B3 teacher's head at E = 768 (it runs under no_grad
# on every CGD step), and a non-integer ratio
RESIZE_SUM_CASES = [
    (f'B0 head b{b} E{e}', [(b, s, s, e) for s in (16, 32, 64)], (128, 128))
    for b, e in ((1, 256), (8, 256), (8, 768))] + [
    ('non-integer ratio', [(2, 15, 20, 256), (2, 23, 31, 256)], (61, 83))]

# K10 in one CGD (or PD) train step, batch 8 at 512x512, bf16 backbones:
# (name, rows, C, launches, the plan K10 must take there: lanes a row,
# vectors a lane, rows in flight, threads a block). Each stage has its
# patch-embedding norm, norm1 and norm2 in every block and the stage norm
# at (8 H W, C); stages 1-3 also the SRA norm of every block at the keys'
# grid, 2048 rows. The B0 student's 30 launches (it also runs K11 on each),
# then the frozen B3 teacher's 89 (no gradient).
LN_STEP_CASES = [
    ('B0 stage1', 131072, 32, 6, (4, 1, 2, 256)),
    ('B0 stage1 sr', 2048, 32, 2, (4, 1, 1, 64)),
    ('B0 stage2', 32768, 64, 6, (4, 2, 1, 256)),
    ('B0 stage2 sr', 2048, 64, 2, (4, 2, 1, 64)),
    ('B0 stage3', 8192, 160, 6, (4, 5, 1, 128)),
    ('B0 stage3 sr', 2048, 160, 2, (4, 5, 1, 64)),
    ('B0 stage4', 2048, 256, 6, (16, 2, 1, 128)),
    ('B3 stage1', 131072, 64, 8, (8, 1, 2, 256)),
    ('B3 stage1 sr', 2048, 64, 3, (4, 2, 1, 64)),
    ('B3 stage2', 32768, 128, 10, (16, 1, 2, 256)),
    ('B3 stage2 sr', 2048, 128, 4, (8, 2, 1, 64)),
    ('B3 stage3', 8192, 320, 38, (8, 5, 1, 256)),
    ('B3 stage3 sr', 2048, 320, 18, (8, 5, 1, 64)),
    ('B3 stage4', 2048, 512, 8, (16, 4, 1, 128))]
# the serving path's, fp32, the B0 student at batch 1, 512x512: (name,
# rows, C, launches a request, the plan)
LN_SERVING_CASES = [
    ('B0 b1 stage1', 16384, 32, 6, (8, 1, 1, 256)),
    ('B0 b1 stage1 sr', 256, 32, 2, (8, 1, 1, 64)),
    ('B0 b1 stage2', 4096, 64, 6, (8, 2, 1, 128)),
    ('B0 b1 stage2 sr', 256, 64, 2, (8, 2, 1, 64)),
    ('B0 b1 stage3', 1024, 160, 6, (8, 5, 1, 64)),
    ('B0 b1 stage3 sr', 256, 160, 2, (8, 5, 1, 64)),
    ('B0 b1 stage4', 256, 256, 6, (16, 4, 1, 64))]
# The widest norm: Swin-T's last PatchMerging norm, over 4 x 384 channels,
# at batch 2 and 512x512 (its stage grid 16 x 16): (name, rows, C, launches
# a swin_CGD step, the plan in bf16 and in fp32)
LN_WIDE_CASES = [('Swin merge3 b2', 512, 1536, 1, (32, 6, 1, 64),
                  (32, 12, 1, 64))]
# (name, rows, C) of every K10/K11 check on the card: the step's shapes
# (the first, B0 stage 1, is the kernels line's), the serving path's, a row
# count no block divides, fewer rows than one block holds, and C = 1536
LN_CASES = [(name, rows, c) for name, rows, c, _, _ in
            LN_STEP_CASES + LN_SERVING_CASES] + [
    ('odd rows', 1001, 160), ('few rows', 10, 32)] + [
    (name, rows, c) for name, rows, c, _, _, _ in LN_WIDE_CASES]

# The miniature convergence run's SegFormer head (``tools/convergence.py``,
# fp32): 4 classes at stride 4 of 64 x 64 crops, batch 4, its CE and (on
# the CGD run) the group-KL over groups of 2, channels permuted; entries of
# SEG_CE_CASES and GROUP_KL_CASES below.
CONVERGENCE_CE = ('convergence C4', (4, 4, 16, 16), (64, 64), 0.05, 16)
CONVERGENCE_GKL = ('convergence C4 g2', (4, 4, 16, 16), (64, 64), 2, True,
                   16)

# (name, logits' shape, labels' size, share of labels ignored, the edge of
# the source tile K6 must plan there: 0 is the gather variant). Each of
# K6's variants at least twice, once with tiles cut by the map's edge.
# 'train-vs-CPU batch' is also PointRend's FPNHead at its batch of 2.
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
    ('ratio 32 (gather)', (1, 19, 8, 8), (256, 256), 0.05, 0),
    ('ratio 30, odd (gather)', (2, 19, 10, 9), (300, 270), 0.05, 0),
    ('Cityscapes b2', (2, 19, 64, 128), (512, 1024), 0.05, 8),
    ('PSANet b2', (2, 150, 64, 64), (512, 512), 0.05, 8),
    ('Cityscapes b2 ratio 4', (2, 19, 128, 256), (512, 1024), 0.05, 16),
    ('Cityscapes b2 ratio 2', (2, 19, 256, 512), (512, 1024), 0.05, 16),
    ('HRF b4 ratio 1', (4, 2, 256, 256), (256, 256), 0.05, 16),
    ('HRF b4 ratio 2', (4, 2, 128, 128), (256, 256), 0.05, 16),
    ('VOC b4', (4, 21, 64, 64), (512, 512), 0.05, 8),
    ('Context b4', (4, 60, 60, 60), (480, 480), 0.05, 8),
    CONVERGENCE_CE]
# The train paths' head CEs on the SGD recipes, bf16 at the configs' batch
# of 2 (name, the SEG_CE_CASES entry, K5 and K6 launches a step at it): the
# Cityscapes PSPNet's decode and FCN auxiliary heads at 19 classes, stride
# 8 of a 512 x 1024 crop; PSANet's decode and auxiliary heads at stride 8
# of 512 x 512; PointRend's FPNHead at stride 4 (the point head's CE takes
# no kernel); the Cityscapes recipes of ``recipes.py``: OCRNet-HR18's FCN
# and OCR heads, FCN-HR18's and the DeepLabV3+ heads (ResNet and
# MobileNetV2) at stride 4, their FCN auxiliary heads, DeepLabV3's and
# OCRNet-R50's two heads at stride 8, and LRASPP's at stride 2; the HRF
# recipes' UNet heads at 2 classes on 256 x 256 crops at batch 4, the
# decode head at stride 1 and the FCN auxiliary head at stride 2 (the
# ResNeSt-101 PSPNet's two heads are the Cityscapes PSPNet's shape);
# PSPNet-R50-d8's decode and FCN auxiliary heads at stride 8 on the Pascal
# recipes, batch 4: 21 classes on 512 x 512 (VOC12-aug), 60 on 480 x 480
# (Pascal Context).
SEG_CE_PATH_CASES = [
    ('Cityscapes PSPNet decode + aux', 'Cityscapes b2', 2),
    ('PSANet decode + aux', 'PSANet b2', 2),
    ('PointRend FPNHead', 'train-vs-CPU batch', 1),
    ('OCRNet-HR18 FCN + OCR', 'Cityscapes b2 ratio 4', 2),
    ('FCN-HR18', 'Cityscapes b2 ratio 4', 1),
    ('DeepLabV3+ sep-ASPP (R50, MNv2)', 'Cityscapes b2 ratio 4', 1),
    ('DeepLabV3+ FCN aux (R50, MNv2)', 'Cityscapes b2', 1),
    ('DeepLabV3-R50, OCRNet-R50 (2 heads)', 'Cityscapes b2', 2),
    ('LRASPP-MobileNetV3', 'Cityscapes b2 ratio 2', 1),
    ('UNet decode (FCN, PSP, ASPP; HRF)', 'HRF b4 ratio 1', 1),
    ('UNet FCN aux (HRF)', 'HRF b4 ratio 2', 1),
    ('PSPNet VOC12-aug decode + aux', 'VOC b4', 2),
    ('PSPNet Pascal Context decode + aux', 'Context b4', 2)]

# (name, maps' shape, output size, group size, channels permuted, the edge
# of the source tile K4 must plan there: 0 is the gather variant). K4 keeps
# no per-output map, so its tiles fit larger ratios than K6's and K8's:
# 16 up to ~10, 8 up to ~16, 4 up to ~30. Each variant at least twice, once
# with tiles cut by the map's edge; 'C7 g3 pad' has a last group of one
# channel and two -1e9 pad channels.
GROUP_KL_CASES = [
    ('CGD bench perm', (8, 150, 128, 128), (512, 512), 10, True, 16),
    ('CGD bench identity', (8, 150, 128, 128), (512, 512), 10, False, 16),
    ('C19 g10 pad', (2, 19, 64, 64), (256, 256), 10, True, 16),
    ('C7 g3 pad', (2, 7, 8, 8), (16, 16), 3, True, 16),
    ('non-integer ratio', (2, 150, 30, 40), (125, 161), 10, True, 16),
    ('odd sizes', (2, 150, 31, 33), (97, 130), 10, True, 16),
    ('downsampling', (2, 19, 64, 48), (24, 20), 10, True, 16),
    ('ratio 1', (2, 19, 40, 40), (40, 40), 10, True, 16),
    ('ratio 8', (1, 19, 16, 16), (128, 128), 10, True, 16),
    ('ratio ~8, odd', (2, 19, 21, 19), (190, 150), 10, True, 16),
    ('ratio 12.5', (1, 19, 24, 24), (300, 300), 10, True, 8),
    ('ratio ~11, odd', (2, 19, 18, 22), (217, 231), 10, True, 8),
    ('ratio 32', (1, 19, 8, 8), (256, 256), 10, True, 4),
    ('ratio 30, odd', (2, 19, 10, 9), (300, 270), 10, False, 4),
    ('ratio 40 (gather)', (1, 19, 8, 8), (320, 320), 10, True, 0),
    ('ratio ~50, odd (gather)', (2, 7, 6, 5), (300, 250), 3, True, 0),
    CONVERGENCE_GKL]

# A student and a teacher of different sizes: (name, the student's maps'
# shape, the teacher's (h, w), output size, group size, channels permuted,
# the rows of K3's output tile (0: its gather variant), the edge of K4's
# source tile (0: its gather variant)), each planned in the tiles'
# two-geometry form where both maps' windows fit. The PSP student's logits
# at stride 8 (64 x 64 at a 512 crop) against the B3 teacher's at stride 4
# (128 x 128), batch 2 as the psp configs train, with CGD's group of 5
# (shuffled and not) and CD's group of 1; a pad group (C 19, g 10); odd
# sizes with the teacher smaller on one axis; a teacher smaller than the
# student; and the gather variants: a teacher at ratio 1 (K3's teacher
# window is larger than the block stages; K4 still fits a tile of 8), a
# student at ratio 40 (no K4 tile; K3's tile) and both at once.
GROUP_KL_TWO_SIZE_CASES = [
    ('PSP CGD g5 perm', (2, 150, 64, 64), (128, 128), (512, 512), 5, True,
     128, 16),
    ('PSP CGD g5 identity', (2, 150, 64, 64), (128, 128), (512, 512), 5,
     False, 128, 16),
    ('PSP CD g1', (2, 150, 64, 64), (128, 128), (512, 512), 1, False, 128,
     16),
    ('C19 g10 pad, two sizes', (2, 19, 16, 16), (32, 32), (128, 128), 10,
     True, 128, 16),
    ('odd, two sizes', (1, 7, 9, 11), (13, 5), (37, 41), 3, True, 128, 16),
    ('teacher smaller', (2, 19, 32, 32), (16, 16), (128, 128), 10, True,
     128, 16),
    ('teacher ratio 1 (fwd gather)', (2, 19, 32, 32), (128, 128),
     (128, 128), 10, True, 0, 8),
    ('student ratio 40 (bwd gather)', (1, 19, 8, 8), (16, 16), (320, 320),
     10, True, 128, 0),
    ('both gather', (1, 7, 4, 4), (160, 160), (160, 160), 3, True, 0, 0)]
# (name, the student's maps' shape, the teacher's (h, w), output size) of
# K7/K8 with two sizes: the PSP PD pair, and the odd and smaller-teacher
# shapes above
PIXEL_KL_TWO_SIZE_CASES = [
    ('PSP PD', (2, 150, 64, 64), (128, 128), (512, 512)),
    ('odd, two sizes', (2, 19, 9, 11), (13, 5), (37, 41)),
    ('teacher smaller', (2, 19, 32, 32), (16, 16), (128, 128))]

# The forwards' stress cases, in the layouts above: logits of N(0, 30²), so
# that K3's group maxima and K5's chunk rescale shift far from 0 (K4 and
# K6 run on what they saved), at the bench shape and with tiles cut by the
# map's edge and a pad group.
SPREAD = 30.0
GROUP_KL_SPREAD_CASES = [
    ('spread 30 bench', (8, 150, 128, 128), (512, 512), 10, True, 16),
    ('spread 30 pad', (2, 19, 30, 40), (125, 161), 10, True, 16)]
SEG_CE_SPREAD_CASES = [
    ('spread 30 bench', (8, 150, 128, 128), (512, 512), 0.05, 16),
    ('spread 30 cut', (2, 19, 30, 40), (125, 161), 0.05, 16)]
# K5's exact ties (tie_logits): the first maximum must win, and `correct`
# equal the plain version's count exactly.
SEG_CE_TIE_CASES = [
    ('ties bench', (8, 150, 128, 128), (512, 512), 0.05, 16),
    ('ties ratio 4', (2, 19, 32, 32), (128, 128), 0.05, 16)]
TIE_COPY = (4, 11)  # channel 11 is a copy of channel 4


def tie_logits(shape, labels, gen):
    """Logits that are multiples of 1/8 in [-1, 1] (every bilinear lerp at
    ratio 4 is exact in float32, so the kernel and the plain version see
    the same values, with many exact ties), channel 11 a copy of channel 4;
    every other row of ``labels`` is set to 11, the later of that pair, so
    that an argmax other than the first maximum counts other pixels."""
    z = torch.randint(-8, 9, shape, device=labels.device,
                      generator=gen).float() / 8
    src, dst = TIE_COPY
    z[:, dst] = z[:, src]
    labels[:, ::2] = dst
    return z


# (name, maps' shape, output size, the edge of the source tile K8 must plan
# there: 0 is the gather variant, the rows of K7's output tile: 0 is its
# gather variant). Each variant of either at least twice, once with tiles
# cut by the map's edge.
PIXEL_KL_CASES = [
    ('PD bench', (8, 150, 128, 128), (512, 512), 16, 32),
    ('non-integer ratio', (2, 150, 30, 40), (125, 161), 16, 32),
    ('odd sizes', (2, 150, 31, 33), (97, 130), 16, 0),
    ('downsampling', (2, 19, 64, 48), (24, 20), 16, 0),
    ('ratio 1', (2, 150, 64, 64), (64, 64), 16, 0),
    ('ratio 8', (1, 19, 16, 16), (128, 128), 8, 32),
    ('ratio ~8, odd', (2, 19, 21, 19), (190, 150), 8, 32),
    ('ratio 12.5', (1, 19, 24, 24), (300, 300), 4, 32),
    ('ratio ~11, odd', (2, 19, 18, 22), (217, 231), 4, 32),
    ('ratio 32 (gather)', (1, 19, 8, 8), (256, 256), 0, 32),
    ('ratio 30, odd (gather)', (2, 19, 10, 9), (300, 270), 0, 32)]
# K7's stress cases, in that layout and with the temperature: maps of N(0,
# 30²), whose chunk maxima jump far from the running ones (every rescale is
# tested), at the bench shape and cut by the map's edge with C = 19, not a
# multiple of K7's chunk (its pad units run); and tau 0.5 and 4 on N(0, 1)
# maps, where the base-2 scale k = log2 e / tau moves the pad units'
# kFwdPad * k and every exponent.
PIXEL_KL_SPREAD_CASES = [
    ('spread 30 bench', (8, 150, 128, 128), (512, 512), 16, 32, 1.0),
    ('spread 30 cut', (2, 19, 30, 40), (125, 161), 16, 32, 1.0)]
PIXEL_KL_TAU_CASES = [
    ('tau 0.5 non-integer', (2, 150, 30, 40), (125, 161), 16, 32, 0.5),
    ('tau 4 ratio ~8', (2, 19, 21, 19), (190, 150), 8, 32, 4.0)]


def bound(nbytes, ops, mm_ops=0.0, mm_peak=PEAK_F32):
    """-> (bound_ms, bound_by): the larger of bytes over the memory rate
    and operations over the peak rate of their type."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = ops / PEAK_F32 + mm_ops / mm_peak
    return max(t_bytes, t_ops) * 1e3, \
        'bytes' if t_bytes >= t_ops else 'operations'


def _size(dtype):
    return 2 if dtype == torch.bfloat16 else 4


def resize_sum_bound(shapes, out_hw, dtype):
    """K1's bound on NHWC parts of ``shapes`` summed at ``out_hw``: every
    part read and the output written once in ``dtype``, 8 operations per
    part and output element."""
    b, _, _, e = shapes[0]
    o = b * out_hw[0] * out_hw[1] * e
    n_in = sum(x[0] * x[1] * x[2] * x[3] for x in shapes)
    return bound(_size(dtype) * (n_in + o), 8 * len(shapes) * o)


def ln_bounds(rows, c, dtype):
    """(K10's, K11's) bound on (rows, c): x read and y written (K11: x and
    dy read, dx written) in ``dtype``, the fp32 parameters (their gradients)
    beside them; 8 (17) operations per element."""
    size = _size(dtype)
    return (bound(2 * size * rows * c + 2 * 4 * c, 8 * rows * c),
            bound(3 * size * rows * c + 3 * 4 * c, 17 * rows * c))


def kl_bounds(shape, out_hw, dtype, pixel_maps, teacher_hw=None):
    """(forward's, backward's) bound of a two-map KL on (B, C, h, w)
    student maps and (B, C, h_t, w_t) teacher maps (``teacher_hw``; the
    student's by default) upsampled to (H, W) in ``dtype``: both maps read
    (the backward: and dxs written), and ``pixel_maps`` fp32 maps of (B, H,
    W) written by the forward and read by the backward (K7/K8: the two
    log-sum-exps; K3/K4: none); 23 (32) operations per upsampled value."""
    b, c, h, w = shape
    ht, wt = teacher_hw or (h, w)
    src = _size(dtype) * b * c * h * w
    src_t = _size(dtype) * b * c * ht * wt
    px = b * out_hw[0] * out_hw[1]
    return (bound(src + src_t + 4 * pixel_maps * px, 23 * c * px),
            bound(2 * src + src_t + 4 * pixel_maps * px, 32 * c * px))


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
