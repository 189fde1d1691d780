#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training and command-line paths
on one NVIDIA GPU.

    python3 chip_smoke.py

Phases: (1) device, (2) build the hand-written kernels from csrc/, one nvcc
per source, all at once, (3) K1 resize_sum, (4) K2 sra_attn, (5) K3/K4
group-KL forward and backward, (6) K5/K6 seg-CE forward and backward, (7)
K7/K8 pixel-KL forward and backward and (8) K9, the SRA backward, with K2
keeping the row log-sum-exp, against their plain PyTorch versions at the
main paths' shapes, with CUDA-event timings (K1 and K2 by device time;
K4, K6 and K8, the one tile kernel with three losses, also at odd,
non-integer and downsampling shapes, each kernel's tile edges 16, 8 and 4
and its gather variant at two shapes or more with the plan asserted, two
backward runs bitwise equal; K3, K5 and K7, the one forward tile kernel,
at its output tile and its gather variant with the plan asserted, two
forward runs bitwise equal, K7's log-sum-exps against a float64 evaluation
and at tau 0.5 and 4; the cases are ``tools/kernel_cases.py``'s), then
K10/K11, the LayerNorm forward and backward, at every shape of the CGD
step (B0 student, B3 teacher) and of a serving request, against their
plain version, K10's plan as the case names it, two forward and two
backward runs bitwise equal, K10's device time at each shape and, at the
kernels line's, beside ``F.layer_norm``, the plain version and the floor
of an empty kernel on K10's grid, K10 right after the kernel that makes
its input, and on slices whose rows do not fold into one stride, (9)
full-width
Segformer-B0
(ADE20K, 150 classes, random weights from seed 0) serving seeded requests
through ``inference_segmentor`` in whole mode, again with
``fused_attention=True``, and slide mode at 1024x2048; the fp32 GPU logits
against the same model on the CPU, bf16 against fp32, throughput, (10) the
CGD distillation train step of ``configs/exp_tab5/segformer_CGD.py`` (B0
student, B3 teacher, bf16 backbones, batch 8 at 512x512, seeded random
weights and data) through ``prepare_training``'s step: losses, step time,
images/s and peak memory, (11) one fp32 train step of the same model at
batch 2 against a copy on the CPU (loss terms and student gradients), and
(12, 13) the same two for the PD train step of
``configs/exp_tab5/segformer_PD.py`` with the student's
``fused_attention='train'``, and (14) the command-line path: a seeded
dataset of ``.npy`` files is written to a temporary directory,
``segdistill_tpu_torch.tools.train`` trains the full-width CGD config on it
for 12 iterations through the real training pipeline (512x512 crops, batch
8, bf16 backbones) with checkpoints and evaluations at 6 and 12, a second
run resumes from the iteration-6 checkpoint to the same losses (and a
resume that takes no step restores that file bitwise), and ``tools.test``
reproduces the last evaluation's mIoU; then the Tab5 students of
``configs/exp_tab5/{psp,swin}_*.py``: (15, 16) the PSPNet-R50 (ResNetV1c-d8
+ PSPHead) and Swin-T + UPerHead students of ``psp_baseline.py`` and
``swin_baseline.py`` served through ``init_segmentor`` (the student of a
distillation config) at full width and depth, four 512x512 requests, the
fp32 GPU logits against the CPU; (17, 18) the timed ``psp_CGD`` and
``swin_CGD`` steps, bf16 backbones, the configs' batch of 2 at 512x512; and
(19-21) fp32 steps of ``psp_CGD``, ``psp_PD`` and ``swin_CGD`` at batch 1
and 256x256 against the CPU. The KL phases (5, 7) also hold K3/K4 and
K7/K8 with a teacher of another size than the student (the PSP student's
logits at stride 8 against the B3 teacher's at stride 4), which take the
gather variants, and the LayerNorm phase K10/K11 at C = 1536, Swin-T's last
PatchMerging norm. Then the ``configs/extra`` models at full width and
depth (random weights from seed 0): (22-24) PSANet-R50 (PSAHead + FCN
auxiliary head) and PointRend-R50/FPN (FPNHead + PointHead, a cascade) on
ADE20K, and PSPNet-R50 with the FCN auxiliary head on Cityscapes (19
classes), each through ``prepare_training``'s SGD step with a bf16
backbone at the config's batch of 2 (512x512; Cityscapes 512x1024), 2 + 10
steps, K5/K6 launched twice a step (PointRend: once); (25-27) the same
models served through ``inference_segmentor``: four 512x512 requests in
whole mode (PointRend with its subdivision refinement), two 1024x2048
requests in slide mode (769x769 windows at stride 513, eight a request),
the fp32 GPU logits against the CPU; and (28-30) one fp32 train step of
each at batch 1 and 256x256 against the CPU step in float64 (PointRend's
training points drawn once and given to both). Then the Cityscapes
recipes of ``segdistill_tpu_torch/recipes.py`` (each model fragment of
``configs/_base_/models/`` with the Cityscapes data, runtime and schedule
bases, composed in memory; random weights from seed 0): (31-37) the SGD
train steps of OCRNet-HR18 (FCN at weight 0.4, then OCR), DeepLabV3+-R50-d8
and LRASPP-MobileNetV3 (2 + 10 steps), FCN-HR18, OCRNet-R50-d8,
DeepLabV3-R50-d8 and DeepLabV3+ on MobileNetV2-d8 (2 + 3 steps), bf16
backbones, batch 2 at 512x1024, each with its K5/K6 launches a step;
(38-44) each served in whole mode at 1024x2048 in fp32 (two requests to
the first three, one to the others); and (45-47) the first three's fp32
eval logits of every head and one train step at batch 1 and 256x512
against the CPU (the step's gradients against the CPU in float64). The
seg-CE phase (6) also holds K5/K6 at those paths' shapes (C = 19 at (2,
19, h, w) -> 512x1024 at ratios 2, 4 and 8; C = 150 at (2, 150, 64, 64)
and (2, 150, 128, 128) -> 512x512) and prints their device times beside
their bounds; the kernels line adds K5 and K6 at ratios 2 and 4. Then
this slice: (48, 49) the multi-teacher CGD steps of ``recipes.py``
(``SDModuleMT``: B0 student, B2 and B3 teachers, bf16 backbones, batch 8 at
512x512, 2 + 10 steps), aligned (one CGD entry a teacher) and the random
ensemble (one teacher a step), each step's launches held to the forwards
it ran (K1 3 / 2, K3/K4 2 / 1, K10 172 / 83 or 119 by the teacher the step
drew, K11 30, K5/K6 1); (50, 51) an fp32 step of each at batch 2 and
256x256 against the CPU, the permutation and the teacher injected;
(52-57) the SGD steps of the Fast-SCNN, CGNet and PSPNet-ResNeSt-101-d8
Cityscapes recipes (batch 2 at 512x1024) and of the three UNet recipes on
HRF (batch 4 at 256x256; K5/K6 at 2 classes, ratios 1 and 2, the
launches counted at each geometry), 2 + 3 steps each with its K5/K6
launches a step; (58-63) the Cityscapes three served at 1024x2048 in
whole mode, FCN-UNet's HRF recipe a 2336x3504 request and the other two
fragments' DRIVE recipes a 584x565 one in slide mode, the windows counted
against the slide grid; (64-69) every head's fp32 eval logits and one
train step of each at batch 1 against the CPU (the gradients against the
CPU in float64); (70) ResNeXt-50 32x4d, which no recipe uses, as a
backbone alone against the CPU at three seeds. The seg-CE phase (6) also
holds K5/K6 at the UNet shapes ((4, 2, 256, 256) and (4, 2, 128, 128) ->
256x256), which the kernels line adds with the UNet steps' launches at
each. Then the attention heads' Cityscapes recipes of ``recipes.py``
(ResNetV1c-50-d8 with the NL, GC, DNL, CC, ANN, APC, DM, DA, EMA or Enc
head and the FCN auxiliary head, each fragment as it stands): (71-80)
their SGD steps, bf16 backbone, batch 2 at 512x1024, 2 + 3 steps, K5/K6
launched at (2, 19, 64, 128) -> 512x1024 alone, 4 a step for DANet's
three CEs and the auxiliary head's, 2 for the others (EMANet's bases
move and stay float32, its frozen ``ema_mid_conv`` stays bitwise); (81-90)
one fp32 1024x2048 whole-mode request each, with its peak memory; (91-100)
every head's fp32 eval logits against the CPU at 256x512 (DANet's three,
EncNet's se logits), with the zero-initialised attention branches drawn
from a seed so that the comparison sees them, and for DANet, EMANet,
EncNet and CCNet one fp32 train step against the CPU in float64. The
kernels line adds K5/K6 at that geometry with the launches those ten
steps made there. The launch count of each kernel is read over each main
path (9, 10, 12, 14, 15-18, 22-27, 31-37, 48, 49, 52-57, 71-80).

Any failed check raises, and the script exits non-zero. It needs a CUDA
device and the repository around it. The second line before the last is
a JSON object with one entry per kernel (its time at its main path's
shape beside the plain version's, the least time the card could take for
that work, and a PyTorch library call's where one computes the same
function); the last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import copy
import itertools
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / 'configs' / 'segformer' / 'segformer_b0_512x512_ade_160k.py'
CGD_CONFIG = ROOT / 'configs' / 'exp_tab5' / 'segformer_CGD.py'
PD_CONFIG = ROOT / 'configs' / 'exp_tab5' / 'segformer_PD.py'
# the Tab5 PSPNet-R50 (ResNetV1c-d8 + PSPHead) and Swin-T + UPerHead students
TAB5 = ROOT / 'configs' / 'exp_tab5'
PSP_BASELINE = TAB5 / 'psp_baseline.py'
SWIN_BASELINE = TAB5 / 'swin_baseline.py'
PSP_CGD, PSP_PD, SWIN_CGD = (TAB5 / 'psp_CGD.py', TAB5 / 'psp_PD.py',
                             TAB5 / 'swin_CGD.py')
# the config's checkpoints are not in the repository: random weights
NO_CHECKPOINTS = {'model.t_pretrain': None, 'model.s_pretrain': None,
                  'model.cfg_s.pretrained': None}
# the student's SRA attention through K2 and its backward K9
STUDENT_FA_TRAIN = {'model.cfg_s.backbone.fused_attention': 'train'}
BF16_BACKBONES = {'model.cfg_s.backbone.dtype': 'bfloat16',
                  'model.cfg_t.backbone.dtype': 'bfloat16'}
NUM_CLASSES = 150
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS = 8, 2, 10
# the psp and swin configs' own batch (samples_per_gpu 2); their fp32
# GPU-vs-CPU step at batch 1 and 256x256, full width and depth
TAB5_BATCH = 2
TAB5_VS_CPU_BATCH, TAB5_VS_CPU_HW = 1, 256
TAB5_REQUESTS = 4  # seeded 512x512 requests to each Tab5 student
# dropout and drop-path off for the GPU-vs-CPU steps (no draw to match)
NO_DROP = {'model.cfg_s.decode_head.dropout_ratio': 0.0,
           'model.cfg_t.decode_head.dropout_ratio': 0.0,
           'model.cfg_t.backbone.drop_path_rate': 0.0}
NO_DROP_PATH_S = {'model.cfg_s.backbone.drop_path_rate': 0.0}
# the configs/extra models: (config, tag, classes, the train crop, K5/K6
# launches a train step, the serving requests' sizes)
EXTRA = ROOT / 'configs' / 'extra'
PSANET, POINTREND, PSP_CITY = (EXTRA / 'psanet_r50_ade.py',
                               EXTRA / 'pointrend_r50_ade.py',
                               EXTRA / 'pspnet_r50_cityscapes_slide.py')
EXTRA_PATHS = [
    (PSANET, 'PSANet-R50', 150, (512, 512), 2, [(512, 512)] * 4),
    (POINTREND, 'PointRend-R50/FPN', 150, (512, 512), 1, [(512, 512)] * 4),
    (PSP_CITY, 'PSPNet-R50 Cityscapes', 19, (512, 1024), 2,
     [(1024, 2048)] * 2)]
EXTRA_BATCH = 2  # the configs' samples_per_gpu
# the Cityscapes recipes of segdistill_tpu_torch/recipes.py (each fragment
# of configs/_base_/models/ with the Cityscapes data, runtime and schedule
# bases, composed in memory): (recipe, tag, K5/K6 launches a train step,
# timed train steps, 1024x2048 requests, whether the fp32 step and logits
# are held to the CPU). The three headline models take the full run.
ZOO_PATHS = [
    ('ocrnet_hr18', 'OCRNet-HR18', 2, 10, 2, True),
    ('deeplabv3plus_r50-d8', 'DeepLabV3+-R50-d8', 2, 10, 2, True),
    ('lraspp_m-v3-d8', 'LRASPP-MobileNetV3', 1, 10, 2, True),
    ('fcn_hr18', 'FCN-HR18', 1, 3, 1, False),
    ('ocrnet_r50-d8', 'OCRNet-R50-d8', 2, 3, 1, False),
    ('deeplabv3_r50-d8', 'DeepLabV3-R50-d8', 2, 3, 1, False),
    ('deeplabv3plus_m-v2-d8', 'DeepLabV3+-MobileNetV2-d8', 2, 3, 1, False)]
ZOO_CLASSES, ZOO_HW, ZOO_REQUEST_HW = 19, (512, 1024), (1024, 2048)
ZOO_VS_CPU_HW = (256, 512)
# K5/K6 at this slice's new geometries: (SEG_CE_CASES entry, the recipes
# whose train steps launch them there and nowhere else)
ZOO_CE_GEOMETRIES = [('Cityscapes b2 ratio 2', ('lraspp_m-v3-d8',)),
                     ('Cityscapes b2 ratio 4', ('ocrnet_hr18', 'fcn_hr18'))]
# the multi-teacher CGD steps of recipes.py (B0 <- B2 + B3, bf16 backbones,
# batch 8 at 512x512): aligned (one CGD entry a teacher) and the random
# ensemble (one teacher a step); their fp32 steps against the CPU at batch
# 2 and 256x256
MT_PATHS = [('mt_cgd_aligned', 'MT aligned'), ('mt_cgd_random', 'MT random')]
MT_VS_CPU_BATCH, MT_VS_CPU_HW = 2, 256
# K10 launches in one forward of a MiT: two LayerNorms a block, the
# spatial-reduction norm of each block of a stage at sr_ratio > 1, and a
# patch embedding's and a stage's norm a stage (B0 (2, 2, 2, 2) blocks: 30;
# B2 (3, 4, 6, 3): 53; B3 (3, 4, 18, 3): 89)
MIT_LN = {'b0': 30, 'b2': 53, 'b3': 89}
# this slice's recipes of recipes.py: (recipe, tag, classes, train crop,
# batch, K5/K6 launches a train step). Fast-SCNN's heads take the sigmoid
# CE and CGNet's the class-weighted CE: neither reaches K5/K6. Each 2 + 3
# steps, bf16 backbone.
ZOO2_PATHS = [
    ('fast_scnn', 'Fast-SCNN', 19, (512, 1024), 2, 0),
    ('cgnet', 'CGNet', 19, (512, 1024), 2, 0),
    ('pspnet_s101-d8', 'PSPNet-ResNeSt-101-d8', 19, (512, 1024), 2, 2),
    ('fcn_unet_s5-d16', 'FCN-UNet-S5-D16 (HRF)', 2, (256, 256), 4, 2),
    ('pspnet_unet_s5-d16', 'PSPNet-UNet-S5-D16 (HRF)', 2, (256, 256), 4, 2),
    ('deeplabv3_unet_s5-d16', 'DeepLabV3-UNet-S5-D16 (HRF)', 2, (256, 256),
     4, 2)]
ZOO2_STEPS = 3
ZOO2_VS_CPU_HW = {19: (256, 512), 2: (256, 256)}
# UNet requests: an HRF image (2336x3504) to the FCN recipe on HRF (256x256
# windows at stride 170), a DRIVE image (584x565) to the other two
# fragments' DRIVE recipes (64x64 windows at stride 42)
HRF_REQUEST_HW, DRIVE_REQUEST_HW = (2336, 3504), (584, 565)
# K5/K6 at the UNet recipes' geometries, 2 classes: the decode head at
# stride 1 and the FCN auxiliary head at stride 2 of the 256x256 crop, one
# launch of each a step
UNET_CE_GEOMETRIES = ['HRF b4 ratio 1', 'HRF b4 ratio 2']
# the attention-head recipes of recipes.py (ResNetV1c-50-d8, an attention
# head and the FCN auxiliary head, Cityscapes, each fragment as it stands):
# (recipe, tag, K5/K6 launches a train step, whether an fp32 train step is
# held to the CPU). K5/K6 run at ATTN_CE_GEOMETRY alone: the decode head's
# CE (DANet's three: pam_cam, pam, cam) and the auxiliary head's. Each
# 2 + ATTN_STEPS SGD steps, bf16 backbone, batch 2 at 512x1024; one fp32
# 1024x2048 whole-mode request; every head's fp32 logits against the CPU
# at ZOO_VS_CPU_HW.
ATTN_PATHS = [
    ('nonlocal_r50-d8', 'NLNet-R50-d8', 2, False),
    ('gcnet_r50-d8', 'GCNet-R50-d8', 2, False),
    ('dnl_r50-d8', 'DNLNet-R50-d8', 2, False),
    ('ccnet_r50-d8', 'CCNet-R50-d8', 2, True),
    ('ann_r50-d8', 'ANN-R50-d8', 2, False),
    ('apcnet_r50-d8', 'APCNet-R50-d8', 2, False),
    ('dmnet_r50-d8', 'DMNet-R50-d8', 2, False),
    ('danet_r50-d8', 'DANet-R50-d8', 4, True),
    ('emanet_r50-d8', 'EMANet-R50-d8', 2, True),
    ('encnet_r50-d8', 'EncNet-R50-d8', 2, True)]
ATTN_STEPS = 3
ATTN_CE_GEOMETRY = 'Cityscapes b2'
# a train path's K5/K6 launches by geometry: tag -> kernel name ->
# {(B, C, h, w, H, W): launches} (ops/seg_ce.py's LAUNCHES_BY_SHAPE)
CE_SHAPE_LAUNCHES = {}
# ResNeXt, which no recipe uses: the 50-layer 32x4d backbone alone, fp32,
# train mode, batch 2
RESNEXT = dict(type='ResNeXt', depth=50, groups=32, base_width=4,
               num_stages=4, out_indices=(0, 1, 2, 3),
               norm_cfg=dict(type='SyncBN', requires_grad=True),
               norm_eval=False, style='pytorch')
RESNEXT_HW = (256, 512)
# ResNeXt's seeds. An fp32 evaluation of this step lies ~1e-3 from float64
#   on either device, most of it in the stem conv's weight gradient (a sum
#   over every input pixel), and one draw can land far nearer: at seed 1 an
#   H100 read 1.33e-3 against the CPU fp32 run's 7.0e-5, at seeds 0 and 2
#   1.07e-3 / 1.29e-3 against 9.2e-4 / 1.38e-3. So the floor of the fp32
#   limit is the largest CPU reading over the seeds, not each seed's own.
RESNEXT_SEEDS = (0, 1, 2)
# the card's float64 gradients against the CPU's (8e-15 read on an H100)
RESNEXT_F64_TOL_REL_L2 = 1e-10
# the command-line phase: dataset size, iterations, and where it saves and
# evaluates
CLI_TRAIN_IMAGES, CLI_VAL_IMAGES = 32, 8
CLI_ITERS, CLI_INTERVAL = 12, 6
CLI_IMAGE_HW = [(512, 683), (683, 512), (480, 640), (512, 512)]
DEVICE = 'cuda'
REQUEST_HW = [(512, 512), (512, 683), (480, 640), (1024, 2048)]

# Tolerances. Inputs of the kernel checks are N(0, 1).
# fp32: kernel and plain version compute the same fp32 formula with sums in
#   other orders (taps; dot products and softmax sums), errors ~1e-6.
K_TOL_F32 = 2e-5
# bf16, per element, against the plain version in fp32 on the same bf16
#   inputs: the kernel rounds its fp32 result to bf16 once, which moves it
#   by at most half a bf16 step, 2^-8 of its magnitude; the second term
#   (2^-12 of the output's rms, ~20x the fp32 order error) leaves no room
#   for bf16 accumulation.
K_TOL_BF16_REL = 2.0 ** -8
K_TOL_BF16_RMS = 2.0 ** -12
# bf16 SRA attention (K2, K9): the tensor cores take the probabilities P
#   (and, backward, dS) as bf16 operands, so each of the M terms of an
#   output element carries a rounding of 2^-9 relative; their sum leaves
#   noise of ~2^-10 of a scale that is the rms of the element's row (its
#   head-dim vector: a row with a peaked softmax has larger terms and more
#   noise) or, where that is larger (a row whose few values cancel), the
#   rms of the tensor; the element's own size does not matter (measured on
#   the CPU: 15-30x the 2^-12 above). So these kernels are held
#   (b) to the plain version in fp32 on the same bf16 inputs within 2^-8 of
#   the magnitude (the one final rounding) plus 2^-6 of that scale (5 sigma
#   of the noise over 10^6 elements, 2-3x headroom): a key dropped or
#   counted twice moves an element by ~2^-4 of it and fails; and
#   (a) to the plain version run in bf16, which rounds P and dS as the JAX
#   kernel does (the normalised P; the kernel rounds exp(s - running max)
#   and sums in another order, so the two sets of roundings are independent
#   and the results not bitwise equal): both sides round the result once
#   more, 2^-7 of the magnitude, plus 2^-5.5 of the scale (sqrt(2) of (b)'s:
#   two sets of operand roundings).
#   The error must also have no bias: its mean, and its mean along the sign
#   of the plain value (a wrong scale or a masked column shows there
#   first), within 0.05 of its rms plus 4 / sqrt(n) (the mean of unbiased
#   noise over n elements scatters by rms / sqrt(n)).
SRA_TOL_F32_REL = 2.0 ** -8
SRA_TOL_PLAIN_REL = 2.0 ** -7
SRA_TOL_F32_RMS = 2.0 ** -6
SRA_TOL_PLAIN_RMS = 2.0 ** -5.5
SRA_BIAS_MAX = 0.05
# Model fp32 GPU vs CPU (TF32 off): other summation orders and cuDNN
#   convolution algorithms through 8 blocks; relative to max |logit|.
#   Measured ~1.2e-6 on an H100; a TF32 or bf16 leak gives ~1e-3.
MODEL_TOL_REL = 1e-5
# PointRend's refined logits, GPU vs CPU: the subdivision writes refined
#   logits at the 8196 most uncertain positions of each step; where two
#   positions' uncertainties lie within the fp32 difference of the two runs
#   at the k-th, each run refines another one (a lerped logit against a
#   refined one). The first stage's logits keep MODEL_TOL_REL; of the
#   refined map's values at most this share may lie outside it.
REFINED_SWAP_SHARE = 1e-3
# bf16 backbone vs fp32: bf16 keeps 8 significant bits, rounded at every
#   linear, conv and residual add; relative L2 error of the logits.
BF16_TOL_REL_L2 = 5e-2
# Loss kernels (K3, K5, K7) against their plain versions, relative: they
#   sum up to 2.6 M fp32 terms per (b, group), or 2 M per-pixel CEs or KLs,
#   in other orders; measured <= 1.5e-6 on an H100 (K3, K5).
LOSS_TOL_REL = 2e-5
# Gradient kernels (K4, K6, K8): the per-element limits above, with the
#   incoming gradient scaled so that the plain gradient's max |value| is 1
#   (a backward is linear in it; unscaled entries are ~1e-7). K9: each of
#   dq, dk and dv and its plain version divided by the plain one's max
#   |value|, which is the same thing (the incoming dO is N(0, 1)).
# Correct-pixel count (K5): exact but for argmax near-ties, which another
#   summation order may break the other way; at most 1e-4 of the pixels.
#   Exactly equal on logits whose every lerp is exact (the tie cases of
#   tools/kernel_cases.py), where exact ties abound and the first maximum
#   must win.
CORRECT_TOL_SHARE = 1e-4
# Untrained model: logits near 0, so the CE is near ln(150) at step 1.
CE_INIT = math.log(NUM_CLASSES)
CE_INIT_TOL = 0.05
# fp32 train step, GPU (kernels) vs CPU (plain versions), TF32 off: each
#   loss term to a relative limit plus an absolute one, since an fp32 loss
#   that is a log-sum-exp over 10^6 values (log Z ~ 15) carries an absolute
#   error of ~1e-6, and an untrained pair's KL is only ~1e-3; the student
#   gradients' relative L2 over all parameters.
#   Measured on an H100: CE 9.5e-8 relative, KL 2.4e-6 absolute, gradients
#   7.5e-5; the limits are about 10x that.
TRAIN_LOSS_TOL_REL = 1e-6
TRAIN_LOSS_TOL_ABS = 2.5e-5
TRAIN_GRAD_TOL_REL_L2 = 1e-3
# The Tab5 PSP and Swin steps (batch 1, 256x256) hold their gradients to
#   the same step run in float64 on the CPU, at the same relative L2 limit.
#   Against the fp32 CPU step they would not fit it, and neither side is at
#   fault: the heads' pyramid pooling runs train-mode BN over 4 to 36
#   values a channel, which magnifies fp32 rounding ~13x (an activation
#   error of ~7e-6 reaches the bottleneck), and each ReLU whose input lies
#   within that error of 0 opens on one side and not the other, which moves
#   the gradient by that element's whole share: measured on an H100, the
#   GPU and CPU fp32 psp_CGD gradients 1.27e-3 apart while their
#   activations agree to 7e-6 and the gradient above the bottleneck's ReLU
#   to 1.5e-6 (9.7e-4 below it); the GPU's against float64, 4.8e-4. The
#   loss terms keep the limits above against the fp32 CPU step.
# A run resumed from a checkpoint against the uninterrupted one, each
#   logged loss: the weights, the optimizer state, the batches and every
#   random draw are the same, so only kernels that sum in an order that
#   varies from run to run (cuDNN's weight gradients) can tell them apart.
#   Measured on an H100 over four runs: at most 7e-5 of the loss; another
#   batch at the same iteration moves the loss by ~1e-2 of it or more (the
#   smoke prints the nearest pair). These iterations are early in a 1500-step
#   warmup (lr ~1e-7), where the losses hardly feel the optimizer's moments,
#   so what a resume restores is also held, bitwise, against the checkpoint
#   file (``_check_restored``).
# The Cityscapes recipes' fp32 steps (batch 1, 256x512) hold their
#   gradients to the CPU step in float64 too, at the limit above, unless
#   fp32 itself cannot evaluate the step that closely: HRNet's train-mode
#   step at initialisation is ill-conditioned (BN's gradient growth through
#   some 150 normalised layers: the CPU's own fp32 gradients lie 1.1e-2 of
#   the L2 norm from float64 on this CPU, 1.4e-2 with every conv a plain
#   GEMM, 1.2e-2 for FCN-HR18 alone; a ResNet-50's ~2e-3, PR 12's steps
#   1e-5-1.5e-3). There the card's fp32 gradients are held within
#   FP32_FLOOR_FACTOR times the CPU fp32 step's own distance from float64:
#   two fp32 evaluations of one step, neither at fault, measured 1.8x
#   apart on an H100 (OCRNet-HR18: 2.07e-2 against 1.13e-2); a wrong
#   kernel or wiring moves the gradients by O(1).
FP32_FLOOR_FACTOR = 4.0
RESUME_TOL_REL = 3e-4
RESUME_TOL_ABS = 3e-6
# tools.test against the last evaluation of the training run: the same
#   weights and images, integer histograms.
MIOU_TOL = 1e-6


def _cases():
    """The case lists of K3-K8 and K10/K11, the card's published peaks and
    the bounds' formulas, shared with ``tools/bench_kernels.py``."""
    from segdistill_tpu_torch.tools import kernel_cases
    return kernel_cases


def log(msg):
    print(msg, flush=True)


def check_close(name, got, want32, dtype=None):
    """``got``, computed in ``dtype`` (by default its own), against
    ``want32``, the plain version in fp32 on the same inputs; returns the
    max abs error and the largest share of its tolerance that any element
    uses."""
    diff = (got.float() - want32).abs()
    if (dtype or got.dtype) == torch.float32:
        tol = torch.full_like(diff, K_TOL_F32)
    else:
        rms = want32.square().mean().sqrt()
        tol = K_TOL_BF16_REL * want32.abs() + K_TOL_BF16_RMS * rms
    err = diff.max().item()
    used = torch.where(diff > 0, diff / tol, 0.0).max().item()
    if not used <= 1.0:
        raise AssertionError(f'{name}: max abs err {err:.3e}, {used:.2f}x '
                             f'the {got.dtype} tolerance')
    return err, used


def check_sra_bf16(name, got, plain_bf16, want32):
    """A bf16 result of K2 or K9 against (a) the plain version in bf16,
    which rounds P and dS as the kernels' operands are rounded, and (b) the
    plain version in fp32 on the same inputs, and the bias of its error;
    returns the max abs error against (b) and the largest shares of the
    limits (a), (b) and of the bias limit that it uses."""
    g = got.float()
    rms = torch.maximum(want32.square().mean(dim=-1, keepdim=True).sqrt(),
                        want32.square().mean().sqrt())
    shares = []
    for ref, rel, share in (
            (plain_bf16.float(), SRA_TOL_PLAIN_REL, SRA_TOL_PLAIN_RMS),
            (want32, SRA_TOL_F32_REL, SRA_TOL_F32_RMS)):
        tol = rel * ref.abs() + share * rms
        shares.append(((g - ref).abs() / tol).max().item())
    err = g - want32
    err_rms = err.square().mean().sqrt()
    bias = max(err.mean().abs().item(),
               (err * want32.sign()).mean().abs().item()) / err_rms.item()
    bias_max = SRA_BIAS_MAX + 4.0 / math.sqrt(err.numel())
    shares.append(bias / bias_max)
    if not max(shares) <= 1.0:
        raise AssertionError(
            f'{name}: {shares[0]:.2f}x the limit against the bf16 plain '
            f'version, {shares[1]:.2f}x against the fp32 one, bias '
            f'{bias:.3f} of the error\'s rms (limit {bias_max:.3f})')
    return err.abs().max().item(), shares


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is False; '
                         'this script runs on an NVIDIA GPU')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    log('== device')
    log(smi)
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'python {sys.version.split()[0]}')
    # every fp32 comparison on the card runs in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build(kernels):
    from segdistill_tpu_torch.ops.cuda_kernel import build_all
    log('== build')
    t0 = time.perf_counter()
    build_all(kernels)
    log(f'all kernels built and loaded in {time.perf_counter() - t0:.1f} s')
    for k in kernels:
        log(f'{k.name}: {k.build_seconds:.1f} s from '
            f'{k.source.relative_to(ROOT)}')
        for line in k.build_log.splitlines():
            if 'registers' in line or 'spill' in line or 'Compiling' in line:
                log(f'  {line.strip()}')


def phase_resize_sum():
    from segdistill_tpu_torch.ops.resize_sum import (fused_resize_sum,
                                                     resize_sum_plain)
    from segdistill_tpu_torch.utils.timing import cuda_ms, device_ms
    log('== K1 resize_sum vs plain (N(0,1) parts; times are the device\'s, '
        '"call" the host-clocked time of one call)')
    rng = np.random.RandomState(0)
    results = {}
    for name, shapes, out_hw in _cases().RESIZE_SUM_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            parts = [torch.from_numpy(rng.randn(*s).astype(np.float32))
                     .to(DEVICE, dtype) for s in shapes]
            got = fused_resize_sum(parts, out_hw)
            torch.cuda.synchronize()
            want = resize_sum_plain([p.float() for p in parts], out_hw)
            err, used = check_close(f'resize_sum {name} {dtype}', got, want)
            ms = device_ms(lambda: fused_resize_sum(parts, out_hw))
            call_ms = cuda_ms(lambda: fused_resize_sum(parts, out_hw))
            plain_ms = device_ms(lambda: resize_sum_plain(parts, out_hw),
                                 calls=3)
            results[(name, dtype)] = (err, ms, plain_ms)
            bound = _cases().resize_sum_bound(shapes, out_hw, dtype)
            log(f'{name:20s} {str(dtype):15s} max_abs_err {err:.3e} '
                f'(tol used {used:.3f})  kernel {ms:.4f} ms (call '
                f'{call_ms:.4f})  plain {plain_ms:.4f} ms  bound '
                f'{bound[0]:.4f} ms ({bound[1]})')
    return results


def _head_split(b, rows, heads, d, n_maps, rng, dtype):
    """``n_maps`` (b, heads, rows, d) views of one (b, rows, n_maps*heads*d)
    linear output, split as the MiT attention splits q and kv."""
    mem = torch.from_numpy(rng.randn(b, rows, n_maps * heads * d)
                           .astype(np.float32)).to(DEVICE, dtype)
    return mem.view(b, rows, n_maps, heads, d).permute(2, 0, 3, 1, 4)


def phase_sra_attn():
    import torch.nn.functional as F
    from segdistill_tpu_torch.ops.sra_attn import (fused_sra_attention,
                                                   sra_attention_plain)
    from segdistill_tpu_torch.utils.timing import cuda_ms, device_ms
    log('== K2 sra_attn vs plain (N(0,1) q, k, v, strided head views as '
        'the model passes them; bf16: shares of the limits against the '
        'bf16 plain version, the fp32 one, and of the bias limit; times '
        'are the device\'s, the calls queued behind a busy stream, and '
        '"call" the host-clocked time of one wrapper call)')
    rng = np.random.RandomState(1)
    cases = []
    for b in (1, 8):  # B0 at 512^2: (heads, N) per stage, M = 256, d = 32
        for s, (h, n) in enumerate(((1, 16384), (2, 4096), (5, 1024),
                                    (8, 256))):
            cases.append((f'B0 stage{s + 1} b{b}', b, h, n, 256, 32))
    cases.append(('ragged N, M', 2, 2, 1000, 100, 32))
    cases.append(('b1-b5 stage1 d64', 2, 1, 16384, 256, 64))
    cases.append(('d128', 1, 2, 300, 70, 128))
    cases.append(('M 300 (640x480)', 1, 1, 19200, 300, 32))
    cases.append(('M 2048, d64', 1, 2, 2048, 2048, 64))  # > resident keys
    results = {}
    for name, b, h, n, m, d in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q = _head_split(b, n, h, d, 1, rng, dtype)[0]
            k, v = _head_split(b, m, h, d, 2, rng, dtype)
            scale = d ** -0.5
            got = fused_sra_attention(q, k, v, scale)
            torch.cuda.synchronize()
            want = sra_attention_plain(q.float(), k.float(), v.float(), scale)
            if dtype == torch.float32:
                err, used = check_close(f'sra_attn {name} {dtype}', got, want)
                used = f'{used:.3f}'
            else:
                err, shares = check_sra_bf16(
                    f'sra_attn {name} {dtype}', got,
                    sra_attention_plain(q, k, v, scale), want)
                used = '/'.join(f'{u:.3f}' for u in shares)
            ms = device_ms(lambda: fused_sra_attention(q, k, v, scale))
            call_ms = cuda_ms(lambda: fused_sra_attention(q, k, v, scale))
            plain_ms = device_ms(lambda: sra_attention_plain(q, k, v, scale))
            lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, scale=scale))
            results[(name, dtype)] = (err, ms, plain_ms, lib_ms)
            bound = _sra_bound(b, h, n, m, d, dtype)
            log(f'{name:20s} {str(dtype):15s} max_abs_err {err:.3e} '
                f'(tol used {used})  kernel {ms:.4f} ms (call {call_ms:.4f})  '
                f'plain {plain_ms:.4f} ms  library (sdpa) {lib_ms:.4f} ms  '
                f'bound {bound[0]:.4f} ms ({bound[1]})')
    return results


def _scaled_grads(want, dunit):
    """The incoming gradient that makes the plain gradient's max |value| 1
    (1 where the gradient is 0), and that plain gradient."""
    peak = dunit.abs().max()
    gbar = torch.where(peak > 0, 1.0 / peak, torch.ones_like(peak))
    return gbar.to(want.dtype), dunit * gbar


def _timed_pair(kernel_fn, plain_fn):
    from segdistill_tpu_torch.utils.timing import cuda_ms
    return cuda_ms(kernel_fn), cuda_ms(plain_fn)


def _loss_case(tag, xs, xt, fused, plain):
    """A distillation-loss kernel pair (``fused(xs, xt)``, differentiable in
    xs) against ``plain`` on the same inputs: the loss to LOSS_TOL_REL, the
    gradient with the incoming gradient that makes max |plain dxs| = 1, two
    backward runs bitwise equal, and both directions timed. -> (loss err,
    fwd ms, plain fwd ms), (dxs err, bwd ms, plain bwd ms)."""
    a = xs.float().requires_grad_()
    want = plain(a, xt.float())
    (dunit,) = torch.autograd.grad(want, a)
    gbar, dwant = _scaled_grads(want, dunit)
    k = xs.clone().requires_grad_()
    loss = fused(k, xt)
    (dxs,) = torch.autograd.grad(loss, k, gbar, retain_graph=True)
    (again,) = torch.autograd.grad(loss, k, gbar, retain_graph=True)
    torch.cuda.synchronize()
    if not torch.equal(dxs, again):
        raise AssertionError(f'{tag}: two backward runs differ')
    if dxs.dtype != xs.dtype or dxs.shape != xs.shape:
        raise AssertionError(f'{tag}: dxs is {dxs.dtype} {tuple(dxs.shape)}')
    loss_err = abs(loss.item() - want.item())
    if not loss_err <= LOSS_TOL_REL * abs(want.item()):
        raise AssertionError(f'{tag}: loss {loss.item()} vs plain '
                             f'{want.item()}')
    err, used = check_close(f'{tag} dxs', dxs, dwant)
    ms = _timed_pair(lambda: fused(xs, xt), lambda: plain(xs, xt))
    p = xs.clone().requires_grad_()
    plain_loss = plain(p, xt)
    bms = _timed_pair(
        lambda: torch.autograd.grad(loss, k, gbar, retain_graph=True),
        lambda: torch.autograd.grad(plain_loss, p, gbar, retain_graph=True))
    del plain_loss
    log(f'{tag:40s} loss {loss.item():.7g} rel err '
        f'{loss_err / abs(want.item()):.2e}  dxs max_abs_err {err:.3e} (tol '
        f'used {used:.3f})  fwd {ms[0]:.4f} ms plain {ms[1]:.4f} ms  bwd '
        f'{bms[0]:.4f} ms plain {bms[1]:.4f} ms')
    return (loss_err, *ms), (err, *bms)


def _check_plan(tag, plan_fn, shape, out_hw, tile):
    """The backward's plan at these shapes names the tile the case is meant
    for: every variant is launched by the cases."""
    plan = plan_fn(*shape, *out_hw, sms=torch.cuda.get_device_properties(0)
                   .multi_processor_count)
    if plan['tile'] != tile:
        raise AssertionError(f'{tag}: planned {plan}, the case is meant for '
                             f'tile {tile}')
    return f'tile {tile}, {plan["blocks"]} blocks of {plan["cpc"]} channels'


def _fwd_plan(plan):
    return f'fwd tile {plan["oh"]}x64' if plan['oh'] else 'fwd gather'


def _same(tag, first, again):
    """Two forward runs on the same inputs agree bitwise (fixed merge
    orders)."""
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f'{tag}: two forward runs differ')


def phase_group_kl():
    from segdistill_tpu_torch.ops import group_kl as gk
    log('== K3/K4 group_kl vs plain (N(0,1) maps, and N(0, 30^2) in the '
        'spread cases, tau 2; backward with the incoming gradient that makes '
        'max |plain dxs| = 1; two forward runs (loss, stats) and two '
        'backward runs must agree bitwise; fwd: K3\'s output tile or its '
        'gather variant; tile: the edge of a K4 block\'s source tile, 0 the '
        'gather variant)')
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    tau = 2.0
    fwd, bwd = {}, {}
    cases = [c + (1.0,) for c in _cases().GROUP_KL_CASES] + \
        [c + (_cases().SPREAD,) for c in _cases().GROUP_KL_SPREAD_CASES]
    for name, shape, out_hw, g, shuffle, tile, scale in cases:
        plan = _fwd_plan(gk.forward_plan(*shape[2:], *out_hw)) + ', ' + \
            _check_plan(f'group_kl {name}', gk.backward_plan, shape, out_hw,
                        tile)
        perm = torch.randperm(shape[1], device=DEVICE, generator=gen) \
            if shuffle else None
        for dtype in (torch.float32, torch.bfloat16):
            xs, xt = (scale * torch.randn(shape, device=DEVICE, generator=gen)
                      for _ in range(2))
            xs, xt = xs.to(dtype), xt.to(dtype)
            fwd[(name, dtype)], bwd[(name, dtype)] = _loss_case(
                f'group_kl {name} {dtype} ({plan})', xs, xt,
                lambda a, t: gk.fused_group_kl_shuffled(a, t, perm, out_hw,
                                                        g, tau)
                if shuffle else gk.fused_group_kl(a, t, out_hw, g, tau),
                lambda a, t: gk.group_kl_plain(a, t, perm, out_hw, g, tau))
            args = gk._prepare(xs, xt, perm, out_hw, g, tau)
            _same(f'group_kl {name} {dtype}', gk._launch_fwd(*args),
                  gk._launch_fwd(*args))
    # a teacher of another size: the gather variants, never a fallback
    for name, shape, thw, out_hw, g, shuffle in \
            _cases().GROUP_KL_TWO_SIZE_CASES:
        _check_gather(f'group_kl {name}', gk, shape, thw, out_hw)
        perm = torch.randperm(shape[1], device=DEVICE, generator=gen) \
            if shuffle else None
        for dtype in (torch.float32, torch.bfloat16):
            xs = torch.randn(shape, device=DEVICE, generator=gen).to(dtype)
            xt = torch.randn(shape[:2] + thw, device=DEVICE,
                             generator=gen).to(dtype)
            before = gk.FWD_KERNEL.launches, gk.BWD_KERNEL.launches
            fwd[(name, dtype)], bwd[(name, dtype)] = _loss_case(
                f'group_kl {name} {dtype} (teacher {thw}, gather)', xs, xt,
                lambda a, t: gk.fused_group_kl_shuffled(a, t, perm, out_hw,
                                                        g, tau)
                if shuffle else gk.fused_group_kl(a, t, out_hw, g, tau),
                lambda a, t: gk.group_kl_plain(a, t, perm, out_hw, g, tau))
            _launched(f'group_kl {name}', gk, before)
            args = gk._prepare(xs, xt, perm, out_hw, g, tau)
            _same(f'group_kl {name} {dtype}', gk._launch_fwd(*args),
                  gk._launch_fwd(*args))
    return fwd, bwd


def _check_gather(tag, mod, shape, teacher_hw, out_hw):
    """A student and a teacher of different sizes plan the gather
    variants of both kernels."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fplan = mod.forward_plan(*shape[2:], *out_hw, teacher_hw)
    bplan = mod.backward_plan(*shape, *out_hw, sms, teacher_hw)
    if fplan['oh'] or bplan['tile']:
        raise AssertionError(f'{tag}: two sizes planned {fplan}, {bplan}')


def _launched(tag, mod, before):
    """The case's calls launched the forward and the backward kernel (the
    plain version is no fallback on a CUDA tensor)."""
    if mod.FWD_KERNEL.launches <= before[0] \
            or mod.BWD_KERNEL.launches <= before[1]:
        raise AssertionError(f'{tag}: the kernels were not launched')


def _check_lse(tag, lse, xs, xt, out_hw, tau):
    """K7's per-pixel log-sum-exps of z / tau against a float64 evaluation
    of the plain (fp32) upsample, within 2^-19 of (1 + max |z / tau|): both
    sides round each upsampled value to a few ulps of the largest source,
    which moves a log-sum-exp by as much; the kernel's exponentials
    (ex2.approx, 2^-22 relative), its fp32 sums over C terms and its log
    add ~2^-21 of it. A pixel that reads a wrong channel or tap, or a chunk
    rescaled with the wrong maximum, is off by ~1e-2 or more."""
    import torch.nn.functional as F
    worst = 0.0
    for i, x in enumerate((xs, xt)):
        u = F.interpolate(x.float(), size=out_hw, mode='bilinear',
                          align_corners=False).double() / tau
        want = torch.logsumexp(u, dim=1)
        tol = 2.0 ** -19 * (1.0 + u.abs().max().item())
        err = (lse[i].double() - want).abs().max().item()
        del u, want
        worst = max(worst, err / tol)
    if not worst <= 1.0:
        raise AssertionError(f'{tag}: the log-sum-exps use {worst:.2f}x '
                             f'their limit')
    return worst


def phase_pixel_kl():
    from segdistill_tpu_torch.ops import pixel_kl as pk
    log('== K7/K8 pixel_kl vs plain (N(0,1) maps, N(0, 30^2) in the spread '
        'cases, tau 1 but where named; backward with the incoming gradient '
        'that makes max |plain dxs| = 1; two forward runs (loss, log-sum-'
        'exps) and two backward runs must agree bitwise; lse: the share of '
        'its limit that K7\'s log-sum-exps use against a float64 '
        'evaluation; fwd: K7\'s output tile or its gather variant; tile: '
        'the edge of a K8 block\'s source tile, 0 the gather variant)')
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    fwd, bwd = {}, {}
    cases = [c + (1.0, 1.0) for c in _cases().PIXEL_KL_CASES] + \
        [c + (_cases().SPREAD,) for c in _cases().PIXEL_KL_SPREAD_CASES] + \
        [c + (1.0,) for c in _cases().PIXEL_KL_TAU_CASES]
    for name, shape, out_hw, tile, oh, tau, scale in cases:
        fplan = pk.forward_plan(*shape[2:], *out_hw)
        if fplan['oh'] != oh:
            raise AssertionError(f'pixel_kl {name}: forward planned {fplan}, '
                                 f'the case is meant for {oh} rows')
        plan = _fwd_plan(fplan) + ', ' + _check_plan(
            f'pixel_kl {name}', pk.backward_plan, shape, out_hw, tile)
        for dtype in (torch.float32, torch.bfloat16):
            xs, xt = ((scale * torch.randn(shape, device=DEVICE,
                                           generator=gen)).to(dtype)
                      for _ in range(2))
            tag = f'pixel_kl {name} {dtype}'
            fwd[(name, dtype)], bwd[(name, dtype)] = _loss_case(
                f'{tag} ({plan})', xs, xt,
                lambda a, t: pk.fused_pixel_kl(a, t, out_hw, tau),
                lambda a, t: pk.pixel_kl_plain(a, t, out_hw, tau))
            first = pk._launch_fwd(xs, xt, out_hw, tau)
            _same(tag, first, pk._launch_fwd(xs, xt, out_hw, tau))
            used = _check_lse(tag, first[1], xs, xt, out_hw, tau)
            log(f'{tag:40s} lse tol used {used:.3f}')
    # a teacher of another size: the gather variants, never a fallback
    for name, shape, thw, out_hw in _cases().PIXEL_KL_TWO_SIZE_CASES:
        _check_gather(f'pixel_kl {name}', pk, shape, thw, out_hw)
        for dtype in (torch.float32, torch.bfloat16):
            xs = torch.randn(shape, device=DEVICE, generator=gen).to(dtype)
            xt = torch.randn(shape[:2] + thw, device=DEVICE,
                             generator=gen).to(dtype)
            tag = f'pixel_kl {name} {dtype}'
            before = pk.FWD_KERNEL.launches, pk.BWD_KERNEL.launches
            fwd[(name, dtype)], bwd[(name, dtype)] = _loss_case(
                f'{tag} (teacher {thw}, gather)', xs, xt,
                lambda a, t: pk.fused_pixel_kl(a, t, out_hw, 1.0),
                lambda a, t: pk.pixel_kl_plain(a, t, out_hw, 1.0))
            _launched(tag, pk, before)
            first = pk._launch_fwd(xs, xt, out_hw, 1.0)
            _same(tag, first, pk._launch_fwd(xs, xt, out_hw, 1.0))
            used = _check_lse(tag, first[1], xs, xt, out_hw, 1.0)
            log(f'{tag:40s} lse tol used {used:.3f}')
    return fwd, bwd


def phase_sra_train():
    import torch.nn.functional as F
    from segdistill_tpu_torch.ops.sra_attn import (
        sra_attention_backward_plain, sra_attention_plain,
        sra_attention_train)
    from segdistill_tpu_torch.utils.timing import cuda_ms, device_ms
    log('== K9 sra_attn_bwd (after K2 keeping the row log-sum-exp) vs the '
        'autograd of the plain version (N(0,1) q, k, v and dO, strided head '
        'views as the model passes them; fp32: each gradient and its plain '
        'version divided by the plain one\'s max |value|; bf16: shares of '
        'the limits against the bf16 plain backward, the fp32 one, and of '
        'the bias limit; two backward runs must agree bitwise; times are '
        'the device\'s, "call" the host-clocked time of one backward)')
    rng = np.random.RandomState(9)
    stages = ((1, 16384), (2, 4096), (5, 1024), (8, 256))  # (heads, N)
    cases = [(f'B0 stage{s + 1} b{b}', b, h, n, 256, 32) for b in (8, 1)
             for s, (h, n) in enumerate(stages)]
    cases.append(('ragged N, M', 2, 2, 1000, 100, 32))
    cases.append(('b1-b5 stage1 d64', 2, 1, 16384, 256, 64))
    # the B3 teacher's stages, d = 64: two key chunks, dq through partials
    cases += [(f'B3 stage{s + 1} b2 d64', 2, h, n, 256, 64)
              for s, (h, n) in enumerate(stages)]
    cases.append(('M 300 (640x480)', 1, 1, 19200, 300, 32))
    cases.append(('M 2048, d64', 1, 2, 2048, 2048, 64))
    cases.append(('d128', 1, 2, 300, 70, 128))
    results = {}
    for name, b, h, n, m, d in cases:
        for dtype in (torch.float32, torch.bfloat16):
            scale = d ** -0.5
            q = _head_split(b, n, h, d, 1, rng, dtype)[0].requires_grad_()
            k, v = (t.requires_grad_()
                    for t in _head_split(b, m, h, d, 2, rng, dtype))
            g = _head_split(b, n, h, d, 1, rng, dtype)[0]
            out = sra_attention_train(q, k, v, scale)
            got = torch.autograd.grad(out, (q, k, v), g, retain_graph=True)
            again = torch.autograd.grad(out, (q, k, v), g, retain_graph=True)
            torch.cuda.synchronize()
            if not all(torch.equal(a, c) for a, c in zip(got, again)):
                raise AssertionError(f'sra_train {name} {dtype}: two runs '
                                     f'of K9 differ')
            ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
            want_out = sra_attention_plain(*ref, scale)
            want = torch.autograd.grad(want_out, ref, g.float())
            tags = ('out', 'dq', 'dk', 'dv')
            for tag, a, w in zip(tags[1:], got, want):
                if a.shape != w.shape or a.dtype != dtype:
                    raise AssertionError(f'sra_train {name}: {tag} is '
                                         f'{a.dtype} {tuple(a.shape)}')
            if dtype == torch.float32:
                errs = [check_close(f'sra_train {name} {dtype} out', out,
                                    want_out.detach())[0]]
                used = 0.0
                for tag, a, w in zip(tags[1:], got, want):
                    peak = w.abs().max()
                    e, u = check_close(f'sra_train {name} {dtype} {tag}',
                                       a / peak, w / peak)
                    errs.append(e)
                    used = max(used, u)
                used = f'{used:.3f}'
            else:
                with torch.no_grad():
                    plain = (sra_attention_plain(q, k, v, scale),
                             *sra_attention_backward_plain(q, k, v, g, scale))
                errs, shares = [], [0.0, 0.0, 0.0]
                for tag, a, pb, w in zip(tags, (out.detach(), *got), plain,
                                         (want_out.detach(), *want)):
                    peak = w.abs().max()
                    e, u = check_sra_bf16(f'sra_train {name} {dtype} {tag}',
                                          a.float() / peak, pb.float() / peak,
                                          w / peak)
                    errs.append(e)
                    shares = [max(x, y) for x, y in zip(shares, u)]
                used = '/'.join(f'{u:.3f}' for u in shares)
            plain_in = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            plain_out = sra_attention_plain(*plain_in, scale)
            ms = device_ms(lambda: torch.autograd.grad(
                out, (q, k, v), g, retain_graph=True))
            call_ms = cuda_ms(lambda: torch.autograd.grad(
                out, (q, k, v), g, retain_graph=True))
            plain_ms = device_ms(lambda: torch.autograd.grad(
                plain_out, plain_in, g, retain_graph=True))
            fwd_ms = device_ms(lambda: sra_attention_train(q, k, v, scale))
            lib_out = F.scaled_dot_product_attention(*plain_in, scale=scale)
            lib_ms = device_ms(lambda: torch.autograd.grad(
                lib_out, plain_in, g, retain_graph=True))
            results[(name, dtype)] = (max(errs), ms, plain_ms, lib_ms)
            bound = _sra_bound(b, h, n, m, d, dtype, backward=True)
            log(f'{name:20s} {str(dtype):15s} max_abs_err {max(errs):.3e} '
                f'(tol used {used})  bwd {ms:.4f} ms (call {call_ms:.4f})  '
                f'plain bwd {plain_ms:.4f} ms  library (sdpa) bwd '
                f'{lib_ms:.4f} ms  bound {bound[0]:.4f} ms ({bound[1]})  fwd '
                f'with lse {fwd_ms:.4f} ms')
    return results


def phase_seg_ce():
    from segdistill_tpu_torch.ops import seg_ce as sc
    log('== K5/K6 seg_ce vs plain (N(0,1) logits, N(0, 30^2) in the spread '
        'cases, multiples of 1/8 with a channel copied in the tie cases, '
        'where `correct` must equal the plain count; a label for every '
        'class with a share set to 255; backward with the incoming gradient '
        'that makes max |plain dz| = 1; two forward runs (ce_sum, correct, '
        'm, se) and two backward runs must agree bitwise; fwd: K5\'s output '
        'tile or its gather variant; tile: the edge of a K6 block\'s source '
        'tile, 0 the gather variant)')
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    fwd, bwd = {}, {}
    cases = [c + ('N(0,1)',) for c in _cases().SEG_CE_CASES] + \
        [c + ('spread',) for c in _cases().SEG_CE_SPREAD_CASES] + \
        [c + ('ties',) for c in _cases().SEG_CE_TIE_CASES]
    for name, shape, out_hw, ignored, tile, kind in cases:
        classes = shape[1]
        plan = _fwd_plan(sc.forward_plan(*shape[2:], *out_hw)) + ', ' + \
            _check_plan(f'seg_ce {name}', sc.backward_plan, shape, out_hw,
                        tile)
        labels = torch.randint(0, classes, (shape[0],) + out_hw,
                               device=DEVICE, generator=gen)
        labels[torch.rand(labels.shape, device=DEVICE, generator=gen)
               < ignored] = 255
        for dtype in (torch.float32, torch.bfloat16):
            if kind == 'ties':
                z = _cases().tie_logits(shape, labels, gen).to(dtype)
            else:
                z = torch.randn(shape, device=DEVICE, generator=gen)
                z = (z * (_cases().SPREAD if kind == 'spread' else 1.0)) \
                    .to(dtype)
            a = z.float().requires_grad_()
            want, want_correct = sc.seg_ce_plain(a, labels, out_hw, classes)
            (dunit,) = torch.autograd.grad(want, a)
            gbar, dwant = _scaled_grads(want, dunit)
            k = z.clone().requires_grad_()
            ce, correct = sc.fused_seg_ce(k, labels, out_hw, classes)
            (dz,) = torch.autograd.grad(ce, k, gbar, retain_graph=True)
            (again,) = torch.autograd.grad(ce, k, gbar, retain_graph=True)
            torch.cuda.synchronize()
            if not torch.equal(dz, again):
                raise AssertionError(f'seg_ce {name} {dtype}: two runs of K6 '
                                     f'differ')
            lab32 = labels.to(torch.int32)
            _same(f'seg_ce {name} {dtype}',
                  sc._launch_fwd(z, lab32, classes, 255),
                  sc._launch_fwd(z, lab32, classes, 255))
            ce_err = abs(ce.item() - want.item())
            miss = abs(correct.item() - want_correct.item())
            if not (ce_err <= LOSS_TOL_REL * abs(want.item())
                    and miss <= (0 if kind == 'ties' else
                                 CORRECT_TOL_SHARE * labels.numel())):
                raise AssertionError(
                    f'seg_ce {name} {dtype}: ce {ce.item()} correct '
                    f'{correct.item()} vs plain {want.item()} '
                    f'{want_correct.item()}')
            err, used = check_close(f'seg_ce {name} {dtype} dz', dz, dwant)
            ms = _timed_pair(
                lambda: sc.fused_seg_ce(z, labels, out_hw, classes),
                lambda: sc.seg_ce_plain(z, labels, out_hw, classes))
            p = z.clone().requires_grad_()
            plain_ce, _ = sc.seg_ce_plain(p, labels, out_hw, classes)
            bms = _timed_pair(
                lambda: torch.autograd.grad(ce, k, gbar, retain_graph=True),
                lambda: torch.autograd.grad(plain_ce, p, gbar,
                                            retain_graph=True))
            del plain_ce
            # error of the mean CE, as the head divides by the pixels
            fwd[(name, dtype)] = (ce_err / labels.numel(), *ms)
            bwd[(name, dtype)] = (err, *bms)
            log(f'{name:20s} {str(dtype):15s} ce_sum {ce.item():.7g} rel err '
                f'{ce_err / max(abs(want.item()), 1e-30):.2e} correct '
                f'{correct.item():.0f} (plain {want_correct.item():.0f})  dz '
                f'max_abs_err {err:.3e} (tol used {used:.3f})  fwd '
                f'{ms[0]:.4f} ms plain {ms[1]:.4f} ms  bwd {bms[0]:.4f} ms '
                f'plain {bms[1]:.4f} ms  {plan}')
    return fwd, bwd, _ce_path_times(sc, gen)


def _ce_path_times(sc, gen):
    """K5 and K6 at the SGD train paths' shapes, bf16 (checked above as
    cases of SEG_CE_CASES): device time (calls queued behind a held stream)
    beside the plain version's and the bound. -> {case: (K5 ms, plain ms,
    K6 ms, plain ms)}."""
    from segdistill_tpu_torch.utils.timing import device_ms
    log('K5/K6 at the SGD train paths\' shapes, bf16, device time (10 '
        'calls queued behind a held stream)')
    times = {}
    for path, case, per_step in _cases().SEG_CE_PATH_CASES:
        _, shape, out_hw, ignored, _ = next(
            c for c in _cases().SEG_CE_CASES if c[0] == case)
        classes = shape[1]
        labels = torch.randint(0, classes, (shape[0],) + out_hw,
                               device=DEVICE, generator=gen)
        labels[torch.rand(labels.shape, device=DEVICE, generator=gen)
               < ignored] = 255
        z = torch.randn(shape, device=DEVICE, generator=gen).to(
            torch.bfloat16)
        with torch.no_grad():
            k5 = device_ms(lambda: sc.fused_seg_ce(z, labels, out_hw,
                                                   classes))
            p5 = device_ms(lambda: sc.seg_ce_plain(z, labels, out_hw,
                                                   classes))
        k = z.clone().requires_grad_()
        ce, _ = sc.fused_seg_ce(k, labels, out_hw, classes)
        p = z.clone().requires_grad_()
        plain_ce, _ = sc.seg_ce_plain(p, labels, out_hw, classes)
        k6 = device_ms(lambda: torch.autograd.grad(ce, k, retain_graph=True))
        p6 = device_ms(lambda: torch.autograd.grad(plain_ce, p,
                                                   retain_graph=True))
        del plain_ce
        (b5, by5), (b6, by6) = _cases().seg_ce_bounds(shape, out_hw,
                                                      torch.bfloat16)
        times[case] = (k5, p5, k6, p6)
        log(f'{path:32s} {shape} -> {out_hw} x{per_step} a step: K5 '
            f'{k5:.4f} ms (plain {p5:.4f}, bound {b5:.4f} by {by5}, '
            f'{k5 / b5:.2f}x); K6 {k6:.4f} ms (plain {p6:.4f}, bound '
            f'{b6:.4f} by {by6}, {k6 / b6:.2f}x)')
    return times


LN_CALLS = 10  # launches per timing: the kernels take microseconds
# cycles the stream is held while they queue up: ~11 ms, since a backward
# through autograd can take the host 0.3 ms a call
LN_HOLD_CYCLES = 20_000_000
# bytes of inputs a timed LayerNorm forward cycles through: twice the
# H100's 50 MB L2 cache
LN_COLD_BYTES = 100 * 2 ** 20


def _ln_check(tag, x, w, b, g, eps):
    """K10 and K11 on (x, w, b) and the incoming gradient g against the
    plain version and its autograd in fp32: -> (forward err, backward err),
    each gradient and its plain version divided by the plain one's max
    |value|. Two runs of K11 must agree bitwise (whichever block sums the
    partials), and with frozen parameters it must give the same dx in one
    launch."""
    from segdistill_tpu_torch.ops.layer_norm import (BWD_KERNEL,
                                                     fused_layer_norm,
                                                     layer_norm_plain)
    ref = [t.detach().float().requires_grad_() for t in (x, w, b)]
    want = layer_norm_plain(*ref, eps)
    dwant = torch.autograd.grad(want, ref, g.float())
    ins = [t.detach().clone().requires_grad_() for t in (x, w, b)]
    y = fused_layer_norm(*ins, eps)
    got = torch.autograd.grad(y, ins, g, retain_graph=True)
    before = BWD_KERNEL.launches
    again = torch.autograd.grad(y, ins, g)
    if BWD_KERNEL.launches != before + 1:
        raise AssertionError(f'{tag}: a backward took '
                             f'{BWD_KERNEL.launches - before} K11 launches')
    y_frozen = fused_layer_norm(ins[0], w, b, eps)
    (dx_frozen,) = torch.autograd.grad(y_frozen, ins[:1], g)
    torch.cuda.synchronize()
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        raise AssertionError(f'{tag}: two runs of K11 differ')
    if not torch.equal(dx_frozen, got[0]):
        raise AssertionError(f'{tag}: dx differs with frozen parameters')
    if y.dtype != x.dtype or y.shape != x.shape:
        raise AssertionError(f'{tag}: output is {y.dtype} {tuple(y.shape)}')
    ferr, fused = check_close(f'{tag} y', y.detach(), want.detach())
    berr, bused = 0.0, 0.0
    for name, a, d in zip(('dx', 'dweight', 'dbias'), got, dwant):
        if a.shape != d.shape or a.dtype != (x.dtype if name == 'dx'
                                             else torch.float32):
            raise AssertionError(f'{tag}: {name} is {a.dtype} '
                                 f'{tuple(a.shape)}')
        peak = d.abs().max()
        e, u = check_close(f'{tag} {name}', a.float() / peak, d / peak,
                           a.dtype)
        berr, bused = max(berr, e), max(bused, u)
    return ferr, fused, berr, bused


def _ln_check_cut_rows(dtype, gen):
    """``x[:, 1:]`` of (4, 34, 64): a unit last stride but no one row
    stride, so K10 reads a copy of the rows, and K11 must read that copy
    (not the memory behind ``x``) and its gradient reach ``x`` through the
    slice. Beside it ``x[:, ::2]``, whose rows fold and are read in
    place."""
    from segdistill_tpu_torch.ops.layer_norm import (fused_layer_norm,
                                                     layer_norm_plain)
    base = torch.randn(4, 34, 64, device=DEVICE, generator=gen).to(dtype)
    w = 1 + 0.1 * torch.randn(64, device=DEVICE, generator=gen)
    b = 0.1 * torch.randn(64, device=DEVICE, generator=gen)
    worst = 0.0
    for tag, cut in (('x[:, 1:]', lambda t: t[:, 1:]),
                     ('x[:, ::2]', lambda t: t[:, ::2])):
        g = torch.randn(cut(base).shape, device=DEVICE,
                        generator=gen).to(dtype)
        ref = [t.detach().float().requires_grad_() for t in (base, w, b)]
        dwant = torch.autograd.grad(
            layer_norm_plain(cut(ref[0]), ref[1], ref[2], 1e-6), ref,
            g.float())
        ins = [t.detach().clone().requires_grad_() for t in (base, w, b)]
        x = cut(ins[0])
        if x.is_contiguous():
            raise AssertionError(f'layer_norm {tag}: the case is contiguous')
        got = torch.autograd.grad(fused_layer_norm(x, ins[1], ins[2], 1e-6),
                                  ins, g)
        for name, a, d in zip(('dx', 'dweight', 'dbias'), got, dwant):
            peak = d.abs().max()
            err, _ = check_close(f'layer_norm {tag} {dtype} {name}',
                                 a.float() / peak, d / peak, a.dtype)
            worst = max(worst, err)
    return worst


def _check_fwd_tickets(tag):
    """Every ticket of the forward tile kernels (K5, K7) is back at 0: each
    launch's last block set it back."""
    from segdistill_tpu_torch.ops.cuda_kernel import TICKETS
    left = {k: t.item() for k, t in TICKETS.items() if t.item()}
    if left or not TICKETS:
        raise AssertionError(f'{tag}: forward tickets {left or TICKETS}')
    log(f'{tag}: {len(TICKETS)} forward ticket(s), all 0')


def _check_ln_tickets(tag):
    """Every K11 workspace's ticket counters are back at 0: each launch
    ran to its end, and the next one's last block will know itself."""
    from segdistill_tpu_torch.ops import layer_norm as ln
    torch.cuda.synchronize()
    for (_, _, c, capacity), ws in ln.WORKSPACES.items():
        if ln.workspace_tickets(ws, c, capacity).any():
            raise AssertionError(f'{tag}: K11 left a ticket counter of its '
                                 f'C = {c} workspace above 0')


def _ln_timed(x, w, b, g, eps):
    """(forward, backward, forward call, backward call) ms of the kernels,
    the plain version and ``F.layer_norm`` on (x, w, b) with the incoming
    gradient g: device times, then a call's; the forwards on copies of x
    that do not fit the L2 cache together."""
    import torch.nn.functional as F
    from segdistill_tpu_torch.ops.layer_norm import (fused_layer_norm,
                                                     layer_norm_plain)
    from segdistill_tpu_torch.utils.timing import cuda_ms, device_ms
    c = x.shape[-1]
    # the forward reads another copy of x at each call, more than twice the
    # L2 cache in all, so that its bytes come from device memory
    copies = [x] + [x.clone() for _ in range(
        min(15, -(-LN_COLD_BYTES // (x.numel() * x.element_size())) - 1))]
    turn = itertools.count()

    def timed(fn, params):
        leaf = x.clone().requires_grad_()
        ps = [t.clone().requires_grad_() for t in params]
        y = fn(leaf, *ps)

        def forward():
            with torch.no_grad():
                fn(copies[next(turn) % len(copies)], *params)

        def backward():
            torch.autograd.grad(y, [leaf] + ps, g, retain_graph=True)
        return (device_ms(forward, calls=LN_CALLS,
                          hold_cycles=LN_HOLD_CYCLES),
                device_ms(backward, calls=LN_CALLS,
                          hold_cycles=LN_HOLD_CYCLES),
                cuda_ms(forward, calls=LN_CALLS),
                cuda_ms(backward, calls=LN_CALLS))
    # the library call takes its parameters in x's dtype
    return (timed(lambda a, ww, bb: fused_layer_norm(a, ww, bb, eps), (w, b)),
            timed(lambda a, ww, bb: layer_norm_plain(a, ww, bb, eps), (w, b)),
            timed(lambda a, ww, bb: F.layer_norm(a, (c,), ww, bb, eps),
                  (w.to(x.dtype), b.to(x.dtype))))


def _ln_planned(name, rows, c, dtype):
    """K10's plan at (rows, c) in ``dtype``; where the case list names the
    plan for that dtype (the step's in bf16, the serving path's in fp32),
    the planner must give it."""
    from segdistill_tpu_torch.ops import layer_norm as ln
    from segdistill_tpu_torch.ops.ln_plan import forward_plan
    plan = forward_plan(rows, c, ln.DTYPE_CODES[dtype], ln.sm_count(0))
    named = {(n, torch.bfloat16): want
             for n, _, _, _, want in _cases().LN_STEP_CASES}
    named.update({(n, torch.float32): want
                  for n, _, _, _, want in _cases().LN_SERVING_CASES})
    for n, _, _, _, bf16, fp32 in _cases().LN_WIDE_CASES:
        named[(n, torch.bfloat16)], named[(n, torch.float32)] = bf16, fp32
    want = named.get((name, dtype))
    if want is not None and tuple(plan[:4]) != want:
        raise AssertionError(f'layer_norm {name} {dtype}: K10 planned '
                             f'{tuple(plan)}, the case names {want}')
    return plan


def _ln_after_producer(dtype, gen):
    """x made by the kernel just before K10 (x = a + b_i, b_i other
    random rows each round), twenty rounds at B3's (8192, 320): a launch
    that read x before its producer ended (the memory of the round
    before, which the allocator hands out again) would differ. -> the
    largest share of the tolerance used."""
    from segdistill_tpu_torch.ops.layer_norm import (fused_layer_norm,
                                                     layer_norm_plain)
    a = torch.randn(8192, 320, device=DEVICE, generator=gen).to(dtype)
    adds = [torch.randn(8192, 320, device=DEVICE, generator=gen).to(dtype)
            for _ in range(20)]
    w = 1 + 0.1 * torch.randn(320, device=DEVICE, generator=gen)
    b = 0.1 * torch.randn(320, device=DEVICE, generator=gen)
    torch.cuda.synchronize()
    worst = 0.0
    for i, add in enumerate(adds):
        x = a + add
        y = fused_layer_norm(x, w, b, 1e-6)
        want = layer_norm_plain(x.float(), w, b, 1e-6)
        worst = max(worst, check_close(f'layer_norm after its producer, '
                                       f'round {i}', y, want)[1])
    return worst


def phase_layer_norm():
    from segdistill_tpu_torch.ops import layer_norm as ln
    from segdistill_tpu_torch.ops.layer_norm import fused_layer_norm
    from segdistill_tpu_torch.utils.timing import device_ms
    log('== K10/K11 layer_norm vs plain (N(0,1) x and dy, weight 1 + 0.1 N, '
        'bias 0.1 N; each gradient and its plain version divided by the '
        'plain one\'s max |value|; eps 1e-6 and 1e-5; two forward and two '
        'backward runs must agree bitwise; K10\'s plan as the case names '
        'it; "K10" is the device time of a forward, the calls queued behind '
        'a busy stream)')
    gen = torch.Generator(device=DEVICE).manual_seed(10)
    main = _cases().LN_CASES[0][0]
    fwd, bwd = {}, {}
    floor = None
    for name, rows, c in _cases().LN_CASES:
        w = 1 + 0.1 * torch.randn(c, device=DEVICE, generator=gen)
        b = 0.1 * torch.randn(c, device=DEVICE, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(rows, c, device=DEVICE, generator=gen).to(dtype)
            g = torch.randn(rows, c, device=DEVICE, generator=gen).to(dtype)
            plan = _ln_planned(name, rows, c, dtype)
            errs = [_ln_check(f'layer_norm {name} {dtype} eps {eps}', x, w, b,
                              g, eps) for eps in (1e-6, 1e-5)]
            ferr, fused, berr, bused = (max(e[i] for e in errs)
                                        for i in range(4))
            with torch.no_grad():
                once = fused_layer_norm(x, w, b, 1e-6)
                again = fused_layer_norm(x, w, b, 1e-6)
                k10 = device_ms(lambda: fused_layer_norm(x, w, b, 1e-6),
                                calls=LN_CALLS, hold_cycles=LN_HOLD_CYCLES)
            if not torch.equal(once, again):
                raise AssertionError(f'layer_norm {name} {dtype}: two runs '
                                     f'of K10 differ')
            line = (f'{name:16s} ({rows}, {c}) {str(dtype):15s} plan '
                    f'{tuple(plan)} y max_abs_err {ferr:.3e} (tol used '
                    f'{fused:.3f})  gradients {berr:.3e} (tol used '
                    f'{bused:.3f})  K10 {k10:.4f} ms')
            times = (None,) * 4, (None,) * 4, (None,) * 4
            if name == main:
                times = _ln_timed(x, w, b, g, 1e-6)
                k_ms, p_ms, l_ms = times
                bounds = _cases().ln_bounds(rows, c, dtype)
                line += (f'  fwd {k_ms[0]:.4f} ms plain {p_ms[0]:.4f} '
                         f'library {l_ms[0]:.4f} (call {k_ms[2]:.4f} / '
                         f'{p_ms[2]:.4f} / {l_ms[2]:.4f})  bwd {k_ms[1]:.4f} '
                         f'ms plain {p_ms[1]:.4f} library {l_ms[1]:.4f} (call '
                         f'{k_ms[3]:.4f} / {p_ms[3]:.4f} / {l_ms[3]:.4f})  '
                         f'bounds {bounds[0][0]:.4f} / {bounds[1][0]:.4f} ms '
                         f'({bounds[1][1]})')
                if dtype == torch.bfloat16:
                    floor = device_ms(lambda: ln.EMPTY_KERNEL.launch(
                        x.device, plan.blocks, plan.threads), calls=LN_CALLS,
                        hold_cycles=LN_HOLD_CYCLES)
                    line += (f'  floor (an empty kernel on K10\'s grid) '
                             f'{floor:.4f} ms')
            k_ms, p_ms, l_ms = times
            fwd[(name, dtype)] = (ferr, k_ms[0], p_ms[0], l_ms[0])
            bwd[(name, dtype)] = (berr, k_ms[1], p_ms[1], l_ms[1])
            log(line)
    for dtype in (torch.float32, torch.bfloat16):
        log(f'rows that do not fold, x[:, 1:] of (4, 34, 64), and rows that '
            f'do, x[:, ::2]  {str(dtype):15s} gradients '
            f'{_ln_check_cut_rows(dtype, gen):.3e}')
        log(f'K10 right after its producer, 20 rounds of x = a + b_i at '
            f'(8192, 320) {str(dtype):15s} tol used '
            f'{_ln_after_producer(dtype, gen):.3f}')
    _check_ln_tickets('layer_norm phase')
    return fwd, bwd, floor


def _requests():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            for h, w in REQUEST_HW]


def _serve(model, imgs, tag):
    from segdistill_tpu_torch.apis import inference_segmentor
    preds, lat = [], []
    for img in imgs:
        t0 = time.perf_counter()
        pred = inference_segmentor(model, img)[0]
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        if pred.shape != img.shape[:2] or pred.min() < 0 \
                or pred.max() >= NUM_CLASSES:
            raise AssertionError(f'{tag}: bad prediction {pred.shape} for '
                                 f'an image of {img.shape}')
        preds.append(pred)
    log(f'{tag}: per-request latency ms '
        + ', '.join(f'{h}x{w} {t:.2f}' for (h, w), t in zip(REQUEST_HW, lat)))
    return preds


def _normalized(cfg, img_hwc_uint8, device):
    from segdistill_tpu_torch.apis import serving_pipeline
    from segdistill_tpu_torch.apis.test import image_to_device
    data = serving_pipeline(cfg)(dict(img=img_hwc_uint8))
    return image_to_device(data['img'][0], device)


def phase_serving(path_kernels):
    from segdistill_tpu_torch.apis import init_segmentor
    from segdistill_tpu_torch.core.evaluation import mean_iou
    from segdistill_tpu_torch.utils.timing import images_per_s

    log('== serving: Segformer-B0, 150 classes, random weights (seed 0)')
    fused = {'model.backbone.fused_attention': True}
    slide_opts = dict(fused, **{'model.test_cfg': dict(
        mode='slide', crop_size=(512, 512), stride=(384, 384))})
    model = init_segmentor(str(CONFIG), device=DEVICE, seed=0)
    model_fa = init_segmentor(str(CONFIG), device=DEVICE, seed=0,
                              cfg_options=fused)
    model_slide = init_segmentor(str(CONFIG), device=DEVICE, seed=0,
                                 cfg_options=slide_opts)
    imgs = _requests()
    slide_x = torch.from_numpy(np.random.RandomState(2).randn(
        1, 3, 1024, 2048).astype(np.float32)).to(DEVICE)
    with torch.no_grad():  # warm up: cuDNN heuristics, allocator
        _serve(model, imgs, 'warmup whole')
        _serve(model_fa, imgs, 'warmup whole, fused_attention')
        model_slide.simple_test(slide_x, rescale=False)
    torch.cuda.synchronize()

    # the serving path: every launch count starts at 0 here
    for k in path_kernels:
        k.launches = 0
    preds = _serve(model, imgs, 'whole')
    preds_fa = _serve(model_fa, imgs, 'whole, fused_attention')
    with torch.no_grad():
        t0 = time.perf_counter()
        slide = model_slide.simple_test(slide_x, rescale=False)
        torch.cuda.synchronize()
        slide_ms = (time.perf_counter() - t0) * 1e3
    launches = {k.name: k.launches for k in path_kernels}
    log(f'slide 1024x2048 (512^2 windows, stride 384): {slide_ms:.2f} ms, '
        f'output {tuple(slide.shape)}')
    log(f'launches during the serving path: {launches}')
    _check_launched(launches, 'serving')
    if slide.shape != (1, 1024, 2048):
        raise AssertionError(f'slide output shape {tuple(slide.shape)}')
    agree = np.mean([np.mean(a == b) for a, b in zip(preds, preds_fa)])
    log(f'whole vs whole+fused_attention: argmax agreement {agree:.6f}')
    if agree < 0.99:
        raise AssertionError('fused attention changed the predictions')

    # mIoU of the predictions against seeded labels: exercises the metrics
    rng = np.random.RandomState(3)
    labels = [np.where(rng.rand(*p.shape) < 0.05, 255,
                       rng.randint(0, NUM_CLASSES, p.shape)) for p in preds]
    _, _, iou = mean_iou(preds, labels, NUM_CLASSES, ignore_index=255)
    miou = float(np.nanmean(iou))
    log(f'mIoU vs seeded random labels (exercises the metrics only): '
        f'{miou:.6f}')
    if not np.isfinite(miou):
        raise AssertionError('mIoU is not finite')

    # fp32 GPU (K1 + K2) against the same model on the CPU (plain versions)
    x = _normalized(model.cfg, imgs[0], DEVICE)
    with torch.no_grad():
        gpu = model_fa.encode_decode(x).cpu()
        cpu = copy.deepcopy(model_fa).cpu().encode_decode(x.cpu())
    err = (gpu - cpu).abs().max().item()
    scale = cpu.abs().max().item()
    log(f'fp32 logits GPU vs CPU at 512x512: max abs err {err:.3e}, '
        f'max |logit| {scale:.3e}, relative {err / scale:.3e} '
        f'(limit {MODEL_TOL_REL}), argmax agreement '
        f'{(gpu.argmax(1) == cpu.argmax(1)).float().mean().item():.6f}')
    if not (torch.isfinite(gpu).all() and err <= MODEL_TOL_REL * scale):
        raise AssertionError(f'GPU logits differ from the CPU run: {err:.3e}'
                             f' > {MODEL_TOL_REL} * {scale:.3e}')

    # bf16 backbone (the bench configuration) against fp32
    model_bf16 = init_segmentor(
        str(CONFIG), device=DEVICE, seed=0,
        cfg_options=dict(fused, **{'model.backbone.dtype': 'bfloat16'}))
    model_bf16.load_state_dict(model_fa.state_dict())
    with torch.no_grad():
        lb = model_bf16.encode_decode(x).cpu()
    rel = ((lb - gpu).norm() / gpu.norm()).item()
    log(f'bf16 backbone vs fp32 logits: relative L2 err {rel:.3e}, argmax '
        f'agreement {(lb.argmax(1) == gpu.argmax(1)).float().mean().item():.6f}')
    if not (torch.isfinite(lb).all() and rel <= BF16_TOL_REL_L2):
        raise AssertionError(f'bf16 logits: relative L2 err {rel:.3e} > '
                             f'{BF16_TOL_REL_L2}')

    # throughput of whole inference at 512^2 (logits at input size)
    with torch.no_grad():
        for tag, m in (('fp32', model), ('fp32 fused_attention', model_fa),
                       ('bf16 fused_attention', model_bf16)):
            for b in (1, 8):
                xb = x.expand(b, -1, -1, -1).contiguous()
                fps = images_per_s(lambda: m.encode_decode(xb), b)
                log(f'whole inference 512x512 {tag} batch {b}: '
                    f'{fps:.2f} images/s')
        slide_fps = images_per_s(lambda: model_slide.simple_test(slide_x,
                                                         rescale=False), 1,
                         iters=3)
    log(f'slide inference 1024x2048 fp32 fused_attention: {slide_fps:.3f} '
        f'images/s')
    return launches


def phase_serving_tab5(config, path_kernels, tag):
    """A Tab5 student served from its distillation config through
    ``init_segmentor`` (which builds the student alone): full width and
    depth, whole mode, seeded 512x512 requests; the fp32 GPU logits of one
    request against the same model on the CPU. -> the launch counts of
    ``path_kernels`` over the requests (the PSP student runs none of the
    hand-written kernels; Swin runs K10 in every LayerNorm)."""
    from segdistill_tpu_torch.apis import init_segmentor
    log(f'== serving: {tag} student of {config.name} through init_segmentor, '
        f'150 classes, random weights (seed 0), {TAB5_REQUESTS} requests at '
        f'512x512')
    model = init_segmentor(str(config), device=DEVICE, seed=0)
    if type(model).__name__ != 'EncoderDecoder':
        raise AssertionError(f'{tag}: init_segmentor served a '
                             f'{type(model).__name__}, not the student')
    rng = np.random.RandomState(4)
    imgs = [rng.randint(0, 256, (512, 512, 3)).astype(np.uint8)
            for _ in range(TAB5_REQUESTS)]
    with torch.no_grad():  # warm up: cuDNN heuristics, allocator
        _serve_tab5(model, imgs[:1], tag)
    torch.cuda.synchronize()

    # the serving path: every launch count starts at 0 here
    for k in path_kernels:
        k.launches = 0
    _serve_tab5(model, imgs, tag)
    launches = {k.name: k.launches for k in path_kernels}
    log(f'launches during the {tag} serving path: {launches}')
    _check_launched(launches, f'{tag} serving')

    x = _normalized(model.cfg, imgs[0], DEVICE)
    with torch.no_grad():
        gpu = model.encode_decode(x).cpu()
        cpu = copy.deepcopy(model).cpu().encode_decode(x.cpu())
    err = (gpu - cpu).abs().max().item()
    scale = cpu.abs().max().item()
    log(f'{tag} fp32 logits GPU vs CPU at 512x512: max abs err {err:.3e}, '
        f'max |logit| {scale:.3e}, relative {err / scale:.3e} (limit '
        f'{MODEL_TOL_REL}), argmax agreement '
        f'{(gpu.argmax(1) == cpu.argmax(1)).float().mean().item():.6f}')
    if not (torch.isfinite(gpu).all() and gpu.shape == (1, NUM_CLASSES, 512,
                                                        512)
            and err <= MODEL_TOL_REL * scale):
        raise AssertionError(f'{tag}: GPU logits {tuple(gpu.shape)} differ '
                             f'from the CPU run: {err:.3e} > '
                             f'{MODEL_TOL_REL} * {scale:.3e}')
    return launches


def _serve_tab5(model, imgs, tag):
    from segdistill_tpu_torch.apis import inference_segmentor
    lat = []
    for img in imgs:
        t0 = time.perf_counter()
        pred = inference_segmentor(model, img)[0]
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        if pred.shape != img.shape[:2] or pred.min() < 0 \
                or pred.max() >= NUM_CLASSES:
            raise AssertionError(f'{tag}: bad prediction {pred.shape}')
    log(f'{tag}: per-request latency ms '
        + ', '.join(f'{t:.2f}' for t in lat))


def _check_launched(launches, path):
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f'kernel {name} was not launched on the '
                                 f'{path} path')


def _train_batch(batch, seed, hw=512):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    img = torch.randn(batch, 3, hw, hw, device=DEVICE, generator=gen)
    gt = torch.randint(0, NUM_CLASSES, (batch, hw, hw), device=DEVICE,
                       generator=gen)
    return img, gt


def phase_train(path_kernels, config, options, tag, batch=TRAIN_BATCH,
                pair='B0 student <- B3 teacher'):
    """The distillation train step of ``config`` with bf16 backbones (and
    ``options``) at ``batch``: -> the launch counts of ``path_kernels`` over
    the timed steps, and the last step's log vars."""
    from segdistill_tpu_torch.apis import (init_segmentor_state,
                                           prepare_training)
    log(f'== train: {tag}, {pair}, bf16 backbones, batch {batch} at '
        f'512x512, random weights (seed 0)')
    t0 = time.perf_counter()
    model = init_segmentor_state(
        str(config), seed=0, device=DEVICE,
        cfg_options=dict(NO_CHECKPOINTS, **BF16_BACKBONES, **options))
    state, train_step = prepare_training(model)
    img, gt = _train_batch(batch, seed=5)
    log(f'model and optimizer built in {time.perf_counter() - t0:.1f} s')
    first = [train_step(state, img, gt) for _ in range(TRAIN_WARMUP)][0]
    torch.cuda.synchronize()
    log('step 1: ' + ', '.join(f'{k} {float(v):.6g}'
                               for k, v in sorted(first.items())))

    # the training path: every launch count starts at 0 here
    for k in path_kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logs = [train_step(state, img, gt) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k.name: k.launches for k in path_kernels}
    peak = torch.cuda.max_memory_allocated()
    step_ms = seconds / TRAIN_STEPS * 1e3
    log(f'step {state.step}: ' + ', '.join(
        f'{k} {float(v):.6g}' for k, v in sorted(logs[-1].items())))
    log(f'train step {step_ms:.2f} ms, '
        f'{batch * TRAIN_STEPS / seconds:.2f} images/s over '
        f'{TRAIN_STEPS} steps; peak memory allocated {peak / 2**30:.2f} GiB')
    log(f'launches during the {tag} training path: {launches}')
    _check_launched(launches, f'{tag} training')
    values = [float(v) for lv in [first] + logs for v in lv.values()]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f'a loss of the {tag} train step is not finite')
    ce = float(first['decode.loss_seg'])
    if not abs(ce - CE_INIT) <= CE_INIT_TOL:
        raise AssertionError(f'decode.loss_seg at step 1 is {ce}, not near '
                             f'ln {NUM_CLASSES} = {CE_INIT:.4f}')
    return launches, logs[-1]


def _loss_and_grads(model, img, gt, perm, **kw):
    from segdistill_tpu_torch.models.segmentors import parse_losses
    model.zero_grad(set_to_none=True)
    total, log_vars = parse_losses(model.forward_train(img, gt, 1000,
                                                       perm=perm, **kw))
    total.backward()
    return ({k: float(v.detach()) for k, v in log_vars.items()},
            {n: p.grad.detach().cpu() for n, p in
             model.student.named_parameters()})


@contextlib.contextmanager
def _float64_kept():
    """Within the block, ``Tensor.float()`` leaves a float64 tensor as it
    is: the plain versions and the norms upcast their inputs to fp32 with
    it, which a float64 reference step must not do."""
    upcast = torch.Tensor.float
    torch.Tensor.float = lambda t, *a, **k: t if t.dtype == torch.float64 \
        else upcast(t, *a, **k)
    try:
        yield
    finally:
        torch.Tensor.float = upcast


def _float64_grads(cpu_model, img, gt, perm):
    """The student gradients of the step run in float64 on the CPU."""
    model = copy.deepcopy(cpu_model).double()
    for part in (model.student, model.teacher):
        part.backbone.dtype = torch.float64
    with _float64_kept():
        return _loss_and_grads(model, img.double(), gt, perm)


def _grad_rel_l2(got, want):
    num = sum(float((got[n].double() - g.double()).square().sum())
              for n, g in want.items())
    return math.sqrt(num / sum(float(g.double().square().sum())
                               for g in want.values()))


def phase_train_vs_cpu(config, options, tag, batch=2, hw=512,
                       pair='B0 <- B3', no_drop=(NO_DROP, NO_DROP_PATH_S),
                       float64_grads=False):
    """One fp32 train step on the card against the same step on the CPU:
    the loss terms and the student gradients; with ``float64_grads`` the
    gradients against the CPU step in float64 (TRAIN_GRAD_TOL_REL_L2's
    note)."""
    from segdistill_tpu_torch.apis import init_segmentor_state
    log(f'== train step, fp32 GPU (kernels) vs CPU (plain versions): the '
        f'same {pair} {tag} model, batch {batch} at {hw}x{hw}, dropout and '
        f'drop-path 0, step 1000 (a CGD step: one seeded channel '
        f'permutation)')
    model = init_segmentor_state(
        str(config), seed=0, device=DEVICE,
        cfg_options=dict(NO_CHECKPOINTS, **options,
                         **{k: v for d in no_drop for k, v in d.items()}))
    cpu_model = copy.deepcopy(model).cpu()
    img, gt = _train_batch(batch, seed=6, hw=hw)
    perm = torch.randperm(NUM_CLASSES,
                          generator=torch.Generator().manual_seed(7))
    gpu_losses, gpu_grads = _loss_and_grads(model, img, gt,
                                            perm.to(DEVICE))
    t0 = time.perf_counter()
    cpu_losses, cpu_grads = _loss_and_grads(cpu_model, img.cpu(), gt.cpu(),
                                            perm)
    log(f'CPU step {time.perf_counter() - t0:.1f} s')
    worst = 0.0
    for k, want in sorted(cpu_losses.items()):
        err = abs(gpu_losses[k] - want)
        worst = max(worst, err / (TRAIN_LOSS_TOL_REL * abs(want)
                                  + TRAIN_LOSS_TOL_ABS))
        log(f'  {k}: GPU {gpu_losses[k]:.9g} CPU {want:.9g} abs err '
            f'{err:.3e} relative {err / max(abs(want), 1e-30):.3e}')
    grad_rel = _grad_rel_l2(gpu_grads, cpu_grads)
    against = 'the CPU step'
    if float64_grads:
        t0 = time.perf_counter()
        _, f64_grads = _float64_grads(cpu_model, img.cpu(), gt.cpu(), perm)
        gpu64 = _grad_rel_l2(gpu_grads, f64_grads)
        log(f'CPU float64 step {time.perf_counter() - t0:.1f} s; fp32 '
            f'gradients against it: GPU {gpu64:.3e}, CPU '
            f'{_grad_rel_l2(cpu_grads, f64_grads):.3e}; GPU against the CPU '
            f'fp32 step {grad_rel:.3e}')
        grad_rel = gpu64
        against = 'the CPU step in float64'
    log(f'loss terms: {worst:.3f} of the limit {TRAIN_LOSS_TOL_REL} * '
        f'|loss| + {TRAIN_LOSS_TOL_ABS} used at most; student gradients: '
        f'relative L2 err {grad_rel:.3e} against {against} over '
        f'{len(cpu_grads)} tensors (limit {TRAIN_GRAD_TOL_REL_L2})')
    if not (worst <= 1.0 and grad_rel <= TRAIN_GRAD_TOL_REL_L2):
        raise AssertionError('the GPU train step differs from the CPU one')


def _extra_batch(batch, classes, hw, seed):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    img = torch.randn(batch, 3, *hw, device=DEVICE, generator=gen)
    gt = torch.randint(0, classes, (batch,) + tuple(hw), device=DEVICE,
                       generator=gen)
    return img, gt


def _config(config):
    """A config file's path as the APIs take it, or a composed
    :class:`Config` as it is."""
    return str(config) if isinstance(config, Path) else config


def _ce_weights(model):
    """{'<prefix>.loss_seg': the head's loss weight} of every head whose
    loss is the softmax CE without class weights (a point head's is not,
    nor Fast-SCNN's sigmoid CE or CGNet's class-weighted CE)."""
    heads = model.decode_head
    named = [(f'decode_{i}', h) for i, h in enumerate(heads)] \
        if isinstance(heads, torch.nn.ModuleList) else [('decode', heads)]
    named += model._aux_heads()
    # DANet's three CEs sit under 'pam_cam.', 'pam.' and 'cam.'
    return {f'{p}.loss_seg': head._loss_cfg().get('loss_weight', 1.0)
            for prefix, head in named
            for p in [f'{prefix}.{b}' for b in getattr(head, 'BRANCHES', ())]
            or [prefix]
            if type(head).__name__ != 'PointHead'
            and not head._loss_cfg().get('use_sigmoid', False)
            and head._loss_cfg().get('class_weight') is None}


def phase_train_extra(path_kernels, config, tag, classes, hw, per_step,
                      steps=TRAIN_STEPS, batch=EXTRA_BATCH, watch=None):
    """A segmentor's own train step (its config's SGD and poly LR) with a
    bf16 backbone at the config's batch (2; the HRF recipes 4): -> the
    launch counts of ``path_kernels`` over the ``steps`` timed steps,
    which must be ``per_step`` a step each. ``config``: a config file, or
    a composed :class:`Config`. ``watch(model)``, called before the first
    step, returns a check that runs after the last."""
    from segdistill_tpu_torch.apis import (init_segmentor_state,
                                           prepare_training)
    from segdistill_tpu_torch.ops import seg_ce
    source = config.name if isinstance(config, Path) else 'recipes.py'
    log(f'== train: {tag} ({source}), bf16 backbone, batch '
        f'{batch} at {hw[0]}x{hw[1]}, {classes} classes, random weights '
        f'(seed 0)')
    t0 = time.perf_counter()
    model = init_segmentor_state(
        _config(config), seed=0, device=DEVICE,
        cfg_options={'model.backbone.dtype': 'bfloat16'})
    state, train_step = prepare_training(model)
    if type(state.optimizer) is not torch.optim.SGD:
        raise AssertionError(f'{tag}: built {type(state.optimizer).__name__}'
                             f', the config asks for SGD')
    img, gt = _extra_batch(batch, classes, hw, seed=5)
    log(f'model and optimizer built in {time.perf_counter() - t0:.1f} s')
    after = None if watch is None else watch(model)
    first = [train_step(state, img, gt) for _ in range(TRAIN_WARMUP)][0]
    torch.cuda.synchronize()
    log('step 1: ' + ', '.join(f'{k} {float(v):.6g}'
                               for k, v in sorted(first.items())))

    # the training path: every launch count starts at 0 here
    for k in path_kernels:
        k.launches = 0
    for by_shape in seg_ce.LAUNCHES_BY_SHAPE.values():
        by_shape.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logs = [train_step(state, img, gt) for _ in range(steps)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k.name: k.launches for k in path_kernels}
    CE_SHAPE_LAUNCHES[tag] = {name: dict(by_shape) for name, by_shape
                              in seg_ce.LAUNCHES_BY_SHAPE.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f'step {state.step}: ' + ', '.join(
        f'{k} {float(v):.6g}' for k, v in sorted(logs[-1].items())))
    log(f'train step {seconds / steps * 1e3:.2f} ms, '
        f'{batch * steps / seconds:.2f} images/s over '
        f'{steps} steps; peak memory allocated {peak / 2**30:.2f} GiB')
    log(f'launches during the {tag} training path: {launches}')
    for name, n in launches.items():
        if n != per_step * steps:
            raise AssertionError(f'{tag}: {name} launched {n} times in '
                                 f'{steps} steps, not {per_step} a step')
    values = [float(v) for lv in [first] + logs for v in lv.values()]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f'a loss of the {tag} train step is not finite')
    for key, weight in _ce_weights(model).items():
        ce = float(first[key]) / weight
        if not abs(ce - math.log(classes)) <= CE_INIT_TOL:
            raise AssertionError(f'{tag}: {key} / {weight} at step 1 is '
                                 f'{ce}, not near ln {classes}')
    if after is not None:
        after()
    return launches


def phase_serving_extra(config, tag, classes, request_hw, vs_cpu=True):
    """A segmentor (a config file or a composed :class:`Config`) served
    through ``init_segmentor`` and ``inference_segmentor`` at full width
    and depth in its test mode, on seeded requests; with ``vs_cpu`` the
    fp32 logits of one 512x512 input (a cascade: its first stage's too;
    PointRend's refined map) or one 769x769 slide window against the same
    model on the CPU."""
    from segdistill_tpu_torch.apis import init_segmentor, inference_segmentor
    model = init_segmentor(_config(config), device=DEVICE, seed=0)
    mode = model.test_cfg.get('mode', 'whole')
    source = config.name if isinstance(config, Path) else 'recipes.py'
    log(f'== serving: {tag} ({source}) through init_segmentor, '
        f'{classes} classes, random weights (seed 0), {len(request_hw)} '
        f'requests of {request_hw[0][0]}x{request_hw[0][1]}, {mode} mode'
        + (f' ({model.test_cfg["crop_size"]} windows at stride '
           f'{model.test_cfg["stride"]})' if mode == 'slide' else ''))
    rng = np.random.RandomState(8)
    imgs = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            for h, w in request_hw]
    with torch.no_grad():  # warm up: cuDNN heuristics, allocator
        inference_segmentor(model, imgs[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for img in imgs:
        t0 = time.perf_counter()
        pred = inference_segmentor(model, img)[0]
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        if pred.shape != img.shape[:2] or pred.min() < 0 \
                or pred.max() >= classes:
            raise AssertionError(f'{tag}: bad prediction {pred.shape}')
    log(f'{tag}: per-request latency ms ' + ', '.join(f'{t:.2f}'
                                                    for t in lat)
        + f'; peak memory allocated '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    if not vs_cpu:
        return
    side = 769 if mode == 'slide' else 512
    x = torch.from_numpy(np.random.RandomState(9).randn(
        1, 3, side, side).astype(np.float32)).to(DEVICE)
    cpu_model = copy.deepcopy(model).cpu()
    cascade = type(model).__name__ == 'CascadeEncoderDecoder'
    point = cascade and type(model.decode_head[-1]).__name__ == 'PointHead'
    with torch.no_grad():
        pairs = [('logits', model.encode_decode(x).cpu(),
                  cpu_model.encode_decode(x.cpu()))]
        if cascade:
            pairs.insert(0, (
                'first-stage logits',
                model.decode_head[0](model.extract_feat(x)).float().cpu(),
                cpu_model.decode_head[0](cpu_model.extract_feat(x.cpu()))))
    for what, gpu, cpu in pairs:
        err = (gpu - cpu).abs()
        scale = cpu.abs().max().item()
        off = (err > MODEL_TOL_REL * scale).float().mean().item()
        refined = what == 'logits' and point
        log(f'{tag} fp32 {what} GPU vs CPU at {side}x{side}: max abs err '
            f'{err.max().item():.3e}, max |logit| {scale:.3e}, relative '
            f'{err.max().item() / scale:.3e} (limit {MODEL_TOL_REL}), share '
            f'of values beyond it {off:.2e}'
            + (f' (limit {REFINED_SWAP_SHARE})' if refined else ''))
        if not torch.isfinite(gpu).all() or (
                off > REFINED_SWAP_SHARE if refined else off > 0):
            raise AssertionError(f'{tag}: GPU {what} differ from the CPU '
                                 f'run')


def _without_dropout(model):
    """Every head's dropout off (no draw to match across devices)."""
    from segdistill_tpu_torch.models.decode_heads import BaseDecodeHead
    for m in model.modules():
        if isinstance(m, BaseDecodeHead):
            m.dropout = None
    return model


def phase_extra_vs_cpu(config, tag, classes,
                       hw=(TAB5_VS_CPU_HW, TAB5_VS_CPU_HW), logits=False,
                       acc_share=0.0, fp32_floor=None, prepare=None):
    """One fp32 train step of a segmentor (a config file or a composed
    :class:`Config`) on the card against the same step on the CPU, batch 1
    at ``hw``, dropout 0: the loss terms against the fp32 CPU step, the
    gradients against the CPU step in float64 (TRAIN_GRAD_TOL_REL_L2's
    note); with ``logits``, first the eval-mode logits of every head
    against the CPU's within MODEL_TOL_REL of the largest. An accuracy
    may differ by one pixel (point), or by ``acc_share`` of them where that
    is more (K5's correct count, CORRECT_TOL_SHARE). With ``fp32_floor``
    the gradients' limit rises to that many times the CPU fp32 step's own
    distance from float64 where fp32 cannot meet it
    (FP32_FLOOR_FACTOR's note). PointRend's training points are drawn once
    and given to both. ``prepare(model)`` edits the model first. The
    float64 model is a copy taken before the CPU step (a train-mode forward
    moves EMANet's bases)."""
    from segdistill_tpu_torch.apis import init_segmentor_state
    from segdistill_tpu_torch.models.segmentors import parse_losses
    log(f'== train step, fp32 GPU (kernels) vs CPU (plain versions): {tag}, '
        f'batch {TAB5_VS_CPU_BATCH} at {hw[0]}x{hw[1]}, dropout 0')
    model = _without_dropout(init_segmentor_state(_config(config), seed=0,
                                                  device=DEVICE))
    if prepare is not None:
        prepare(model)
    cpu_model = copy.deepcopy(model).cpu()
    img, gt = _extra_batch(TAB5_VS_CPU_BATCH, classes, hw, seed=6)
    if logits:
        _heads_vs_cpu(model, cpu_model, img, tag)
    points = None
    if type(model).__name__ == 'CascadeEncoderDecoder' and \
            type(model.decode_head[-1]).__name__ == 'PointHead':
        points = torch.rand(TAB5_VS_CPU_BATCH,
                            model.decode_head[-1].num_points, 2,
                            generator=torch.Generator().manual_seed(7))

    def step(m, x, y, pts):
        m.zero_grad(set_to_none=True)
        losses, _ = m.forward_train(x, y, generator=None, points=pts)
        total, log_vars = parse_losses(losses)
        total.backward()
        return ({k: float(v.detach()) for k, v in log_vars.items()},
                {n: p.grad.detach().cpu() for n, p in m.named_parameters()
                 if p.requires_grad})

    gpu_losses, gpu_grads = step(model, img, gt, None if points is None
                                 else points.to(DEVICE))
    model64 = copy.deepcopy(cpu_model).double()
    t0 = time.perf_counter()
    cpu_losses, cpu_grads = step(cpu_model, img.cpu(), gt.cpu(), points)
    log(f'CPU step {time.perf_counter() - t0:.1f} s')
    worst = 0.0
    for k, want in sorted(cpu_losses.items()):
        err = abs(gpu_losses[k] - want)
        if '.acc_' in k:  # an argmax near-tie may flip: one pixel (point)
            n = TAB5_VS_CPU_BATCH * (hw[0] * hw[1] if 'seg' in k
                                     else len(points[0]))
            ok = err <= 100.0 / n * max(1, acc_share * n) * 1.001
        else:
            ok = err <= TRAIN_LOSS_TOL_REL * abs(want) + TRAIN_LOSS_TOL_ABS
            worst = max(worst, err / (TRAIN_LOSS_TOL_REL * abs(want)
                                      + TRAIN_LOSS_TOL_ABS))
        log(f'  {k}: GPU {gpu_losses[k]:.9g} CPU {want:.9g} abs err '
            f'{err:.3e}')
        if not ok:
            raise AssertionError(f'{tag}: {k} differs from the CPU step')
    t0 = time.perf_counter()
    model64.backbone.dtype = torch.float64
    with _float64_kept():
        _, f64_grads = step(model64, img.cpu().double(), gt.cpu(),
                            None if points is None else points.double())
    gpu64 = _grad_rel_l2(gpu_grads, f64_grads)
    cpu64 = _grad_rel_l2(cpu_grads, f64_grads)
    limit = TRAIN_GRAD_TOL_REL_L2 if fp32_floor is None \
        else max(TRAIN_GRAD_TOL_REL_L2, fp32_floor * cpu64)
    log(f'CPU float64 step {time.perf_counter() - t0:.1f} s; fp32 gradients '
        f'against it: GPU {gpu64:.3e}, CPU {cpu64:.3e}; GPU against the CPU '
        f'fp32 step {_grad_rel_l2(gpu_grads, cpu_grads):.3e}')
    log(f'loss terms: {worst:.3f} of the limit used at most; gradients: '
        f'relative L2 err {gpu64:.3e} against the CPU step in float64 over '
        f'{len(f64_grads)} tensors (limit {limit:.3e})')
    if not gpu64 <= limit:
        raise AssertionError(f'{tag}: the GPU train step differs from the '
                             f'CPU one')


def _heads_vs_cpu(model, cpu_model, img, tag):
    """Eval mode: each head's fp32 logits (each stage of a cascade, the
    auxiliary heads) on the card against the CPU's, within MODEL_TOL_REL of
    the largest |logit|."""
    outs = []
    for m, x in ((model, img), (cpu_model, img.cpu())):
        m.eval()
        with torch.no_grad():
            feats = m.extract_feat(x)
            heads = m._stages(feats, None) \
                if isinstance(m.decode_head, torch.nn.ModuleList) \
                else _head_outputs(m.decode_head(feats))
            outs.append([h.float().cpu() for h in heads] + [
                h(feats).float().cpu() for _, h in m._aux_heads()])
        m.train()
    for i, (gpu, cpu) in enumerate(zip(*outs)):
        err = (gpu - cpu).abs().max().item()
        scale = cpu.abs().max().item()
        log(f'{tag} fp32 eval logits of head {i} {tuple(gpu.shape)}, GPU vs '
            f'CPU: max abs err {err:.3e}, max |logit| {scale:.3e}, relative '
            f'{err / scale:.3e} (limit {MODEL_TOL_REL})')
        if not (torch.isfinite(gpu).all() and err <= MODEL_TOL_REL * scale):
            raise AssertionError(f'{tag}: head {i}\'s GPU logits differ from '
                                 f'the CPU run')


def _head_outputs(out):
    """A head's outputs as a list (DANet's three logits, EncNet's logits
    and se logits)."""
    return list(out) if isinstance(out, tuple) else [out]


def _wake_attention(model, seed=1):
    """Draw the attention heads' zero-initialised residual parameters
    (NL and DNL ``conv_out``'s norm weight, GC's last transform conv, CC's,
    PAM's and CAM's ``gamma``, ANN's output projections: every parameter
    of the decode head but a bias that is all zero) from ``seed``, so that
    a comparison of logits or gradients sees the attention: a scale or
    norm weight 0.5, a conv N(0, 1 / fan_in); logs their names."""
    gen = torch.Generator().manual_seed(seed)
    woken = []
    with torch.no_grad():
        for name, p in model.decode_head.named_parameters():
            if name.endswith('bias') or p.any():
                continue
            if p.dim() <= 1:
                p.fill_(0.5)
            else:
                p.copy_(torch.randn(p.shape, generator=gen)
                        * p[0].numel() ** -0.5)
            woken.append(name)
    log(f'woken: {woken}')


def _write_dataset(root):
    """A seeded ADE-like dataset of .npy files under ``root``: uint8 BGR
    images of a few sizes around 512x683, label maps of 0..150 (0 is
    unlabeled) in blocks of ~64 px, and the 150 class names."""
    rng = np.random.RandomState(11)
    for split, n in (('train', CLI_TRAIN_IMAGES), ('val', CLI_VAL_IMAGES)):
        (root / 'img' / split).mkdir(parents=True)
        (root / 'ann' / split).mkdir(parents=True)
        for i in range(n):
            h, w = CLI_IMAGE_HW[i % len(CLI_IMAGE_HW)]
            blocks = rng.randint(0, NUM_CLASSES + 1,
                                 (-(-h // 64), -(-w // 64)))
            ann = np.kron(blocks, np.ones((64, 64), np.int64))[:h, :w]
            img = rng.randint(0, 256, (h, w, 3))
            # a little of the label in the image, so the loss can move
            img = (img + ann[..., None] * [1, 2, 3]) % 256
            np.save(root / 'img' / split / f's{i:03d}.npy',
                    img.astype(np.uint8))
            np.save(root / 'ann' / split / f's{i:03d}.npy',
                    ann.astype(np.uint8))
    (root / 'classes.txt').write_text(
        '\n'.join(f'class{i}' for i in range(NUM_CLASSES)) + '\n')


def _cli_options(root):
    """The ``--options`` that point the CGD config at the .npy dataset
    (``CustomDataset`` inside the config's ``RepeatDataset``), clear the
    checkpoint paths and set the bf16 backbones, the batch and the
    intervals."""
    opts = {'model.t_pretrain': None, 'model.s_pretrain': None,
            'model.cfg_s.pretrained': None,
            'model.cfg_s.backbone.dtype': 'bfloat16',
            'model.cfg_t.backbone.dtype': 'bfloat16',
            'data.samples_per_gpu': TRAIN_BATCH, 'data.workers_per_gpu': 6,
            'runner.max_iters': CLI_ITERS,
            'checkpoint_config.interval': CLI_INTERVAL,
            'checkpoint_config.max_keep_ckpts': 2,
            'evaluation.interval': CLI_INTERVAL, 'log_config.interval': 1}
    for key, split in (('data.train.dataset', 'train'), ('data.val', 'val'),
                       ('data.test', 'val')):
        opts.update({f'{key}.type': 'CustomDataset',
                     f'{key}.data_root': str(root),
                     f'{key}.img_dir': f'img/{split}',
                     f'{key}.ann_dir': f'ann/{split}',
                     f'{key}.img_suffix': '.npy',
                     f'{key}.seg_map_suffix': '.npy',
                     f'{key}.reduce_zero_label': True,
                     f'{key}.classes': str(root / 'classes.txt')})
    return [f'{k}={v}' for k, v in opts.items()]


def _json_log(work_dir):
    """-> ({iter: train line}, {iter: val line}) of the run's json log."""
    (path,) = sorted(Path(work_dir).glob('*.log.json'))
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    return ({ln['iter']: ln for ln in lines if ln['mode'] == 'train'},
            {ln['iter']: ln for ln in lines if ln['mode'] == 'val'})


def _same_tree(a, b):
    """Whether two checkpoint payloads hold the same values, tensors
    bitwise."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            _same_tree(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and \
            torch.equal(a, b)
    return a == b


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    return tree.cpu() if torch.is_tensor(tree) else tree


def _check_restored(train_cli, ckpt, work_dir, options):
    """``--resume-from ckpt`` with ``max_iters`` at the checkpoint's own
    iteration takes no step, so what it returns and saves again is what a
    resume restores: the step, the seed, the student's weights and BN
    statistics, the adapters and every optimizer moment must equal the
    checkpoint file, on the device and in the file written again."""
    saved = torch.load(ckpt, map_location='cpu', weights_only=True)
    moments = saved['optimizer']['state']
    n_params = sum(len(g['params'])
                   for g in saved['optimizer']['param_groups'])
    if saved['step'] != CLI_INTERVAL or len(moments) != n_params or not all(
            float(m['exp_avg_sq'].sum()) > 0.0 and int(m['step']) ==
            CLI_INTERVAL for m in moments.values()):
        raise AssertionError(f'{ckpt} does not hold {CLI_INTERVAL} steps of '
                             f'moments for {n_params} parameters')
    state = train_cli.main(
        [str(CGD_CONFIG), '--work-dir', str(work_dir), '--seed', '0',
         '--no-validate', '--resume-from', str(ckpt), '--options', *options,
         f'runner.max_iters={CLI_INTERVAL}'])
    live = {'state_dict': state.model.student.state_dict(),
            'adapters': state.model.distill_adapters.state_dict(),
            'optimizer': state.optimizer.state_dict(),
            'step': state.step, 'seed': state.seed}
    live = _to_cpu(live)
    again = torch.load(work_dir / 'checkpoints' / ckpt.name,
                       map_location='cpu', weights_only=True)
    for key, want in saved.items():
        if key != 'meta' and not (_same_tree(want, live[key])
                                  and _same_tree(want, again[key])):
            raise AssertionError(f'a resume does not restore {key!r} of the '
                                 f'checkpoint')
    n = len(saved['state_dict']) + len(saved['adapters'])
    log(f'restored by --resume-from, bitwise equal to {ckpt.name} on the '
        f'device and saved again: step {saved["step"]}, seed '
        f'{saved["seed"]}, {n} weight and statistics tensors, moments of '
        f'{n_params} parameters')


def phase_cli(path_kernels):
    """Train, resume and test from the command lines' ``main`` (called in
    this process, so that the launch counts can be read)."""
    from segdistill_tpu_torch.engine import load_meta
    from segdistill_tpu_torch.tools import test as test_cli
    from segdistill_tpu_torch.tools import train as train_cli
    log(f'== command line: tools.train on {CGD_CONFIG.name} (B0 <- B3, bf16 '
        f'backbones, batch {TRAIN_BATCH}, 512x512 crops through the '
        f'training pipeline) from {CLI_TRAIN_IMAGES} + {CLI_VAL_IMAGES} .npy '
        f'images, {CLI_ITERS} iterations, checkpoint and evaluation every '
        f'{CLI_INTERVAL}; then --resume-from iteration {CLI_INTERVAL}; then '
        f'tools.test')
    loss_keys = ('loss', 'decode.loss_seg',
                 'loss_decode_head.linear_pred<->decode_head.linear_pred_other')
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        _write_dataset(root / 'data')
        log(f'dataset written in {time.perf_counter() - t0:.1f} s')
        options = _cli_options(root / 'data')
        work, work2 = root / 'work', root / 'work_resumed'

        # the command-line path: every launch count starts at 0 here
        for k in path_kernels:
            k.launches = 0
        t0 = time.perf_counter()
        state = train_cli.main([str(CGD_CONFIG), '--work-dir', str(work),
                                '--seed', '0', '--options', *options])
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in path_kernels}
        log(f'tools.train: {time.perf_counter() - t0:.1f} s in all')
        log(f'launches during the command-line path: {launches}')
        _check_launched(launches, 'command-line')
        train, val = _json_log(work)
        if state.step != CLI_ITERS or sorted(train) != list(
                range(1, CLI_ITERS + 1)):
            raise AssertionError(f'trained to {state.step}, logged '
                                 f'{sorted(train)}')
        for it, line in train.items():
            if not all(math.isfinite(line[k]) for k in loss_keys):
                raise AssertionError(f'iteration {it}: {line}')
        if sorted(val) != [CLI_INTERVAL, CLI_ITERS]:
            raise AssertionError(f'evaluations at {sorted(val)}')
        ckpts = sorted(q.name for q in (work / 'checkpoints').iterdir())
        want = sorted([f'iter_{CLI_INTERVAL}.pth', f'iter_{CLI_ITERS}.pth',
                       'meta.json'])
        meta = load_meta(str(work))
        if ckpts != want or meta['iter'] != CLI_ITERS \
                or len(meta['CLASSES']) != NUM_CLASSES:
            raise AssertionError(f'checkpoints {ckpts}, meta iter '
                                 f'{meta and meta.get("iter")}')
        # the first two steps warm up; an evaluation is not a step's time
        steady = [train[i] for i in range(3, CLI_ITERS + 1)
                  if i != CLI_INTERVAL + 1]
        step_ms = float(np.median([ln['time'] for ln in steady])) * 1e3
        data_ms = float(np.median([ln['data_time'] for ln in steady])) * 1e3
        eval_s = val[CLI_ITERS]['seconds']
        log(f'step time {step_ms:.2f} ms (median of iterations 3-'
            f'{CLI_ITERS}), of it data_time {data_ms:.2f} ms; '
            f'{TRAIN_BATCH / step_ms * 1e3:.2f} images/s; evaluation of '
            f'{CLI_VAL_IMAGES} images {eval_s:.2f} s, '
            f'{CLI_VAL_IMAGES / eval_s:.2f} images/s; mIoU at '
            f'{CLI_ITERS}: {val[CLI_ITERS]["mIoU"]:.6f}')
        log('losses: ' + ', '.join(f'{i}: {train[i]["loss"]:.5f}'
                                   for i in sorted(train)))

        resumed = train_cli.main(
            [str(CGD_CONFIG), '--work-dir', str(work2), '--seed', '0',
             '--resume-from',
             str(work / 'checkpoints' / f'iter_{CLI_INTERVAL}.pth'),
             '--options', *options])
        train2, val2 = _json_log(work2)
        if resumed.step != CLI_ITERS or sorted(train2) != list(
                range(CLI_INTERVAL + 1, CLI_ITERS + 1)):
            raise AssertionError(f'the resumed run logged {sorted(train2)}')
        worst, worst_rel, bitwise = 0.0, 0.0, True
        for it, line in train2.items():
            for k in loss_keys:
                a, b = train[it][k], line[k]
                bitwise &= a == b
                worst_rel = max(worst_rel, abs(a - b) / abs(a))
                worst = max(worst, abs(a - b)
                            / (RESUME_TOL_REL * abs(a) + RESUME_TOL_ABS))
        # what the limit must tell apart: the loss of another batch
        nearest = min(abs(train[i]['loss'] - train[j]['loss'])
                      / abs(train[i]['loss'])
                      for i in train2 for j in train if j != i)
        log(f'resumed from iteration {CLI_INTERVAL}: iterations '
            f'{CLI_INTERVAL + 1}-{CLI_ITERS} differ by at most '
            f'{worst_rel:.3e} of a loss term, {worst:.4f} of the limit '
            f'{RESUME_TOL_REL} * |loss| + {RESUME_TOL_ABS} (the nearest '
            f'losses of two different iterations differ by {nearest:.3e}); '
            f'bitwise equal: {bitwise}; mIoU at {CLI_ITERS}: '
            f'{val2[CLI_ITERS]["mIoU"]:.6f}')
        if not worst <= 1.0 or sorted(val2) != [CLI_ITERS]:
            raise AssertionError('the resumed run differs from the '
                                 'uninterrupted one')
        _check_restored(
            train_cli, work / 'checkpoints' / f'iter_{CLI_INTERVAL}.pth',
            root / 'work_restored', options)

        metrics = test_cli.main([str(CGD_CONFIG), str(work), '--eval', 'mIoU',
                                 '--options', *options])
        diff = max(abs(metrics[k] - val[CLI_ITERS][k])
                   for k in ('mIoU', 'mAcc', 'aAcc'))
        log(f'tools.test on the work dir: mIoU {metrics["mIoU"]:.9f}, the '
            f'last evaluation logged {val[CLI_ITERS]["mIoU"]:.9f} (mIoU, mAcc '
            f'and aAcc differ by at most {diff:.2e}, limit {MIOU_TOL})')
        if not diff <= MIOU_TOL:
            raise AssertionError('tools.test does not reproduce the last '
                                 'evaluation')
    return launches


def _pd_loss_check(last):
    """The PD loss of a train step is finite and >= 0."""
    key = 'loss_decode_head.linear_pred<->decode_head.linear_pred_other'
    value = float(last[key])
    log(f'PD loss at the last step: {value:.6g}')
    if not (math.isfinite(value) and value >= 0.0):
        raise AssertionError(f'the PD loss is {value}')


def phase_train_mt(kernels, name, tag):
    """A multi-teacher CGD step of ``recipes.py`` (B0 student, B2 and B3
    teachers, bf16 backbones, batch 8 at 512x512) through
    ``prepare_training``'s step, 2 + 10 steps: -> the launch counts of
    ``kernels`` (K1, K3, K4, K5, K6, K10, K11) over the timed steps, each
    step's counts held to its forwards: aligned, three SegFormer heads (K1),
    two CGD entries (K3/K4) and the LayerNorms of all three MiTs (K10);
    the random ensemble, the student's and the drawn teacher's
    (``draw_teacher_index`` of the step's seed, which each step's K10 count
    must show); the student's head CE (K5/K6) and its backward's
    LayerNorms (K11) either way."""
    from segdistill_tpu_torch.apis import (init_segmentor_state,
                                           prepare_training)
    from segdistill_tpu_torch.engine import step_seed
    from segdistill_tpu_torch.models.segmentors import draw_teacher_index
    from segdistill_tpu_torch.recipes import (MT_TEACHERS, mt_bf16_options,
                                              mt_recipe)
    k1, k3, k4, k5, k6, k10, k11 = kernels
    log(f'== train: {tag} ({name}, recipes.py), B0 student <- '
        f'{" + ".join(v.upper() for v in MT_TEACHERS)} teachers, bf16 '
        f'backbones, batch {TRAIN_BATCH} at 512x512, random weights (seed 0)')
    t0 = time.perf_counter()
    config = mt_recipe(name)
    model = init_segmentor_state(config, seed=0, device=DEVICE,
                                 cfg_options=mt_bf16_options(config))
    state, train_step = prepare_training(model)
    img, gt = _train_batch(TRAIN_BATCH, seed=5)
    log(f'model and optimizer built in {time.perf_counter() - t0:.1f} s')
    first = [train_step(state, img, gt) for _ in range(TRAIN_WARMUP)][0]
    torch.cuda.synchronize()
    log('step 1: ' + ', '.join(f'{k} {float(v):.6g}'
                               for k, v in sorted(first.items())))
    aligned = not model.random_ensemble
    teacher_ln = [MIT_LN[v] for v in MT_TEACHERS]

    # the training path: every launch count starts at 0 here
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logs, per_step = [], []
    for _ in range(TRAIN_STEPS):
        before = [k.launches for k in kernels]
        step = state.step + 1
        logs.append(train_step(state, img, gt))
        drawn = None if aligned else draw_teacher_index(
            step_seed(state.seed, step), len(MT_TEACHERS))
        per_step.append((drawn, {k.name: k.launches - b
                                 for k, b in zip(kernels, before)}))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    log(f'step {state.step}: ' + ', '.join(
        f'{k} {float(v):.6g}' for k, v in sorted(logs[-1].items())))
    log(f'train step {seconds / TRAIN_STEPS * 1e3:.2f} ms, '
        f'{TRAIN_BATCH * TRAIN_STEPS / seconds:.2f} images/s over '
        f'{TRAIN_STEPS} steps; peak memory allocated {peak / 2**30:.2f} GiB')
    log(f'launches during the {tag} training path: {launches}')
    log(f'{tag}: per step, the teacher drawn and K10\'s launches: '
        + ', '.join(f'{"both" if d is None else MT_TEACHERS[d]} '
                    f'{got[k10.name]}' for d, got in per_step))
    for i, (drawn, got) in enumerate(per_step):
        n = len(MT_TEACHERS) if aligned else 1
        want = {k1.name: 1 + n, k3.name: n, k4.name: n, k5.name: 1,
                k6.name: 1, k11.name: MIT_LN['b0'],
                k10.name: MIT_LN['b0'] + (sum(teacher_ln) if aligned
                                          else teacher_ln[drawn])}
        if got != want:
            raise AssertionError(f'{tag} step {i + 1}: launches {got}, the '
                                 f'forwards it ran give {want}')
    keys = [k for k in logs[-1] if k.startswith('loss_')]
    want_keys = ['loss_random'] if not aligned else [
        f'loss_decode_head.linear_pred<->decode_head.linear_pred{i}_{i}'
        for i in range(len(MT_TEACHERS))]
    if sorted(keys) != sorted(want_keys):
        raise AssertionError(f'{tag}: distillation keys {keys}')
    values = [float(v) for lv in [first] + logs for v in lv.values()]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f'a loss of the {tag} train step is not finite')
    ce = float(first['decode.loss_seg'])
    if not abs(ce - CE_INIT) <= CE_INIT_TOL:
        raise AssertionError(f'decode.loss_seg at step 1 is {ce}, not near '
                             f'ln {NUM_CLASSES} = {CE_INIT:.4f}')
    return launches


def phase_mt_vs_cpu(name, tag):
    """One fp32 multi-teacher step on the card against the same step on
    the CPU, batch 2 at 256x256, the student's dropout and drop-path 0,
    step 1000 with one seeded channel permutation and (random ensemble)
    teacher 1, the B3, injected on both sides: the loss terms and the
    student's gradients (TRAIN_GRAD_TOL_REL_L2)."""
    from segdistill_tpu_torch.apis import init_segmentor_state
    from segdistill_tpu_torch.recipes import mt_recipe
    log(f'== train step, fp32 GPU (kernels) vs CPU (plain versions): {tag}, '
        f'batch {MT_VS_CPU_BATCH} at {MT_VS_CPU_HW}x{MT_VS_CPU_HW}, step '
        f'1000, the permutation and the teacher injected')
    model = init_segmentor_state(mt_recipe(name), seed=0, device=DEVICE,
                                 cfg_options={k: v for k, v in dict(
                                     NO_DROP, **NO_DROP_PATH_S).items()
                                     if 'cfg_s' in k})
    cpu_model = copy.deepcopy(model).cpu()
    img, gt = _train_batch(MT_VS_CPU_BATCH, seed=6, hw=MT_VS_CPU_HW)
    perm = torch.randperm(NUM_CLASSES,
                          generator=torch.Generator().manual_seed(7))
    kw = {} if not model.random_ensemble else dict(teacher_index=1)
    gpu_losses, gpu_grads = _loss_and_grads(model, img, gt, perm.to(DEVICE),
                                            **kw)
    t0 = time.perf_counter()
    cpu_losses, cpu_grads = _loss_and_grads(cpu_model, img.cpu(), gt.cpu(),
                                            perm, **kw)
    log(f'CPU step {time.perf_counter() - t0:.1f} s')
    worst = 0.0
    for k, want in sorted(cpu_losses.items()):
        err = abs(gpu_losses[k] - want)
        worst = max(worst, err / (TRAIN_LOSS_TOL_REL * abs(want)
                                  + TRAIN_LOSS_TOL_ABS))
        log(f'  {k}: GPU {gpu_losses[k]:.9g} CPU {want:.9g} abs err '
            f'{err:.3e}')
    grad_rel = _grad_rel_l2(gpu_grads, cpu_grads)
    log(f'loss terms: {worst:.3f} of the limit used at most; student '
        f'gradients: relative L2 err {grad_rel:.3e} over {len(cpu_grads)} '
        f'tensors (limit {TRAIN_GRAD_TOL_REL_L2})')
    if not (worst <= 1.0 and grad_rel <= TRAIN_GRAD_TOL_REL_L2):
        raise AssertionError(f'{tag}: the GPU train step differs from the '
                             f'CPU one')


def _check_unet_ce_geometries(kernels):
    """Each UNet train path launched each of K5 and K6 once a step at each
    of UNET_CE_GEOMETRIES (the decode head at ratio 1, the auxiliary head
    at ratio 2) and at no other geometry."""
    want = {}
    for case in UNET_CE_GEOMETRIES:
        _, shape, out_hw, _, _ = next(c for c in _cases().SEG_CE_CASES
                                      if c[0] == case)
        want[tuple(shape) + tuple(out_hw)] = ZOO2_STEPS
    for _, tag, classes, *_ in ZOO2_PATHS:
        if classes != 2:
            continue
        for k in kernels:
            got = CE_SHAPE_LAUNCHES[tag][k.name]
            log(f'{tag}: {k.name} launches by (B, C, h, w, H, W): {got}')
            if got != want:
                raise AssertionError(f'{tag}: {k.name} launched {got}, not '
                                     f'{want}')


def phase_serving_slide(config, tag, request_hw):
    """A UNet recipe served through ``init_segmentor`` and
    ``inference_segmentor`` in slide mode, fp32: a DRIVE-sized warmup
    request, then one request of ``request_hw``; the windows it ran (calls
    of the model's ``encode_decode``) must be the slide grid of the image
    the pipeline gave the model."""
    from segdistill_tpu_torch.apis import init_segmentor, inference_segmentor
    model = init_segmentor(config, device=DEVICE, seed=0)
    crop, stride = model.test_cfg['crop_size'], model.test_cfg['stride']
    log(f'== serving: {tag} (recipes.py) through init_segmentor, 2 classes, '
        f'random weights (seed 0), one {request_hw[0]}x{request_hw[1]} '
        f'request, slide mode ({crop} windows at stride {stride})')
    seen = []
    encode, slide = model.encode_decode, model.slide_inference

    def counted(img):
        seen[-1][1] += 1
        return encode(img)

    def recorded(img, *args, **kw):
        seen.append([tuple(img.shape[2:]), 0])
        return slide(img, *args, **kw)
    model.encode_decode, model.slide_inference = counted, recorded
    rng = np.random.RandomState(8)
    warm = rng.randint(0, 256, DRIVE_REQUEST_HW + (3,)).astype(np.uint8)
    img = rng.randint(0, 256, tuple(request_hw) + (3,)).astype(np.uint8)
    with torch.no_grad():
        inference_segmentor(model, warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = inference_segmentor(model, img)[0]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    (h, w), windows = seen[-1]
    grid = ((max(h - crop[0] + stride[0] - 1, 0) // stride[0] + 1)
            * (max(w - crop[1] + stride[1] - 1, 0) // stride[1] + 1))
    log(f'{tag}: {ms:.2f} ms for a {request_hw[0]}x{request_hw[1]} request, '
        f'served at {h}x{w}: {windows} windows (the slide grid: {grid})')
    if windows != grid or pred.shape != img.shape[:2] or pred.min() < 0 \
            or pred.max() >= 2:
        raise AssertionError(f'{tag}: {windows} windows for a grid of '
                             f'{grid}, prediction {pred.shape}')


def _ema_watch(model):
    """EMANet's train path: -> a check that its bases moved, stayed
    float32 (the backbone computes in bf16) and finite, and that the frozen
    ``ema_mid_conv`` is bitwise as built."""
    head = model.decode_head
    mid = {k: v.clone() for k, v in head.ema_mid_conv.state_dict().items()}
    bases = head.ema_module.bases.clone()

    def check():
        now = head.ema_module.bases
        moved = (now.double() - bases.double()).abs().max().item()
        same = all(torch.equal(v, mid[k]) for k, v in
                   head.ema_mid_conv.state_dict().items())
        log(f'EMANet: bases ({now.dtype}) moved by {moved:.3e} at most over '
            f'the steps; ema_mid_conv bitwise unchanged: {same}')
        if not (moved > 0 and now.dtype == torch.float32 and same
                and torch.isfinite(now).all()):
            raise AssertionError('EMANet: the bases did not move, or the '
                                 'frozen conv did')
    return check


def _check_attn_ce_geometry(kernels):
    """Each attention train path launched K5 and K6 at ATTN_CE_GEOMETRY
    alone, its per-step count a step."""
    _, shape, out_hw, _, _ = next(c for c in _cases().SEG_CE_CASES
                                  if c[0] == ATTN_CE_GEOMETRY)
    geometry = tuple(shape) + tuple(out_hw)
    for _, tag, per_step, _ in ATTN_PATHS:
        want = {geometry: per_step * ATTN_STEPS}
        for k in kernels:
            got = CE_SHAPE_LAUNCHES[tag][k.name]
            log(f'{tag}: {k.name} launches by (B, C, h, w, H, W): {got}')
            if got != want:
                raise AssertionError(f'{tag}: {k.name} launched {got}, not '
                                     f'{want}')


def phase_attn_logits_vs_cpu(name, tag):
    """An attention recipe's fp32 eval logits of every head (DANet's three,
    EncNet's se logits) on the card against the CPU's, batch 1 at
    ZOO_VS_CPU_HW, the zero-initialised attention branches woken
    (:func:`_wake_attention`)."""
    from segdistill_tpu_torch.apis import init_segmentor_state
    from segdistill_tpu_torch.recipes import recipe
    log(f'== eval logits, fp32 GPU vs CPU: {tag} (recipes.py), batch 1 at '
        f'{ZOO_VS_CPU_HW[0]}x{ZOO_VS_CPU_HW[1]}')
    model = _without_dropout(init_segmentor_state(recipe(name), seed=0,
                                                  device=DEVICE))
    _wake_attention(model)
    img, _ = _extra_batch(1, ZOO_CLASSES, ZOO_VS_CPU_HW, seed=6)
    _heads_vs_cpu(model, copy.deepcopy(model).cpu(), img, tag)


def phase_resnext_vs_cpu():
    """ResNeXt-50 32x4d, which no recipe uses, as a backbone alone in train
    mode at batch 2, at each of RESNEXT_SEEDS (weights, input and map
    weighting drawn from it): its four fp32 maps on the card against the
    same model on the CPU (within MODEL_TOL_REL of each map's largest
    value); the card's float64 gradients of a seeded weighting of the maps
    against the CPU's in float64 (RESNEXT_F64_TOL_REL_L2: the wiring on
    the card, free of fp32 rounding); and the card's fp32 gradients
    against the CPU's float64 ones, within TRAIN_GRAD_TOL_REL_L2 or
    FP32_FLOOR_FACTOR times the CPU fp32 run's own distance from float64,
    the largest over the seeds (RESNEXT_SEEDS' note)."""
    from segdistill_tpu_torch.models import build_backbone
    log(f'== ResNeXt-50 32x4d backbone alone, train mode, batch 2 at '
        f'{RESNEXT_HW[0]}x{RESNEXT_HW[1]}, GPU vs CPU, seeds '
        f'{RESNEXT_SEEDS}')
    readings = [_resnext_vs_cpu(build_backbone(dict(RESNEXT)), seed)
                for seed in RESNEXT_SEEDS]
    floor = max(cpu64 for _, cpu64 in readings)
    limit = max(TRAIN_GRAD_TOL_REL_L2, FP32_FLOOR_FACTOR * floor)
    for seed, (rel, cpu64) in zip(RESNEXT_SEEDS, readings):
        log(f'ResNeXt seed {seed} fp32 gradients against the CPU in '
            f'float64: relative L2 err {rel:.3e} (the CPU fp32 run\'s '
            f'{cpu64:.3e}; limit {limit:.3e}, from the largest CPU '
            f'reading {floor:.3e})')
        if not rel <= limit:
            raise AssertionError(f'ResNeXt seed {seed} gradients differ from '
                                 f'the CPU run')


def _worst_tensor(got, want):
    """-> (name, its own relative L2 err) of the tensor that adds the most
    to ``got``'s squared distance from ``want``."""
    name = max(want, key=lambda n: float((got[n].double() - want[n].double())
                                         .square().sum()))
    return name, _grad_rel_l2({name: got[name]}, {name: want[name]})


def _resnext_vs_cpu(net, seed):
    """One seed of :func:`phase_resnext_vs_cpu`: checks the maps and the
    card's float64 gradients, -> (the card's fp32 gradients' and the CPU
    fp32 run's relative L2 distances from the CPU's float64 ones)."""
    net.init_weights(torch.Generator().manual_seed(seed))
    cpu = copy.deepcopy(net).train()
    net = net.to(DEVICE).train()
    gen = torch.Generator().manual_seed(6 + 100 * seed)
    x = torch.randn(2, 3, *RESNEXT_HW, generator=gen)

    def run(model, inp):
        model.zero_grad(set_to_none=True)
        outs = model(inp)
        weights = [torch.randn(o.shape, generator=torch.Generator()
                               .manual_seed(9 + i + 100 * seed)).to(o)
                   for i, o in enumerate(outs)]
        sum((o * w).sum() for o, w in zip(outs, weights)).backward()
        return ([o.detach().cpu() for o in outs],
                {n: p.grad.detach().cpu()
                 for n, p in model.named_parameters()})
    gpu_outs, gpu_grads = run(net, x.to(DEVICE))
    cpu_outs, cpu_grads = run(cpu, x)
    model64 = copy.deepcopy(cpu).double()
    model64.dtype = torch.float64
    with _float64_kept():
        _, f64_grads = run(model64, x.double())
        gpu64 = copy.deepcopy(model64).to(DEVICE)
        _, gpu64_grads = run(gpu64, x.double().to(DEVICE))
    for i, (g, c) in enumerate(zip(gpu_outs, cpu_outs)):
        err = (g - c).abs().max().item()
        scale = c.abs().max().item()
        log(f'ResNeXt seed {seed} map {i} {tuple(g.shape)}: max abs err '
            f'{err:.3e}, max |value| {scale:.3e}, relative '
            f'{err / scale:.3e} (limit {MODEL_TOL_REL})')
        if not (torch.isfinite(g).all() and err <= MODEL_TOL_REL * scale):
            raise AssertionError(f'ResNeXt seed {seed} map {i} differs from '
                                 f'the CPU run')
    rel64 = _grad_rel_l2(gpu64_grads, f64_grads)
    log(f'ResNeXt seed {seed} float64 gradients, card against CPU: '
        f'relative L2 err {rel64:.3e} over {len(f64_grads)} tensors (limit '
        f'{RESNEXT_F64_TOL_REL_L2})')
    if not rel64 <= RESNEXT_F64_TOL_REL_L2:
        raise AssertionError(f'ResNeXt seed {seed} float64 gradients differ '
                             f'from the CPU run')
    rel, cpu64 = (_grad_rel_l2(gpu_grads, f64_grads),
                  _grad_rel_l2(cpu_grads, f64_grads))
    for who, grads in (('card', gpu_grads), ('CPU', cpu_grads)):
        name, own = _worst_tensor(grads, f64_grads)
        log(f'ResNeXt seed {seed} fp32 on the {who}: most of the distance '
            f'from float64 in {name} (its own relative L2 err {own:.3e})')
    return rel, cpu64


# Operation counts behind ``bound_ms`` (fp32, outside the tensor cores,
# unless said): a bilinear tap 7 (4 multiplies, 3 adds); one softmax term
# 3 (scale or subtract, exp, add); so an upsampled value inside a two-map KL
# 23 per output element (2 x (7 + 3) + 3 for the KL), a CE term 10, and
# their backwards 32 and 21 (the recomputed forward, the gradient, the
# transposed tap); K1 8 per part and output element; attention 4 N M d in
# the products (at the inputs' type: bf16 on the tensor cores) plus 5 N M
# for the softmax, its backward 10 N M d plus 8 N M; LayerNorm 8 per
# element forward, 17 backward. Each counts the algorithm once, not what a
# kernel recomputes. Bytes: every input read once, every output written
# once, in their own types.


def _bound(*args):
    return _cases().bound(*args)


def _sra_bound(b, h, n, m, d, dtype, backward=False):
    """The bound of K2 (or K9) on b * h heads of (n, m, d) in ``dtype``: q,
    k, v read and the output written once (K9: also dO, the fp32 output and
    the row log-sum-exp read, dq, dk, dv written), against the products at
    the peak of the inputs' type plus the softmax terms in fp32. At d = 32
    in bf16 the n * m exponentials (16 per clock and SM: ~0.009 ms at B0
    stage 1, batch 8) cost as much as the products: the products must
    leave the CUDA cores, and the softmax must stay cheap."""
    size, peak = (2, _cases().PEAK_BF16) if dtype == torch.bfloat16 \
        else (4, _cases().PEAK_F32)
    bh = b * h
    if not backward:
        return _bound(bh * size * (2 * n * d + 2 * m * d), bh * 5 * n * m,
                      bh * 4 * n * m * d, peak)
    return _bound(bh * (size * (2 * n * d + 2 * m * d) + 4 * n * d + 4 * n
                        + size * (n * d + 2 * m * d)),
                  bh * 8 * n * m, bh * 10 * n * m * d, peak)


def _bounds(names):
    """{kernel name: (bound_ms, bound_by)} at the shapes of
    ``main_case`` in :func:`main`."""
    k1, k2, k3, k4, k5, k6, k7, k8, k9, k10, k11 = names
    out = {}
    # K1: B0 head, batch 1, fp32: three (s, s, 256) parts -> (128, 128, 256)
    _, shapes, out_hw = _cases().RESIZE_SUM_CASES[0]
    out[k1] = _cases().resize_sum_bound(shapes, out_hw, torch.float32)
    # K2: B0 stage 1, batch 1, fp32: N 16384, M 256, d 32, one head; K9:
    # the same stage at batch 8 in bf16 (the K2 phase logs K2's bound
    # there too, beside its batch-8 bf16 time)
    out[k2] = _sra_bound(1, 1, 16384, 256, 32, torch.float32)
    out[k9] = _sra_bound(8, 1, 16384, 256, 32, torch.bfloat16, backward=True)
    # K3-K8: (8, 150, 128, 128) bf16 maps -> 512 x 512
    _, shape, out_hw, _, _, _ = _cases().GROUP_KL_CASES[0]
    out[k3], out[k4] = _cases().kl_bounds(shape, out_hw, torch.bfloat16, 0)
    _, shape, out_hw, _, _ = _cases().SEG_CE_CASES[0]
    out[k5], out[k6] = _cases().seg_ce_bounds(shape, out_hw, torch.bfloat16)
    _, shape, out_hw, _, _ = _cases().PIXEL_KL_CASES[0]
    out[k7], out[k8] = _cases().kl_bounds(shape, out_hw, torch.bfloat16, 2)
    # K10/K11: B0 stage 1, batch 8, bf16: (131072, 32)
    _, rows, c = _cases().LN_CASES[0]
    out[k10], out[k11] = _cases().ln_bounds(rows, c, torch.bfloat16)
    return out


def main():
    phase_device()
    sys.path.insert(0, str(ROOT))
    from segdistill_tpu_torch.ops import (group_kl, layer_norm, pixel_kl,
                                          resize_sum, seg_ce, sra_attn)
    k1, k2, k3, k4, k5, k6, k7, k8, k9, k10, k11 = kernels = [
        resize_sum.KERNEL, sra_attn.KERNEL, group_kl.FWD_KERNEL,
        group_kl.BWD_KERNEL, seg_ce.FWD_KERNEL, seg_ce.BWD_KERNEL,
        pixel_kl.FWD_KERNEL, pixel_kl.BWD_KERNEL, sra_attn.BWD_KERNEL,
        layer_norm.FWD_KERNEL, layer_norm.BWD_KERNEL]
    phase_build(kernels)
    results = {k1.name: phase_resize_sum(), k2.name: phase_sra_attn()}
    results[k3.name], results[k4.name] = phase_group_kl()
    results[k5.name], results[k6.name], ce_device = phase_seg_ce()
    results[k7.name], results[k8.name] = phase_pixel_kl()
    _check_fwd_tickets('seg_ce and pixel_kl phases')
    results[k9.name] = phase_sra_train()
    results[k10.name], results[k11.name], k10_floor = phase_layer_norm()
    launches = {k.name: 0 for k in kernels}
    cgd_kernels = [k1, k3, k4, k5, k6, k10, k11]
    paths = [phase_serving([k1, k2, k10]),
             phase_train(cgd_kernels, CGD_CONFIG, {}, 'CGD')[0]]
    phase_train_vs_cpu(CGD_CONFIG, {}, 'CGD')
    pd_launches, pd_last = phase_train(
        [k1, k2, k5, k6, k7, k8, k9, k10, k11], PD_CONFIG, STUDENT_FA_TRAIN,
        'PD')
    _pd_loss_check(pd_last)
    paths.append(pd_launches)
    phase_train_vs_cpu(PD_CONFIG, STUDENT_FA_TRAIN, 'PD')
    paths.append(phase_cli(cgd_kernels))
    # the Tab5 PSP and Swin students: serving, the timed CGD steps (the PSP
    # student has no LayerNorm: K11 runs only on the Swin path), and fp32
    # steps against the CPU, where the PSP pair takes K3/K4 and K7/K8 at
    # two sizes and Swin's last PatchMerging norm K10/K11 at C = 1536
    paths.append(phase_serving_tab5(PSP_BASELINE, [], 'PSP'))
    paths.append(phase_serving_tab5(SWIN_BASELINE, [k10], 'Swin'))
    paths.append(phase_train([k1, k3, k4, k5, k6, k10], PSP_CGD, {},
                             'psp_CGD', TAB5_BATCH,
                             'PSPNet-R50 student <- B3 teacher')[0])
    paths.append(phase_train([k1, k3, k4, k5, k6, k10, k11], SWIN_CGD, {},
                             'swin_CGD', TAB5_BATCH,
                             'Swin-T + UPerHead student <- B3 teacher')[0])
    tab5_vs_cpu = dict(batch=TAB5_VS_CPU_BATCH, hw=TAB5_VS_CPU_HW)
    tab5_vs_cpu = dict(tab5_vs_cpu, float64_grads=True)
    phase_train_vs_cpu(PSP_CGD, {}, 'psp_CGD', pair='PSPNet-R50 <- B3',
                       no_drop=(NO_DROP,), **tab5_vs_cpu)
    phase_train_vs_cpu(PSP_PD, {}, 'psp_PD', pair='PSPNet-R50 <- B3',
                       no_drop=(NO_DROP,), **tab5_vs_cpu)
    phase_train_vs_cpu(SWIN_CGD, {}, 'swin_CGD', pair='Swin-T <- B3',
                       **tab5_vs_cpu)
    # the configs/extra models: their own SGD steps (K5/K6 on the decode and
    # auxiliary heads, on PointRend's FPNHead), serving (no hand-written
    # kernel on those paths: ResNet has BN, the heads no K1), fp32 steps
    # against the CPU
    for config, tag, classes, hw, per_step, _ in EXTRA_PATHS:
        paths.append(phase_train_extra([k5, k6], config, tag, classes, hw,
                                       per_step))
    for config, tag, classes, _, _, request_hw in EXTRA_PATHS:
        phase_serving_extra(config, tag, classes, request_hw)
    for config, tag, classes, *_ in EXTRA_PATHS:
        phase_extra_vs_cpu(config, tag, classes)
    # this slice's Cityscapes recipes: SGD steps (K5/K6 at ratios 2, 4 and
    # 8 of the 512x1024 crop), 1024x2048 whole-mode serving, and the three
    # headline models' fp32 logits and step against the CPU
    from segdistill_tpu_torch import recipes
    from segdistill_tpu_torch.recipes import (cityscapes_recipe,
                                              drive_recipe, hrf_recipe)
    zoo_launches = {}
    for recipe, tag, per_step, steps, _, _ in ZOO_PATHS:
        zoo_launches[recipe] = phase_train_extra(
            [k5, k6], cityscapes_recipe(recipe), tag, ZOO_CLASSES, ZOO_HW,
            per_step, steps)
        paths.append(zoo_launches[recipe])
    for recipe, tag, _, _, requests, vs_cpu in ZOO_PATHS:
        phase_serving_extra(cityscapes_recipe(recipe), tag, ZOO_CLASSES,
                            [ZOO_REQUEST_HW] * requests, vs_cpu=False)
    for recipe, tag, _, _, _, vs_cpu in ZOO_PATHS:
        if vs_cpu:
            phase_extra_vs_cpu(cityscapes_recipe(recipe), tag, ZOO_CLASSES,
                               hw=ZOO_VS_CPU_HW, logits=True,
                               acc_share=CORRECT_TOL_SHARE,
                               fp32_floor=FP32_FLOOR_FACTOR)
    # this slice: the multi-teacher CGD steps (K1, K3/K4, K5/K6, K10/K11
    # counted a step against the forwards each ran) and their fp32 steps
    # against the CPU; the last A10 recipes' SGD steps (K5/K6 on the
    # ResNeSt PSPNet's two heads and at 2 classes on the UNet heads, at
    # ratios 1 and 2; Fast-SCNN and CGNet take no kernel), their serving
    # (Cityscapes whole mode at 1024x2048; UNet slide windows on an HRF
    # and a DRIVE image), every head's fp32 logits and the step against
    # the CPU, and ResNeXt as a backbone alone
    mt_kernels = [k1, k3, k4, k5, k6, k10, k11]
    for name, tag in MT_PATHS:
        paths.append(phase_train_mt(mt_kernels, name, tag))
    for name, tag in MT_PATHS:
        phase_mt_vs_cpu(name, tag)
    for name, tag, classes, hw, batch, per_step in ZOO2_PATHS:
        paths.append(phase_train_extra(
            [k5, k6], recipes.recipe(name), tag, classes, hw, per_step,
            ZOO2_STEPS, batch))
    _check_unet_ce_geometries([k5, k6])
    for name, tag, classes, *_ in ZOO2_PATHS:
        if classes == ZOO_CLASSES:
            phase_serving_extra(cityscapes_recipe(name), tag, classes,
                                [ZOO_REQUEST_HW], vs_cpu=False)
    phase_serving_slide(hrf_recipe('fcn_unet_s5-d16'), ZOO2_PATHS[3][1],
                        HRF_REQUEST_HW)
    for name, tag, *_ in ZOO2_PATHS[4:]:
        phase_serving_slide(drive_recipe(f'{name}_drive'),
                            tag.replace('HRF', 'DRIVE'), DRIVE_REQUEST_HW)
    for name, tag, classes, *_ in ZOO2_PATHS:
        phase_extra_vs_cpu(recipes.recipe(name), tag, classes,
                           hw=ZOO2_VS_CPU_HW[classes], logits=True,
                           acc_share=CORRECT_TOL_SHARE,
                           fp32_floor=FP32_FLOOR_FACTOR)
    # this slice: the attention-head recipes' SGD steps (K5/K6 at
    # ATTN_CE_GEOMETRY alone, 4 a step for DANet's three CEs and the
    # auxiliary head's, 2 for the others; EMANet's bases move and its
    # frozen conv stays put), a 1024x2048 whole-mode request each, every
    # head's fp32 logits against the CPU, and four fp32 steps against it
    attn_tags = []
    for name, tag, per_step, _ in ATTN_PATHS:
        paths.append(phase_train_extra(
            [k5, k6], recipes.recipe(name), tag, ZOO_CLASSES, ZOO_HW,
            per_step, ATTN_STEPS,
            watch=_ema_watch if name == 'emanet_r50-d8' else None))
        attn_tags.append(tag)
    _check_attn_ce_geometry([k5, k6])
    for name, tag, *_ in ATTN_PATHS:
        phase_serving_extra(recipes.recipe(name), tag, ZOO_CLASSES,
                            [ZOO_REQUEST_HW], vs_cpu=False)
    for name, tag, _, step in ATTN_PATHS:
        if step:
            phase_extra_vs_cpu(recipes.recipe(name), tag, ZOO_CLASSES,
                               hw=ZOO_VS_CPU_HW, logits=True,
                               acc_share=CORRECT_TOL_SHARE,
                               fp32_floor=FP32_FLOOR_FACTOR,
                               prepare=_wake_attention)
        else:
            phase_attn_logits_vs_cpu(name, tag)
    phase_resnext_vs_cpu()
    _check_ln_tickets('after the train steps')
    _check_fwd_tickets('after the train steps')
    for path in paths:
        for name, n in path.items():
            launches[name] += n
    # each kernel at its main path's shape: serving at batch 1 (fp32) for
    # K1 and K2, the bf16 bench train steps for K3-K11
    main_case = {k1.name: (_cases().RESIZE_SUM_CASES[0][0], torch.float32),
                 k2.name: ('B0 stage1 b1', torch.float32),
                 k3.name: (_cases().GROUP_KL_CASES[0][0], torch.bfloat16),
                 k4.name: (_cases().GROUP_KL_CASES[0][0], torch.bfloat16),
                 k5.name: (_cases().SEG_CE_CASES[0][0], torch.bfloat16),
                 k6.name: (_cases().SEG_CE_CASES[0][0], torch.bfloat16),
                 k7.name: (_cases().PIXEL_KL_CASES[0][0], torch.bfloat16),
                 k8.name: (_cases().PIXEL_KL_CASES[0][0], torch.bfloat16),
                 k9.name: ('B0 stage1 b8', torch.bfloat16),
                 k10.name: (_cases().LN_CASES[0][0], torch.bfloat16),
                 k11.name: (_cases().LN_CASES[0][0], torch.bfloat16)}
    bounds = _bounds([k.name for k in kernels])
    entries = []
    for k in kernels:
        res = results[k.name]
        case = res[main_case[k.name]]
        bound_ms, bound_by = bounds[k.name]
        entries.append({
            'name': k.name, 'route': 'cuda',
            'source': str(k.source.relative_to(ROOT)),
            'replaces': k.replaces, 'launches': launches[k.name],
            'max_abs_err': max(r[0] for (_, dt), r in res.items()
                               if dt == torch.float32),
            'ms': case[1], 'plain_ms': case[2], 'bound_ms': bound_ms,
            'bound_by': bound_by,
            'library_ms': case[3] if len(case) > 3 else None})
        if k is k10:  # the queued floor of an empty kernel on K10's grid
            entries[-1]['floor_ms'] = k10_floor
    # K5/K6 at this slice's new geometries (bf16, the train steps' shapes;
    # device time), launched there by the recipes that run no other one
    for case, recipes in ZOO_CE_GEOMETRIES:
        _, shape, out_hw, _, _ = next(c for c in _cases().SEG_CE_CASES
                                      if c[0] == case)
        times = ce_device[case]
        for i, (k, bound) in enumerate(zip((k5, k6), _cases().seg_ce_bounds(
                shape, out_hw, torch.bfloat16))):
            err = results[k.name][(case, torch.float32)][0]
            ms, plain_ms = times[2 * i], times[2 * i + 1]
            entries.append({
                'name': f'{k.name} {shape} -> {out_hw[0]}x{out_hw[1]}',
                'route': 'cuda', 'source': str(k.source.relative_to(ROOT)),
                'replaces': k.replaces,
                'launches': sum(zoo_launches[r][k.name] for r in recipes),
                'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
                'bound_ms': bound[0], 'bound_by': bound[1],
                'library_ms': None})
    # K5/K6 at the UNet recipes' two geometries (2 classes, ratios 1 and 2;
    # bf16, device time), with the launches the UNet steps made at each
    unet = [tag for _, tag, classes, *_ in ZOO2_PATHS if classes == 2]
    for case in UNET_CE_GEOMETRIES:
        _, shape, out_hw, _, _ = next(c for c in _cases().SEG_CE_CASES
                                      if c[0] == case)
        geometry = tuple(shape) + tuple(out_hw)
        times = ce_device[case]
        for i, (k, bound) in enumerate(zip((k5, k6), _cases().seg_ce_bounds(
                shape, out_hw, torch.bfloat16))):
            entries.append({
                'name': f'{k.name} {shape} -> {out_hw[0]}x{out_hw[1]}',
                'route': 'cuda', 'source': str(k.source.relative_to(ROOT)),
                'replaces': k.replaces,
                'launches': sum(CE_SHAPE_LAUNCHES[t][k.name].get(geometry, 0)
                                for t in unet),
                'max_abs_err': results[k.name][(case, torch.float32)][0],
                'ms': times[2 * i], 'plain_ms': times[2 * i + 1],
                'bound_ms': bound[0], 'bound_by': bound[1],
                'library_ms': None})
    # K5/K6 at the attention recipes' geometry (bf16, device time), with
    # the launches their train steps made there
    _, shape, out_hw, _, _ = next(c for c in _cases().SEG_CE_CASES
                                  if c[0] == ATTN_CE_GEOMETRY)
    geometry = tuple(shape) + tuple(out_hw)
    times = ce_device[ATTN_CE_GEOMETRY]
    for i, (k, bound) in enumerate(zip((k5, k6), _cases().seg_ce_bounds(
            shape, out_hw, torch.bfloat16))):
        entries.append({
            'name': f'{k.name} {shape} -> {out_hw[0]}x{out_hw[1]}',
            'route': 'cuda', 'source': str(k.source.relative_to(ROOT)),
            'replaces': k.replaces,
            'launches': sum(CE_SHAPE_LAUNCHES[t][k.name].get(geometry, 0)
                            for t in attn_tags),
            'max_abs_err': results[k.name][(ATTN_CE_GEOMETRY,
                                            torch.float32)][0],
            'ms': times[2 * i], 'plain_ms': times[2 * i + 1],
            'bound_ms': bound[0], 'bound_by': bound[1],
            'library_ms': None})
    log('launches per path: ' + json.dumps(
        dict(zip(('serving', 'CGD', 'PD', 'command line', 'PSP serving',
                  'Swin serving', 'psp_CGD', 'swin_CGD')
                 + tuple(tag for _, tag, *_ in EXTRA_PATHS)
                 + tuple(tag for _, tag, *_ in ZOO_PATHS)
                 + tuple(tag for _, tag in MT_PATHS)
                 + tuple(tag for _, tag, *_ in ZOO2_PATHS)
                 + tuple(attn_tags), paths))))
    print(json.dumps({'kernels': entries}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
