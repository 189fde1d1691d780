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
logits at stride 8 against the B3 teacher's at stride 4): K3/K4 in the
tiles' two-geometry form or their gather variants, as each case names (the
PSP CGD case's device times printed beside their bounds), K7/K8 in their
gather variants; and the LayerNorm phase K10/K11 at C = 1536, Swin-T's last
PatchMerging norm. Then the ``configs/extra`` models at full width and
depth (random weights from seed 0): (22-24) PSANet-R50 (PSAHead + FCN
auxiliary head) and PointRend-R50/FPN (FPNHead + PointHead, a cascade) on
ADE20K, and PSPNet-R50 with the FCN auxiliary head on Cityscapes (19
classes), each through ``prepare_training``'s SGD step with a bf16
backbone at the config's batch of 2 (512x512; Cityscapes 512x1024), 2 + 5
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
and LRASPP-MobileNetV3 (2 + 5 steps), FCN-HR18, OCRNet-R50-d8,
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
512x512, 2 + 5 steps), aligned (one CGD entry a teacher) and the random
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
steps made there. Then data parallelism across processes, each rank a
process of its own started with torchrun's environment
(``segdistill_tpu_torch/parallel/``): right after the command-line phase
(14), (101) ``tools.train --multi-host`` for 6 iterations and
``tools.test --multi-host`` on its checkpoint, each in a process of its
own under torchrun's variables for one rank (NCCL at world size 1): the
logged losses within the resume limit (3e-4 * |loss| + 3e-6) of phase
14's one-process run, the checkpoint without a ``module.`` prefix, the
text log naming NCCL, and the test's mIoU, mAcc and aAcc within 1e-6 of
the run's own evaluation of the same weights; (102) ``fast_evaluate`` of
phase 14's last checkpoint sharded over two gloo ranks on the card (each
4 of the 8 images, the histograms summed), equal to one process exactly;
and at the end (103) the CGD step of (10) at two ranks sharing the card
over gloo, 4 images a rank (global batch 8), each rank's step time over 3
steps after 2, peak memory and launches, which must be the one-process
step's own counts a step (K1 2, K3-K6 1, K10 119, K11 30), every
parameter, buffer and optimizer moment bitwise equal on the two ranks,
and an fp32 step at 2 images a rank held to the one-process fp32 step on
the same 4 images within (11)'s limits (loss terms 1e-6 * |loss| +
2.5e-5, gradients relative L2 1e-3); where the machine has two cards or
more, (103) runs again under NCCL, a card a rank. Two processes on one
card are not a multi-GPU figure. Then this slice, the loader backends and
batched evaluation, right after (102): (104) ``tools.train`` on phase 14's
dataset with ``data.loader_backend`` native (the C++ core, built with g++)
and then device (the augmentation on the card), the ADE20K recipe in
``data.aug_cfg``, 12 iterations each without evaluation: the median
``time`` and ``data_time`` of iterations 3-12 beside the host loader's,
finite losses, every batch handed to the step as CUDA tensors with no
copy, and the launches exactly the in-memory CGD step's a step; (105)
``DeviceAugPipeline.apply`` on the card against the same function on the
CPU on the same draws, 8 canvases of (512, 2048) from phase 14's images:
labels equal, images within 1e-4, one call under
``torch.cuda.set_sync_debug_mode('error')``, ms a batch and peak memory;
(106) ``single_device_test(batch_size=8)`` of phase 14's B0 student in
fp32 against ``batch_size=1`` on 16 images of two shapes: at most 1e-4 of
the pixels differ (argmax near-ties), images/s of each in two rounds after
an untimed pass of each. Then this slice, the rest of the data layer,
after the attention phases: (107) a seeded Pascal VOC 2012 + SBD tree
(images as PNG bytes under VOC's ``.jpg`` names, palette label maps with
255 outlines, SBD ``.mat`` files) completed by the port's ``voc_aug``
converter run as a command, ``PascalVOCDataset`` reading the palette maps
as the indices written and the converted maps as the ``.mat`` labels, the
``aug.txt`` split and the recipe's ConcatDataset; (108) ``tools.train`` on
the ``pspnet_r50-d8_voc12aug`` recipe of ``recipes.py`` (PSPNet-R50-d8, 21
classes, bf16 backbone, batch 4 of 512x512 crops through the recipe's
pipeline) for 6 iterations with a checkpoint and an evaluation: ms a step,
``data_time``, peak memory, K5/K6 exactly twice an iteration at (4, 21,
64, 64) -> 512x512; ``tools.test --eval mIoU --show-dir`` reproducing the
evaluation and writing one painted PNG a val image at its size; a
Cityscapes submission (``results2img``) read back equal; in-memory SGD
steps of the recipe (2 + 3) and its fp32 step against the CPU; (109) the
same for ``pspnet_r50-d8_pascal_context`` (60 classes, 480x480, K5/K6 at
(4, 60, 60, 60) -> 480x480), two requests of ~520 px served in slide mode
(480x480 windows at stride 320), and K5/K6's fp32 device times at both
geometries; nothing of OpenCV or pillow is imported. The launch count
of each kernel is read over each main path (9, 10, 12, 14, 15-18, 22-27,
31-37, 48, 49, 52-57, 71-80, each rank's in 103, 104, 106, 108 and 109,
110-112, added together).

Then this slice, the serving export, the tool twins and the convergence
run. (110) While the kernels build (2), full-width Segformer-B0 (150
classes, random weights from seed 0, fp32) is exported at 512x512 through
``tools.export`` (labels and ``--logits`` as it stands, labels with
``fused_attention=True``; K1, K10 and K2 as ``segdistill::`` custom
operators, whose nodes the graphs must hold: 1, 30 and 8). A fresh
process that imports torch and ``segdistill_tpu_torch.ops`` alone (and
nothing of JAX, the JAX package or the rest of the port, checked there)
loads the saved programs and runs 4 seeded requests through each; near the
end the same requests go through eager ``encode_decode`` here, against
which the programs' outputs are held: labels equal but at argmax
near-ties, logits within 1e-5 of max |logit|, K1, K10 and K2 launched as
often as eager's, request for request; then each labels program, loaded
here as well, is timed against eager in 3 rounds of A B B A (ms a request,
host clock, each the median of 10 after 3). (111) The tool twins:
``get_flops`` on B0 at 512x512 (parameters; FLOPs against ``bench.py``'s
8.4e9), ``benchmark`` (50 requests, whole mode), ``image_demo`` on a
seeded image (its labels equal ``inference_segmentor``'s),
``convert_checkpoint`` and ``publish_model`` on a reference-layout file of
the B0 weights (read back bitwise under the SHA-256 name), and
``profile_train --trace-dir`` (a Chrome trace with the card's kernels).
(112) The miniature convergence run of ``docs/convergence.md``
(``tools/convergence.py``: mit_b0 + SegFormerHead, 4 classes, 240
iterations of batch 4 at 64x64 from ``tests/data/convergence/``, fp32,
then +CGD against the trained baseline) through ``tools.train`` and
``tools.test`` in this process, held to the doc's criteria, K5/K6 once an
iteration at (4, 4, 16, 16) -> 64x64 and nowhere else, K3/K4 once a CGD
iteration; K3-K6's fp32 device times at that shape (phases 5 and 6 check
them there).

Then this slice, steps per dispatch (``engine/cuda_graph.py``): (113,
114) the CGD and PD steps of (10) and (12) with the optimizer in its
capturable form, steps 998-1001 (CGD's shuffle draws its permutation at
1000, a graph of its own) run eagerly twice and as a chunk of 4 replays
of the step's CUDA graph twice, each from one snapshot (cuDNN
deterministic): every parameter, buffer and optimizer tensor and the last
step's log vars bitwise equal across all four, or the operations PyTorch
names nondeterministic and the replays within (11)'s limits; a
``torch.profiler`` trace of the eager steps (each kernel's CUDA function
counted as often as its wrapper counted launches) and of the chunk (each
at the eager count, no kernel the eager steps do not launch but the
graph's copy and fill nodes); capture seconds, the graphs' pool, peak
memory, and the eager step against the chunk in 3 rounds in turns (ms a
step by host clock and CUDA events, device-busy ms from each trace's
kernel union); with CGD, a graph of three K10 launches, whose
programmatic edges (K10's dependent launch kept in a graph) the CUDA
runtime counts, and a checkpoint saved and loaded between a single step
and a chunk against the same steps straight on (bitwise, the learning
rates float64 scalars on the card); (115) ``tools.train`` on phase 14's
dataset with ``runner.steps_per_dispatch=4`` over 10 iterations,
evaluations and checkpoints every 5: the JAX runner's cadence (logs at 4,
8, 9, 10, evaluations and checkpoints at 8 and 10), the losses within the resume
limit of phase 14's k = 1 run, ``tools.test`` reproducing the last
evaluation; (116) psp_CGD, swin_CGD and the MT random ensemble (batch 2)
under capture against eager (any error fails), and so the SGD configs:
the three configs/extra models at their own batch and crop, and the
EMANet-R50, OCRNet-HR18 and Fast-SCNN recipes (cuDNN deterministic and
PyTorch's deterministic algorithms where it has them: bitwise, or within
the eager runs' spread where PyTorch names a nondeterministic operation of
the step, each distance logged). The kernels line says for
each kernel how often a replay of each graph launched it.

Then steps per dispatch across processes: (117) under torchrun's
variables (NCCL at world size 1; NCCL refuses two ranks on one card), in a
process of its own, the CGD and PD steps, PSPNet-R50 Cityscapes (SGD) and
the MT random ensemble (bf16, batch 8 at 512x512; a chunk whose two steps
draw both teachers, a graph each) through
``prepare_training(distributed=True)`` at k = 2: DDP's static graph
captured, a chunk of replays against the eager DDP steps from one
snapshot (phase 116's rule), a replay's trace (the random ensemble's: one
a teacher, K1 2, K3/K4 1, K5/K6 1, K11 30, K10 83 or 119 by the teacher)
with K1-K11 at their eager counts and NCCL's kernels named (none at world
size 1: the all-reduce is in place), the DDP graph against the eager DDP
step in turns; and ``tools.train --multi-host`` at k = 4 with phase 115's
checks, then ``tools.test --multi-host``. Phase 103's gloo ranks on the
card must be refused k = 2 (``GraphCaptureError``).

Then this slice, MiT's per-block recompute (``with_cp``, each student
block under a non-reentrant checkpoint, its dropout and drop-path masks
replayed): (118) the CGD and PD steps of (113, 114) with
``model.cfg_s.backbone.with_cp=True``, steps 998-1001 eagerly with and
without the flag from one snapshot (cuDNN deterministic): each step's
launches those of the step without the flag plus the recompute's (K10
141, PD's K2 16), the two bitwise or within (11)'s limits where PyTorch
names an operation that adds with atomics; a chunk of 4 replays with the
flag against its eager steps by the same rule, a replay's trace at the
eager counts; then the eager step and the chunk of replays, with and
without the flag, in 2 rounds in turns: ms a step (5 eager steps, a chunk
of 4 replays), the eager peak memory allocated, each graph's pool, and
the device-busy share of one trace each; and, in the block of fp32 steps
below, the CGD step with the flag against the CPU.

The order differs from the numbering: the export traces while the kernels
build; the timed phases of the later slices run first, and their fp32
steps against the CPU, which time nothing, in one block after them; the
checks in processes of their own that time nothing run beside that
block in two chains: the program loader of 110 and the ``--multi-host``
command lines of 101 and 117; 116 in a process of its own and the
sharded evaluation of 102. Every phase that times something runs
alone. The fp32 steps of (11), (13) and the Tab5 pairs against the CPU
take the frozen B3 teacher at B2's depth (the timed steps keep B3).

Any failed check raises, and the script exits non-zero. It needs a CUDA
device and the repository around it. The second line before the last is
a JSON object with one entry per kernel (its time at its main path's
shape beside the plain version's, the least time the card could take for
that work, and a PyTorch library call's where one computes the same
function); the last line is ``{"ok": true, "device": {...}}``.
"""

import ast
import atexit
import collections
import contextlib
import copy
import gc
import hashlib
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
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
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS = 8, 2, 5
# the fp32 GPU-vs-CPU steps of the B0 <- B3 pairs (11, 13) and the Tab5
# pairs: the frozen B3 teacher cut to B2's depth, (3, 4, 6, 3) blocks at
# B3's widths (every kernel at the same shapes; the timed steps keep B3)
TEACHER_DEPTH_CUT = {'model.cfg_t.backbone.type': 'mit_b2'}
B3_AT_B2_DEPTH = 'B3 at B2\'s depth'
# the psp and swin configs' own batch (samples_per_gpu 2); their fp32
# GPU-vs-CPU step at batch 1 and 256x256, full width
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
    ('ocrnet_hr18', 'OCRNet-HR18', 2, 5, 2, True),
    ('deeplabv3plus_r50-d8', 'DeepLabV3+-R50-d8', 2, 5, 2, True),
    ('lraspp_m-v3-d8', 'LRASPP-MobileNetV3', 1, 5, 2, True),
    ('fcn_hr18', 'FCN-HR18', 1, 3, 1, False),
    ('ocrnet_r50-d8', 'OCRNet-R50-d8', 2, 3, 1, False),
    ('deeplabv3_r50-d8', 'DeepLabV3-R50-d8', 2, 3, 1, False),
    ('deeplabv3plus_m-v2-d8', 'DeepLabV3+-MobileNetV2-d8', 2, 3, 1, False)]
ZOO_CLASSES, ZOO_HW, ZOO_REQUEST_HW = 19, (512, 1024), (1024, 2048)
# (116) the recipes whose SGD steps run under steps per dispatch beside the
# configs/extra models: EMANet's bases move in place, HRNet's 37 upsamples,
# Fast-SCNN's own SGD schedule
SGD_DISPATCH_RECIPES = [('emanet_r50-d8', 'EMANet-R50-d8'),
                        ('ocrnet_hr18', 'OCRNet-HR18'),
                        ('fast_scnn', 'Fast-SCNN')]
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
# a command line under torchrun's variables, in a process of its own
CLI_MULTI_HOST_TIMEOUT = 300
# (104) the native and device loader backends through tools.train on the
#   command line's dataset, the ADE20K recipe of the config's pipeline
#   (``tools/bench_loader.py``'s), no evaluation
CLI_BACKENDS = ('native', 'device')
# (105) DeviceAugPipeline.apply on the card against the CPU on the same
#   draws: a batch of 8 canvases of (512, 2048) from the command line's
#   images, the labels equal, the normalised images within the CPU test's
#   limit (fp32 sums of the same taps in another order; 1e-5 read on the
#   CPU against the JAX matmuls); timed over this many calls
DEVICE_AUG_TOL = 1e-4
DEVICE_AUG_CALLS = 20
# (106) batched evaluation of the B0 student of phase 14's checkpoint in
#   fp32 against the per-image path: images of two shapes, batch 8; the
#   label maps may differ at argmax near-ties, another batch size summing
#   in another order, at most this share of the pixels
EVAL_IMAGES, EVAL_BATCH = 16, 8
EVAL_HW = [(512, 683), (683, 512)]
EVAL_DIFF_SHARE = 1e-4
# (107-109) Pascal VOC 2012 + SBD and Pascal Context: a VOC-like tree of
#   VOC_TRAIN + VOC_VAL images with palette label maps and SBD_ONLY more
#   with SBD labels alone (SBD also labels the VOC train images, as it
#   labels most of VOC's), the VOC12-aug recipe's command line for
#   VOC_ITERS iterations (bf16 backbone, the recipe's batch of 4 at
#   512x512), in-memory steps of both recipes (PASCAL_STEPS after the
#   warm-up), fp32 steps against the CPU at PASCAL_VS_CPU_HW, and two slide
#   requests to the Context recipe
VOC_TRAIN, VOC_VAL, SBD_ONLY = 6, 4, 6
VOC_IMAGE_HW = [(375, 500), (500, 375), (333, 500), (500, 500)]
VOC_ITERS = 6
VOC_CLASSES, CONTEXT_CLASSES = 21, 60
VOC_HW, CONTEXT_HW = (512, 512), (480, 480)
PASCAL_BATCH, PASCAL_STEPS = 4, 3
PASCAL_VS_CPU_HW = (256, 256)
CONTEXT_REQUEST_HW = [(390, 520), (520, 700)]
# the K5/K6 geometries of the two recipes (SEG_CE_CASES names)
VOC_CE_GEOMETRY, CONTEXT_CE_GEOMETRY = 'VOC b4', 'Context b4'
# two ranks, one process each: the timed CGD steps at 4 images a rank
# (global batch 8, as the one-process step), the fp32 step at 2 a rank
# against one process on the 4; the ranks' own time limit (a rank that
# fails makes the launcher kill the other)
DIST_WORLD, DIST_PER_RANK, DIST_STEPS = 2, 4, 3
DIST_VS_ONE_PER_RANK = 2
DIST_TIMEOUT = 420
# the ranks' functions, as parallel.launch starts them
DIST_CGD_RANK, DIST_EVAL_RANK = ('chip_smoke:dist_cgd_rank',
                                 'chip_smoke:dist_eval_rank')
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


T0 = time.perf_counter()


def log(msg):
    """Print a line; a phase's header (``== ``) with the seconds since the
    script started."""
    if msg.startswith('== '):
        msg = f'== [{time.perf_counter() - T0:.1f} s] {msg[3:]}'
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
    # a teacher of another size: the variants each case names (the
    # two-geometry tiles, or the gather variants), never a fallback
    for name, shape, thw, out_hw, g, shuffle, oh, tile in \
            _cases().GROUP_KL_TWO_SIZE_CASES:
        plan = _check_variant(f'group_kl {name}', gk, shape, thw, out_hw, oh,
                              tile)
        perm = torch.randperm(shape[1], device=DEVICE, generator=gen) \
            if shuffle else None
        for dtype in (torch.float32, torch.bfloat16):
            xs = torch.randn(shape, device=DEVICE, generator=gen).to(dtype)
            xt = torch.randn(shape[:2] + thw, device=DEVICE,
                             generator=gen).to(dtype)
            before = gk.FWD_KERNEL.launches, gk.BWD_KERNEL.launches
            fused = (lambda a, t: gk.fused_group_kl_shuffled(
                a, t, perm, out_hw, g, tau)) if shuffle else \
                (lambda a, t: gk.fused_group_kl(a, t, out_hw, g, tau))
            fwd[(name, dtype)], bwd[(name, dtype)] = _loss_case(
                f'group_kl {name} {dtype} (teacher {thw}, {plan})', xs, xt,
                fused,
                lambda a, t: gk.group_kl_plain(a, t, perm, out_hw, g, tau))
            _launched(f'group_kl {name}', gk, before)
            args = gk._prepare(xs, xt, perm, out_hw, g, tau)
            _same(f'group_kl {name} {dtype}', gk._launch_fwd(*args),
                  gk._launch_fwd(*args))
            if name == PSP_CGD_CASE and dtype == torch.bfloat16:
                _two_size_device_ms(name, xs, xt, fused, shape, thw, out_hw)
    return fwd, bwd


# the two-size case whose K3/K4 device times the group-KL phase prints
# beside their bounds: the psp_CGD step's pair
PSP_CGD_CASE = 'PSP CGD g5 perm'


def _two_size_device_ms(name, xs, xt, fused, shape, thw, out_hw):
    """K3's and K4's device time (calls queued behind a held stream) at a
    two-size case, beside their bounds and the forward's exponential
    floor."""
    from segdistill_tpu_torch.utils.timing import device_ms
    with torch.no_grad():
        fwd_ms = device_ms(lambda: fused(xs, xt), calls=3)
    k = xs.clone().requires_grad_()
    loss = fused(k, xt)
    gbar = torch.ones((), device=DEVICE)
    bwd_ms = device_ms(
        lambda: torch.autograd.grad(loss, k, gbar, retain_graph=True),
        calls=3)
    fb, bb = _cases().kl_bounds(shape, out_hw, xs.dtype, 0, thw)
    floor = 2 * shape[0] * shape[1] * out_hw[0] * out_hw[1] \
        / _cases().PEAK_EXP2 * 1e3
    log(f'group_kl {name} {xs.dtype} (teacher {thw}) device time: K3 '
        f'{fwd_ms:.4f} ms (bound {fb[0]:.4f}, {fb[1]}; exponentials\' floor '
        f'{floor:.4f}), K4 {bwd_ms:.4f} ms (bound {bb[0]:.4f}, {bb[1]})')


def _check_variant(tag, mod, shape, teacher_hw, out_hw, oh, tile):
    """A student and a teacher of different sizes plan the variants the
    case names: the forward's output tile of ``oh`` rows (0: its gather
    variant) and the backward's source tile of edge ``tile`` (0: its gather
    variant; K7/K8 plan both gather variants)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fplan = mod.forward_plan(*shape[2:], *out_hw, teacher_hw)
    bplan = mod.backward_plan(*shape, *out_hw, sms, teacher_hw)
    if fplan['oh'] != oh or bplan['tile'] != tile:
        raise AssertionError(f'{tag}: two sizes planned {fplan}, {bplan}, '
                             f'the case is meant for {oh} rows, tile {tile}')
    return (f'two-geometry {_fwd_plan(fplan)}' if oh else 'fwd gather') + \
        (f', two-geometry tile {tile}' if tile else ', bwd gather')


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
        _check_variant(f'pixel_kl {name}', pk, shape, thw, out_hw, 0, 0)
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
    cases = [(f'B0 stage{s + 1} b8', 8, h, n, 256, 32)
             for s, (h, n) in enumerate(stages)]
    # batch 1 once: fewer heads, more splits of the query rows
    cases.append(('B0 stage1 b1', 1, 1, 16384, 256, 32))
    cases.append(('ragged N, M', 2, 2, 1000, 100, 32))
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


def _ce_device_times(sc, case, dtype, gen):
    """K5 and K6 at SEG_CE_CASES' ``case`` in ``dtype``, device time (calls
    queued behind a held stream), beside the plain version's -> (K5 ms,
    plain ms, K6 ms, plain ms)."""
    from segdistill_tpu_torch.utils.timing import device_ms
    _, shape, out_hw, ignored, _ = next(
        c for c in _cases().SEG_CE_CASES if c[0] == case)
    classes = shape[1]
    labels = torch.randint(0, classes, (shape[0],) + out_hw, device=DEVICE,
                           generator=gen)
    labels[torch.rand(labels.shape, device=DEVICE, generator=gen)
           < ignored] = 255
    z = torch.randn(shape, device=DEVICE, generator=gen).to(dtype)
    with torch.no_grad():
        k5 = device_ms(lambda: sc.fused_seg_ce(z, labels, out_hw, classes))
        p5 = device_ms(lambda: sc.seg_ce_plain(z, labels, out_hw, classes))
    k = z.clone().requires_grad_()
    ce, _ = sc.fused_seg_ce(k, labels, out_hw, classes)
    p = z.clone().requires_grad_()
    plain_ce, _ = sc.seg_ce_plain(p, labels, out_hw, classes)
    k6 = device_ms(lambda: torch.autograd.grad(ce, k, retain_graph=True))
    p6 = device_ms(lambda: torch.autograd.grad(plain_ce, p,
                                               retain_graph=True))
    return k5, p5, k6, p6


def _ce_path_times(sc, gen):
    """K5 and K6 at the SGD train paths' shapes, bf16 (checked above as
    cases of SEG_CE_CASES): device time (calls queued behind a held
    stream) beside the plain version's and the bound. -> {case: (K5 ms,
    plain ms, K6 ms, plain ms)}."""
    log('K5/K6 at the SGD train paths\' shapes, bf16, device time (10 '
        'calls queued behind a held stream)')
    times = {}
    for path, case, per_step in _cases().SEG_CE_PATH_CASES:
        _, shape, out_hw, _, _ = next(
            c for c in _cases().SEG_CE_CASES if c[0] == case)
        k5, p5, k6, p6 = times[case] = _ce_device_times(
            sc, case, torch.bfloat16, gen)
        (b5, by5), (b6, by6) = _cases().seg_ce_bounds(shape, out_hw,
                                                      torch.bfloat16)
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
    the timed steps, the last step's log vars and the step's time (ms)."""
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
    return launches, logs[-1], step_ms


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
    intervals, as ``key=value`` arguments."""
    return [f'{k}={v}' for k, v in _cli_config_options(root).items()]


def _cli_config_options(root):
    """:func:`_cli_options` as a dict of dotted keys."""
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
    return opts


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


def phase_cli(path_kernels, root):
    """Train, resume and test from the command lines' ``main`` (called in
    this process, so that the launch counts can be read), the dataset and
    the work dirs under ``root``; -> the launch counts of the training run
    and its JSON log ({iter: train line}, {iter: val line})."""
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
    return launches, train, val


def _digests(*tensors_by_name):
    """{name: sha1 of the bytes} of every tensor in the given dicts (state
    dicts, an optimizer's flattened state): two ranks compare bitwise."""
    out = {}
    for prefix, tree in tensors_by_name:
        for name, t in tree.items():
            if torch.is_tensor(t):
                data = t.detach().cpu().reshape(-1).view(torch.uint8)
                out[f'{prefix}{name}'] = hashlib.sha1(
                    data.numpy().tobytes()).hexdigest()
    return out


def _optimizer_tensors(optimizer):
    return {f'{i}.{k}': v for i, st in optimizer.state_dict()['state'].items()
            for k, v in st.items()}


def _vs_one_perm():
    """The fp32 steps' channel permutation (phase_train_vs_cpu's)."""
    return torch.randperm(NUM_CLASSES,
                          generator=torch.Generator().manual_seed(7))


def _dist_timed_steps(rank, kernels):
    """Phase (a)'s bf16 steps on this rank's share: -> (step ms, peak
    bytes, launches over the timed steps, last log vars, digests)."""
    from segdistill_tpu_torch.apis import (init_segmentor_state,
                                           prepare_training)
    model = init_segmentor_state(
        str(CGD_CONFIG), seed=0, device=DEVICE,
        cfg_options=dict(NO_CHECKPOINTS, **BF16_BACKBONES))
    state, train_step = prepare_training(model, distributed=True)
    img, gt = _train_batch(DIST_WORLD * DIST_PER_RANK, seed=5)
    share = slice(rank * DIST_PER_RANK, (rank + 1) * DIST_PER_RANK)
    img, gt = img[share], gt[share]
    for _ in range(TRAIN_WARMUP):
        train_step(state, img, gt)
    torch.cuda.synchronize()
    # the two-rank path: every launch count of this rank starts at 0 here
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logs = [train_step(state, img, gt) for _ in range(DIST_STEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    return (seconds / DIST_STEPS * 1e3, torch.cuda.max_memory_allocated(),
            launches, {k: float(v) for k, v in logs[-1].items()},
            _digests(('model.', model.state_dict()),
                     ('optimizer.', _optimizer_tensors(state.optimizer))))


def _dist_fp32_step(rank, out_dir):
    """Phase (a)'s fp32 step through DDP on this rank's 2 of the 4 images
    of the one-process step: -> its log vars (the ranks' mean); rank 0
    saves the averaged student gradients."""
    from segdistill_tpu_torch.apis import init_segmentor_state
    from segdistill_tpu_torch.models.segmentors import parse_losses
    from segdistill_tpu_torch.parallel import wrap_model
    model = init_segmentor_state(
        str(CGD_CONFIG), seed=0, device=DEVICE,
        cfg_options=dict(NO_CHECKPOINTS, **NO_DROP, **NO_DROP_PATH_S))
    img, gt = _train_batch(DIST_WORLD * DIST_VS_ONE_PER_RANK, seed=6)
    share = slice(rank * DIST_VS_ONE_PER_RANK,
                  (rank + 1) * DIST_VS_ONE_PER_RANK)
    ddp = wrap_model(model)  # alive until the backward has averaged
    total, log_vars = parse_losses(ddp(
        img[share], gt[share], 1000, perm=_vs_one_perm().to(DEVICE)))
    total.backward()
    if rank == 0:
        torch.save({n: p.grad.detach().cpu()
                    for n, p in model.student.named_parameters()},
                   Path(out_dir) / 'grads.pt')
    return {k: float(v) for k, v in log_vars.items()}


def dist_cgd_rank(out_dir, backend):
    """One rank of phase (a), started by ``parallel.launch`` with
    torchrun's environment: the timed bf16 CGD steps and the fp32 step;
    writes ``rank<r>.json`` under ``out_dir``."""
    from segdistill_tpu_torch.ops import group_kl, layer_norm, resize_sum, \
        seg_ce
    from segdistill_tpu_torch.parallel import process_group
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = [resize_sum.KERNEL, group_kl.FWD_KERNEL, group_kl.BWD_KERNEL,
               seg_ce.FWD_KERNEL, seg_ce.BWD_KERNEL, layer_norm.FWD_KERNEL,
               layer_norm.BWD_KERNEL]
    with process_group(backend) as (rank, world):
        step_ms, peak, launches, last, digests = _dist_timed_steps(
            rank, kernels)
        _check_fwd_tickets(f'rank {rank}')
        _check_ln_tickets(f'rank {rank}')
        torch.cuda.empty_cache()
        fp32 = _dist_fp32_step(rank, out_dir)
        refusal = _dispatch_refusal(backend)
        with open(Path(out_dir) / f'rank{rank}.json', 'w') as f:
            json.dump(dict(rank=rank, world=world, backend=backend,
                           device=str(torch.cuda.current_device()),
                           step_ms=step_ms, peak=peak, launches=launches,
                           last=last, digests=digests, fp32=fp32,
                           refusal=refusal), f)


def _dispatch_refusal(backend):
    """The CGD step at k = 2 across the ranks: over gloo on CUDA tensors
    ``prepare_training`` must raise ``GraphCaptureError`` (gloo's
    collectives cannot be captured); -> its message, or None under NCCL
    (not tried)."""
    from segdistill_tpu_torch.apis import (init_segmentor_state,
                                           prepare_training)
    from segdistill_tpu_torch.engine.cuda_graph import GraphCaptureError
    if backend != 'gloo':
        return None
    model = init_segmentor_state(
        str(CGD_CONFIG), seed=0, device=DEVICE,
        cfg_options=dict(NO_CHECKPOINTS, **{'runner.steps_per_dispatch': 2}))
    try:
        prepare_training(model, distributed=True)
    except GraphCaptureError as exc:
        return str(exc)
    raise AssertionError('a gloo rank on CUDA tensors took '
                         'runner.steps_per_dispatch = 2')


def phase_dist_train(kernels, one_process_ms):
    """(a) The CGD step of ``CGD_CONFIG`` (B0 <- B3, bf16 backbones) at
    two ranks on the one card, over gloo, 4 images a rank (global batch
    8): each rank's step time, peak memory and launches (the CGD step's
    own counts a step), every parameter, buffer and optimizer moment
    bitwise equal on the two ranks, and an fp32 step at 2 images a rank
    held to the one-process fp32 step on the same 4 images. Where the
    machine has two cards or more, again under NCCL, a card a rank. ->
    the gloo run's launches, both ranks together."""
    from segdistill_tpu_torch.apis import init_segmentor_state
    from segdistill_tpu_torch.parallel import launch
    backends = ['gloo'] + (['nccl'] if torch.cuda.device_count() > 1
                           else [])
    log(f'== two ranks, one process each, CGD step of {CGD_CONFIG.name} '
        f'(B0 <- B3, bf16 backbones, {DIST_PER_RANK} images a rank at '
        f'512x512, global batch {DIST_WORLD * DIST_PER_RANK}); backends: '
        f'{backends} (gloo: both ranks on one card)')
    per_step = dict(zip([k.name for k in kernels],
                        (2, 1, 1, 1, 1, MIT_LN['b0'] + MIT_LN['b3'],
                         MIT_LN['b0'])))
    one_card = {'CUDA_VISIBLE_DEVICES': os.environ.get(
        'CUDA_VISIBLE_DEVICES', '0').split(',')[0]}
    torch.cuda.empty_cache()
    path = None
    for backend in backends:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            launch(DIST_CGD_RANK, DIST_WORLD, [tmp, backend],
                   timeout=DIST_TIMEOUT,
                   env=one_card if backend == 'gloo' else None)
            seconds = time.perf_counter() - t0
            ranks = [json.loads((Path(tmp) / f'rank{r}.json').read_text())
                     for r in range(DIST_WORLD)]
            grads = torch.load(Path(tmp) / 'grads.pt', weights_only=True)
        log(f'{backend}: two ranks started, built, stepped and checked in '
            f'{seconds:.1f} s')
        for r in ranks:
            log(f"rank {r['rank']} ({r['backend']}, card {r['device']}): "
                f"train step {r['step_ms']:.2f} ms (mean of {DIST_STEPS} "
                f"after {TRAIN_WARMUP}), peak memory allocated "
                f"{r['peak'] / 2**30:.2f} GiB, launches {r['launches']}; "
                f"loss {r['last']['loss']:.6g}")
            want = {k: DIST_STEPS * n for k, n in per_step.items()}
            if r['launches'] != want:
                raise AssertionError(f"rank {r['rank']} launched "
                                     f"{r['launches']}, not {want}")
        slowest = max(r['step_ms'] for r in ranks)
        log(f'{backend}: {DIST_WORLD * DIST_PER_RANK / slowest * 1e3:.2f} '
            f'images/s for the two ranks together (the slower rank\'s '
            f'step); one process at batch {TRAIN_BATCH}: {one_process_ms:.2f}'
            f' ms a step, {TRAIN_BATCH / one_process_ms * 1e3:.2f} images/s')
        differ = [k for k in ranks[0]['digests']
                  if ranks[0]['digests'][k] != ranks[1]['digests'].get(k)]
        if differ or ranks[0]['digests'].keys() != ranks[1]['digests'].keys():
            raise AssertionError(f'{backend}: the ranks differ after the '
                                 f'steps in {differ[:5]}')
        log(f"{backend}: {len(ranks[0]['digests'])} parameters, buffers "
            f'(SyncBN statistics) and optimizer moments bitwise equal on '
            f'both ranks')
        if ranks[0]['fp32'] != ranks[1]['fp32']:
            raise AssertionError('the ranks log other fp32 losses')
        if backend == 'gloo':
            # this slice: steps per dispatch over gloo on the card refused
            log(f"{backend}: k = 2 on CUDA tensors, each rank: "
                f"GraphCaptureError: {ranks[0]['refusal']}")
            if not all('gloo collectives cannot be captured'
                       in (r['refusal'] or '') for r in ranks):
                raise AssertionError('gloo ranks on the card were not '
                                     'refused steps per dispatch')
        if backend == 'gloo':
            model = init_segmentor_state(
                str(CGD_CONFIG), seed=0, device=DEVICE,
                cfg_options=dict(NO_CHECKPOINTS, **NO_DROP, **NO_DROP_PATH_S))
            img, gt = _train_batch(DIST_WORLD * DIST_VS_ONE_PER_RANK, seed=6)
            one_losses, one_grads = _loss_and_grads(
                model, img, gt, _vs_one_perm().to(DEVICE))
            del model
            path = {k: sum(r['launches'][k] for r in ranks)
                    for k in per_step}
        worst = 0.0
        for k, want in sorted(one_losses.items()):
            if 'loss' not in k:
                continue
            got = ranks[0]['fp32'][k]
            worst = max(worst, abs(got - want) / (
                TRAIN_LOSS_TOL_REL * abs(want) + TRAIN_LOSS_TOL_ABS))
            log(f'  {k}: two ranks {got:.9g}, one process {want:.9g}')
        grad_rel = _grad_rel_l2(grads, one_grads)
        log(f'{backend}: fp32 step at {DIST_VS_ONE_PER_RANK} images a rank '
            f'against one process on the {DIST_WORLD * DIST_VS_ONE_PER_RANK}'
            f': loss terms {worst:.3f} of the limit {TRAIN_LOSS_TOL_REL} * '
            f'|loss| + {TRAIN_LOSS_TOL_ABS}; student gradients relative L2 '
            f'{grad_rel:.3e} (limit {TRAIN_GRAD_TOL_REL_L2})')
        if not (worst <= 1.0 and grad_rel <= TRAIN_GRAD_TOL_REL_L2):
            raise AssertionError(f'{backend}: the two-rank fp32 step differs '
                                 f'from one process')
    log(f'backends run: {backends}')
    return path


def _torchrun_env():
    """torchrun's variables for one rank of one (NCCL on the card)."""
    from segdistill_tpu_torch.parallel.launch import free_port
    return dict(os.environ, RANK='0', WORLD_SIZE='1', LOCAL_RANK='0',
                LOCAL_WORLD_SIZE='1', MASTER_ADDR='localhost',
                MASTER_PORT=str(free_port()), PYTHONPATH=str(ROOT))


def _run_cli(args, what):
    res = subprocess.run([sys.executable, '-m', *args], cwd=ROOT,
                         env=_torchrun_env(), capture_output=True, text=True,
                         timeout=CLI_MULTI_HOST_TIMEOUT)
    if res.returncode != 0:
        raise AssertionError(f'{what} failed:\n{res.stderr[-4000:]}')
    return res


def phase_cli_multi_host(root, train):
    """(b) ``tools.train --multi-host`` and ``tools.test --multi-host`` as
    torchrun starts one rank (RANK 0, WORLD_SIZE 1: NCCL at world size 1),
    each in a process of its own, on phase_cli's dataset and config: the
    logged losses of iterations 1-6 against the one-process run's
    (``train``), rank 0's checkpoint, and ``tools.test --multi-host`` on
    it against the evaluation the run logged of the same weights at
    iteration 6 (in its one process)."""
    log(f'== command line under torchrun\'s variables (RANK 0, WORLD_SIZE '
        f'1, NCCL): tools.train --multi-host for {CLI_INTERVAL} iterations, '
        f'then tools.test --multi-host')
    options = _cli_options(root / 'data')
    work = root / 'work_multi_host'
    t0 = time.perf_counter()
    _run_cli(['segdistill_tpu_torch.tools.train', str(CGD_CONFIG),
              '--work-dir', str(work), '--seed', '0', '--multi-host',
              '--options', *options, f'runner.max_iters={CLI_INTERVAL}'],
             'tools.train --multi-host')
    log(f'tools.train --multi-host: {time.perf_counter() - t0:.1f} s')
    (text_log,) = work.glob('*.log')
    if 'Backend: nccl' not in text_log.read_text():
        raise AssertionError('the --multi-host run did not use NCCL')
    got, got_val = _json_log(work)
    if sorted(got) != list(range(1, CLI_INTERVAL + 1)) \
            or sorted(got_val) != [CLI_INTERVAL]:
        raise AssertionError(f'logged {sorted(got)}, evaluated '
                             f'{sorted(got_val)}')
    worst, worst_rel = 0.0, 0.0
    for it, line in got.items():
        for k in ('loss', 'decode.loss_seg', 'loss_decode_head.linear_pred'
                  '<->decode_head.linear_pred_other'):
            a, b = train[it][k], line[k]
            worst_rel = max(worst_rel, abs(a - b) / abs(a))
            worst = max(worst, abs(a - b) / (RESUME_TOL_REL * abs(a)
                                             + RESUME_TOL_ABS))
    ckpt = work / 'checkpoints' / f'iter_{CLI_INTERVAL}.pth'
    payload = torch.load(ckpt, map_location='cpu', weights_only=True)
    prefixed = [k for part in ('state_dict', 'adapters')
                for k in payload[part] if k.startswith(('module.', 'model.'))]
    log(f'iterations 1-{CLI_INTERVAL} against the one-process run: at most '
        f'{worst_rel:.3e} of a loss term, {worst:.4f} of the limit '
        f'{RESUME_TOL_REL} * |loss| + {RESUME_TOL_ABS}; {ckpt.name}: '
        f"{len(payload['state_dict'])} student tensors, step "
        f"{payload['step']}")
    if not worst <= 1.0 or prefixed or payload['step'] != CLI_INTERVAL:
        raise AssertionError(f'the --multi-host run differs: {worst}, '
                             f'{prefixed[:3]}')
    t0 = time.perf_counter()
    res = _run_cli(['segdistill_tpu_torch.tools.test', str(CGD_CONFIG),
                    str(work), '--eval', 'mIoU', '--multi-host', '--options',
                    *options], 'tools.test --multi-host')
    metrics = ast.literal_eval(res.stdout.strip().splitlines()[-1])
    want = got_val[CLI_INTERVAL]
    diff = max(abs(metrics[k] - want[k]) for k in ('mIoU', 'mAcc', 'aAcc'))
    log(f'tools.test --multi-host ({time.perf_counter() - t0:.1f} s): mIoU '
        f'{metrics["mIoU"]:.9f}, the evaluation logged at {CLI_INTERVAL} '
        f'{want["mIoU"]:.9f} (mIoU, mAcc and aAcc differ by at most '
        f'{diff:.2e}, limit {MIOU_TOL})')
    if not diff <= MIOU_TOL:
        raise AssertionError('tools.test --multi-host does not reproduce '
                             'the evaluation of its checkpoint')


def dist_eval_rank(checkpoint, options, out_dir):
    """One rank of phase (c): ``fast_evaluate`` of the checkpoint over the
    command line's test set, sharded over the gloo group."""
    from segdistill_tpu_torch.apis import fast_evaluate, init_segmentor
    from segdistill_tpu_torch.datasets import build_dataset
    from segdistill_tpu_torch.parallel import process_group
    with process_group('gloo') as (rank, _):
        model = init_segmentor(str(CGD_CONFIG), checkpoint, device=DEVICE,
                               cfg_options=options)
        dataset = build_dataset(model.cfg.data['test'], dict(test_mode=True))
        metrics = fast_evaluate(model, dataset)
        with open(Path(out_dir) / f'eval{rank}.json', 'w') as f:
            json.dump(metrics, f)


def _one_process_eval(root):
    """``fast_evaluate`` of phase_cli's last checkpoint in this process:
    what (c) holds the sharded evaluation to."""
    from segdistill_tpu_torch.apis import fast_evaluate, init_segmentor
    from segdistill_tpu_torch.datasets import build_dataset
    ckpt = str(root / 'work' / 'checkpoints' / f'iter_{CLI_ITERS}.pth')
    model = init_segmentor(str(CGD_CONFIG), ckpt, device=DEVICE,
                           cfg_options=_cli_config_options(root / 'data'))
    want = fast_evaluate(model, build_dataset(model.cfg.data['test'],
                                              dict(test_mode=True)))
    del model
    torch.cuda.empty_cache()
    return want


def phase_dist_eval(root, want):
    """(c) The sharded ``fast_evaluate`` (two gloo ranks on the one card,
    each 4 of the 8 images, the histograms summed) of phase_cli's last
    checkpoint, against one process (``want``, :func:`_one_process_eval`):
    equal, the histograms being integers."""
    from segdistill_tpu_torch.parallel import launch
    log(f'== sharded evaluation: fast_evaluate at two gloo ranks on the '
        f'card against one process, {CLI_VAL_IMAGES} images')
    ckpt = str(root / 'work' / 'checkpoints' / f'iter_{CLI_ITERS}.pth')
    options = _cli_config_options(root / 'data')
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        launch(DIST_EVAL_RANK, DIST_WORLD, [ckpt, options, tmp],
               timeout=DIST_TIMEOUT)
        got = [json.loads((Path(tmp) / f'eval{r}.json').read_text())
               for r in range(DIST_WORLD)]
    log(f'two ranks: {got[0]} ({time.perf_counter() - t0:.1f} s with their '
        f'start); one process: {want}')
    if any(g != want for g in got):
        raise AssertionError('the sharded evaluation differs from one '
                             'process')


@contextlib.contextmanager
def _no_copy_check():
    """Wrap the runner's ``_to_device`` for the length of the block: ->
    a list of, for each batch, whether it came as CUDA tensors and went to
    the step with no copy (the same storage)."""
    from segdistill_tpu_torch.engine import runner
    original = runner.IterBasedRunner._to_device
    seen = []

    def checked(self, batch, device):
        img, gt = original(self, batch, device)
        src_img, src_gt = batch['img'], batch['gt_semantic_seg']
        seen.append(torch.is_tensor(src_img) and src_img.is_cuda
                    and img.data_ptr() == src_img.data_ptr()
                    and gt.data_ptr() == src_gt.data_ptr())
        return img, gt
    runner.IterBasedRunner._to_device = checked
    try:
        yield seen
    finally:
        runner.IterBasedRunner._to_device = original


def phase_cli_backends(path_kernels, root, host_train, per_step, card):
    """(104) ``tools.train`` on phase 14's dataset with
    ``data.loader_backend`` native and then device (the ADE20K recipe in
    ``data.aug_cfg``), ``CLI_ITERS`` iterations each, no evaluation: the
    median ``time`` and ``data_time`` of iterations 3 on beside the host
    loader's (``host_train``, phase 14's log), finite losses, every batch
    handed to the step as CUDA tensors with no copy, and each kernel's
    launches exactly ``per_step`` (the in-memory CGD step's) a step. ->
    the launch counts of both runs."""
    from segdistill_tpu_torch.tools import bench_loader
    from segdistill_tpu_torch.tools import train as train_cli
    log(f'== loader backends through the command line: tools.train on '
        f'{CGD_CONFIG.name} with data.loader_backend '
        f'{" and ".join(CLI_BACKENDS)}, {CLI_ITERS} iterations each, no '
        f'evaluation ({card})')
    options = _cli_options(root / 'data')
    host = [host_train[i] for i in range(3, CLI_ITERS + 1)
            if i != CLI_INTERVAL + 1]
    rows = {'host': tuple(float(np.median([ln[k] for ln in host])) * 1e3
                          for k in ('time', 'data_time'))}
    total = {k.name: 0 for k in path_kernels}
    for backend in CLI_BACKENDS:
        work = root / f'work_{backend}'
        for k in path_kernels:
            k.launches = 0
        t0 = time.perf_counter()
        with _no_copy_check() as seen:
            train_cli.main(
                [str(CGD_CONFIG), '--work-dir', str(work), '--seed', '0',
                 '--no-validate', '--options', *options,
                 f'data.loader_backend={backend}',
                 f'data.aug_cfg={bench_loader.aug_cfg(backend)!r}',
                 f'checkpoint_config.interval={CLI_ITERS}'])
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in path_kernels}
        train, _ = _json_log(work)
        if sorted(train) != list(range(1, CLI_ITERS + 1)) or not all(
                math.isfinite(ln['loss']) for ln in train.values()):
            raise AssertionError(f'{backend}: logged {train}')
        if len(seen) != CLI_ITERS or not all(seen):
            raise AssertionError(f'{backend}: batches not handed to the step '
                                 f'as CUDA tensors without a copy: {seen}')
        steady = [train[i] for i in range(3, CLI_ITERS + 1)]
        rows[backend] = tuple(
            float(np.median([ln[k] for ln in steady])) * 1e3
            for k in ('time', 'data_time'))
        want = {name: n * CLI_ITERS for name, n in per_step.items()}
        log(f'{backend}: {time.perf_counter() - t0:.1f} s in all; launches '
            f'{launches} ({CLI_ITERS} steps; the in-memory step\'s a step: '
            f'{per_step}); every batch a CUDA tensor handed over with no '
            f'copy; losses ' + ', '.join(f'{i}: {train[i]["loss"]:.5f}'
                                         for i in sorted(train)))
        if launches != want:
            raise AssertionError(f'{backend}: launches {launches}, expected '
                                 f'{want}')
        for name, n in launches.items():
            total[name] += n
    for backend, (step_ms, data_ms) in rows.items():
        log(f'loader {backend}: step time {step_ms:.2f} ms, data_time '
            f'{data_ms:.2f} ms (medians of iterations 3-{CLI_ITERS}), '
            f'{TRAIN_BATCH / step_ms * 1e3:.2f} images/s ({card})')
    return total


def phase_device_aug(root, card):
    """(105) ``DeviceAugPipeline.apply`` on the card against the same
    function on the CPU, on the same draws, for a batch of
    ``TRAIN_BATCH`` canvases of (512, 2048) made by ``PrepareCanvas`` from
    the command line's images: labels equal, images within
    ``DEVICE_AUG_TOL``; one call, its copy from pinned memory included
    (the device loader's one packed buffer a batch), under
    ``torch.cuda.set_sync_debug_mode('error')`` (no synchronising call
    that the mode detects); ms a batch (CUDA events) and the peak
    memory; the host ms to issue a call (no loader threads beside it)."""
    from segdistill_tpu_torch.data import DeviceAugPipeline, PrepareCanvas
    from segdistill_tpu_torch.datasets.builder import _layout, _views
    from segdistill_tpu_torch.tools import bench_loader
    from segdistill_tpu_torch.utils.image import imread
    cfg = bench_loader.aug_cfg('device')
    canvas = PrepareCanvas(img_scale=cfg.pop('img_scale'),
                           canvas=cfg.pop('canvas'))
    aug = DeviceAugPipeline(**cfg)
    log(f'== DeviceAugPipeline.apply on the card against the CPU: batch '
        f'{TRAIN_BATCH}, canvas {canvas.canvas}, crop {aug.crop_size} '
        f'({card})')
    samples = []
    for i in range(TRAIN_BATCH):
        ann = imread(str(root / 'data' / 'ann' / 'train' / f's{i:03d}.npy'),
                     'unchanged')
        ann = np.where(ann == 0, 255, ann - 1).astype(np.uint8)
        samples.append(canvas(dict(img=imread(str(
            root / 'data' / 'img' / 'train' / f's{i:03d}.npy')),
            gt_semantic_seg=ann)))
    host = [torch.from_numpy(np.stack([s[k] for s in samples]))
            for k in ('img', 'gt_semantic_seg', 'valid_hw')]
    draws = aug.draw(torch.Generator().manual_seed(0), TRAIN_BATCH)
    want_img, want_gt = aug.apply(draws, *host)
    keys = ('img', 'gt_semantic_seg', 'valid_hw')
    layout, nbytes = _layout([(k, t.dtype, t.shape)
                              for k, t in zip(keys, host)]
                             + [(k, v.dtype, v.shape)
                                for k, v in draws.items()])
    packed = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    for k, v in _views(packed, layout).items():
        v.copy_(draws[k] if k in draws else host[keys.index(k)])

    def on_card():
        parts = _views(packed.to(DEVICE, non_blocking=True), layout)
        return aug.apply(parts, *[parts[k] for k in keys])
    on_card()  # the mean and std reach the card once
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.set_sync_debug_mode('error')
    try:
        img, gt = on_card()
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    err = (img.cpu() - want_img).abs().max().item()
    same = torch.equal(gt.cpu(), want_gt)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    t0 = time.perf_counter()
    for _ in range(DEVICE_AUG_CALLS):
        on_card()
    host_ms = (time.perf_counter() - t0) * 1e3 / DEVICE_AUG_CALLS
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / DEVICE_AUG_CALLS
    log(f'labels equal to the CPU\'s: {same}; images max abs err {err:.3e} '
        f'(limit {DEVICE_AUG_TOL}); no synchronising call in a call that '
        f'set_sync_debug_mode detects; {ms:.3f} ms a batch with its copy '
        f'from pinned memory (CUDA '
        f'events over {DEVICE_AUG_CALLS} calls), {host_ms:.3f} ms on the host '
        f'clock to issue a call; peak {peak / 2**20:.1f} '
        f'MiB above the inputs ({card})')
    if not same or not err <= DEVICE_AUG_TOL:
        raise AssertionError('DeviceAugPipeline.apply on the card differs '
                             'from the CPU')


def phase_batched_eval(path_kernels, root, card):
    """(106) ``single_device_test(batch_size=EVAL_BATCH)`` against
    ``batch_size=1`` of the B0 student of phase 14's last checkpoint in
    fp32, on ``EVAL_IMAGES`` images of two shapes: label maps equal but at
    most ``EVAL_DIFF_SHARE`` of the pixels (argmax near-ties), images/s of
    each in two rounds after one untimed pass of each (the host pipeline
    included; the order batched, per image, per image, batched), and the
    kernels' launches over the timed batched runs. -> those launch
    counts."""
    from segdistill_tpu_torch.apis import init_segmentor, single_device_test
    from segdistill_tpu_torch.datasets import build_dataset
    from segdistill_tpu_torch.tools import bench_loader
    log(f'== batched evaluation: single_device_test of the B0 student, fp32, '
        f'batch_size {EVAL_BATCH} against 1, {EVAL_IMAGES} images of shapes '
        f'{EVAL_HW} ({card})')
    data = root / 'eval'
    bench_loader.write_dataset(data, EVAL_IMAGES, seed=12, shapes=EVAL_HW,
                               split='val')
    options = dict(_cli_config_options(data),
                   **{'model.cfg_s.backbone.dtype': 'float32'})
    model = init_segmentor(
        str(CGD_CONFIG),
        str(root / 'work' / 'checkpoints' / f'iter_{CLI_ITERS}.pth'),
        device=DEVICE, cfg_options=options)
    dataset = build_dataset(model.cfg.data['test'], dict(test_mode=True))
    launches = {k.name: 0 for k in path_kernels}
    rates = {EVAL_BATCH: [], 1: []}
    maps = {}
    for batch_size in (EVAL_BATCH, 1):  # warm-up at each batch shape
        single_device_test(model, dataset, batch_size=batch_size)
    for order in ((EVAL_BATCH, 1), (1, EVAL_BATCH)):
        for batch_size in order:
            for k in path_kernels:
                k.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            maps[batch_size] = single_device_test(model, dataset,
                                                  batch_size=batch_size)
            rates[batch_size].append(
                len(dataset) / (time.perf_counter() - t0))
            if batch_size == EVAL_BATCH:
                for k in path_kernels:
                    launches[k.name] += k.launches
    pixels = sum(m.size for m in maps[1])
    differ = sum(int((a != b).sum()) for a, b in zip(maps[EVAL_BATCH],
                                                     maps[1]))
    shapes = sorted({m.shape for m in maps[1]})
    log(f'label maps of shapes {shapes}: {differ} of {pixels} pixels differ '
        f'({differ / pixels:.2e}, limit {EVAL_DIFF_SHARE}); images/s '
        f'batched ' + ' / '.join(f'{r:.2f}' for r in rates[EVAL_BATCH])
        + ', per image ' + ' / '.join(f'{r:.2f}' for r in rates[1])
        + f' (two rounds after a warm-up pass, the host pipeline included; '
        f'{card}); launches '
        f'over the batched runs {launches}')
    _check_launched(launches, 'batched evaluation')
    if len(shapes) != 2 or not differ <= EVAL_DIFF_SHARE * pixels:
        raise AssertionError('batched evaluation differs from per-image')
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
    ``prepare_training``'s step, 2 + 5 steps: -> the launch counts of
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


def phase_serving_slide(config, tag, requests, classes=2,
                        warm_hw=DRIVE_REQUEST_HW):
    """A recipe served through ``init_segmentor`` and
    ``inference_segmentor`` in slide mode, fp32: a ``warm_hw`` warmup
    request, then one request of each size in ``requests``; the windows
    each ran (calls of the model's ``encode_decode``) must be the slide
    grid of the image the pipeline gave the model, the prediction the
    request's size with labels below ``classes``."""
    from segdistill_tpu_torch.apis import init_segmentor, inference_segmentor
    model = init_segmentor(config, device=DEVICE, seed=0)
    crop, stride = model.test_cfg['crop_size'], model.test_cfg['stride']
    log(f'== serving: {tag} (recipes.py) through init_segmentor, {classes} '
        f'classes, random weights (seed 0), requests of '
        f'{", ".join(f"{h}x{w}" for h, w in requests)}, slide mode ({crop} '
        f'windows at stride {stride})')
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
    warm = rng.randint(0, 256, tuple(warm_hw) + (3,)).astype(np.uint8)
    with torch.no_grad():
        inference_segmentor(model, warm)
    for request_hw in requests:
        img = rng.randint(0, 256, tuple(request_hw) + (3,)).astype(np.uint8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = inference_segmentor(model, img)[0]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        (h, w), windows = seen[-1]
        grid = ((max(h - crop[0] + stride[0] - 1, 0) // stride[0] + 1)
                * (max(w - crop[1] + stride[1] - 1, 0) // stride[1] + 1))
        log(f'{tag}: {ms:.2f} ms for a {request_hw[0]}x{request_hw[1]} '
            f'request, served at {h}x{w}: {windows} windows (the slide '
            f'grid: {grid})')
        if windows != grid or pred.shape != img.shape[:2] \
                or pred.min() < 0 or pred.max() >= classes:
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


def _voc_palette():
    """Pascal VOC's palette: its 21 class colours, 255 (the outlines) in
    (224, 224, 192)."""
    from segdistill_tpu_torch.core.evaluation import get_palette
    palette = np.zeros((256, 3), np.uint8)
    palette[:VOC_CLASSES] = get_palette('voc')
    palette[255] = (224, 224, 192)
    return palette


def _write_voc(root):
    """A seeded VOC 2012 + SBD tree under ``root``: images as PNG bytes
    under VOC's ``.jpg`` names, ``SegmentationClass`` palette PNGs (VOC's
    palette, 255 outlines) of the train and val names, SBD ``.mat`` files
    (``GTcls.Segmentation``) of the train names and SBD_ONLY more, the
    train / val split files. -> (devkit, sbd root, {name: VOC labels},
    {name: SBD labels}, train names, val names)."""
    from scipy.io import savemat
    from segdistill_tpu_torch.utils import image as imutil
    rng = np.random.RandomState(12)
    devkit, sbd = root / 'VOCdevkit', root / 'benchmark_RELEASE'
    voc = devkit / 'VOC2012'
    for d in ('JPEGImages', 'SegmentationClass', 'ImageSets/Segmentation'):
        (voc / d).mkdir(parents=True)
    (sbd / 'dataset' / 'cls').mkdir(parents=True)
    names = [f'2008_{i:06d}' for i in range(VOC_TRAIN + VOC_VAL + SBD_ONLY)]
    train, val = names[:VOC_TRAIN], names[VOC_TRAIN:VOC_TRAIN + VOC_VAL]
    sbd_names = train + names[VOC_TRAIN + VOC_VAL:]
    palette = _voc_palette()
    voc_labels, sbd_labels = {}, {}
    for i, name in enumerate(names):
        h, w = VOC_IMAGE_HW[i % len(VOC_IMAGE_HW)]
        blocks = rng.randint(0, VOC_CLASSES, (-(-h // 48), -(-w // 48)))
        idx = np.kron(blocks, np.ones((48, 48), np.int64))[:h, :w]
        img = (rng.randint(0, 256, (h, w, 3)) + idx[..., None] * [3, 5, 7]) \
            % 256
        imutil.imwrite(img.astype(np.uint8), str(voc / 'JPEGImages' /
                                                 f'{name}.png'))
        (voc / 'JPEGImages' / f'{name}.png').rename(
            voc / 'JPEGImages' / f'{name}.jpg')
        if name in train or name in val:
            outlined = idx.astype(np.uint8)
            outlined[np.diff(idx, axis=1, prepend=idx[:, :1]) != 0] = 255
            imutil.imwrite(outlined, str(voc / 'SegmentationClass' /
                                         f'{name}.png'), palette=palette)
            voc_labels[name] = outlined
        if name in sbd_names:
            labels = np.roll(idx, 7, axis=0).astype(np.uint8)
            savemat(str(sbd / 'dataset' / 'cls' / f'{name}.mat'),
                    {'GTcls': {'Segmentation': labels}})
            sbd_labels[name] = labels
    sets = voc / 'ImageSets' / 'Segmentation'
    (sets / 'train.txt').write_text('\n'.join(train) + '\n')
    (sets / 'val.txt').write_text('\n'.join(val) + '\n')
    (sbd / 'dataset' / 'train.txt').write_text('\n'.join(sbd_names) + '\n')
    return devkit, sbd, voc_labels, sbd_labels, train, val


def _pascal_data_cfg(cfg, split, data_root):
    return dict(cfg.data[split], data_root=str(data_root))


def phase_voc_convert(root):
    """(107) The VOC-aug converter as a command on a seeded VOC 2012 + SBD
    tree (PNG written and read by the port's codec, no OpenCV or pillow
    needed); then ``PascalVOCDataset`` reads the palette label maps as the
    indices written and the converted SBD maps as the ``.mat`` labels, the
    ``aug.txt`` split is the SBD and VOC train names less val, and the
    recipe's train set is the ConcatDataset of the two. -> (devkit, val
    names)."""
    import importlib.util
    from segdistill_tpu_torch.datasets import ConcatDataset, build_dataset
    from segdistill_tpu_torch.recipes import recipe
    log(f'== Pascal VOC 2012 + SBD: the voc_aug converter and the datasets '
        f'({VOC_TRAIN} train + {VOC_VAL} val VOC images, {SBD_ONLY} more '
        f'SBD-only; images PNG under .jpg names, palette label maps)')
    missing = {m: importlib.util.find_spec(m) is None for m in ('cv2', 'PIL')}
    log(f'on this machine: import cv2 {"fails" if missing["cv2"] else "works"}'
        f', import PIL {"fails" if missing["PIL"] else "works"}')
    t0 = time.perf_counter()
    devkit, sbd, voc_labels, sbd_labels, train, val = _write_voc(root)
    log(f'tree written in {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, '-m',
         'segdistill_tpu_torch.tools.convert_datasets.voc_aug', str(devkit),
         str(sbd)], cwd=ROOT, capture_output=True, text=True, timeout=300)
    log(f'voc_aug converter: rc {res.returncode} in '
        f'{time.perf_counter() - t0:.1f} s: {res.stdout.strip()!r}')
    if res.returncode != 0:
        raise AssertionError(f'the voc_aug converter failed: {res.stderr}')
    voc = devkit / 'VOC2012'
    aug = (voc / 'ImageSets/Segmentation/aug.txt').read_text().split()
    want = sorted(set(sbd_labels) | set(train))
    if aug != want:
        raise AssertionError(f'aug.txt lists {aug}, not {want}')
    cfg = recipe('pspnet_r50-d8_voc12aug')
    both = build_dataset(_pascal_data_cfg(cfg, 'train', voc))
    if not isinstance(both, ConcatDataset) or [
            len(d) for d in both.datasets] != [len(train), len(aug)]:
        raise AssertionError(f'the VOC12-aug train set is {both!r}')
    voc_part, aug_part = both.datasets
    for part, names, labels in ((voc_part, train, voc_labels),
                                (aug_part, aug, sbd_labels)):
        maps = list(part.get_gt_seg_maps())
        if len(maps) != len(names) or not all(
                np.array_equal(m, labels[n]) for m, n in zip(maps, names)):
            raise AssertionError(f'{part.ann_dir}: the label maps read are '
                                 f'not the ones written')
    val_set = build_dataset(_pascal_data_cfg(cfg, 'val', voc),
                            dict(test_mode=True))
    if not all(np.array_equal(m, voc_labels[n]) for m, n in
               zip(val_set.get_gt_seg_maps(), val)):
        raise AssertionError('the val palette maps read are not the '
                             'indices written')
    sample = voc_part.__getitem__(0, np.random.RandomState(0))
    shapes = [tuple(sample[k].shape) for k in ('img', 'gt_semantic_seg')]
    log(f'read back equal: {len(train)} + {len(val)} palette label maps (as '
        f'indices), {len(aug)} converted SBD maps; the train set a '
        f'ConcatDataset of {len(train)} + {len(aug)}; a training sample '
        f'{shapes}')
    return devkit, val


def _voc_options(devkit):
    """``--options`` of the VOC12-aug command line: the tree, a bf16
    backbone, VOC_ITERS iterations with a checkpoint and an evaluation at
    the end, a log line an iteration."""
    voc = devkit / 'VOC2012'
    return [f'data.{split}.data_root={voc}' for split in
            ('train', 'val', 'test')] + [
        'model.backbone.dtype=bfloat16', f'runner.max_iters={VOC_ITERS}',
        f'checkpoint_config.interval={VOC_ITERS}',
        f'evaluation.interval={VOC_ITERS}', 'log_config.interval=1',
        'data.workers_per_gpu=4']


def phase_voc_cli(path_kernels, root, devkit, val):
    """(108) ``tools.train`` on the ``pspnet_r50-d8_voc12aug`` recipe
    (written out as a config file) over the converted tree: the recipe's
    pipeline (Resize, RandomCrop with cat_max_ratio, flip,
    PhotoMetricDistortion, Pad) at 512x512, batch 4, 21 classes, VOC_ITERS
    iterations with a checkpoint and an evaluation; then ``tools.test
    --eval mIoU --show-dir`` on the work dir: the last evaluation's mIoU
    again and one painted PNG an image at its size. -> the launch counts
    of the training run."""
    from segdistill_tpu_torch.engine import load_meta
    from segdistill_tpu_torch.ops import seg_ce
    from segdistill_tpu_torch.recipes import recipe
    from segdistill_tpu_torch.tools import test as test_cli
    from segdistill_tpu_torch.tools import train as train_cli
    from segdistill_tpu_torch.utils import image as imutil
    config = root / 'pspnet_r50-d8_512x512_20k_voc12aug.py'
    recipe('pspnet_r50-d8_voc12aug').dump(str(config))
    options = _voc_options(devkit)
    work, show = root / 'voc_work', root / 'voc_painted'
    log(f'== command line: tools.train on pspnet_r50-d8_voc12aug (recipes.py'
        f', PSPNet-R50-d8, 21 classes, bf16 backbone, batch {PASCAL_BATCH} '
        f'of 512x512 crops through the recipe\'s pipeline) for {VOC_ITERS} '
        f'iterations, a checkpoint and an evaluation at {VOC_ITERS}; then '
        f'tools.test --eval mIoU --show-dir')
    for k in path_kernels:
        k.launches = 0
    for by_shape in seg_ce.LAUNCHES_BY_SHAPE.values():
        by_shape.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train_cli.main([str(config), '--work-dir', str(work), '--seed',
                            '0', '--options', *options])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k.name: k.launches for k in path_kernels}
    CE_SHAPE_LAUNCHES['VOC12-aug command line'] = {
        name: dict(by_shape)
        for name, by_shape in seg_ce.LAUNCHES_BY_SHAPE.items()}
    peak = torch.cuda.max_memory_allocated()
    train, val_log = _json_log(work)
    if state.step != VOC_ITERS or sorted(train) != list(
            range(1, VOC_ITERS + 1)) or sorted(val_log) != [VOC_ITERS]:
        raise AssertionError(f'trained to {state.step}, logged '
                             f'{sorted(train)}, evaluated at '
                             f'{sorted(val_log)}')
    if not all(math.isfinite(ln['loss']) for ln in train.values()):
        raise AssertionError(f'a VOC12-aug loss is not finite: {train}')
    meta = load_meta(str(work))
    if meta['iter'] != VOC_ITERS or len(meta['CLASSES']) != VOC_CLASSES:
        raise AssertionError(f'checkpoint meta {meta}')
    steady = [train[i] for i in range(3, VOC_ITERS + 1)]
    step_ms = float(np.median([ln['time'] for ln in steady])) * 1e3
    data_ms = float(np.median([ln['data_time'] for ln in steady])) * 1e3
    log(f'tools.train: {seconds:.1f} s in all; step time {step_ms:.2f} ms '
        f'(median of iterations 3-{VOC_ITERS}), of it data_time '
        f'{data_ms:.2f} ms; {PASCAL_BATCH / step_ms * 1e3:.2f} images/s; '
        f'peak memory allocated {peak / 2**30:.2f} GiB; evaluation of '
        f'{len(val)} images {val_log[VOC_ITERS]["seconds"]:.2f} s, mIoU '
        f'{val_log[VOC_ITERS]["mIoU"]:.6f}')
    log('losses: ' + ', '.join(f'{i}: {train[i]["loss"]:.5f}'
                               for i in sorted(train)))
    log(f'launches during the VOC12-aug command line: {launches} (by '
        f'geometry: {CE_SHAPE_LAUNCHES["VOC12-aug command line"]})')
    geometry = tuple(next(c for c in _cases().SEG_CE_CASES
                          if c[0] == VOC_CE_GEOMETRY)[1]) + VOC_HW
    for name, n in launches.items():
        at = CE_SHAPE_LAUNCHES['VOC12-aug command line'][name].get(
            geometry, 0)
        if n != 2 * VOC_ITERS or at != n:
            raise AssertionError(f'{name}: {n} launches ({at} at '
                                 f'{geometry}) in {VOC_ITERS} iterations, '
                                 f'not 2 an iteration (decode + aux)')
    t0 = time.perf_counter()
    metrics = test_cli.main([str(config), str(work), '--eval', 'mIoU',
                             '--show-dir', str(show), '--options',
                             *options])
    diff = max(abs(metrics[k] - val_log[VOC_ITERS][k])
               for k in ('mIoU', 'mAcc', 'aAcc'))
    painted = sorted(p.name for p in show.iterdir())
    log(f'tools.test --show-dir: {time.perf_counter() - t0:.1f} s, mIoU '
        f'{metrics["mIoU"]:.9f} (the last evaluation logged '
        f'{val_log[VOC_ITERS]["mIoU"]:.9f}; mIoU, mAcc and aAcc differ by at '
        f'most {diff:.2e}, limit {MIOU_TOL}); painted: {painted}')
    if not diff <= MIOU_TOL:
        raise AssertionError('tools.test does not reproduce the last '
                             'evaluation')
    if painted != sorted(f'{n}.png' for n in val):
        raise AssertionError(f'--show-dir wrote {painted}')
    voc = devkit / 'VOC2012'
    for name in val:
        img = imutil.imread(str(voc / 'JPEGImages' / f'{name}.jpg'))
        out = imutil.imread(str(show / f'{name}.png'))
        if out.shape != img.shape:
            raise AssertionError(f'{name}: painted {out.shape}, the image '
                                 f'{img.shape}')
    return launches


def _check_results2img(root):
    """A Cityscapes-style submission: train-id results of 1024x2048 written
    by ``CityscapesDataset.results2img`` (the port's PNG encoder) read back
    as their label ids."""
    from segdistill_tpu_torch.datasets import CityscapesDataset
    from segdistill_tpu_torch.utils import image as imutil
    rng = np.random.RandomState(13)
    city = root / 'cityscapes'
    for d in ('img/frankfurt', 'ann/frankfurt'):
        (city / d).mkdir(parents=True)
    for i in range(2):
        stem = f'frankfurt_{i:06d}_000019'
        imutil.imwrite(rng.randint(0, 256, (64, 128, 3)).astype(np.uint8),
                       str(city / 'img' / 'frankfurt' /
                           f'{stem}_leftImg8bit.png'))
        imutil.imwrite(rng.randint(0, 19, (64, 128)).astype(np.uint8),
                       str(city / 'ann' / 'frankfurt' /
                           f'{stem}_gtFine_labelTrainIds.png'))
    data = CityscapesDataset(pipeline=[], data_root=str(city), img_dir='img',
                             ann_dir='ann')
    results = [rng.randint(0, 19, (1024, 2048)) for _ in range(2)]
    t0 = time.perf_counter()
    files, tmp_dir = data.format_results(results)
    seconds = time.perf_counter() - t0
    for path, result in zip(files, results):
        got = imutil.imread(path, 'unchanged')
        if not np.array_equal(got, data._convert_to_label_id(result)):
            raise AssertionError(f'{path} does not read back as written')
    names = [Path(f).name for f in files]
    log(f'results2img: {len(files)} 1024x2048 submission PNGs written in '
        f'{seconds:.2f} s and read back equal ({names})')
    tmp_dir.cleanup()


def phase_pascal_kernel_times():
    """K5/K6 at the two Pascal geometries in fp32, device time, beside the
    plain versions and the bounds (bf16: phase 6's path times). ->
    {case: (K5 ms, plain ms, K6 ms, plain ms)}."""
    from segdistill_tpu_torch.ops import seg_ce as sc
    gen = torch.Generator(device=DEVICE).manual_seed(14)
    times = {}
    for case in (VOC_CE_GEOMETRY, CONTEXT_CE_GEOMETRY):
        _, shape, out_hw, _, _ = next(c for c in _cases().SEG_CE_CASES
                                      if c[0] == case)
        k5, p5, k6, p6 = times[case] = _ce_device_times(
            sc, case, torch.float32, gen)
        (b5, _), (b6, _) = _cases().seg_ce_bounds(shape, out_hw,
                                                  torch.float32)
        log(f'{case} {shape} -> {out_hw} fp32, device time: K5 {k5:.4f} ms '
            f'(plain {p5:.4f}, bound {b5:.4f}, {k5 / b5:.2f}x); K6 '
            f'{k6:.4f} ms (plain {p6:.4f}, bound {b6:.4f}, {k6 / b6:.2f}x)')
    return times


# ---- this slice: the serving export, the tool twins, the convergence run

# the export phase: full-width Segformer-B0 (CONFIG) exported at EXPORT_HW
# while the kernels build (tracing launches nothing); the saved programs
# loaded and run on EXPORT_REQUESTS seeded requests by a fresh process (it
# times nothing: it runs beside the fp32 steps against the CPU); at the end
# of the script the same requests through eager encode_decode here, held
# to the programs' outputs; then each labels program, loaded here too,
# against eager in EXPORT_ROUNDS rounds of A B B A, each side's ms a
# request the median of EXPORT_TIMED host-clocked requests after
# EXPORT_WARMUP
EXPORT_HW = (512, 512)
EXPORT_REQUESTS = 4
EXPORT_WARMUP, EXPORT_TIMED, EXPORT_ROUNDS = 3, 10, 3
EXPORT_FUSED = {'model.backbone.fused_attention': True}
# (tag, config options, --logits): the labels program as the config
# stands and with fused_attention=True, and the logits program
EXPORT_PROGRAMS = [('plain', {}, False), ('plain', {}, True),
                   ('fused_attention', EXPORT_FUSED, False)]
# the loader process's time limit
EXPORT_TIMEOUT = 300
# bench.py:157 takes B0 as 8.4e9 FLOPs an image at 512x512; get_flops'
# count is a finding to explain where it lies further from it than this
BENCH_B0_FLOPS, FLOPS_FINDING_SHARE = 8.4e9, 0.10
BENCHMARK_ITERS = 50
DEMO_HW = (512, 683)
# profile_train at a small size: its trace is what the phase checks
PROFILE_ARGS = ['--steps', '2', '--batch', '2', '--hw', '256', '256']

# The loader of the saved programs, run in a fresh interpreter: it imports
# torch and the port's kernels (which register the operators) and nothing
# else of the repository, loads each program and runs the requests through
# it, counting each kernel's launches a request.
EXPORT_LOADER = """
import json
import sys
import time
import numpy as np
import torch
import segdistill_tpu_torch.ops
from segdistill_tpu_torch.ops import layer_norm, resize_sum, sra_attn
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
kernels = (resize_sum.KERNEL, layer_norm.FWD_KERNEL, sra_attn.KERNEL)
requests, paths = sys.argv[1], sys.argv[2:]
imgs = torch.from_numpy(np.load(requests)).cuda()
report = {}
for path in paths:
    t0 = time.perf_counter()
    program = torch.export.load(path).module()
    report[path] = dict(load_s=time.perf_counter() - t0)
    outs, launches = [], []
    with torch.no_grad():
        for i in range(len(imgs)):
            before = [k.launches for k in kernels]
            outs.append(program(imgs[i:i + 1]))
            launches.append({k.name: k.launches - b
                             for k, b in zip(kernels, before)})
    np.save(path + '.out.npy', torch.cat(outs).cpu().numpy())
    report[path].update(launches=launches)
port = sorted(m for m in sys.modules if m.startswith('segdistill_tpu'))
others = [m for m in port if m != 'segdistill_tpu_torch'
          and not m.startswith('segdistill_tpu_torch.ops')]
foreign = [m for m in sys.modules
           if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'segdistill_tpu')]
assert not others and not foreign, (others, foreign)
print(json.dumps(report))
"""


def _host_ms(fn, imgs, warmup=EXPORT_WARMUP, timed=EXPORT_TIMED):
    """Median host-clocked ms of ``fn`` on one request, each ending in
    ``torch.cuda.synchronize()``, after ``warmup`` requests."""
    ms = []
    for i in range(warmup + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(imgs[i % len(imgs):i % len(imgs) + 1])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms[warmup:]))


def _graph_ops(program):
    """{operator: calls} of the ``segdistill::`` operators in a program's
    graph."""
    code = program.graph_module.code
    return {op: code.count(f'torch.ops.segdistill.{op}.')
            for op in ('resize_sum', 'layer_norm', 'sra_attention')}


def run_export_loader(root, programs):
    """Load and run the saved ``programs`` in a fresh process that imports
    torch and the port's ``ops`` alone (:data:`EXPORT_LOADER`); each
    program's outputs are saved beside it. -> the process's report
    ({path: load seconds, launches a request})."""
    log(f'== export, loader: the {len(programs)} saved programs loaded and '
        f'run on {EXPORT_REQUESTS} seeded requests in a fresh process that '
        f'imports torch and segdistill_tpu_torch.ops alone')
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, '-c', EXPORT_LOADER, str(root / 'requests.npy'),
         *programs], cwd=ROOT, capture_output=True, text=True,
        timeout=EXPORT_TIMEOUT, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    if res.returncode != 0:
        raise AssertionError(f'the program loader failed:\n{res.stdout}\n'
                             f'{res.stderr[-6000:]}')
    log(f'the loader process ran in {time.perf_counter() - t0:.1f} s with '
        f'its start')
    return json.loads(res.stdout.strip().splitlines()[-1])


def export_programs(root):
    """Export full-width Segformer-B0 through ``tools.export``
    (EXPORT_PROGRAMS) on the card into ``root``, beside the seeded
    requests; nothing is launched (the kernels may still be building). ->
    {path: (tag, options, --logits)}."""
    from segdistill_tpu_torch.tools import export as export_cli
    log(f'== export: Segformer-B0 (150 classes, random weights from seed 0, '
        f'fp32) through tools.export at {EXPORT_HW[0]}x{EXPORT_HW[1]}: '
        f'labels and --logits as it stands, labels with '
        f'fused_attention=True (while the kernels build)')
    np.save(root / 'requests.npy', np.random.RandomState(4).randn(
        EXPORT_REQUESTS, 3, *EXPORT_HW).astype(np.float32))
    programs = {}
    for tag, options, logits in EXPORT_PROGRAMS:
        path = root / f'b0_{tag}_{"logits" if logits else "labels"}.pt2'
        argv = [str(CONFIG), '--output', str(path), '--shape',
                *map(str, EXPORT_HW), '--graph', str(path) + '.txt']
        argv += ['--logits'] if logits else []
        argv += ['--options', *(f'{k}={v}' for k, v in options.items())] \
            if options else []
        t0 = time.perf_counter()
        ops = _graph_ops(export_cli.main(argv))
        want = {'resize_sum': 1, 'layer_norm': MIT_LN['b0'],
                'sra_attention': 8 if options else 0}
        log(f'{path.name}: exported in {time.perf_counter() - t0:.2f} s, '
            f'{path.stat().st_size / 1e6:.1f} MB; segdistill:: nodes {ops}')
        if ops != want:
            raise AssertionError(f'{path.name}: the graph holds {ops}, not '
                                 f'{want}')
        programs[str(path)] = (tag, options, logits)
    return programs


def phase_export(root, programs, report, path_kernels):
    """The export's requests: eager ``encode_decode`` of each exported
    configuration here, against which the programs' outputs in the loader
    process (``report``, :func:`run_export_loader`) are held (labels equal
    but at near-ties, logits within MODEL_TOL_REL of max |logit|, each
    kernel's launches equal request for request); then each labels
    program, loaded here too, timed against eager in turns. -> the launch
    counts of the eager requests and of the programs' (the export's main
    paths)."""
    from segdistill_tpu_torch.apis import init_segmentor
    from segdistill_tpu_torch.tools.export import Serving
    log(f'== export, requests: {EXPORT_REQUESTS} seeded requests through '
        f'eager encode_decode here, against each loaded program\'s')
    imgs = torch.from_numpy(np.load(root / 'requests.npy')).to(DEVICE)
    eager = {}
    for tag, options, _ in EXPORT_PROGRAMS:
        if tag in eager:
            continue
        model = init_segmentor(str(CONFIG), device=DEVICE, seed=0,
                               cfg_options=options or None)
        # eager: every launch count starts at 0 here, request by request
        outs, launches = [], []
        with torch.no_grad():
            model.encode_decode(imgs[:1])  # cuDNN heuristics, allocator
            for k in path_kernels:
                k.launches = 0
            for i in range(EXPORT_REQUESTS):
                before = [k.launches for k in path_kernels]
                outs.append(model.encode_decode(imgs[i:i + 1]))
                launches.append({k.name: k.launches - b
                                 for k, b in zip(path_kernels, before)})
            torch.cuda.synchronize()
        total = {k.name: k.launches for k in path_kernels}
        eager[tag] = (torch.cat(outs).cpu(), launches, model, total)
        log(f'eager {tag}: launches a request {launches[0]}')
    paths = [v[3] for v in eager.values()]
    for path, (tag, _, logits) in programs.items():
        want, want_launches, _, _ = eager[tag]
        got = torch.from_numpy(np.load(path + '.out.npy'))
        r = report[path]
        scale = want.abs().max().item()
        top2 = want.topk(2, dim=1).values
        near = (top2[:, 0] - top2[:, 1]) <= MODEL_TOL_REL * scale
        if logits:
            err = (got - want).abs().max().item()
            what = (f'logits max abs err {err:.3e}, max |logit| '
                    f'{scale:.3e} (limit {MODEL_TOL_REL} of it)')
            ok = err <= MODEL_TOL_REL * scale
        else:
            differ = got.long() != want.argmax(dim=1)
            what = (f'labels: {int(differ.sum())} of {differ.numel()} '
                    f'differ, {int((differ & ~near).sum())} of them not a '
                    f'near-tie (top two within {MODEL_TOL_REL} of max '
                    f'|logit|)')
            ok = got.dtype == torch.int32 and not bool((differ & ~near).any())
        same = r['launches'] == want_launches
        log(f'{Path(path).name}: loaded in {r["load_s"]:.2f} s; {what}; '
            f'launches a request {r["launches"][0]} (eager '
            f'{want_launches[0]}, equal request for request: {same})')
        if not ok or not same:
            raise AssertionError(f'{Path(path).name}: the loaded program '
                                 f'differs from eager encode_decode')
        paths.append({name: sum(req[name] for req in r['launches'])
                      for name in r['launches'][0]})
    for tag, part in (('eager', paths[:len(eager)]),
                      ('the loaded programs', paths[len(eager):])):
        _check_launched({k.name: sum(p.get(k.name, 0) for p in part)
                         for k in path_kernels}, f'export, {tag}')
    # ms a request, the program against eager in one process, in turns
    with torch.no_grad():
        for path, (tag, _, logits) in programs.items():
            if logits:
                continue
            arms = {'eager': Serving(eager[tag][2]),
                    'program': torch.export.load(path).module()}
            ms = {arm: [] for arm in arms}
            for _ in range(EXPORT_ROUNDS):
                for arm in ('eager', 'program', 'program', 'eager'):
                    ms[arm].append(_host_ms(arms[arm], imgs))
            eager_ms, program_ms = (float(np.median(ms[a])) for a in arms)
            log(f'{Path(path).name}: {program_ms:.3f} ms a request against '
                f'eager {eager_ms:.3f} ({program_ms / eager_ms:.3f}x; '
                f'medians of {EXPORT_ROUNDS} rounds of A B B A, each the '
                f'median of {EXPORT_TIMED} host-clocked requests after '
                f'{EXPORT_WARMUP}: eager ' + ' '.join(
                    f'{t:.3f}' for t in ms['eager']) + ', program '
                + ' '.join(f'{t:.3f}' for t in ms['program']) + ')')
    return paths


def phase_tools(root, card):
    """The tool twins on the card: ``get_flops`` and ``benchmark`` on
    Segformer-B0 at 512x512, ``image_demo`` on a seeded image (its labels
    against ``inference_segmentor``'s), ``convert_checkpoint`` and
    ``publish_model`` on a reference-layout file of the B0 weights (read
    back bitwise), ``profile_train --trace-dir`` (its Chrome trace holds
    the card's kernels)."""
    from segdistill_tpu_torch.apis import inference_segmentor, init_segmentor
    from segdistill_tpu_torch.tools import (benchmark, convert_checkpoint,
                                            get_flops, image_demo,
                                            profile_train, publish_model)
    from segdistill_tpu_torch.utils import image as imutil
    log(f'== tools: get_flops, benchmark ({BENCHMARK_ITERS} requests at '
        f'512x512, whole mode), image_demo, convert_checkpoint, '
        f'publish_model and profile_train --trace-dir on Segformer-B0 '
        f'({card})')
    t0 = time.perf_counter()
    params, flops, _ = get_flops.main([str(CONFIG), '--shape', '512'])
    off = flops / BENCH_B0_FLOPS - 1
    log(f'get_flops: {params} parameters, {flops} FLOPs ({flops / 2e9:.3f} '
        f'G multiply-adds), {off:+.2%} from bench.py\'s 8.4e9 '
        f'({time.perf_counter() - t0:.1f} s)'
        + (' -- a FINDING: more than 10% apart' if abs(off) >
           FLOPS_FINDING_SHARE else ''))
    if not (params > 3e6 and flops > 1e9):
        raise AssertionError('get_flops counted nothing')
    t0 = time.perf_counter()
    fps = benchmark.main([str(CONFIG), '--iters', str(BENCHMARK_ITERS),
                          '--log-interval', '25'])
    log(f'benchmark: {fps:.2f} images/s ({time.perf_counter() - t0:.1f} '
        f's with the model\'s build)')
    if not (math.isfinite(fps) and fps > 0):
        raise AssertionError(f'benchmark: {fps} images/s')

    img = np.random.RandomState(5).randint(0, 256, DEMO_HW + (3,)) \
        .astype(np.uint8)
    imutil.imwrite(img, str(root / 'demo.png'))
    labels = image_demo.main([str(root / 'demo.png'), str(CONFIG),
                              '--out-file', str(root / 'demo_out.png')])
    model = init_segmentor(str(CONFIG), device=DEVICE, seed=0)
    want = inference_segmentor(model, img)[0]
    painted = imutil.imread(str(root / 'demo_out.png'))
    log(f'image_demo: {DEMO_HW} -> labels {labels.shape}, painted '
        f'{painted.shape}; labels equal inference_segmentor\'s: '
        f'{np.array_equal(labels, want)}')
    if not np.array_equal(labels, want) or painted.shape != img.shape:
        raise AssertionError('image_demo differs from inference_segmentor')

    state = {f'module.{k}': v.cpu() for k, v in model.state_dict().items()}
    state['module.decode_head.conv_seg.weight'] = torch.zeros(
        NUM_CLASSES, 256, 1, 1)
    torch.save({'state_dict': state}, root / 'reference.pth')
    matched, missing, unexpected = convert_checkpoint.main(
        [str(CONFIG), str(root / 'reference.pth'), str(root / 'b0.pth')])
    final = publish_model.main([str(root / 'b0.pth'),
                                str(root / 'release.pth')])
    digest = hashlib.sha256((root / 'b0.pth').read_bytes()).hexdigest()
    loaded = init_segmentor(str(CONFIG), final, device=DEVICE, seed=1)
    same = all(torch.equal(v, loaded.state_dict()[k])
               for k, v in model.state_dict().items())
    log(f'convert_checkpoint: {len(matched)} matched, {len(missing)} '
        f'missing, {len(unexpected)} unexpected; publish_model -> '
        f'{Path(final).name}; read back bitwise: {same}')
    if missing or unexpected or not same \
            or not final.endswith(f'release-{digest[:8]}.pth'):
        raise AssertionError('convert_checkpoint / publish_model')
    del model, loaded

    t0 = time.perf_counter()
    profile_train.main(PROFILE_ARGS + ['--trace-dir', str(root / 'trace')])
    trace = json.loads((root / 'trace' / 'train_step.json').read_text())
    kernels = [e for e in trace['traceEvents'] if e.get('cat') == 'kernel']
    own = sum(1 for e in kernels if 'segdistill' in e.get('name', ''))
    log(f'profile_train --trace-dir: train_step.json, '
        f'{len(trace["traceEvents"])} events, {len(kernels)} kernels, '
        f'{own} of them hand-written ({time.perf_counter() - t0:.1f} s)')
    if not kernels or not own:
        raise AssertionError('the trace holds no kernel of the card')


# sessions of torch.profiler before a measurement takes the profiler as
# having seen nothing: CUPTI has returned a trace with no device event at
# all on the H100 (once, in a run whose other traces were whole)
PROFILE_SESSIONS = 3


def _device_events(fn, calls=1, prepare=None):
    """-> the CUDA events (kernels, copies, fills) of ``calls`` calls of
    ``fn`` under torch.profiler; a session whose trace holds no device
    event at all is logged and made again, up to PROFILE_SESSIONS, each
    after ``prepare()`` where given; [] where none saw one."""
    from torch.profiler import ProfilerActivity, profile
    for session in range(PROFILE_SESSIONS):
        if prepare is not None:
            prepare()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation]
        if events:
            return events
        log(f'torch.profiler saw no kernel on the card (session '
            f'{session + 1} of {PROFILE_SESSIONS})')
    return []


def _profiled_ms(fn, calls=20):
    """Device milliseconds of one call of ``fn``: the durations of the
    kernels it launches (torch.profiler, CUPTI), summed over ``calls``
    calls after one untimed, divided by the calls: no host time and no gap
    between kernels (at these sizes a launch's host time is many times a
    kernel's, and the queued-stream timing scatters). Where the profiler
    sees no kernel in any session, CUDA events around the calls queued
    behind a held stream (``utils.timing.device_ms``, gaps included), and
    the log says so."""
    from segdistill_tpu_torch.utils.timing import device_ms
    fn()
    torch.cuda.synchronize()
    events = _device_events(fn, calls)
    if events:
        return sum(e.device_time for e in events) / calls / 1e3
    ms = device_ms(fn, calls=calls)
    log(f'timed with CUDA events on a held stream instead: {ms:.4f} ms')
    return ms


def phase_convergence(path_kernels):
    """The miniature convergence run of ``tools/convergence.py`` on the
    card, in this process (the launches are counted around each run):
    the baseline and the +CGD run held to docs/convergence.md's criteria,
    ``tools.test`` to the last evaluation, K5/K6 (both runs) and K3/K4
    (CGD) launched once a step each at the run's shape and nowhere else;
    then those kernels' fp32 device times at that shape. -> ({run: launch
    counts}, {kernel name: (ms, plain ms)})."""
    from segdistill_tpu_torch.ops import group_kl as gk
    from segdistill_tpu_torch.ops import seg_ce as sc
    from segdistill_tpu_torch.tools import convergence
    ce_case, gkl_case = _cases().CONVERGENCE_CE, _cases().CONVERGENCE_GKL
    log(f'== convergence (docs/convergence.md): mit_b0 + SegFormerHead '
        f'(embed 64, 4 classes), AdamW 3e-4, batch 4 of 64x64 crops from '
        f'tests/data/convergence, {convergence.ITERS} iterations, '
        f'evaluations at {convergence.ITERS // 2} and {convergence.ITERS}, '
        f'fp32; then +CGD (group 2, alpha 3, tau 2) against the trained '
        f'baseline; tools.train and tools.test in this process')
    geometry = tuple(ce_case[1]) + tuple(ce_case[2])
    counts, by_shape, seconds = {}, {}, {}

    def counted(name, fn):
        before = {n: collections.Counter(c)
                  for n, c in sc.LAUNCHES_BY_SHAPE.items()}
        for k in path_kernels:
            k.launches = 0
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        counts[name] = {k.name: k.launches for k in path_kernels}
        by_shape[name] = {n: dict(c - before[n])
                          for n, c in sc.LAUNCHES_BY_SHAPE.items()}

    with tempfile.TemporaryDirectory() as tmp:
        out = convergence.run(tmp, DEVICE, on_run=counted)
    convergence.report(out)
    for name, tag in (('baseline', 'baseline'), ('cgd', 'CGD')):
        step_ms = float(np.median(list(out[name]['step_s'].values()))) * 1e3
        log(f'{tag}: {seconds[name]:.1f} s with its evaluations; step '
            f'{step_ms:.2f} ms (median of the logged 20-iteration means); '
            f'launches {counts[name]}; K5/K6 by (B, C, h, w, H, W) '
            f'{by_shape[name]}')
        convergence.check(out[name], tag)
        want = {n: {geometry: convergence.ITERS} for n in by_shape[name]}
        if by_shape[name] != want:
            raise AssertionError(f'{tag}: K5/K6 launched {by_shape[name]}, '
                                 f'not {want}')
    if counts['cgd'][gk.FWD_KERNEL.name] != convergence.ITERS \
            or counts['cgd'][gk.BWD_KERNEL.name] != convergence.ITERS:
        raise AssertionError(f'CGD: K3/K4 launched {counts["cgd"]}')
    last = out['cgd']['miou'][convergence.ITERS]
    if not abs(out['test_miou'] - last) <= MIOU_TOL:
        raise AssertionError(f'tools.test: mIoU {out["test_miou"]}, the '
                             f'last evaluation {last}')
    for name in counts:
        _check_launched({k: n for k, n in counts[name].items()
                         if name == 'cgd' or 'group_kl' not in k},
                        f'convergence {name}')

    return counts, _convergence_kernel_times()


def _convergence_kernel_times():
    """K3/K4 and K5/K6 at the convergence run's shape in fp32, device time
    (:func:`_profiled_ms`), beside the plain versions and the bounds. ->
    {kernel name: (ms, plain ms)}."""
    from segdistill_tpu_torch.ops import group_kl as gk
    from segdistill_tpu_torch.ops import seg_ce as sc
    (_, shape, out_hw, ignored, _), gkl = (_cases().CONVERGENCE_CE,
                                           _cases().CONVERGENCE_GKL)
    gen = torch.Generator(device=DEVICE).manual_seed(19)
    classes, g, tau = shape[1], gkl[3], 2.0
    labels = torch.randint(0, classes, (shape[0],) + out_hw, device=DEVICE,
                           generator=gen)
    labels[torch.rand(labels.shape, device=DEVICE, generator=gen)
           < ignored] = 255
    perm = torch.randperm(classes, device=DEVICE, generator=gen)
    z, xt = (torch.randn(shape, device=DEVICE, generator=gen)
             for _ in range(2))
    fwd = {'seg_ce': (lambda a: sc.fused_seg_ce(a, labels, out_hw,
                                                 classes)[0],
                      lambda a: sc.seg_ce_plain(a, labels, out_hw,
                                                classes)[0]),
           'group_kl': (lambda a: gk.fused_group_kl_shuffled(
                            a, xt, perm, out_hw, g, tau),
                        lambda a: gk.group_kl_plain(a, xt, perm, out_hw, g,
                                                    tau))}
    times = {}
    for mod, (fused, plain) in ((sc, fwd['seg_ce']), (gk, fwd['group_kl'])):
        with torch.no_grad():
            times[mod.FWD_KERNEL.name] = (_profiled_ms(lambda: fused(z)),
                                          _profiled_ms(lambda: plain(z)))
        a, b = z.clone().requires_grad_(), z.clone().requires_grad_()
        lk, lp = fused(a), plain(b)
        times[mod.BWD_KERNEL.name] = (
            _profiled_ms(lambda: torch.autograd.grad(lk, a,
                                                     retain_graph=True)),
            _profiled_ms(lambda: torch.autograd.grad(lp, b,
                                                     retain_graph=True)))
    bounds = dict(zip((gk.FWD_KERNEL.name, gk.BWD_KERNEL.name),
                      _cases().kl_bounds(shape, out_hw, torch.float32, 0)))
    bounds.update(zip((sc.FWD_KERNEL.name, sc.BWD_KERNEL.name),
                      _cases().seg_ce_bounds(shape, out_hw, torch.float32)))
    log(f'{shape} -> {out_hw} fp32, device time (the kernels\' durations '
        f'under torch.profiler, 20 calls): ' + '; '.join(
            f'{name} {ms:.4f} ms (plain {plain:.4f}, bound '
            f'{bounds[name][0]:.6f}, {ms / bounds[name][0]:.0f}x)'
            for name, (ms, plain) in times.items()))
    return times


# this slice: steps per dispatch (113-115). The CGD and PD steps at full
# width, captured in CUDA graphs and replayed in chunks of DISPATCH_K, against
# the same steps run eagerly from the same snapshot
DISPATCH_K = 4
# the chunk's steps: 998-1001, so that CGD's channel shuffle draws its
# permutation at 1000 (a graph of its own) among steps of the identity
DISPATCH_START = 997
DISPATCH_ROUNDS = 3
# (116, 117) where a step adds with atomics (an operation PyTorch names
# nondeterministic; with none named a chunk must be bitwise), a chunk of
# replays is held to this many eager runs from one snapshot: the median of
# the eager runs' distances from each other is the noise (one pair is a
# fragile estimate of it), the median of the chunk's distances to them the
# reading; each distance is logged
DISPATCH_EAGER_RUNS = 3
# (116) runs in a process of its own beside the fp32 steps against the CPU
DISPATCH_TRY_RANK = 'chip_smoke:dispatch_try_rank'
DISPATCH_TRY_TIMEOUT = 600
# each kernel's CUDA function in a profiler trace, one a wrapper's launch
# (K3 also launches gkl_finalize or the forward tile, K9 sra_bwd_reduce)
KERNEL_TRACE = {
    'resize_sum': r'resize_sum_kernel',
    'sra_attn': r'sra_fwd_(mma|f32)',
    'group_kl_fwd': r'gkl_max',
    'group_kl_bwd': r'tile_bwd<.*gkl_tile|gkl_bwd<',
    'seg_ce_fwd': r'fwd_tile<.*ce_fwd_tile|ce_fwd<',
    'seg_ce_bwd': r'tile_bwd<.*ce_tile|ce_bwd<',
    'pixel_kl_fwd': r'fwd_tile<.*pkl_fwd_tile|pkl_fwd<',
    'pixel_kl_bwd': r'tile_bwd<.*pkl_tile|pkl_bwd<',
    'sra_attn_bwd': r'sra_bwd_(mma|f32)',
    'layer_norm_fwd': r'ln_fwd<',
    'layer_norm_bwd': r'ln_bwd<',
}
# kernels a chunk may launch that the eager steps do not (phase_dispatch)
DISPATCH_EXTRA = r'^(memcpy|memset)|FillFunctor|MulFunctor<float>'
# (117) the DDP step as a CUDA graph at NCCL world size 1, in a process of
# its own: (config, options, tag, batch, crop); a chunk of DDP_DISPATCH_K
# replays, timed against the eager DDP step in DDP_DISPATCH_ROUNDS turns
DDP_DISPATCH_RANK = 'chip_smoke:ddp_dispatch_rank'
DDP_DISPATCH_K, DDP_DISPATCH_ROUNDS = 2, 3
DDP_DISPATCH_TIMEOUT = 540
DDP_DISPATCH_CASES = [
    (CGD_CONFIG, dict(NO_CHECKPOINTS, **BF16_BACKBONES), 'CGD', TRAIN_BATCH,
     (512, 512)),
    (PD_CONFIG, dict(NO_CHECKPOINTS, **BF16_BACKBONES, **STUDENT_FA_TRAIN),
     'PD', TRAIN_BATCH, (512, 512)),
    (PSP_CITY, {'model.backbone.dtype': 'bfloat16'},
     'PSPNet-R50 Cityscapes (SGD)', EXTRA_BATCH, (512, 1024)),
    # a multi-teacher recipe of recipes.py (its bf16 options): the random
    # ensemble, a graph for each teacher its chunk draws
    ('mt_cgd_random', None, 'MT random', TRAIN_BATCH, (512, 512))]
# the command line at k = 4 (115): iterations not a multiple of 4 (chunk
# ends 4 and 8, then single steps 9 and 10), evaluation and checkpoint
# intervals crossed at 8 and 10
CLI_DISPATCH_ITERS, CLI_DISPATCH_INTERVAL = 10, 5


def _train_tensors(state):
    """{name: tensor} of what a train step changes: the model's parameters
    and buffers, and each tensor of the optimizer's state."""
    out = dict(state.model.state_dict(keep_vars=True))
    params = [p for g in state.optimizer.param_groups for p in g['params']]
    index = {id(p): i for i, p in enumerate(params)}
    for p, st in state.optimizer.state.items():
        for key, value in st.items():
            if torch.is_tensor(value):
                out[f'optimizer.{index[id(p)]}.{key}'] = value
    return out


def _snapshot(state):
    return {k: v.detach().clone() for k, v in _train_tensors(state).items()}


@torch.no_grad()
def _restore(state, snap, step):
    for name, t in _train_tensors(state).items():
        t.copy_(snap[name])
    state.step = step


def _unequal(state, snap):
    """The tensors of ``state`` that are not bitwise those of ``snap``."""
    return [k for k, v in _train_tensors(state).items()
            if not torch.equal(v, snap[k])]


def _rel_l2(got, start, want):
    """Relative L2 distance between the change ``got`` holds from
    ``start`` and the change ``want`` holds ({name: tensor} each), over the
    floating tensors."""
    num = den = 0.0
    for name, t in got.items():
        if not t.is_floating_point():
            continue
        a = (t.detach().double() - start[name].double())
        b = (want[name].double() - start[name].double())
        num += float((a - b).square().sum())
        den += float(b.square().sum())
    return math.sqrt(num / den)


def _moved_rel_l2(state, start, want):
    """:func:`_rel_l2` of the change a run made in ``state``."""
    return _rel_l2(_train_tensors(state), start, want)


def _spread(start, eager, graph):
    """-> (the median of the distances (:func:`_rel_l2`) between the
    changes of the eager runs ``eager``, the median of the graph run's
    distances to them, each distance in a line): the noise of a step that
    adds with atomics, and the graph's reading against it (phases 116 and
    117)."""
    pairs = [_rel_l2(a, start, b)
             for a, b in itertools.combinations(eager, 2)]
    graph_to = [_rel_l2(graph, start, e) for e in eager]
    table = ('eager pairs ' + ', '.join(f'{d:.3e}' for d in pairs)
             + '; graph to each eager run '
             + ', '.join(f'{d:.3e}' for d in graph_to))
    return float(np.median(pairs)), float(np.median(graph_to)), table


def _traced(fn, prepare=None, names=(), want=None):
    """-> the CUDA events of one call of ``fn`` under torch.profiler
    (:func:`_device_events`, ``prepare()`` before each session). With
    ``want``, a trace whose counts of the kernels ``names``
    (:func:`_trace_counts`) are not ``want`` is logged and made again, up
    to PROFILE_SESSIONS; the last is returned. CUPTI has lost a few dozen
    of a replay's ~3000 records on the H100 (copies, fills and kernels of
    every kind at once): a lost record lowers a count, and never adds a
    kernel."""
    for session in range(PROFILE_SESSIONS):
        events = _device_events(fn, prepare=prepare)
        if not events:
            raise AssertionError(f'torch.profiler saw no kernel on the card '
                                 f'in {PROFILE_SESSIONS} sessions')
        counts = _trace_counts(events, names)
        if want is None or counts == want:
            break
        log(f'trace {session + 1} of {PROFILE_SESSIONS}: {len(events)} '
            f'device events, kernels {counts}, not {want}')
    return events


def _trace_counts(events, names):
    return {n: sum(1 for e in events if re.search(KERNEL_TRACE[n], e.name))
            for n in names}


def _pool_bytes(pool=None):
    """Bytes the caching allocator holds in private pools: the CUDA
    graphs' memory (``pool``: that pool's alone, a graph's ``pool()``)."""
    return sum(s['total_size'] for s in torch.cuda.memory_snapshot()
               if tuple(s.get('segment_pool_id', (0, 0))) != (0, 0)
               and (pool is None
                    or tuple(s['segment_pool_id']) == tuple(pool)))


def _nondeterministic_ops(fn):
    """The operations that ``fn`` runs and that PyTorch names as having no
    deterministic implementation on the card (the warnings of
    ``torch.use_deterministic_algorithms(True, warn_only=True)``)."""
    import warnings
    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])
    return sorted({str(w.message).split(' does not')[0] for w in caught
                   if 'deterministic' in str(w.message)})


def _programmatic_edges():
    """K10's programmatic dependent launch inside a CUDA graph: a graph of
    three K10 launches, the last two each right after a kernel, captured
    as the train step's graphs are; -> (programmatic edges, all edges) of
    the graph, from the CUDA runtime's ``cudaGraphGetEdges_v2`` (edge type
    1: programmatic), and whether its replay equals the eager calls."""
    import ctypes
    from segdistill_tpu_torch.ops.layer_norm import fused_layer_norm
    gen = torch.Generator(device=DEVICE).manual_seed(40)
    x = torch.randn(8192, 320, device=DEVICE, dtype=torch.bfloat16,
                    generator=gen)
    w = torch.ones(320, device=DEVICE)
    b = torch.zeros(320, device=DEVICE)

    def body():
        y = fused_layer_norm(x, w, b, 1e-6)
        y = fused_layer_norm(y * 1.5, w, b, 1e-6)
        return fused_layer_norm(y, w, b, 1e-6)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        want = body()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        got = body()
    graph.instantiate()
    graph.replay()
    torch.cuda.synchronize()
    runtime = ctypes.CDLL('libcudart.so')
    get_edges = runtime.cudaGraphGetEdges_v2
    n = ctypes.c_size_t(0)
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    if get_edges(raw, None, None, None, ctypes.byref(n)):
        raise AssertionError('cudaGraphGetEdges_v2 failed')
    src = (ctypes.c_void_p * n.value)()
    dst = (ctypes.c_void_p * n.value)()
    data = (ctypes.c_ubyte * (8 * n.value))()  # cudaGraphEdgeData: 8 bytes
    if get_edges(raw, src, dst, data, ctypes.byref(n)):
        raise AssertionError('cudaGraphGetEdges_v2 failed')
    types = [data[8 * i + 2] for i in range(n.value)]
    return types.count(1), n.value, torch.equal(got, want)


def phase_dispatch(path_kernels, config, options, tag):
    """Steps per dispatch on the card (113, 114): the step of ``config``
    (bf16 backbones, batch 8 at 512x512) with the optimizer made
    capturable, run eagerly for DISPATCH_K steps from a snapshot (the multi
    step's single step, as a replay computes it) and as a chunk of
    DISPATCH_K replays from the same snapshot; two replays from it; a trace
    of each (every kernel of ``path_kernels`` at its eager count, the
    replay's kernels all of the eager step's); the k = 1 step (K1's atomic
    backward) against the graph in turns; with CGD, a checkpoint saved and
    loaded between two chunks, against the same chunks with no reload
    (bitwise, the learning rates on the card). -> the launches of each
    kernel in a replay's trace."""
    from segdistill_tpu_torch.apis import (init_segmentor_state,
                                           prepare_training)
    from segdistill_tpu_torch.engine import (load_checkpoint, make_capturable,
                                             save_checkpoint)
    from segdistill_tpu_torch.engine.cuda_graph import CAPTURE_WARMUP
    from segdistill_tpu_torch.tools.profile_train import _union_ms
    k = DISPATCH_K
    log(f'== steps per dispatch: {tag} (B0 <- B3, bf16 backbones, batch '
        f'{TRAIN_BATCH} at 512x512), steps {DISPATCH_START + 1}-'
        f'{DISPATCH_START + k} as a chunk of {k} replays of the step\'s CUDA '
        f'graph against the same step run eagerly, both from one snapshot')
    model = init_segmentor_state(
        str(config), seed=0, device=DEVICE,
        cfg_options=dict(NO_CHECKPOINTS, **BF16_BACKBONES, **options,
                         **{'runner.steps_per_dispatch': k}))
    state, multi = prepare_training(model)
    single, eager_k1 = multi.step, multi.eager_step
    make_capturable(state.optimizer, torch.device(DEVICE))
    batches = [_train_batch(TRAIN_BATCH, seed=20 + i) for i in range(k)]
    imgs = torch.stack([b[0] for b in batches])
    gts = torch.stack([b[1] for b in batches])
    state.step = DISPATCH_START - 1
    single(state, imgs[-1], gts[-1])  # kernels loaded, moments made
    torch.cuda.synchronize()
    snap = _snapshot(state)
    names = [kn.name for kn in path_kernels]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # eager, twice from the snapshot: the launches counted a step
        ends, counted = [], []
        for _ in range(2):
            _restore(state, snap, DISPATCH_START)
            torch.cuda.reset_peak_memory_stats()
            for img, gt in zip(imgs, gts):
                for kn in path_kernels:
                    kn.launches = 0
                eager_logs = single(state, img, gt)
                counted.append({kn.name: kn.launches for kn in path_kernels})
            torch.cuda.synchronize()
            ends.append(_snapshot(state))
        eager_peak = torch.cuda.max_memory_allocated()
        eager_last = {n: float(v) for n, v in eager_logs.items()}
        eager_twice = _unequal(state, ends[0])
        # the chunk: a graph captured at each key's first step, k replays
        _restore(state, snap, DISPATCH_START)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = multi(state, imgs, gts)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        graph_peak = torch.cuda.max_memory_allocated()
        pool = _pool_bytes()
        graphed = multi.graphed
        graph_end = _snapshot(state)
        graph_last = {n: float(v) for n, v in got.items()}
        if state.step != DISPATCH_START + k:
            raise AssertionError(f'{tag}: the chunk ended at {state.step}')
        vs_eager = _unequal(state, ends[0])
        moved = _moved_rel_l2(state, snap, ends[0]) if vs_eager else 0.0
        # two replays from one snapshot
        _restore(state, snap, DISPATCH_START)
        torch.cuda.reset_peak_memory_stats()
        again = multi(state, imgs, gts)
        torch.cuda.synchronize()
        replay_peak = torch.cuda.max_memory_allocated()
        replays_differ = _unequal(state, graph_end) + [
            n for n, v in again.items() if float(v) != graph_last[n]]
        nondeterministic = []
        if eager_twice or vs_eager or replays_differ:
            _restore(state, snap, DISPATCH_START)
            nondeterministic = _nondeterministic_ops(
                lambda: single(state, imgs[0], gts[0]))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log(f'capture: {len(graphed.graphs)} graph(s), '
        + ', '.join(f'{s:.2f}' for s in graphed.capture_seconds)
        + f' s each with {CAPTURE_WARMUP} eager warm-up steps; the first '
        f'chunk {first_s:.2f} s in all; graph pool {pool / 2**20:.1f} MiB')
    log(f'peak memory allocated: eager {eager_peak / 2**30:.3f} GiB, the '
        f'chunk with its captures {graph_peak / 2**30:.3f} GiB, a chunk of '
        f'replays {replay_peak / 2**30:.3f} GiB')
    log(f'last step: eager ' + ', '.join(
        f'{n} {v:.9g}' for n, v in sorted(eager_last.items())))
    log(f'last step: graph ' + ', '.join(
        f'{n} {v:.9g}' for n, v in sorted(graph_last.items())))
    # log vars against (11)'s limits: loss terms 1e-6 * |loss| + 2.5e-5,
    # an accuracy (in percent) CORRECT_TOL_SHARE of the pixels
    limits = [abs(graph_last[n] - want) / (
        100 * CORRECT_TOL_SHARE if 'acc' in n
        else TRAIN_LOSS_TOL_REL * abs(want) + TRAIN_LOSS_TOL_ABS)
        for n, want in eager_last.items() if n != 'lr']
    log(f'eager twice from the snapshot: '
        f'{"bitwise equal" if not eager_twice else f"{len(eager_twice)} tensors differ"}; '
        f'graph against eager: '
        f'{"bitwise equal" if not vs_eager else f"{len(vs_eager)} tensors differ, e.g. {vs_eager[:4]}"}'
        f' (the change from the snapshot within {moved:.3e} relative L2, '
        f'log vars {max(limits):.3f} of the loss limit); two replays: '
        f'{"bitwise equal" if not replays_differ else f"{len(replays_differ)} differ, e.g. {replays_differ[:4]}"}')
    if nondeterministic:
        log(f'operations without a deterministic implementation in the '
            f'step: {nondeterministic}')
    if vs_eager and not (max(limits) <= 1.0
                         and moved <= TRAIN_GRAD_TOL_REL_L2):
        raise AssertionError(f'{tag}: the replays differ from the eager '
                             f'steps beyond the fp32 train-step limits')
    if replays_differ and not nondeterministic:
        raise AssertionError(f'{tag}: two replays from one snapshot differ '
                             f'with no nondeterministic operation named')
    if tag == 'CGD':
        edges, n_edges, same = _programmatic_edges()
        log(f'K10 in a graph (three launches, two right after a kernel): '
            f'{edges} programmatic of {n_edges} edges; the replay equals '
            f'the eager calls: {same}')
        if not same:
            raise AssertionError('a graph of K10 differs from its eager '
                                 'calls')

    # one trace of each, step 998 from the snapshot: the eager step (the
    # wrappers count) and one replay of its graph
    def restore():
        _restore(state, snap, DISPATCH_START)
    want = counted[0]
    eager_events = _traced(lambda: single(state, imgs[0], gts[0]), restore,
                           names, want)
    graph_events = _traced(lambda: multi.graphed(state, imgs[:1], gts[:1]),
                           restore, names, want)
    in_eager = _trace_counts(eager_events, names)
    in_graph = _trace_counts(graph_events, names)
    if in_eager != want:
        raise AssertionError(f'{tag}: the eager trace counts {in_eager}, '
                             f'the wrappers {want}')
    # what a replay launches beside the graph's own kernels: its copy and
    # fill nodes (memcpy128, memset32, ...), the fills of the device
    # scalars and of the generator's seed and offset before a replay, and
    # alpha's product with the loss as two device scalars (a Python float
    # eagerly); no plain version
    new = sorted(n for n in {e.name for e in graph_events}
                 - {e.name for e in eager_events}
                 if not re.search(DISPATCH_EXTRA, n))
    log(f'kernels of step {DISPATCH_START + 1}: eager trace {in_eager}, '
        f'replay trace {in_graph}; {len(eager_events)} device events '
        f'eager, {len(graph_events)} in the replay; kernels of the replay '
        f'that the eager step does not launch: {new}')
    if in_graph != want or new:
        short = collections.Counter(e.name for e in eager_events)
        short.subtract(e.name for e in graph_events)
        log('fewer in the replay\'s trace: ' + str(
            [(n[:90], c) for n, c in short.most_common(12) if c > 0]))
        raise AssertionError(f'{tag}: the replay launches other kernels '
                             f'than the eager step')
    busy = {'eager': _union_ms(eager_events),
            'graph': _union_ms(graph_events)}

    # the k = 1 step (K1's atomic backward; the optimizer's capturable form)
    # against the graph, in turns
    times = {'eager': [], 'graph': []}
    for r in range(DISPATCH_ROUNDS):
        for arm in (('eager', 'graph') if r % 2 == 0 else ('graph', 'eager')):
            _restore(state, snap, DISPATCH_START)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            if arm == 'eager':
                for img, gt in zip(imgs, gts):
                    eager_k1(state, img, gt)
            else:
                multi(state, imgs, gts)
            end.record()
            torch.cuda.synchronize()
            times[arm].append(((time.perf_counter() - t0) / k * 1e3,
                               start.elapsed_time(end) / k))
    for arm, rows in times.items():
        host = [h for h, _ in rows]
        dev = [d for _, d in rows]
        med = float(np.median(host))
        log(f'{arm}: {", ".join(f"{h:.3f}" for h in host)} ms a step '
            f'(host clock), {", ".join(f"{d:.3f}" for d in dev)} (CUDA '
            f'events); device busy {busy[arm]:.3f} ms a step (the trace\'s '
            f'kernel union), {busy[arm] / med:.1%} of the median')
    if tag == 'CGD':
        _dispatch_resume(state, multi, snap, imgs, gts, save_checkpoint,
                         load_checkpoint)
    return in_graph


def _dispatch_resume(state, multi, snap, imgs, gts, save_checkpoint,
                     load_checkpoint):
    """A k > 1 run resumed: from the snapshot one single step (998), then
    a chunk (999-1002), once straight on and once with a checkpoint saved
    at 998 and loaded into the state in between (the loaded optimizer in
    the plain form: float learning rates, which the chunk's graphs, captured
    anew, must read from the card). Both end bitwise equal, with equal
    learning rates, each a float64 scalar on the card."""
    ends, lrs, values = [], [], []
    for reload in (False, True):
        _restore(state, snap, DISPATCH_START)
        multi.step(state, imgs[0], gts[0])
        if reload:
            work = Path(tempfile.mkdtemp(prefix='dispatch-resume-'))
            save_checkpoint(str(work), state)
            load_checkpoint(str(work), state)
            shutil.rmtree(work, ignore_errors=True)
            loaded = [g['lr'] for g in state.optimizer.param_groups]
        multi(state, imgs, gts)
        torch.cuda.synchronize()
        ends.append(_snapshot(state))
        lrs.append([g['lr'] for g in state.optimizer.param_groups])
        values.append([float(lr) for lr in lrs[-1]])
    differ = _unequal(state, ends[0])
    on_card = all(torch.is_tensor(lr) and lr.is_cuda
                  and lr.dtype == torch.float64 for lr in lrs[1])
    same_lr = values[0] == values[1]
    log(f'resume between chunks (a checkpoint saved at '
        f'{DISPATCH_START + 1} and loaded, the groups\' learning rates '
        f'{[type(lr).__name__ for lr in loaded]} after the load): '
        f'{len(multi.graphed.graphs)} graph(s) captured anew; against no '
        f'reload: '
        + ('bitwise equal' if not differ else
           f'{len(differ)} tensors differ, e.g. {differ[:4]}')
        + f'; '
        f'learning rates {values[1]} on the card: {on_card}, equal to '
        f'those straight on: {same_lr}')
    if differ or not on_card or not same_lr:
        raise AssertionError('a k > 1 run resumed from a checkpoint differs '
                             'from the run straight on')


def phase_dispatch_try(config, options, tag, batch=TAB5_BATCH,
                       hw=(512, 512)):
    """(116) Another config under steps per dispatch: its step (bf16
    backbones, ``batch`` at ``hw``) with the optimizer made capturable
    (an SGD's a :class:`CapturableSGD`), steps 999-1000 as a chunk of 2
    replays against the same steps run eagerly DISPATCH_EAGER_RUNS times
    from one snapshot (bitwise, or, where PyTorch names a nondeterministic
    operation of the step, within the eager runs' spread,
    :func:`_spread`); any error fails. -> what it did, in a line."""
    from segdistill_tpu_torch.apis import (init_segmentor_state,
                                           prepare_training)
    from segdistill_tpu_torch.engine import make_capturable
    model = init_segmentor_state(_config(config), seed=0, device=DEVICE,
                                 cfg_options=dict(options, **{
                                     'runner.steps_per_dispatch': 2}))
    state, multi = prepare_training(model)
    single = multi.step
    log(f'== steps per dispatch, another config: {tag}, bf16 backbone(s), '
        f'{type(state.optimizer).__name__}, batch {batch} at '
        f'{hw[0]}x{hw[1]}, a chunk of 2 replays against eager')
    classes = model.num_classes
    g = torch.Generator(device=DEVICE).manual_seed(30)
    imgs = torch.randn(2, batch, 3, *hw, device=DEVICE, generator=g)
    gts = torch.randint(0, classes, (2, batch) + tuple(hw), device=DEVICE,
                        generator=g)
    make_capturable(state.optimizer, torch.device(DEVICE))
    state.step = 997
    single(state, imgs[0], gts[0])
    snap = _snapshot(state)
    ends = []
    for _ in range(DISPATCH_EAGER_RUNS):
        _restore(state, snap, 998)
        for img, gt in zip(imgs, gts):
            want = single(state, img, gt)
        ends.append(_snapshot(state))
    _restore(state, snap, 998)
    got = multi(state, imgs, gts)
    torch.cuda.synchronize()
    differ = _unequal(state, ends[0])
    noise, moved, table = _spread(snap, ends, _snapshot(state)) if differ \
        else (0.0, 0.0, '')
    same_logs = all(float(got[n]) == float(v) for n, v in want.items())
    line = (f'runs in {len(multi.graphed.graphs)} graph(s), capture '
            + ', '.join(f'{c:.2f}' for c in multi.graphed.capture_seconds)
            + ' s; against eager: '
            + ('bitwise equal' if not differ and same_logs else
               f'{len(differ)} tensors differ, the change within '
               f'{moved:.3e} relative L2 of the {DISPATCH_EAGER_RUNS} eager '
               f'runs\' (median; theirs from each other: {noise:.3e}; '
               f'{table})'))
    nondeterministic = []
    if differ or not same_logs:
        _restore(state, snap, 998)
        nondeterministic = _nondeterministic_ops(
            lambda: single(state, imgs[0], gts[0]))
        line += '; nondeterministic: ' + (', '.join(nondeterministic)
                                          or 'none named')
    log(f'{tag}: {line}')
    # deterministic algorithms where PyTorch has them (dispatch_try_rank):
    # a step with no operation it names nondeterministic must be bitwise;
    # one that adds with atomics, within
    # the limit of (11) or 4x the eager runs' distance from each other
    # (PERF.md section 2)
    if (differ or not same_logs) and not nondeterministic:
        raise AssertionError(f'{tag}: the replays differ from eager with no '
                             f'nondeterministic operation named: {line}')
    if (differ or not same_logs) and not moved <= max(
            TRAIN_GRAD_TOL_REL_L2, 4 * noise):
        raise AssertionError(f'{tag}: the replays differ from eager: {line}')
    return line


def dispatch_try_rank():
    """(116) in a process of its own (``parallel.launch``, one rank, no
    process group), beside the fp32 steps against the CPU: psp_CGD,
    swin_CGD and the MT random ensemble at the Tab5 batch and 512x512,
    and the SGD configs (the configs/extra models at their own batch and
    crop, SGD_DISPATCH_RECIPES), each through :func:`phase_dispatch_try`.
    """
    from segdistill_tpu_torch import recipes
    from segdistill_tpu_torch.recipes import mt_bf16_options, mt_recipe
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuDNN deterministic, as in 113 and 117, and the deterministic forms
    # of the operations that have one (the bilinear and gather backwards
    # add with atomics otherwise, unnamed): the eager runs then differ only
    # where an operation that PyTorch names adds with atomics
    import warnings
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    warnings.filterwarnings('ignore', '.*deterministic implementation')
    mt_random = mt_recipe('mt_cgd_random')
    for config, options, tag in (
            (str(PSP_CGD), dict(NO_CHECKPOINTS, **BF16_BACKBONES), 'psp_CGD'),
            (str(SWIN_CGD), dict(NO_CHECKPOINTS, **BF16_BACKBONES),
             'swin_CGD'),
            (mt_random, mt_bf16_options(mt_random), 'MT random')):
        phase_dispatch_try(config, options, tag)
    # the SGD configs: the configs/extra models at their own batch and
    # crop, and three recipes whose steps hold what no other captured step
    # does (EMANet's bases moved in place, HRNet's 37 upsamples, Fast-SCNN's
    # own schedule)
    bf16 = {'model.backbone.dtype': 'bfloat16'}
    for config, tag, _, hw, _, _ in EXTRA_PATHS:
        phase_dispatch_try(config, bf16, f'{tag} (SGD)', EXTRA_BATCH, hw)
    for name, tag in SGD_DISPATCH_RECIPES:
        phase_dispatch_try(recipes.recipe(name), bf16, f'{tag} (SGD)',
                           EXTRA_BATCH, ZOO_HW)


def _dispatch_try_process():
    """Run :func:`dispatch_try_rank` and print what it logged."""
    from segdistill_tpu_torch.parallel import launch
    t0 = time.perf_counter()
    ((out, _),) = launch(DISPATCH_TRY_RANK, 1, [],
                         timeout=DISPATCH_TRY_TIMEOUT)
    print(out, end='', flush=True)
    log(f'(116) in its own process, beside the fp32 steps: '
        f'{time.perf_counter() - t0:.1f} s')


def phase_cli_dispatch(root, host_train, multi_host=False):
    """(115) ``tools.train`` on phase 14's dataset and config with
    ``runner.steps_per_dispatch`` = DISPATCH_K over CLI_DISPATCH_ITERS
    iterations (the CGD step captured in CUDA graphs): the JAX runner's
    cadence (chunk ends 4 and 8, single steps 9 and 10; evaluations and
    checkpoints where a chunk crosses CLI_DISPATCH_INTERVAL), the logged
    losses within the resume limit of phase 14's k = 1 run at the same
    iterations, ``tools.test`` on its checkpoint reproducing its last
    evaluation. (117) With ``multi_host``, ``tools.train --multi-host`` and
    ``tools.test --multi-host`` under torchrun's variables (NCCL at world
    size 1, each in a process of its own, as phase 101): the DDP step's
    graphs."""
    from segdistill_tpu_torch.tools import test as test_cli
    from segdistill_tpu_torch.tools import train as train_cli
    k, iters, every = DISPATCH_K, CLI_DISPATCH_ITERS, CLI_DISPATCH_INTERVAL
    flag = ' --multi-host' if multi_host else ''
    log(f'== command line, steps per dispatch: tools.train{flag} on phase '
        f'14\'s dataset and config with --options '
        f'runner.steps_per_dispatch={k}, {iters} iterations, checkpoint and '
        f'evaluation every {every}; then tools.test{flag}'
        + (' (torchrun\'s variables: RANK 0, WORLD_SIZE 1, NCCL)'
           if multi_host else ''))
    opts = dict(_cli_config_options(root / 'data'), **{
        'runner.steps_per_dispatch': k, 'runner.max_iters': iters,
        'checkpoint_config.interval': every, 'evaluation.interval': every})
    options = [f'{key}={value}' for key, value in opts.items()]
    work = root / ('work_dispatch_multi_host' if multi_host
                   else 'work_dispatch')
    args = [str(CGD_CONFIG), '--work-dir', str(work), '--seed', '0',
            '--options', *options]
    t0 = time.perf_counter()
    if multi_host:
        _run_cli(['segdistill_tpu_torch.tools.train', *args, '--multi-host'],
                 'tools.train --multi-host')
        step = json.loads((work / 'checkpoints' / 'meta.json').read_text())[
            'iter']
    else:
        step = train_cli.main(args).step
        torch.cuda.synchronize()
    log(f'tools.train{flag}: {time.perf_counter() - t0:.1f} s in all')
    train, val = _json_log(work)
    (text_log,) = work.glob('*.log')
    text = text_log.read_text()
    if multi_host and 'Backend: nccl' not in text:
        raise AssertionError('the --multi-host run did not use NCCL')
    ckpts = sorted(q.name for q in (work / 'checkpoints').iterdir())
    want_ckpts = sorted([f'iter_{2 * k}.pth', f'iter_{iters}.pth',
                         'meta.json'])
    if step != iters or sorted(train) != [k, 2 * k, 2 * k + 1, iters] \
            or sorted(val) != [2 * k, iters] or ckpts != want_ckpts \
            or f'Iter [{iters}/{iters}]' not in text \
            or f'Eval at iter {2 * k}' not in text:
        raise AssertionError(f'logged {sorted(train)}, evaluated '
                             f'{sorted(val)}, checkpoints {ckpts}')
    worst, worst_rel = 0.0, 0.0
    for it, line in train.items():
        for key in ('loss', 'decode.loss_seg',
                    'loss_decode_head.linear_pred<->'
                    'decode_head.linear_pred_other'):
            a, b = host_train[it][key], line[key]
            worst_rel = max(worst_rel, abs(a - b) / abs(a))
            worst = max(worst, abs(a - b)
                        / (RESUME_TOL_REL * abs(a) + RESUME_TOL_ABS))
    log('logged at ' + ', '.join(
        f'{it}: loss {line["loss"]:.6f} (k = 1: '
        f'{host_train[it]["loss"]:.6f}), time {line["time"] * 1e3:.2f} ms, '
        f'data_time {line["data_time"] * 1e3:.2f} ms'
        for it, line in sorted(train.items())))
    log(f'against the k = 1 run: at most {worst_rel:.3e} of a loss term, '
        f'{worst:.4f} of the limit {RESUME_TOL_REL} * |loss| + '
        f'{RESUME_TOL_ABS}')
    if not worst <= 1.0:
        raise AssertionError('the k = 4 run differs from the k = 1 run')
    test_args = [str(CGD_CONFIG), str(work), '--eval', 'mIoU', '--options',
                 *options]
    if multi_host:
        res = _run_cli(['segdistill_tpu_torch.tools.test', *test_args,
                        '--multi-host'], 'tools.test --multi-host')
        metrics = ast.literal_eval(res.stdout.strip().splitlines()[-1])
    else:
        metrics = test_cli.main(test_args)
    diff = max(abs(metrics[key] - val[iters][key])
               for key in ('mIoU', 'mAcc', 'aAcc'))
    log(f'tools.test{flag} on the work dir: mIoU {metrics["mIoU"]:.9f}, the '
        f'last evaluation {val[iters]["mIoU"]:.9f} (differ by at most '
        f'{diff:.2e}, limit {MIOU_TOL})')
    if not diff <= MIOU_TOL:
        raise AssertionError(f'tools.test{flag} does not reproduce the k = 4 '
                             f'run\'s last evaluation')
    return train


def _ddp_start(model, k):
    """The step after which (117) takes its chunk: 998, or for a random
    ensemble the first from there whose next k steps draw every teacher
    (``draw_teacher_index`` of each step's seed)."""
    from segdistill_tpu_torch.engine import step_seed
    from segdistill_tpu_torch.models.segmentors import draw_teacher_index
    start = DISPATCH_START + 1
    if not getattr(model, 'random_ensemble', False):
        return start, None
    n = len(model.teachers)
    while True:
        drawn = [draw_teacher_index(step_seed(0, start + i + 1), n)
                 for i in range(k)]
        if len(set(drawn)) == n:
            return start, drawn
        start += 1


def _ddp_dispatch_case(config, options, tag, kernels, batch, hw, k):
    """One config of (117) in the rank: its DDP step (``prepare_training(
    distributed=True)``: the static-graph DDP) from one snapshot, k steps
    (999 to 998 + k; a random ensemble's first k that draw every teacher)
    run eagerly DISPATCH_EAGER_RUNS times (the multi step's single step,
    the wrappers counting each step's launches) and as a chunk of k
    replays of the DDP step's graphs, held as phase 116 holds them; a
    replay of each step whose eager counts differ from the earlier ones'
    traced (K1-K11 at their eager counts, and the NCCL kernels); the graph
    and the eager DDP step timed in turns. ``config`` a name: a
    multi-teacher recipe of ``recipes.py`` with its bf16 options. -> a
    dict for the log."""
    from segdistill_tpu_torch.apis import (init_segmentor_state,
                                           prepare_training)
    from segdistill_tpu_torch.engine import make_capturable
    if isinstance(config, str):
        from segdistill_tpu_torch.recipes import mt_bf16_options, mt_recipe
        config = mt_recipe(config)
        options = mt_bf16_options(config)
    model = init_segmentor_state(_config(config), seed=0, device=DEVICE,
                                 cfg_options=dict(options, **{
                                     'runner.steps_per_dispatch': k}))
    start, drawn = _ddp_start(model, k)
    state, multi = prepare_training(model, distributed=True)
    if not multi.forward_train.static_graph:
        raise AssertionError(f'{tag}: the DDP of a k > 1 run on the card '
                             f'is not a static graph')
    single = multi.step
    g = torch.Generator(device=DEVICE).manual_seed(31)
    imgs = torch.randn(k, batch, 3, *hw, device=DEVICE, generator=g)
    gts = torch.randint(0, model.num_classes, (k, batch) + tuple(hw),
                        device=DEVICE, generator=g)
    make_capturable(state.optimizer, torch.device(DEVICE))
    state.step = start - 1
    single(state, imgs[0], gts[0])
    snap = _snapshot(state)
    ends, counted = [], []
    for _ in range(DISPATCH_EAGER_RUNS):
        _restore(state, snap, start)
        for img, gt in zip(imgs, gts):
            for kn in kernels:
                kn.launches = 0
            want = single(state, img, gt)
            counted.append({kn.name: kn.launches for kn in kernels})
        ends.append(_snapshot(state))
    _restore(state, snap, start)
    t0 = time.perf_counter()
    got = multi(state, imgs, gts)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    differ = _unequal(state, ends[0])
    noise, moved, table = _spread(snap, ends, _snapshot(state)) if differ \
        else (0.0, 0.0, '')
    same_logs = all(float(got[n]) == float(v) for n, v in want.items())
    nondeterministic = []
    if differ or not same_logs:
        _restore(state, snap, start)
        nondeterministic = _nondeterministic_ops(
            lambda: single(state, imgs[0], gts[0]))
    out = dict(tag=tag, graphs=len(multi.graphed.graphs),
               capture_s=multi.graphed.capture_seconds, first_s=first_s,
               differ=len(differ), moved=moved, noise=noise, table=table,
               same_logs=same_logs, nondeterministic=nondeterministic,
               optimizer=type(state.optimizer).__name__,
               steps=[start + 1, start + k], drawn=drawn)
    names = [kn.name for kn in kernels if counted[0][kn.name]]
    out['traced'], out['nccl'], out['events'] = [], [], []
    for i in range(k):
        want_counts = {n: counted[i][n] for n in names}
        if any(want_counts == w for _, w, _ in out['traced']):
            continue

        def restore(i=i):
            _restore(state, snap, start + i)
        events = _traced(
            lambda i=i: multi.graphed(state, imgs[i:i + 1], gts[i:i + 1]),
            restore, names, want_counts)
        label = '' if drawn is None else f' (teacher {drawn[i]})'
        out['traced'].append((label, want_counts,
                              _trace_counts(events, names)))
        out['nccl'] += [e.name for e in events if 'nccl' in e.name.lower()]
        out['events'].append(len(events))
    out['nccl'] = sorted(collections.Counter(out['nccl']).items())
    times = {'eager': [], 'graph': []}
    for r in range(DDP_DISPATCH_ROUNDS):
        for arm in (('eager', 'graph') if r % 2 == 0 else ('graph', 'eager')):
            _restore(state, snap, start)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if arm == 'eager':
                for img, gt in zip(imgs, gts):
                    single(state, img, gt)
            else:
                multi(state, imgs, gts)
            torch.cuda.synchronize()
            times[arm].append((time.perf_counter() - t0) / k * 1e3)
    out['ms'] = times
    return out


def ddp_dispatch_rank(out_dir):
    """(117) The rank of one process that torchrun's variables describe
    (NCCL at world size 1, started by ``parallel.launch``): each config of
    DDP_DISPATCH_CASES through :func:`_ddp_dispatch_case`; writes
    ``ddp_dispatch.json`` under ``out_dir``."""
    import torch.distributed as dist
    from segdistill_tpu_torch.ops import (group_kl, layer_norm, pixel_kl,
                                          resize_sum, seg_ce, sra_attn)
    from segdistill_tpu_torch.parallel import process_group
    kernels = [resize_sum.KERNEL, sra_attn.KERNEL, group_kl.FWD_KERNEL,
               group_kl.BWD_KERNEL, seg_ce.FWD_KERNEL, seg_ce.BWD_KERNEL,
               pixel_kl.FWD_KERNEL, pixel_kl.BWD_KERNEL, sra_attn.BWD_KERNEL,
               layer_norm.FWD_KERNEL, layer_norm.BWD_KERNEL]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    results = []
    with process_group() as (rank, world):
        backend = dist.get_backend()
        for config, options, tag, batch, hw in DDP_DISPATCH_CASES:
            results.append(_ddp_dispatch_case(
                config, options, tag, kernels, batch, hw, DDP_DISPATCH_K))
            torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = deterministic
    with open(Path(out_dir) / 'ddp_dispatch.json', 'w') as f:
        json.dump(dict(rank=rank, world=world, backend=backend,
                       torch=torch.__version__,
                       nccl='.'.join(map(str, torch.cuda.nccl.version())),
                       cases=results), f)


def phase_ddp_dispatch():
    """(117) Steps per dispatch across processes, on the one card: the DDP
    step (static graph, NCCL at world size 1) of the CGD and PD steps and
    of PSPNet-R50 Cityscapes (SGD) in CUDA graphs against the eager DDP
    steps (:func:`ddp_dispatch_rank`, a process of its own). The command
    line at k = 4 with ``--multi-host`` runs later, beside the fp32 steps
    (:func:`_untimed_processes`). SyncBN, the log vars' mean and EMANet's
    bases take their one-process branch at world size 1: their collectives
    are captured only on several cards. -> each config's launches in a
    replay's trace."""
    from segdistill_tpu_torch.parallel import launch
    log(f'== steps per dispatch under DDP: torchrun\'s variables (RANK 0, '
        f'WORLD_SIZE 1, NCCL), the DDP step as a CUDA graph, a chunk of '
        f'{DDP_DISPATCH_K} replays (steps 999-1000; the random ensemble\'s '
        f'first two that draw both teachers) against the eager DDP '
        f'steps from one snapshot: '
        + ', '.join(tag for _, _, tag, _, _ in DDP_DISPATCH_CASES))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        launch(DDP_DISPATCH_RANK, 1, [tmp], timeout=DDP_DISPATCH_TIMEOUT)
        report = json.loads((Path(tmp) / 'ddp_dispatch.json').read_text())
    log(f"one rank ({report['backend']}, world size {report['world']}, "
        f"torch {report['torch']}, NCCL {report['nccl']}) started, built, "
        f'stepped and traced in {time.perf_counter() - t0:.1f} s')
    if report['backend'] != 'nccl':
        raise AssertionError(f"the rank used {report['backend']}")
    for case in report['cases']:
        tag = case['tag']
        ms = case['ms']
        log(f"{tag} ({case['optimizer']}): {case['graphs']} graph(s), "
            f"capture " + ', '.join(f'{c:.2f}' for c in case['capture_s'])
            + f" s each with the DDP warm-up; against eager: "
            + ('bitwise equal' if not case['differ'] and case['same_logs']
               else f"{case['differ']} tensors differ, the change within "
               f"{case['moved']:.3e} relative L2 of the "
               f"{DISPATCH_EAGER_RUNS} eager runs' (median; theirs from "
               f"each other: {case['noise']:.3e}; {case['table']}; "
               f"nondeterministic: {case['nondeterministic']})"))
        # at world size 1 DDP's all-reduce is in place and NCCL (2.28)
        # launches nothing for it: the graph holds DDP's bucket copies and
        # its division by the world size
        for label, eager_counts, replay_counts in case['traced']:
            log(f"  replay trace{label}: kernels {replay_counts} (eager "
                f"{eager_counts})")
        log(f"  steps {case['steps'][0]}-{case['steps'][1]}"
            + ('' if case['drawn'] is None else
               f", teachers drawn {case['drawn']}")
            + f"; {', '.join(map(str, case['events']))} device events a "
            f"trace; NCCL's kernels: "
            f"{case['nccl'] or 'none'}")
        log(f"  ms a step (host clock, {DDP_DISPATCH_K} steps, in turns): "
            f"eager DDP {', '.join(f'{t:.3f}' for t in ms['eager'])}; graph "
            f"{', '.join(f'{t:.3f}' for t in ms['graph'])}")
        if (case['differ'] or not case['same_logs']) and not case[
                'nondeterministic']:
            raise AssertionError(f'{tag}: the DDP replays differ from the '
                                 f'eager DDP steps with no nondeterministic '
                                 f'operation named')
        if (case['differ'] or not case['same_logs']) and not case[
                'moved'] <= max(TRAIN_GRAD_TOL_REL_L2, 4 * case['noise']):
            raise AssertionError(f'{tag}: the DDP replays differ from the '
                                 f'eager DDP steps')
        if any(r != e for _, e, r in case['traced']):
            raise AssertionError(f'{tag}: the replay launches other counts '
                                 f'of the kernels than the eager DDP step')
        if case['drawn'] is not None:
            _check_mt_ddp(case)
    return {case['tag'] + label: replay for case in report['cases']
            for label, _, replay in case['traced']}


def _check_mt_ddp(case):
    """(117) A random ensemble's DDP chunk: a graph for each teacher drawn,
    each traced replay at the forwards it ran (K1 2, K3/K4 1, K5/K6 1,
    K10 30 + the drawn teacher's LayerNorms, K11 30)."""
    from segdistill_tpu_torch.recipes import MT_TEACHERS
    if case['graphs'] != len(set(case['drawn'])):
        raise AssertionError(f"{case['tag']}: {case['graphs']} graphs for "
                             f"the teachers {case['drawn']}")
    for label, _, replay in case['traced']:
        teacher = int(label.split()[-1].rstrip(')'))
        want = {'resize_sum': 2, 'group_kl_fwd': 1, 'group_kl_bwd': 1,
                'seg_ce_fwd': 1, 'seg_ce_bwd': 1, 'layer_norm_bwd': 30,
                'layer_norm_fwd': MIT_LN['b0']
                + MIT_LN[MT_TEACHERS[teacher]]}
        if replay != want:
            raise AssertionError(f"{case['tag']}{label}: a replay launches "
                                 f"{replay}, the forwards it ran give "
                                 f"{want}")


# (118) MiT's per-block recompute (``with_cp``) on the CGD and PD steps at
# full width: the eager steps with the flag against the same steps without
# it from one snapshot (steps 998-1001, CGD's shuffle drawing at 1000), a
# chunk of REMAT_K replays with the flag against its eager steps, and each
# arm timed in REMAT_ROUNDS turns (REMAT_EAGER_TIMED eager steps, a chunk of
# REMAT_K replays), its peak memory and a trace of each
WITH_CP = {'model.cfg_s.backbone.with_cp': True}
REMAT_K, REMAT_ROUNDS, REMAT_EAGER_TIMED = 4, 2, 5
# K10 and K2 launches a step of the B0 student's recompute: its 8 blocks'
# norm1 and norm2 and the SRA norm of the 6 blocks at sr_ratio > 1; its
# 8 blocks' SRA attention under fused_attention='train'
REMAT_LAUNCHES = {'CGD': {'layer_norm_fwd': 22},
                  'PD': {'layer_norm_fwd': 22, 'sra_attn': 8}}


def _recompute_launches(model):
    """{kernel: launches a step} that the student's recompute adds, from
    its blocks: their LayerNorms (K10) and their SRA attention through
    K2 (``fused_attention='train'``)."""
    from segdistill_tpu_torch.models.backbones.mix_transformer import Block
    from segdistill_tpu_torch.models.utils import FusedLayerNorm
    blocks = [m for m in model.student.backbone.modules()
              if isinstance(m, Block)]
    out = {'layer_norm_fwd': sum(isinstance(m, FusedLayerNorm)
                                 for b in blocks for m in b.modules())}
    k2 = sum(b.attn.fused_attention == 'train' and b.attn.attn_drop.p == 0
             for b in blocks)
    if k2:
        out['sra_attn'] = k2
    return out


def phase_remat(path_kernels, config, options, tag):
    """(118) The ``tag`` step of ``config`` (bf16 backbones, batch 8 at
    512x512; the optimizer capturable, K1's deterministic backward, cuDNN
    deterministic) with the student's ``with_cp`` (each MiT block under a
    non-reentrant checkpoint) against the same step without it: REMAT_K
    eager steps from one snapshot with each, each step's launches those of
    the step without the flag plus the recompute's (REMAT_LAUNCHES, which
    the blocks give: K10 141, PD's K2 16), the two runs bitwise equal or
    within (11)'s limits where PyTorch names an operation that adds with
    atomics; a chunk of REMAT_K replays with the flag against its eager
    steps, the same rule, a replay's trace at the eager counts; then each
    arm, eager and replayed, with and without the flag, timed in turns,
    its memory (the eager peak, the graphs' pool) and its device-busy
    share. -> (the launches of the eager steps with the flag, the
    launches of a replay's trace)."""
    from segdistill_tpu_torch.apis import (init_segmentor_state,
                                           prepare_training)
    from segdistill_tpu_torch.engine import (build_multi_train_step,
                                             make_capturable)
    from segdistill_tpu_torch.tools.profile_train import _union_ms
    k = REMAT_K
    log(f'== with_cp: {tag} (B0 <- B3, bf16 backbones, batch {TRAIN_BATCH} '
        f'at 512x512), the student\'s blocks recomputed in the backward, '
        f'steps {DISPATCH_START + 1}-{DISPATCH_START + k} eagerly with and '
        f'without the flag and as a chunk of {k} replays with it')
    model = init_segmentor_state(
        str(config), seed=0, device=DEVICE,
        cfg_options=dict(NO_CHECKPOINTS, **BF16_BACKBONES, **options,
                         **WITH_CP, **{'runner.steps_per_dispatch': k}))
    backbone = model.student.backbone
    state, multi = prepare_training(model)
    # the graphs without the flag, for the numbers
    plain_multi = build_multi_train_step(model, state.optimizer,
                                         multi.lr_schedule, k)
    single, eager_k1 = multi.step, multi.eager_step
    make_capturable(state.optimizer, torch.device(DEVICE))
    batches = [_train_batch(TRAIN_BATCH, seed=20 + i) for i in range(k)]
    imgs = torch.stack([b[0] for b in batches])
    gts = torch.stack([b[1] for b in batches])
    state.step = DISPATCH_START - 1
    single(state, imgs[-1], gts[-1])
    torch.cuda.synchronize()
    snap = _snapshot(state)
    added = _recompute_launches(model)
    if added != REMAT_LAUNCHES[tag]:
        raise AssertionError(f'{tag}: the student\'s blocks give {added} '
                             f'recomputed launches a step, not '
                             f'{REMAT_LAUNCHES[tag]}')
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager = {}
        for flag in (False, True):
            backbone.with_cp = flag
            _restore(state, snap, DISPATCH_START)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counted = []
            for img, gt in zip(imgs, gts):
                for kn in path_kernels:
                    kn.launches = 0
                logs = single(state, img, gt)
                counted.append({kn.name: kn.launches for kn in path_kernels})
            torch.cuda.synchronize()
            eager[flag] = dict(peak=torch.cuda.max_memory_allocated(),
                               counted=counted, end=_snapshot(state),
                               logs={n: float(v) for n, v in logs.items()})
        differ = [n for n, v in eager[True]['end'].items()
                  if not torch.equal(v, eager[False]['end'][n])]
        moved = _rel_l2(eager[True]['end'], snap, eager[False]['end']) \
            if differ else 0.0
        backbone.with_cp = True
        _restore(state, snap, DISPATCH_START)
        got = multi(state, imgs, gts)
        torch.cuda.synchronize()
        graphs = len(multi.graphed.graphs)
        vs_eager = _unequal(state, eager[True]['end'])
        graph_moved = _moved_rel_l2(state, snap, eager[True]['end']) \
            if vs_eager else 0.0
        graph_logs = {n: float(v) for n, v in got.items()}
        nondeterministic = []
        if differ or vs_eager:
            _restore(state, snap, DISPATCH_START)
            nondeterministic = _nondeterministic_ops(
                lambda: single(state, imgs[0], gts[0]))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    per_step = [f'{c["layer_norm_fwd"]}'
                + (f'/{c["sra_attn"]}' if 'sra_attn' in c else '')
                for c in eager[True]['counted']]
    log(f'launches a step with the flag, K10' + ('/K2' if 'sra_attn' in added
                                                else '')
        + f': {", ".join(per_step)} (the recompute adds {added}); '
        f'{eager[True]["counted"][0]}')
    for i, (base, got_n) in enumerate(zip(eager[False]['counted'],
                                          eager[True]['counted'])):
        want = {n: c + added.get(n, 0) for n, c in base.items()}
        if got_n != want:
            raise AssertionError(f'{tag} with_cp step {i + 1}: launches '
                                 f'{got_n}, the step without the flag and '
                                 f'its recompute give {want}')
    limits = [abs(eager[True]['logs'][n] - want) / (
        100 * CORRECT_TOL_SHARE if 'acc' in n
        else TRAIN_LOSS_TOL_REL * abs(want) + TRAIN_LOSS_TOL_ABS)
        for n, want in eager[False]['logs'].items() if n != 'lr']
    log(f'with the flag against without it (eager, {k} steps): '
        + ('bitwise equal' if not differ else
           f'{len(differ)} tensors differ, e.g. {differ[:4]}, the change '
           f'within {moved:.3e} relative L2, log vars {max(limits):.3f} '
           f'of the loss limit')
        + f'; a chunk of {k} replays ({graphs} graph(s)) against its eager '
        f'steps: ' + ('bitwise equal' if not vs_eager else
                      f'{len(vs_eager)} tensors differ, within '
                      f'{graph_moved:.3e} relative L2')
        + f'; last log vars ' + ', '.join(
            f'{n} {v:.9g}' for n, v in sorted(graph_logs.items())))
    if nondeterministic:
        log(f'operations without a deterministic implementation in the '
            f'step: {nondeterministic}')
    for what, n_differ, dist, lim in (
            ('the flag', differ, moved, max(limits)),
            ('the replays', vs_eager, graph_moved, 0.0)):
        if n_differ and not nondeterministic:
            raise AssertionError(f'{tag}: {what} changed the step with no '
                                 f'nondeterministic operation named')
        if n_differ and not (dist <= TRAIN_GRAD_TOL_REL_L2 and lim <= 1.0):
            raise AssertionError(f'{tag}: {what} changed the step beyond '
                                 f'the fp32 train-step limits')

    # a replay's trace, step 998 with the flag: the eager counts
    def restore():
        _restore(state, snap, DISPATCH_START)
    names = [kn.name for kn in path_kernels]
    want = eager[True]['counted'][0]
    backbone.with_cp = True
    in_graph = _trace_counts(_traced(
        lambda: multi.graphed(state, imgs[:1], gts[:1]), restore, names,
        want), names)
    if in_graph != want:
        raise AssertionError(f'{tag} with_cp: a replay launches {in_graph}, '
                             f'the eager step {want}')
    # the numbers: the eager steps' peak memory allocated, the graphs' pool
    # (a replay allocates nothing), each arm's time in turns and its
    # device-busy share from one trace
    arms = {(True, 'eager'): eager_k1, (False, 'eager'): eager_k1,
            (True, 'graph'): multi, (False, 'graph'): plain_multi}
    memory = {(f, 'eager'): eager[f]['peak'] for f in (False, True)}
    backbone.with_cp = False
    restore()
    plain_multi(state, imgs, gts)  # the graphs without the flag
    torch.cuda.synchronize()
    for flag in (False, True):
        memory[flag, 'graph'] = _pool_bytes(arms[flag, 'graph'].graphed.pool)
    times = {arm: [] for arm in arms}
    order = list(arms)
    for r in range(REMAT_ROUNDS):
        for flag, kind in (order if r % 2 == 0 else order[::-1]):
            backbone.with_cp = flag
            restore()
            torch.cuda.synchronize()
            if kind == 'eager':
                for i in range(REMAT_EAGER_TIMED):
                    t0 = time.perf_counter()
                    eager_k1(state, imgs[i % k], gts[i % k])
                    torch.cuda.synchronize()
                    times[flag, kind].append(
                        (time.perf_counter() - t0) * 1e3)
            else:
                t0 = time.perf_counter()
                arms[flag, kind](state, imgs, gts)
                torch.cuda.synchronize()
                times[flag, kind].append((time.perf_counter() - t0) / k * 1e3)
    busy = {}
    for (flag, kind), runner in arms.items():
        backbone.with_cp = flag
        fn = (lambda: runner(state, imgs[0], gts[0])) if kind == 'eager' \
            else (lambda: runner.graphed(state, imgs[:1], gts[:1]))
        busy[flag, kind] = _union_ms(_traced(fn, restore))
    backbone.with_cp = True
    for (flag, kind), ts in times.items():
        med = float(np.median(ts))
        log(f'{tag} {"with_cp" if flag else "plain"} {kind}: '
            f'{", ".join(f"{t:.3f}" for t in ts)} ms a step (host clock; '
            f'median {med:.3f}); '
            + ('peak memory allocated' if kind == 'eager' else 'graph pool')
            + f' {memory[flag, kind] / 2**30:.3f} GiB; device busy '
            f'{busy[flag, kind]:.3f} ms a step, {busy[flag, kind] / med:.1%}'
            f' of the median')
    report = {f'{"with_cp" if f else "plain"} {kind}': dict(
        ms=float(np.median(times[f, kind])), gib=memory[f, kind] / 2**30,
        busy_ms=busy[f, kind]) for f, kind in arms}
    log(f'{tag} with_cp numbers: {json.dumps(report)}')
    launches = {n: sum(c[n] for c in eager[True]['counted']) for n in names}
    _check_launched(launches, f'{tag} with_cp training')
    del arms, multi, plain_multi, state, model
    gc.collect()  # the graphs and their pools, held in reference cycles
    torch.cuda.empty_cache()
    return launches, in_graph


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


def _untimed_processes(export_dir, programs, cli_root, cli_train):
    """The checks that run in processes of their own and time nothing, one
    after another: the exported programs' loader (110) and the command
    lines under torchrun's variables (101; 117's at k = 4). -> the
    loader's report."""
    report = run_export_loader(export_dir, programs)
    phase_cli_multi_host(cli_root, cli_train)
    phase_cli_dispatch(cli_root, cli_train, multi_host=True)
    return report


def _other_untimed_processes(cli_root, want):
    """The rest of them, beside :func:`_untimed_processes`: the other
    configs under steps per dispatch (116), then the sharded evaluation
    (102)."""
    _dispatch_try_process()
    phase_dist_eval(cli_root, want)


def main():
    card = phase_device()
    sys.path.insert(0, str(ROOT))
    from segdistill_tpu_torch.ops import (group_kl, layer_norm, pixel_kl,
                                          resize_sum, seg_ce, sra_attn)
    k1, k2, k3, k4, k5, k6, k7, k8, k9, k10, k11 = kernels = [
        resize_sum.KERNEL, sra_attn.KERNEL, group_kl.FWD_KERNEL,
        group_kl.BWD_KERNEL, seg_ce.FWD_KERNEL, seg_ce.BWD_KERNEL,
        pixel_kl.FWD_KERNEL, pixel_kl.BWD_KERNEL, sra_attn.BWD_KERNEL,
        layer_norm.FWD_KERNEL, layer_norm.BWD_KERNEL]
    # this slice: the serving export traces while the kernels build (it
    # launches nothing)
    export_dir = Path(tempfile.mkdtemp(prefix='export-'))
    atexit.register(shutil.rmtree, export_dir, True)
    with ThreadPoolExecutor(1) as pool:
        build = pool.submit(phase_build, kernels)
        programs = export_programs(export_dir)
        build.result()
    results = {k1.name: phase_resize_sum(), k2.name: phase_sra_attn()}
    results[k3.name], results[k4.name] = phase_group_kl()
    results[k5.name], results[k6.name], ce_device = phase_seg_ce()
    results[k7.name], results[k8.name] = phase_pixel_kl()
    _check_fwd_tickets('seg_ce and pixel_kl phases')
    results[k9.name] = phase_sra_train()
    results[k10.name], results[k11.name], k10_floor = phase_layer_norm()
    launches = {k.name: 0 for k in kernels}
    cgd_kernels = [k1, k3, k4, k5, k6, k10, k11]
    paths = [phase_serving([k1, k2, k10])]
    cgd_launches, _, cgd_ms = phase_train(cgd_kernels, CGD_CONFIG, {}, 'CGD')
    paths.append(cgd_launches)
    cgd_per_step = {k: n // TRAIN_STEPS for k, n in cgd_launches.items()}
    phase_train_vs_cpu(CGD_CONFIG, TEACHER_DEPTH_CUT, 'CGD',
                       pair=f'B0 <- {B3_AT_B2_DEPTH}')
    pd_launches, pd_last, _ = phase_train(
        [k1, k2, k5, k6, k7, k8, k9, k10, k11], PD_CONFIG, STUDENT_FA_TRAIN,
        'PD')
    _pd_loss_check(pd_last)
    paths.append(pd_launches)
    phase_train_vs_cpu(PD_CONFIG, dict(STUDENT_FA_TRAIN, **TEACHER_DEPTH_CUT),
                       'PD', pair=f'B0 <- {B3_AT_B2_DEPTH}')
    # this slice: steps per dispatch, the CGD and PD steps replayed from
    # CUDA graphs against the same steps run eagerly (113, 114)
    dispatch = {'CGD': phase_dispatch(cgd_kernels, CGD_CONFIG, {}, 'CGD'),
                'PD': phase_dispatch([k1, k2, k5, k6, k7, k8, k9, k10, k11],
                                     PD_CONFIG, STUDENT_FA_TRAIN, 'PD')}
    # this slice: the student's per-block recompute (with_cp) on the CGD
    # and PD steps, eager and replayed, against the steps without it (118)
    for tag, config, kernels_of, options in (
            ('CGD', CGD_CONFIG, cgd_kernels, {}),
            ('PD', PD_CONFIG, [k1, k2, k5, k6, k7, k8, k9, k10, k11],
             STUDENT_FA_TRAIN)):
        eager_cp, dispatch[f'{tag} with_cp'] = phase_remat(
            kernels_of, config, options, tag)
        paths.append(eager_cp)
    # the command lines' dataset and work dirs, kept for the --multi-host
    # command lines and the sharded evaluation
    cli_root = Path(tempfile.mkdtemp(prefix='cli-'))
    atexit.register(shutil.rmtree, cli_root, True)
    cli_launches, cli_train, _ = phase_cli(cgd_kernels, cli_root)
    paths.append(cli_launches)
    phase_cli_dispatch(cli_root, cli_train)  # k = 4 (115)
    # this slice: the DDP step as a CUDA graph, NCCL at world size 1 (117)
    dispatch.update((f'DDP {tag}', counts) for tag, counts in
                    phase_ddp_dispatch().items())
    # this slice: the native and device loader backends on the command
    # line, the device augmentation against the CPU, batched evaluation
    paths.append(phase_cli_backends(cgd_kernels, cli_root, cli_train,
                                    cgd_per_step, card))
    phase_device_aug(cli_root, card)
    paths.append(phase_batched_eval([k1, k10], cli_root, card))
    # The timed phases of the later slices come first; their fp32 steps
    # against the CPU, which time nothing, follow in one block (below).
    # The Tab5 PSP and Swin students: serving and the timed CGD steps (the
    # PSP student has no LayerNorm: K11 runs only on the Swin path)
    paths.append(phase_serving_tab5(PSP_BASELINE, [], 'PSP'))
    paths.append(phase_serving_tab5(SWIN_BASELINE, [k10], 'Swin'))
    paths.append(phase_train([k1, k3, k4, k5, k6, k10], PSP_CGD, {},
                             'psp_CGD', TAB5_BATCH,
                             'PSPNet-R50 student <- B3 teacher')[0])
    paths.append(phase_train([k1, k3, k4, k5, k6, k10, k11], SWIN_CGD, {},
                             'swin_CGD', TAB5_BATCH,
                             'Swin-T + UPerHead student <- B3 teacher')[0])
    from segdistill_tpu_torch import recipes
    # the configs/extra models: their own SGD steps (K5/K6 on the decode and
    # auxiliary heads, on PointRend's FPNHead) and serving (no hand-written
    # kernel on those paths: ResNet has BN, the heads no K1)
    for config, tag, classes, hw, per_step, _ in EXTRA_PATHS:
        paths.append(phase_train_extra([k5, k6], config, tag, classes, hw,
                                       per_step))
    for config, tag, classes, _, _, request_hw in EXTRA_PATHS:
        phase_serving_extra(config, tag, classes, request_hw)
    # the Cityscapes recipes: SGD steps (K5/K6 at ratios 2, 4 and 8 of the
    # 512x1024 crop) and 1024x2048 whole-mode serving
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
    # the multi-teacher CGD steps (K1, K3/K4, K5/K6, K10/K11 counted a step
    # against the forwards each ran); the last A10 recipes' SGD steps
    # (K5/K6 on the ResNeSt PSPNet's two heads and at 2 classes on the UNet
    # heads, at ratios 1 and 2; Fast-SCNN and CGNet take no kernel) and
    # their serving (Cityscapes whole mode at 1024x2048; UNet slide windows
    # on an HRF and a DRIVE image)
    mt_kernels = [k1, k3, k4, k5, k6, k10, k11]
    for name, tag in MT_PATHS:
        paths.append(phase_train_mt(mt_kernels, name, tag))
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
                        [HRF_REQUEST_HW])
    for name, tag, *_ in ZOO2_PATHS[4:]:
        phase_serving_slide(drive_recipe(f'{name}_drive'),
                            tag.replace('HRF', 'DRIVE'), [DRIVE_REQUEST_HW])
    # the attention-head recipes' SGD steps (K5/K6 at ATTN_CE_GEOMETRY
    # alone, 4 a step for DANet's three CEs and the auxiliary head's, 2 for
    # the others; EMANet's bases move and its frozen conv stays put) and a
    # 1024x2048 whole-mode request each
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
    # The fp32 steps against the CPU (the Tab5 pairs, where the PSP pair
    # takes K3/K4 and K7/K8 at two sizes and Swin's last PatchMerging norm
    # K10/K11 at C = 1536; the configs/extra models; the Cityscapes, MT,
    # A10 and attention recipes, every head's fp32 logits first where
    # named; ResNeXt as a backbone alone). They time nothing, so the checks
    # that run in processes of their own and time nothing either run beside
    # them in two chains: the exported programs' loader (110) and the
    # command lines under torchrun's variables (101, 117); the other
    # configs under steps per dispatch (116), whose checks compare runs and
    # time nothing, and the sharded evaluation (102)
    want = _one_process_eval(cli_root)
    with ThreadPoolExecutor(2) as pool:
        beside = pool.submit(_untimed_processes, export_dir, programs,
                             cli_root, cli_train)
        other_beside = pool.submit(_other_untimed_processes, cli_root, want)
        tab5_vs_cpu = dict(batch=TAB5_VS_CPU_BATCH, hw=TAB5_VS_CPU_HW,
                           float64_grads=True)
        phase_train_vs_cpu(PSP_CGD, TEACHER_DEPTH_CUT, 'psp_CGD',
                           pair=f'PSPNet-R50 <- {B3_AT_B2_DEPTH}',
                           no_drop=(NO_DROP,), **tab5_vs_cpu)
        phase_train_vs_cpu(PSP_PD, TEACHER_DEPTH_CUT, 'psp_PD',
                           pair=f'PSPNet-R50 <- {B3_AT_B2_DEPTH}',
                           no_drop=(NO_DROP,), **tab5_vs_cpu)
        phase_train_vs_cpu(SWIN_CGD, TEACHER_DEPTH_CUT, 'swin_CGD',
                           pair=f'Swin-T <- {B3_AT_B2_DEPTH}', **tab5_vs_cpu)
        # this slice: the CGD step with the student's with_cp (118)
        phase_train_vs_cpu(CGD_CONFIG, dict(TEACHER_DEPTH_CUT, **WITH_CP),
                           'CGD with_cp', pair=f'B0 <- {B3_AT_B2_DEPTH}')
        for config, tag, classes, *_ in EXTRA_PATHS:
            phase_extra_vs_cpu(config, tag, classes)
        for recipe, tag, _, _, _, vs_cpu in ZOO_PATHS:
            if vs_cpu:
                phase_extra_vs_cpu(cityscapes_recipe(recipe), tag,
                                   ZOO_CLASSES, hw=ZOO_VS_CPU_HW, logits=True,
                                   acc_share=CORRECT_TOL_SHARE,
                                   fp32_floor=FP32_FLOOR_FACTOR)
        for name, tag in MT_PATHS:
            phase_mt_vs_cpu(name, tag)
        for name, tag, classes, *_ in ZOO2_PATHS:
            phase_extra_vs_cpu(recipes.recipe(name), tag, classes,
                               hw=ZOO2_VS_CPU_HW[classes], logits=True,
                               acc_share=CORRECT_TOL_SHARE,
                               fp32_floor=FP32_FLOOR_FACTOR)
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
        export_report = beside.result()
        other_beside.result()
    # this slice: Pascal VOC 2012 + SBD and Pascal Context (107-109): the
    # voc_aug converter and the datasets on PNG files, the VOC12-aug recipe
    # on the command line (K5/K6 twice an iteration at 21 classes) with
    # --show-dir, a Cityscapes submission written, in-memory steps of both
    # recipes (K5/K6 at 21 and 60 classes), fp32 steps against the CPU, two
    # Context requests in slide mode, K5/K6's fp32 device times there
    voc_name, voc_tag = 'pspnet_r50-d8_voc12aug', 'PSPNet-R50-d8 VOC12-aug'
    ctx_name, ctx_tag = ('pspnet_r50-d8_pascal_context',
                         'PSPNet-R50-d8 Pascal Context')
    with tempfile.TemporaryDirectory() as tmp:
        devkit, voc_val = phase_voc_convert(Path(tmp))
        paths.append(phase_voc_cli([k5, k6], Path(tmp), devkit, voc_val))
        _check_results2img(Path(tmp))
    for name, tag, classes, hw in ((voc_name, voc_tag, VOC_CLASSES, VOC_HW),
                                   (ctx_name, ctx_tag, CONTEXT_CLASSES,
                                    CONTEXT_HW)):
        paths.append(phase_train_extra([k5, k6], recipes.recipe(name), tag,
                                       classes, hw, 2, PASCAL_STEPS,
                                       PASCAL_BATCH))
    for name, tag, classes in ((voc_name, voc_tag, VOC_CLASSES),
                               (ctx_name, ctx_tag, CONTEXT_CLASSES)):
        phase_extra_vs_cpu(recipes.recipe(name), tag, classes,
                           hw=PASCAL_VS_CPU_HW, logits=True,
                           acc_share=CORRECT_TOL_SHARE,
                           fp32_floor=FP32_FLOOR_FACTOR)
    phase_serving_slide(recipes.recipe(ctx_name), ctx_tag,
                        CONTEXT_REQUEST_HW, classes=CONTEXT_CLASSES,
                        warm_hw=CONTEXT_REQUEST_HW[0])
    pascal_fp32 = phase_pascal_kernel_times()
    loaded = [m for m in ('cv2', 'PIL') if m in sys.modules]
    if loaded:
        raise AssertionError(f'the PNG data path imported {loaded}')
    # this slice: the tool twins, the miniature convergence run (its JPEG
    # images go through OpenCV: after the PNG check above) and the serving
    # export's requests (K1, K10 and, with fused_attention, K2 as custom
    # operators of the saved programs) against eager
    with tempfile.TemporaryDirectory() as tmp:
        phase_tools(Path(tmp), card)
    conv_launches, conv_times = phase_convergence(
        [k1, k3, k4, k5, k6, k10, k11])
    paths.extend(phase_export(export_dir, programs, export_report,
                              [k1, k2, k10]))
    paths.extend(conv_launches.values())
    # the CGD step at two ranks sharing the card (gloo), each rank's
    # launches counted in its own process and added here
    paths.append(phase_dist_train(cgd_kernels, cgd_ms))
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
        # this slice: launches a step in the CGD and PD graphs' replays
        # (their profiler traces; the wrappers do not count a replay)
        replayed = {tag: d[k.name] for tag, d in dispatch.items()
                    if k.name in d}
        entries[-1]['replay_launches_per_step'] = replayed
        entries[-1]['replayed'] = any(n > 0 for n in replayed.values())
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
    # K5/K6 at the Pascal recipes' geometries (bf16 device time, fp32
    # beside it), with the launches their paths made there
    for case, tags in ((VOC_CE_GEOMETRY, ('VOC12-aug command line',
                                          voc_tag)),
                       (CONTEXT_CE_GEOMETRY, (ctx_tag,))):
        _, shape, out_hw, _, _ = next(c for c in _cases().SEG_CE_CASES
                                      if c[0] == case)
        geometry = tuple(shape) + tuple(out_hw)
        times, fp32 = ce_device[case], pascal_fp32[case]
        for i, (k, bound) in enumerate(zip((k5, k6), _cases().seg_ce_bounds(
                shape, out_hw, torch.bfloat16))):
            entries.append({
                'name': f'{k.name} {shape} -> {out_hw[0]}x{out_hw[1]}',
                'route': 'cuda', 'source': str(k.source.relative_to(ROOT)),
                'replaces': k.replaces,
                'launches': sum(CE_SHAPE_LAUNCHES[t][k.name].get(geometry, 0)
                                for t in tags),
                'max_abs_err': results[k.name][(case, torch.float32)][0],
                'ms': times[2 * i], 'plain_ms': times[2 * i + 1],
                'bound_ms': bound[0], 'bound_by': bound[1],
                'library_ms': None, 'fp32_ms': fp32[2 * i],
                'fp32_plain_ms': fp32[2 * i + 1]})
    # K3/K4 and K5/K6 at the convergence run's shape (fp32, device time),
    # with the launches its two runs made there (K3/K4: the CGD run)
    for k, case, runs in ((k3, _cases().CONVERGENCE_GKL, ('cgd',)),
                          (k4, _cases().CONVERGENCE_GKL, ('cgd',)),
                          (k5, _cases().CONVERGENCE_CE, ('baseline', 'cgd')),
                          (k6, _cases().CONVERGENCE_CE,
                           ('baseline', 'cgd'))):
        name, shape, out_hw = case[:3]
        bounds = _cases().kl_bounds(shape, out_hw, torch.float32, 0) \
            if k in (k3, k4) else _cases().seg_ce_bounds(shape, out_hw,
                                                         torch.float32)
        bound = bounds[0 if k in (k3, k5) else 1]
        ms, plain_ms = conv_times[k.name]
        entries.append({
            'name': f'{k.name} {shape} -> {out_hw[0]}x{out_hw[1]} fp32',
            'route': 'cuda', 'source': str(k.source.relative_to(ROOT)),
            'replaces': k.replaces,
            'launches': sum(conv_launches[r][k.name] for r in runs),
            'max_abs_err': results[k.name][(name, torch.float32)][0],
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound[0],
            'bound_by': bound[1], 'library_ms': None})
    log('launches per path: ' + json.dumps(
        dict(zip(('serving', 'CGD', 'PD', 'CGD with_cp', 'PD with_cp',
                  'command line',
                  'command line, native and device loaders',
                  'batched evaluation', 'PSP serving', 'Swin serving',
                  'psp_CGD', 'swin_CGD')
                 + tuple(tag for _, tag, *_ in EXTRA_PATHS)
                 + tuple(tag for _, tag, *_ in ZOO_PATHS)
                 + tuple(tag for _, tag in MT_PATHS)
                 + tuple(tag for _, tag, *_ in ZOO2_PATHS)
                 + tuple(attn_tags)
                 + ('VOC12-aug command line', voc_tag, ctx_tag)
                 + ('export, eager, plain', 'export, eager, fused')
                 + tuple(f'export, loaded .pt2, {tag}, '
                         f'{"logits" if logits else "labels"}'
                         for tag, _, logits in EXPORT_PROGRAMS)
                 + ('convergence baseline', 'convergence CGD')
                 + ('CGD, two ranks on one card',),
                 paths))))
    log(f'== all phases done in {time.perf_counter() - T0:.1f} s')
    print(json.dumps({'kernels': entries}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
