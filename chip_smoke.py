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
reproduces the last evaluation's mIoU. The launch count of
each kernel is read over each main path (9, 10, 12 and 14).

Any failed check raises, and the script exits non-zero. It needs a CUDA
device and the repository around it. The second line before the last is
a JSON object with one entry per kernel (its time at its main path's
shape beside the plain version's, the least time the card could take for
that work, and a PyTorch library call's where one computes the same
function); the last line is ``{"ok": true, "device": {...}}``.
"""

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
# the config's checkpoints are not in the repository: random weights
NO_CHECKPOINTS = {'model.t_pretrain': None, 'model.s_pretrain': None,
                  'model.cfg_s.pretrained': None}
# the student's SRA attention through K2 and its backward K9
STUDENT_FA_TRAIN = {'model.cfg_s.backbone.fused_attention': 'train'}
BF16_BACKBONES = {'model.cfg_s.backbone.dtype': 'bfloat16',
                  'model.cfg_t.backbone.dtype': 'bfloat16'}
NUM_CLASSES = 150
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS = 8, 2, 10
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
    return fwd, bwd


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
    return fwd, bwd


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


def _check_launched(launches, path):
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f'kernel {name} was not launched on the '
                                 f'{path} path')


def _train_batch(batch, seed):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    img = torch.randn(batch, 3, 512, 512, device=DEVICE, generator=gen)
    gt = torch.randint(0, NUM_CLASSES, (batch, 512, 512), device=DEVICE,
                       generator=gen)
    return img, gt


def phase_train(path_kernels, config, options, tag):
    """The distillation train step of ``config`` with bf16 backbones (and
    ``options``) at batch 8: -> the launch counts of ``path_kernels`` over
    the timed steps, and the last step's log vars."""
    from segdistill_tpu_torch.apis import (init_segmentor_state,
                                           prepare_training)
    log(f'== train: {tag}, B0 student <- B3 teacher, bf16 backbones, batch '
        f'{TRAIN_BATCH} at 512x512, random weights (seed 0)')
    t0 = time.perf_counter()
    model = init_segmentor_state(
        str(config), seed=0, device=DEVICE,
        cfg_options=dict(NO_CHECKPOINTS, **BF16_BACKBONES, **options))
    state, train_step = prepare_training(model)
    img, gt = _train_batch(TRAIN_BATCH, seed=5)
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
        f'{TRAIN_BATCH * TRAIN_STEPS / seconds:.2f} images/s over '
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


def _loss_and_grads(model, img, gt, perm):
    from segdistill_tpu_torch.models.segmentors import parse_losses
    model.zero_grad(set_to_none=True)
    total, log_vars = parse_losses(model.forward_train(img, gt, 1000,
                                                       perm=perm))
    total.backward()
    return ({k: float(v.detach()) for k, v in log_vars.items()},
            {n: p.grad.detach().cpu() for n, p in
             model.student.named_parameters()})


def phase_train_vs_cpu(config, options, tag):
    from segdistill_tpu_torch.apis import init_segmentor_state
    log(f'== train step, fp32 GPU (kernels) vs CPU (plain versions): the '
        f'same B0 <- B3 {tag} model, batch 2 at 512x512, dropout and '
        f'drop-path 0, step 1000 (a CGD step: one seeded channel '
        f'permutation)')
    model = init_segmentor_state(
        str(config), seed=0, device=DEVICE,
        cfg_options=dict(NO_CHECKPOINTS, **options, **{
            'model.cfg_s.decode_head.dropout_ratio': 0.0,
            'model.cfg_t.decode_head.dropout_ratio': 0.0,
            'model.cfg_s.backbone.drop_path_rate': 0.0,
            'model.cfg_t.backbone.drop_path_rate': 0.0}))
    cpu_model = copy.deepcopy(model).cpu()
    img, gt = _train_batch(2, seed=6)
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
    num = sum(float((gpu_grads[n] - g).square().sum())
              for n, g in cpu_grads.items())
    den = sum(float(g.square().sum()) for g in cpu_grads.values())
    grad_rel = math.sqrt(num / den)
    log(f'loss terms: {worst:.3f} of the limit {TRAIN_LOSS_TOL_REL} * '
        f'|loss| + {TRAIN_LOSS_TOL_ABS} used at most; student gradients: '
        f'relative L2 err {grad_rel:.3e} over {len(cpu_grads)} tensors '
        f'(limit {TRAIN_GRAD_TOL_REL_L2})')
    if not (worst <= 1.0 and grad_rel <= TRAIN_GRAD_TOL_REL_L2):
        raise AssertionError('the GPU train step differs from the CPU one')


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
    results[k5.name], results[k6.name] = phase_seg_ce()
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
    log('launches per path: ' + json.dumps(
        dict(zip(('serving', 'CGD', 'PD', 'command line'), paths))))
    print(json.dumps({'kernels': entries}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
