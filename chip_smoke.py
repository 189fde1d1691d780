#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA
GPU.

    python3 chip_smoke.py

Phases: (1) device, (2) build the hand-written kernels from csrc/, one nvcc
per source, all at once, (3) K1 resize_sum, (4) K2 sra_attn, (5) K3/K4
group-KL forward and backward, (6) K5/K6 seg-CE forward and backward, (7)
K7/K8 pixel-KL forward and backward and (8) K9, the SRA backward, with K2
keeping the row log-sum-exp, against their plain PyTorch versions at the
main paths' shapes, with CUDA-event timings, (9) full-width Segformer-B0
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
``fused_attention='train'``. The launch count of each kernel is read over
each main path (9, 10 and 12).

Any failed check raises, and the script exits non-zero. It needs a CUDA
device and the repository around it. The second line before the last is
a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

import copy
import json
import math
import subprocess
import sys
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
    from segdistill_tpu_torch.utils.timing import cuda_ms
    log('== K1 resize_sum vs plain (N(0,1) parts)')
    rng = np.random.RandomState(0)
    cases = []
    for b, e in ((1, 256), (8, 256), (8, 768)):  # B0 head; B3 head E=768
        cases.append((f'B0 head b{b} E{e}',
                      [(b, 16, 16, e), (b, 32, 32, e), (b, 64, 64, e)],
                      (128, 128)))
    cases.append(('non-integer ratio', [(2, 15, 20, 256), (2, 23, 31, 256)],
                  (61, 83)))
    results = {}
    for name, shapes, out_hw in cases:
        for dtype in (torch.float32, torch.bfloat16):
            parts = [torch.from_numpy(rng.randn(*s).astype(np.float32))
                     .to(DEVICE, dtype) for s in shapes]
            got = fused_resize_sum(parts, out_hw)
            torch.cuda.synchronize()
            want = resize_sum_plain([p.float() for p in parts], out_hw)
            err, used = check_close(f'resize_sum {name} {dtype}', got, want)
            ms = cuda_ms(lambda: fused_resize_sum(parts, out_hw))
            plain_ms = cuda_ms(lambda: resize_sum_plain(parts, out_hw))
            results[(name, dtype)] = (err, ms, plain_ms)
            log(f'{name:20s} {str(dtype):15s} max_abs_err {err:.3e} '
                f'(tol used {used:.3f})  kernel {ms:.4f} ms  '
                f'plain {plain_ms:.4f} ms')
    return results


def _head_split(b, rows, heads, d, n_maps, rng, dtype):
    """``n_maps`` (b, heads, rows, d) views of one (b, rows, n_maps*heads*d)
    linear output, split as the MiT attention splits q and kv."""
    mem = torch.from_numpy(rng.randn(b, rows, n_maps * heads * d)
                           .astype(np.float32)).to(DEVICE, dtype)
    return mem.view(b, rows, n_maps, heads, d).permute(2, 0, 3, 1, 4)


def phase_sra_attn():
    from segdistill_tpu_torch.ops.sra_attn import (fused_sra_attention,
                                                   sra_attention_plain)
    from segdistill_tpu_torch.utils.timing import cuda_ms
    log('== K2 sra_attn vs plain (N(0,1) q, k, v, strided head views as '
        'the model passes them)')
    rng = np.random.RandomState(1)
    cases = []
    for b in (1, 8):  # B0 at 512^2: (heads, N) per stage, M = 256, d = 32
        for s, (h, n) in enumerate(((1, 16384), (2, 4096), (5, 1024),
                                    (8, 256))):
            cases.append((f'B0 stage{s + 1} b{b}', b, h, n, 256, 32))
    cases.append(('ragged N, M', 2, 2, 1000, 100, 32))
    cases.append(('b1-b5 stage1 d64', 2, 1, 16384, 256, 64))
    cases.append(('d128', 1, 2, 300, 70, 128))
    results = {}
    for name, b, h, n, m, d in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q = _head_split(b, n, h, d, 1, rng, dtype)[0]
            k, v = _head_split(b, m, h, d, 2, rng, dtype)
            scale = d ** -0.5
            got = fused_sra_attention(q, k, v, scale)
            torch.cuda.synchronize()
            want = sra_attention_plain(q.float(), k.float(), v.float(), scale)
            err, used = check_close(f'sra_attn {name} {dtype}', got, want)
            ms = cuda_ms(lambda: fused_sra_attention(q, k, v, scale))
            plain_ms = cuda_ms(lambda: sra_attention_plain(q, k, v, scale))
            results[(name, dtype)] = (err, ms, plain_ms)
            log(f'{name:20s} {str(dtype):15s} max_abs_err {err:.3e} '
                f'(tol used {used:.3f})  kernel {ms:.4f} ms  '
                f'plain {plain_ms:.4f} ms')
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
    gradient with the incoming gradient that makes max |plain dxs| = 1, and
    both directions timed. -> (loss err, fwd ms, plain fwd ms), (dxs err,
    bwd ms, plain bwd ms)."""
    a = xs.float().requires_grad_()
    want = plain(a, xt.float())
    (dunit,) = torch.autograd.grad(want, a)
    gbar, dwant = _scaled_grads(want, dunit)
    k = xs.clone().requires_grad_()
    loss = fused(k, xt)
    (dxs,) = torch.autograd.grad(loss, k, gbar, retain_graph=True)
    torch.cuda.synchronize()
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


def phase_group_kl():
    from segdistill_tpu_torch.ops import group_kl as gk
    log('== K3/K4 group_kl vs plain (N(0,1) maps, tau 2; backward with the '
        'incoming gradient that makes max |plain dxs| = 1)')
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    tau = 2.0
    cases = [('CGD bench perm', (8, 150, 128, 128), (512, 512), True),
             ('CGD bench identity', (8, 150, 128, 128), (512, 512), False),
             ('C19 g10 pad', (2, 19, 64, 64), (256, 256), True),
             ('non-integer ratio', (2, 150, 30, 40), (125, 161), True)]
    fwd, bwd = {}, {}
    for name, shape, out_hw, shuffle in cases:
        perm = torch.randperm(shape[1], device=DEVICE, generator=gen) \
            if shuffle else None
        for dtype in (torch.float32, torch.bfloat16):
            xs = torch.randn(shape, device=DEVICE, generator=gen).to(dtype)
            xt = torch.randn(shape, device=DEVICE, generator=gen).to(dtype)
            fwd[(name, dtype)], bwd[(name, dtype)] = _loss_case(
                f'group_kl {name} {dtype}', xs, xt,
                lambda a, t: gk.fused_group_kl_shuffled(a, t, perm, out_hw,
                                                        10, tau)
                if shuffle else gk.fused_group_kl(a, t, out_hw, 10, tau),
                lambda a, t: gk.group_kl_plain(a, t, perm, out_hw, 10, tau))
    return fwd, bwd


def phase_pixel_kl():
    from segdistill_tpu_torch.ops import pixel_kl as pk
    log('== K7/K8 pixel_kl vs plain (N(0,1) maps, tau 1; backward with the '
        'incoming gradient that makes max |plain dxs| = 1)')
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    cases = [('PD bench', (8, 150, 128, 128), (512, 512)),
             ('non-integer ratio', (2, 150, 30, 40), (125, 161)),
             ('ratio 1', (2, 150, 64, 64), (64, 64))]
    fwd, bwd = {}, {}
    for name, shape, out_hw in cases:
        for dtype in (torch.float32, torch.bfloat16):
            xs = torch.randn(shape, device=DEVICE, generator=gen).to(dtype)
            xt = torch.randn(shape, device=DEVICE, generator=gen).to(dtype)
            fwd[(name, dtype)], bwd[(name, dtype)] = _loss_case(
                f'pixel_kl {name} {dtype}', xs, xt,
                lambda a, t: pk.fused_pixel_kl(a, t, out_hw, 1.0),
                lambda a, t: pk.pixel_kl_plain(a, t, out_hw, 1.0))
    return fwd, bwd


def phase_sra_train():
    from segdistill_tpu_torch.ops.sra_attn import (sra_attention_plain,
                                                   sra_attention_train)
    from segdistill_tpu_torch.utils.timing import cuda_ms
    log('== K9 sra_attn_bwd (after K2 keeping the row log-sum-exp) vs the '
        'autograd of the plain version (N(0,1) q, k, v and dO, strided head '
        'views as the model passes them; each gradient and its plain '
        'version divided by the plain one\'s max |value|)')
    rng = np.random.RandomState(9)
    cases = [(f'B0 stage{s + 1} b8', 8, h, n, 256, 32) for s, (h, n) in
             enumerate(((1, 16384), (2, 4096), (5, 1024), (8, 256)))]
    cases.append(('ragged N, M', 2, 2, 1000, 100, 32))
    cases.append(('b1-b5 stage1 d64', 2, 1, 16384, 256, 64))
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
            torch.cuda.synchronize()
            ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
            want_out = sra_attention_plain(*ref, scale)
            want = torch.autograd.grad(want_out, ref, g.float())
            errs = [check_close(f'sra_train {name} {dtype} out', out,
                                want_out.detach())[0]]
            used = 0.0
            for tag, a, w in zip(('dq', 'dk', 'dv'), got, want):
                if a.shape != w.shape or a.dtype != dtype:
                    raise AssertionError(f'sra_train {name}: {tag} is '
                                         f'{a.dtype} {tuple(a.shape)}')
                peak = w.abs().max()
                e, u = check_close(f'sra_train {name} {dtype} {tag}',
                                   a.float() / peak, w / peak, dtype)
                errs.append(e)
                used = max(used, u)
            plain_in = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            plain_out = sra_attention_plain(*plain_in, scale)
            ms = cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), g,
                                                     retain_graph=True))
            plain_ms = cuda_ms(lambda: torch.autograd.grad(
                plain_out, plain_in, g, retain_graph=True))
            fwd_ms = cuda_ms(lambda: sra_attention_train(q, k, v, scale))
            results[(name, dtype)] = (max(errs), ms, plain_ms)
            log(f'{name:20s} {str(dtype):15s} max_abs_err {max(errs):.3e} '
                f'(gradients use {used:.3f} of the tol)  bwd {ms:.4f} ms  '
                f'plain bwd {plain_ms:.4f} ms  fwd with lse {fwd_ms:.4f} ms')
    return results


def phase_seg_ce():
    from segdistill_tpu_torch.ops import seg_ce as sc
    log('== K5/K6 seg_ce vs plain (N(0,1) logits, labels in [0, 150) with a '
        'share set to 255; backward with the incoming gradient that makes '
        'max |plain dz| = 1)')
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    cases = [('head CE bench', (8, 150, 128, 128), (512, 512), 0.05),
             ('non-integer ratio', (2, 150, 30, 40), (125, 161), 0.05),
             ('all ignored', (2, 150, 32, 32), (128, 128), 1.0)]
    fwd, bwd = {}, {}
    for name, shape, out_hw, ignored in cases:
        labels = torch.randint(0, NUM_CLASSES, (shape[0],) + out_hw,
                               device=DEVICE, generator=gen)
        labels[torch.rand(labels.shape, device=DEVICE, generator=gen)
               < ignored] = 255
        for dtype in (torch.float32, torch.bfloat16):
            z = torch.randn(shape, device=DEVICE, generator=gen).to(dtype)
            a = z.float().requires_grad_()
            want, want_correct = sc.seg_ce_plain(a, labels, out_hw,
                                                 NUM_CLASSES)
            (dunit,) = torch.autograd.grad(want, a)
            gbar, dwant = _scaled_grads(want, dunit)
            k = z.clone().requires_grad_()
            ce, correct = sc.fused_seg_ce(k, labels, out_hw, NUM_CLASSES)
            (dz,) = torch.autograd.grad(ce, k, gbar, retain_graph=True)
            torch.cuda.synchronize()
            ce_err = abs(ce.item() - want.item())
            if not (ce_err <= LOSS_TOL_REL * abs(want.item())
                    and abs(correct.item() - want_correct.item())
                    <= CORRECT_TOL_SHARE * labels.numel()):
                raise AssertionError(
                    f'seg_ce {name} {dtype}: ce {ce.item()} correct '
                    f'{correct.item()} vs plain {want.item()} '
                    f'{want_correct.item()}')
            err, used = check_close(f'seg_ce {name} {dtype} dz', dz, dwant)
            ms = _timed_pair(
                lambda: sc.fused_seg_ce(z, labels, out_hw, NUM_CLASSES),
                lambda: sc.seg_ce_plain(z, labels, out_hw, NUM_CLASSES))
            p = z.clone().requires_grad_()
            plain_ce, _ = sc.seg_ce_plain(p, labels, out_hw, NUM_CLASSES)
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
                f'plain {bms[1]:.4f} ms')
    return fwd, bwd


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


def _pd_loss_check(last):
    """The PD loss of a train step is finite and >= 0."""
    key = 'loss_decode_head.linear_pred<->decode_head.linear_pred_other'
    value = float(last[key])
    log(f'PD loss at the last step: {value:.6g}')
    if not (math.isfinite(value) and value >= 0.0):
        raise AssertionError(f'the PD loss is {value}')


def main():
    phase_device()
    sys.path.insert(0, str(ROOT))
    from segdistill_tpu_torch.ops import (group_kl, pixel_kl, resize_sum,
                                          seg_ce, sra_attn)
    k1, k2, k3, k4, k5, k6, k7, k8, k9 = kernels = [
        resize_sum.KERNEL, sra_attn.KERNEL, group_kl.FWD_KERNEL,
        group_kl.BWD_KERNEL, seg_ce.FWD_KERNEL, seg_ce.BWD_KERNEL,
        pixel_kl.FWD_KERNEL, pixel_kl.BWD_KERNEL, sra_attn.BWD_KERNEL]
    phase_build(kernels)
    results = {k1.name: phase_resize_sum(), k2.name: phase_sra_attn()}
    results[k3.name], results[k4.name] = phase_group_kl()
    results[k5.name], results[k6.name] = phase_seg_ce()
    results[k7.name], results[k8.name] = phase_pixel_kl()
    results[k9.name] = phase_sra_train()
    launches = {k.name: 0 for k in kernels}
    paths = [phase_serving([k1, k2]),
             phase_train([k1, k3, k4, k5, k6], CGD_CONFIG, {}, 'CGD')[0]]
    phase_train_vs_cpu(CGD_CONFIG, {}, 'CGD')
    pd_launches, pd_last = phase_train([k1, k2, k5, k6, k7, k8, k9],
                                       PD_CONFIG, STUDENT_FA_TRAIN, 'PD')
    _pd_loss_check(pd_last)
    paths.append(pd_launches)
    phase_train_vs_cpu(PD_CONFIG, STUDENT_FA_TRAIN, 'PD')
    for path in paths:
        for name, n in path.items():
            launches[name] += n
    # each kernel at its main path's shape: serving at batch 1 (fp32) for
    # K1 and K2, the bf16 bench train steps for K3-K9
    main_case = {k1.name: ('B0 head b1 E256', torch.float32),
                 k2.name: ('B0 stage1 b1', torch.float32),
                 k3.name: ('CGD bench perm', torch.bfloat16),
                 k4.name: ('CGD bench perm', torch.bfloat16),
                 k5.name: ('head CE bench', torch.bfloat16),
                 k6.name: ('head CE bench', torch.bfloat16),
                 k7.name: ('PD bench', torch.bfloat16),
                 k8.name: ('PD bench', torch.bfloat16),
                 k9.name: ('B0 stage1 b8', torch.bfloat16)}
    entries = []
    for k in kernels:
        res = results[k.name]
        _, ms, plain_ms = res[main_case[k.name]]
        entries.append({
            'name': k.name, 'route': 'cuda',
            'source': str(k.source.relative_to(ROOT)),
            'replaces': k.replaces, 'launches': launches[k.name],
            'max_abs_err': max(e for (_, dt), (e, _, _) in res.items()
                               if dt == torch.float32),
            'ms': ms, 'plain_ms': plain_ms})
    print(json.dumps({'kernels': entries}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
