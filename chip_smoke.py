#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases: (1) device, (2) build the hand-written kernels from csrc/,
(3) K1 resize_sum and (4) K2 sra_attn against their plain PyTorch versions
at the serving path's shapes, with CUDA-event timings, (5) full-width
Segformer-B0 (ADE20K, 150 classes, random weights from seed 0) serving
seeded requests through ``inference_segmentor`` in whole mode, again with
``fused_attention=True``, and slide mode at 1024x2048; the fp32 GPU logits
against the same model on the CPU, bf16 against fp32, throughput, and the
launch count of each kernel during that run.

Any failed check raises, and the script exits non-zero. It needs a CUDA
device and the repository around it. The second line before the last is
a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / 'configs' / 'segformer' / 'segformer_b0_512x512_ade_160k.py'
NUM_CLASSES = 150
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


def log(msg):
    print(msg, flush=True)


def check_close(name, got, want32):
    """``got`` in its dtype against ``want32``, the plain version in fp32
    on the same inputs; returns the max abs error and the largest share of
    its tolerance that any element uses."""
    diff = (got.float() - want32).abs()
    if got.dtype == torch.float32:
        tol = torch.full_like(diff, K_TOL_F32)
    else:
        rms = want32.square().mean().sqrt()
        tol = K_TOL_BF16_REL * want32.abs() + K_TOL_BF16_RMS * rms
    err = diff.max().item()
    used = (diff / tol).max().item()
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
    log('== build')
    for k in kernels:
        k.function()
        log(f'{k.name}: built and loaded in {k.build_seconds:.1f} s '
            f'from {k.source.relative_to(ROOT)}')
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


def phase_serving(kernels):
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

    # the main path: every launch count starts at 0 here
    for k in kernels:
        k.launches = 0
    preds = _serve(model, imgs, 'whole')
    preds_fa = _serve(model_fa, imgs, 'whole, fused_attention')
    with torch.no_grad():
        t0 = time.perf_counter()
        slide = model_slide.simple_test(slide_x, rescale=False)
        torch.cuda.synchronize()
        slide_ms = (time.perf_counter() - t0) * 1e3
    launches = {k.name: k.launches for k in kernels}
    log(f'slide 1024x2048 (512^2 windows, stride 384): {slide_ms:.2f} ms, '
        f'output {tuple(slide.shape)}')
    log(f'launches during the main path: {launches}')
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f'kernel {name} was not launched on the '
                                 f'main path')
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


def main():
    phase_device()
    sys.path.insert(0, str(ROOT))
    from segdistill_tpu_torch.ops import resize_sum, sra_attn
    kernels = [resize_sum.KERNEL, sra_attn.KERNEL]
    phase_build(kernels)
    k1 = phase_resize_sum()
    k2 = phase_sra_attn()
    launches = phase_serving(kernels)
    # each kernel at its serving-path shape: the B0 head at batch 1 and the
    # stage-1 attention at batch 1, fp32
    main_case = {'resize_sum': (k1, ('B0 head b1 E256', torch.float32)),
                 'sra_attn': (k2, ('B0 stage1 b1', torch.float32))}
    entries = []
    for k in kernels:
        res, key = main_case[k.name]
        _, ms, plain_ms = res[key]
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
