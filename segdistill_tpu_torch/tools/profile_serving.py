"""Where one Segformer-B0 forward spends its time on a CUDA device, and two
A/B comparisons of the serving forward, in one process:

    python -m segdistill_tpu_torch.tools.profile_serving [--pairs 10]

1. ``torch.profiler`` over 10 forwards at 512x512, batch 1 and 8, with
   ``fused_attention`` off and on: wall and device-busy ms per forward,
   kernels per forward, and the kernels that take the most device time.
2. ``fused_attention`` off vs on: ``encode_decode`` images/s in
   alternating pairs of runs.
3. The final logits resize from the classifier's channels-last memory
   (what ``encode_decode`` does) vs from contiguous NCHW memory: the resize
   alone by CUDA events, then the forward in alternating pairs.

fp32 with TF32 off; full-width B0 (150 classes), random weights from seed
0. The first line is the card's name and power limit.
"""

import argparse
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..apis import init_segmentor
from ..ops import resize
from ..utils.timing import cuda_ms, images_per_s

CONFIG = Path(__file__).resolve().parents[2] / 'configs' / 'segformer' / \
    'segformer_b0_512x512_ade_160k.py'
FUSED = {'model.backbone.fused_attention': True}


def profile_forward(model, x, iters=10, top=12):
    with torch.no_grad():
        for _ in range(5):
            model.encode_decode(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                model.encode_decode(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / iters * 1e3
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in events) / iters / 1e3
    print(f'  wall {wall_ms:.3f} ms/forward (profiled), device busy '
          f'{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}), '
          f'{len(events) / iters:.0f} kernels/forward')
    rows = {}
    for e in events:
        row = rows.setdefault(e.name, [0.0, 0])
        row[0] += e.device_time / iters / 1e3
        row[1] += 1
    for name, (ms, n) in sorted(rows.items(), key=lambda r: -r[1][0])[:top]:
        print(f'  {ms:8.4f} ms {ms / busy_ms:6.1%} x{n // iters:3d}  '
              f'{name[:90]}')


def alternate(variants, n_images, pairs, iters=20):
    """images/s of two variants, run in alternating order; prints the
    medians, interquartile ranges and how often the second one won."""
    (a, fa), (b, fb) = variants.items()
    res = {a: [], b: []}
    for i in range(pairs):
        for name, fn in ((a, fa), (b, fb)) if i % 2 == 0 else \
                ((b, fb), (a, fa)):
            res[name].append(images_per_s(fn, n_images, iters))
    wins = sum(vb > va for va, vb in zip(res[a], res[b]))
    print('  ' + '; '.join(
        f'{k} median {np.median(v):.2f} IQR '
        f'{np.subtract(*np.percentile(v, [75, 25])):.2f}'
        for k, v in res.items()) + f'; {b} wins {wins}/{pairs}')
    for k, v in res.items():
        print(f'  {k:>8s}', ' '.join(f'{x:.1f}' for x in v))


def encode_decode_nchw(model, img):
    """``encode_decode`` with the logits made contiguous NCHW before the
    resize to the input size."""
    return resize(model(img).float().contiguous(), size=img.shape[2:],
                  mode='bilinear', align_corners=model.align_corners)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--pairs', type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_serving needs a CUDA device')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    off = init_segmentor(str(CONFIG), device='cuda', seed=0)
    on = init_segmentor(str(CONFIG), device='cuda', seed=0,
                        cfg_options=FUSED)
    gen = torch.Generator(device='cuda').manual_seed(0)
    xs = {b: torch.randn(b, 3, 512, 512, device='cuda', generator=gen)
          for b in (1, 8)}

    print('== 1. torch.profiler, one forward at 512x512, fp32')
    for b, x in xs.items():
        for tag, m in (('fused_attention off', off),
                       ('fused_attention on', on)):
            print(f'batch {b}, {tag}')
            profile_forward(m, x)

    with torch.no_grad():
        print(f'== 2. fused_attention off vs on, images/s, {args.pairs} '
              f'alternating pairs of 20 forwards')
        for b, x in xs.items():
            print(f'batch {b}')
            alternate({'off': lambda: off.encode_decode(x),
                       'on': lambda: on.encode_decode(x)}, b, args.pairs)

        print('== 3. logits resize from channels-last vs NCHW memory')
        for b, x in xs.items():
            logits = on(x).float()
            cl = lambda: resize(logits, size=(512, 512), mode='bilinear',
                                align_corners=False)
            nchw = lambda: resize(logits.contiguous(), size=(512, 512),
                                  mode='bilinear', align_corners=False)
            diff = (cl() - nchw()).abs().max().item()
            ms = [cuda_ms(f, iters=30) for f in (cl, nchw, nchw, cl)]
            print(f'batch {b} resize {tuple(logits.shape)} -> 512x512 '
                  f'(channels-last memory: '
                  f'{logits.is_contiguous(memory_format=torch.channels_last)}'
                  f'): channels-last {ms[0]:.4f} / {ms[3]:.4f} ms, NCHW '
                  f'{ms[1]:.4f} / {ms[2]:.4f} ms, outputs differ by '
                  f'{diff:.2e}')
        for b, x in xs.items():
            print(f'batch {b}, fused_attention on, forward images/s')
            alternate({'channels-last': lambda: on.encode_decode(x),
                       'NCHW': lambda: encode_decode_nchw(on, x)}, b,
                      args.pairs)


if __name__ == '__main__':
    main()
