"""Inference images/s of a config's model (counterpart of
``tools/benchmark.py`` at the root of the repository; reference
``tools/benchmark.py``).

    python -m segdistill_tpu_torch.tools.benchmark <config> [checkpoint]
        [--iters 200] [--warmup 5] [--log-interval 50] [--shape H W]
        [--device cuda]

times ``model.inference`` (the config's own test mode, whole or slide
windows, and the softmax) on one seeded (1, 3, H, W) image, one request at
a time on the host clock with ``torch.cuda.synchronize()`` after each,
after ``--warmup`` untimed requests: "Done image [i/N], fps" every
``--log-interval`` requests, then "Overall fps". On the card the first line
is the card's name and power limit (``nvidia-smi``).
"""

import argparse
import subprocess
import time

import numpy as np
import torch

from ..apis import init_segmentor


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='benchmark fps')
    parser.add_argument('config')
    parser.add_argument('checkpoint', nargs='?', default=None)
    parser.add_argument('--log-interval', type=int, default=50)
    parser.add_argument('--iters', type=int, default=200)
    parser.add_argument('--warmup', type=int, default=5)
    parser.add_argument('--shape', type=int, nargs=2, default=[512, 512])
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    return parser.parse_args(argv)


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def main(argv=None):
    """Run the benchmark; -> the overall images/s."""
    args = parse_args(argv)
    model = init_segmentor(args.config, args.checkpoint, device=args.device)
    device = next(model.parameters()).device
    if device.type == 'cuda':
        print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, check=True).stdout.strip())
    h, w = args.shape
    img = torch.from_numpy(np.random.RandomState(0).randn(1, 3, h, w)
                           .astype(np.float32)).to(device)
    total = 0.0
    with torch.no_grad():
        for i in range(args.warmup + args.iters):
            _sync(device)
            t0 = time.perf_counter()
            model.inference(img)
            _sync(device)
            if i < args.warmup:
                continue
            total += time.perf_counter() - t0
            done = i + 1 - args.warmup
            if done % args.log_interval == 0:
                print(f'Done image [{done:3}/{args.iters}], fps: '
                      f'{done / total:.2f} img/s', flush=True)
    fps = args.iters / total
    print(f'Overall fps: {fps:.2f} img/s')
    return fps


if __name__ == '__main__':
    main()
