"""Timing on a CUDA device: kernel time by CUDA events, and images per
second on the host clock."""

import time

import numpy as np
import torch


def cuda_ms(fn, iters=20, warmup=3, calls=1):
    """Median milliseconds of one call of ``fn`` by CUDA events, after
    warmup. With ``calls`` > 1 each timing spans that many calls in a row
    and is divided by it: for kernels of a few microseconds, where one
    launch's latency would be most of a single timing."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs])) / calls


def images_per_s(fn, n_images, iters=10):
    """Images per second over ``iters`` calls of ``fn``, each handling
    ``n_images``, after one warmup call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return n_images * iters / (time.perf_counter() - t0)
