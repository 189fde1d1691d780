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


def device_ms(fn, calls=10, iters=5, warmup=2, hold_cycles=8_000_000):
    """Median milliseconds the device spends on one call of ``fn``, the
    host's time to launch it taken out: the stream is first held busy for
    ``hold_cycles`` clock cycles (a few ms), so the ``calls`` calls queue up
    behind it and then run back to back between the two events. For
    kernels that the host cannot launch as fast as the device runs them."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold_cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


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
