"""Where the train loop's data time goes under ``tools.train``, for each
loader backend:

    python -m segdistill_tpu_torch.tools.profile_loader [--backends host
        native device] [--iters 14] [--window 6] [--num-images 64]
        [--workers 6]

writes ``bench_loader``'s seeded ADE-like dataset and runs ``tools.train``
on ``configs/exp_tab5/segformer_CGD.py`` (MiT-B0 student, frozen MiT-B3
teacher, bf16 backbones, batch 8 at 512x512, random weights from seed 0,
no evaluation, a log line each step, which reads the losses back and so
ends each step on the host) with ``data.loader_backend`` set to each
backend in turn (the ADE20K recipe in ``data.aug_cfg``).

The loader's hooks are timed on the host clock, on whatever thread runs
them: a sample's ``_load`` (a pool thread), a batch's ``_collate`` and the
interval between two batches handed over (the producer thread), and
``_deliver`` (the train thread, where a batch is copied to the card and,
for 'device', augmented). Iterations ``3 .. window_start - 1`` and
``window_end + 2 ..`` give the medians of the logged ``time`` and
``data_time`` and of the consumer's wait for the queue (``data_time``
less ``_deliver``). Over ``--window`` steps from the middle of the run,
``torch.profiler`` records the CUDA runtime calls of every thread: count
and host ms a step of each call, on the train thread and on the others,
and the device's busy ms a step (the union of the kernels' intervals).

The first line is the card's name and power limit; then a few lines a
backend and one JSON line a backend with every figure.
"""

import argparse
import collections
import contextlib
import json
import re
import statistics
import tempfile
import threading
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from ..datasets import LOADER_BACKENDS
from . import bench_loader
from . import train as train_cli
from .profile_train import _union_ms

CONFIG = Path(__file__).resolve().parents[2] / 'configs' / 'exp_tab5' / \
    'segformer_CGD.py'
BATCH = 8
# the runtime calls that wait for the device or for an allocation
WAITS = ('cudaStreamSynchronize', 'cudaEventSynchronize',
         'cudaDeviceSynchronize', 'cudaMemcpy', 'cudaHostAlloc',
         'cudaFreeHost', 'cudaMalloc', 'cudaFree')


def options(root, iters, workers, backend):
    """``--options`` for the CGD config on the dataset under ``root``."""
    opts = {'model.t_pretrain': None, 'model.s_pretrain': None,
            'model.cfg_s.pretrained': None,
            'model.cfg_s.backbone.dtype': 'bfloat16',
            'model.cfg_t.backbone.dtype': 'bfloat16',
            'data.samples_per_gpu': BATCH, 'data.workers_per_gpu': workers,
            'runner.max_iters': iters,
            'checkpoint_config.interval': iters, 'log_config.interval': 1,
            'data.loader_backend': backend,
            'data.aug_cfg': bench_loader.aug_cfg(backend)}
    key = 'data.train.dataset'
    opts.update({f'{key}.type': 'CustomDataset',
                 f'{key}.data_root': str(root), f'{key}.img_dir': 'img/train',
                 f'{key}.ann_dir': 'ann/train', f'{key}.img_suffix': '.npy',
                 f'{key}.seg_map_suffix': '.npy',
                 f'{key}.reduce_zero_label': True,
                 f'{key}.classes': str(Path(root) / 'classes.txt')})
    return [f'{k}={v!r}' if isinstance(v, dict) else f'{k}={v}'
            for k, v in opts.items()]


class Spans:
    """Host-clock intervals of the wrapped loader hooks, by hook."""

    def __init__(self):
        self.rows = {}
        self.lock = threading.Lock()

    def add(self, name, t0, t1):
        with self.lock:
            self.rows.setdefault(name, []).append((t0, t1))

    def ms(self, name, lo=0):
        """Durations in ms of ``name``'s intervals from the ``lo``-th."""
        return [(b - a) * 1e3 for a, b in self.rows.get(name, [])[lo:]]


@contextlib.contextmanager
def instrumented(cls, spans, on_deliver):
    """Wrap ``cls``'s ``_load``, ``_collate`` and ``_deliver`` with host
    clocks for the length of the block; ``on_deliver(n)`` runs on the train
    thread before the n-th (from 1) ``_deliver``."""
    saved = {name: cls.__dict__.get(name)
             for name in ('_load', '_collate', '_deliver')}
    delivered = [0]

    def timed(name, fn):
        def run(self, *args):
            if name == '_deliver':
                delivered[0] += 1
                on_deliver(delivered[0])
            t0 = time.perf_counter()
            out = fn(self, *args)
            spans.add(name, t0, time.perf_counter())
            return out
        return run

    for name in saved:
        setattr(cls, name, timed(name, getattr(cls, name)))
    try:
        yield
    finally:
        for name, fn in saved.items():
            if fn is None:
                delattr(cls, name)
            else:
                setattr(cls, name, fn)


def runtime_calls(prof, steps):
    """{call: {'train'|'other': [calls a step, host ms a step]}} of the
    CUDA runtime and driver calls the profiler saw; the train thread is
    the one that launched the most kernels."""
    calls = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU
             and re.match(r'cu(da)?[A-Z]', e.name)]
    launches = collections.Counter(e.thread for e in calls
                                   if 'LaunchKernel' in e.name)
    train = launches.most_common(1)[0][0] if launches else None
    out = {}
    for e in calls:
        side = 'train' if e.thread == train else 'other'
        row = out.setdefault(e.name, {}).setdefault(side, [0.0, 0.0])
        row[0] += 1 / steps
        row[1] += (e.time_range.end - e.time_range.start) / 1e3 / steps
    return out


def run_backend(root, backend, iters, window, workers, work):
    """One ``tools.train`` run with ``backend``: -> the figures."""
    cls = LOADER_BACKENDS[backend]
    spans = Spans()
    first = max(3, (iters - window) // 2 + 1)  # the first profiled step
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    marks = {}

    def on_deliver(n):
        # the n-th _deliver opens step n
        if n == first:
            torch.cuda.synchronize()
            prof.start()
            marks['t0'] = time.perf_counter()
        elif n == first + window:
            torch.cuda.synchronize()
            marks['t1'] = time.perf_counter()
            prof.stop()

    with instrumented(cls, spans, on_deliver):
        train_cli.main([str(CONFIG), '--work-dir', str(work), '--seed', '0',
                        '--no-validate', '--options',
                        *options(root, iters, workers, backend)])
    torch.cuda.synchronize()
    (path,) = sorted(Path(work).glob('*.log.json'))
    log = {ln['iter']: ln for ln in map(json.loads,
                                        path.read_text().splitlines())
           if ln['mode'] == 'train'}
    # the steps the profiler's start and stop do not touch
    quiet = [i for i in range(3, iters + 1)
             if not first <= i <= first + window]
    deliver = spans.ms('_deliver')  # index i - 1 is step i's
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    wall_ms = (marks['t1'] - marks['t0']) * 1e3 / window
    ends = sorted(b for _, b in spans.rows.get('_collate', []))
    period = [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]
    return dict(
        backend=backend, steps=quiet, card=bench_loader.card(),
        time_ms=statistics.median(log[i]['time'] * 1e3 for i in quiet),
        data_time_ms=statistics.median(log[i]['data_time'] * 1e3
                                       for i in quiet),
        deliver_ms=statistics.median(deliver[i - 1] for i in quiet),
        queue_wait_ms=statistics.median(
            log[i]['data_time'] * 1e3 - deliver[i - 1] for i in quiet),
        collate_ms=statistics.median(spans.ms('_collate', 2)),
        producer_period_ms=statistics.median(period[2:]),
        load_ms=statistics.median(spans.ms('_load', 2 * BATCH)),
        window=window, profiled_wall_ms=wall_ms,
        device_busy_ms=_union_ms(kernels) / window,
        runtime=runtime_calls(prof, window))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--backends', nargs='+', default=list(
        LOADER_BACKENDS), choices=list(LOADER_BACKENDS))
    parser.add_argument('--iters', type=int, default=14)
    parser.add_argument('--window', type=int, default=6,
                        help='profiled steps, in the middle of the run')
    parser.add_argument('--num-images', type=int, default=64)
    parser.add_argument('--workers', type=int, default=6)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_loader needs a CUDA device')
    if args.iters < args.window + 6:
        raise SystemExit('--iters must leave 3 steps before the window and '
                         '2 after it')
    print(bench_loader.card(), flush=True)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / 'data'
        bench_loader.write_dataset(root, args.num_images, split='train')
        for backend in args.backends:
            row = run_backend(root, backend, args.iters, args.window,
                              args.workers, Path(tmp) / f'work_{backend}')
            print(f'== {backend}: step {row["time_ms"]:.2f} ms, data_time '
                  f'{row["data_time_ms"]:.2f} ms = _deliver '
                  f'{row["deliver_ms"]:.2f} ms + queue wait '
                  f'{row["queue_wait_ms"]:.2f} ms (medians of steps '
                  f'{row["steps"]}); producer: a batch every '
                  f'{row["producer_period_ms"]:.2f} ms, _collate '
                  f'{row["collate_ms"]:.2f} ms, _load {row["load_ms"]:.2f} '
                  f'ms a sample; profiled: wall {row["profiled_wall_ms"]:.2f}'
                  f' ms a step, device busy {row["device_busy_ms"]:.2f} ms',
                  flush=True)
            waits = {k: v for k, v in row['runtime'].items()
                     if k.startswith(WAITS)}
            for name, sides in sorted(waits.items()):
                print(f'   {name}: ' + ', '.join(
                    f'{side} {n:.1f} calls {ms:.3f} ms a step'
                    for side, (n, ms) in sorted(sides.items())), flush=True)
            print(json.dumps(row), flush=True)
            rows.append(row)
            torch.cuda.empty_cache()
    return rows


if __name__ == '__main__':
    main()
