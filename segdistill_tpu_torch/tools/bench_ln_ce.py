"""Time the LayerNorm kernels (K10 forward, K11 backward) and the seg-CE
kernels (K5, K6) on the card: the quick loop for work on these kernels.
``chip_smoke.py`` holds them to their limits against the plain versions, at
the same shapes (``tools/kernel_cases.py``); nothing is checked here.

    python -m segdistill_tpu_torch.tools.bench_ln_ce [--times-only]

Builds only ``csrc/layer_norm.cu`` and ``csrc/seg_ce.cu`` (two ``nvcc`` at
once) and prints ptxas' registers and spills. Then

- K10/K11 at the MiT-B0 LayerNorm shapes of a batch of 8 at 512x512 and two
  of B3's: forward and backward, the median device time (the calls queued
  behind a busy stream, so the host's time to launch them is left out) and
  the host-clocked time of a call, for the kernel, the plain version and
  ``F.layer_norm``, beside the bounds;
- K5 and K6 at the head's bench shape and three smaller ones: device time
  beside the bounds;
- without ``--times-only``: K11's device time with other numbers of blocks
  per SM, and where the host time of a K10 and a K11 call goes (the launch
  alone, the autograd node, ``torch.autograd.grad`` through it) beside the
  library's node and an identity ``autograd.Function``, the least a Python
  node costs.

``--times-only`` goes through the wrappers' public functions alone: run
from another checkout with ``PYTHONPATH`` pointing at it
(``PYTHONPATH=<checkout> python <this file> --times-only``), it times that
checkout's kernels, so two trees can be compared inside one process-pair on
one card. Needs a CUDA device; prints the card's name and power limit first.
"""

import argparse
import subprocess
import time

import torch
import torch.nn.functional as F

from segdistill_tpu_torch.ops import layer_norm as ln
from segdistill_tpu_torch.ops import seg_ce as sc
from segdistill_tpu_torch.ops.cuda_kernel import build_all
from segdistill_tpu_torch.utils.timing import cuda_ms, device_ms

try:
    from segdistill_tpu_torch.tools import kernel_cases
except ImportError:  # PYTHONPATH names a checkout from before that module
    import importlib.util
    import pathlib
    _spec = importlib.util.spec_from_file_location(
        'kernel_cases', pathlib.Path(__file__).with_name('kernel_cases.py'))
    kernel_cases = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(kernel_cases)

LN_CASES = [(rows, c) for _, rows, c in kernel_cases.LN_CASES[:7]]
CE_CASES = kernel_cases.SEG_CE_CASES[:4]
LN_CALLS = 10


def _ln_inputs(rows, c, dtype, gen):
    w = 1 + 0.1 * torch.randn(c, device='cuda', generator=gen)
    b = 0.1 * torch.randn(c, device='cuda', generator=gen)
    x = torch.randn(rows, c, device='cuda', generator=gen).to(dtype)
    g = torch.randn(rows, c, device='cuda', generator=gen).to(dtype)
    return x, w, b, g


def _fwd_bwd_times(fn, x, params, g):
    """(forward device ms, forward call ms, backward device ms, backward
    call ms) of ``fn(x, *params)``."""
    with torch.no_grad():
        fd = device_ms(lambda: fn(x, *params), calls=LN_CALLS)
        fc = cuda_ms(lambda: fn(x, *params), calls=LN_CALLS)
    leaf = x.clone().requires_grad_()
    ps = [t.clone().requires_grad_() for t in params]
    y = fn(leaf, *ps)

    def backward():
        torch.autograd.grad(y, [leaf] + ps, g, retain_graph=True)
    return fd, fc, device_ms(backward, calls=LN_CALLS), \
        cuda_ms(backward, calls=LN_CALLS)


def ln_times(rows, c, dtype, gen):
    x, w, b, g = _ln_inputs(rows, c, dtype, gen)
    eps = 1e-6
    rows_ = [('kernel', lambda a, ww, bb: ln.fused_layer_norm(a, ww, bb, eps),
              (w, b)),
             ('plain', lambda a, ww, bb: ln.layer_norm_plain(a, ww, bb, eps),
              (w, b)),
             ('library', lambda a, ww, bb: F.layer_norm(a, (c,), ww, bb, eps),
              (w.to(dtype), b.to(dtype)))]
    fb, bb = kernel_cases.ln_bounds(rows, c, dtype)
    for tag, fn, params in rows_:
        fd, fc, bd, bc = _fwd_bwd_times(fn, x, params, g)
        print(f'LN ({rows}, {c}) {str(dtype)[6:]:8s} {tag:8s} fwd device '
              f'{fd:.4f} call {fc:.4f} | bwd device {bd:.4f} call {bc:.4f} '
              f'ms | bounds {fb[0]:.4f} {bb[0]:.4f} ({bb[1]})', flush=True)


class _Identity(torch.autograd.Function):
    """The least a Python autograd node costs: nothing but the hand-over."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g


def _host_us(fn, n=300):
    """Microseconds of host time per call of ``fn`` (the device is left to
    run behind; one synchronize at the end)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def ln_host_breakdown(rows, c, dtype, gen):
    """Where a K11 call's host time goes: the launch alone, the node's
    backward called directly, and ``torch.autograd.grad`` through the
    node, beside the library's and an identity node's."""
    x, w, b, g = _ln_inputs(rows, c, dtype, gen)
    ins = [t.clone().requires_grad_() for t in (x, w, b)]
    _, xrows, plan = ln._launch_fwd(x, w, b, 1e-6)
    yk = ln.fused_layer_norm(*ins, 1e-6)
    lib_ins = [ins[0]] + [t.to(dtype).requires_grad_() for t in (w, b)]
    yl = F.layer_norm(lib_ins[0], (c,), lib_ins[1], lib_ins[2], 1e-6)
    yi = _Identity.apply(ins[0])
    rows_ = [
        ('K10 launch', lambda: ln._launch_fwd(x, w, b, 1e-6)),
        ('K10 fused_layer_norm, no grad',
         lambda: ln.fused_layer_norm(x, w, b, 1e-6)),
        ('K10 fused_layer_norm, node',
         lambda: ln.fused_layer_norm(*ins, 1e-6)),
        ('library forward, node',
         lambda: F.layer_norm(lib_ins[0], (c,), lib_ins[1], lib_ins[2],
                              1e-6)),
        ('K11 launch', lambda: ln._launch_bwd(xrows, w, g, 1e-6, plan)),
        ('K11 node.apply', lambda: yk.grad_fn.apply(g)),
        ('K11 autograd.grad', lambda: torch.autograd.grad(
            yk, ins, g, retain_graph=True)),
        ('library autograd.grad', lambda: torch.autograd.grad(
            yl, lib_ins, g, retain_graph=True)),
        ('identity node autograd.grad', lambda: torch.autograd.grad(
            yi, ins[:1], g, retain_graph=True)),
    ]
    print(f'LN ({rows}, {c}) {str(dtype)[6:]} host microseconds per call: '
          + ', '.join(f'{tag} {_host_us(fn):.1f}' for tag, fn in rows_),
          flush=True)


def ln_block_sweep(rows, c, dtype, gen):
    """K11's device time with other numbers of blocks per SM."""
    x, w, b, g = _ln_inputs(rows, c, dtype, gen)
    ins = [t.clone().requires_grad_() for t in (x, w, b)]
    y = ln.fused_layer_norm(*ins, 1e-6)
    kept = ln._BWD_BLOCKS_PER_SM, ln._BWD_BLOCKS_PER_SM_WIDE
    out = []
    for per_sm in (1, 2, 4, 8, 4, 2, 1):
        ln._BWD_BLOCKS_PER_SM = ln._BWD_BLOCKS_PER_SM_WIDE = per_sm
        ms = device_ms(lambda: torch.autograd.grad(
            y, ins, g, retain_graph=True), calls=LN_CALLS)
        blocks = ln.bwd_blocks(rows, c, ln.bwd_capacity(0, c))
        out.append(f'{per_sm} ({blocks}): {ms:.4f}')
    ln._BWD_BLOCKS_PER_SM, ln._BWD_BLOCKS_PER_SM_WIDE = kept
    print(f'LN ({rows}, {c}) {str(dtype)[6:]} K11 device ms by blocks per '
          f'SM (blocks): ' + ', '.join(out), flush=True)


def _ce_inputs(shape, out_hw, ignored, dtype, gen):
    classes = shape[1]
    labels = torch.randint(0, classes, (shape[0],) + out_hw, device='cuda',
                           generator=gen)
    labels[torch.rand(labels.shape, device='cuda', generator=gen)
           < ignored] = 255
    z = torch.randn(shape, device='cuda', generator=gen).to(dtype)
    return z, labels, classes


def ce_times(name, shape, out_hw, ignored, tile, dtype, gen):
    del tile  # the smoke asserts the plan
    z, labels, classes = _ce_inputs(shape, out_hw, ignored, dtype, gen)
    with torch.no_grad():
        fwd = device_ms(lambda: sc.fused_seg_ce(z, labels, out_hw, classes),
                        calls=3)
    k = z.clone().requires_grad_()
    ce, _ = sc.fused_seg_ce(k, labels, out_hw, classes)
    gbar = torch.ones((), device='cuda')
    bwd = device_ms(lambda: torch.autograd.grad(ce, k, gbar,
                                                retain_graph=True), calls=3)
    fb, bb = kernel_cases.seg_ce_bounds(shape, out_hw, dtype)
    print(f'CE {name:18s} {shape}->{out_hw} {str(dtype)[6:]:8s} K5 device '
          f'{fwd:.4f} ms | K6 device {bwd:.4f} ms | bounds {fb[0]:.4f} '
          f'{bb[0]:.4f} ({bb[1]})', flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--times-only', action='store_true')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('bench_ln_ce: needs a CUDA device')
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    print(f'kernels of {ln.__file__}', flush=True)
    kernels = [ln.FWD_KERNEL, ln.BWD_KERNEL, sc.FWD_KERNEL, sc.BWD_KERNEL]
    build_all(kernels)
    for kern in kernels[::2]:
        print(f'{kern.source.name}: built in {kern.build_seconds:.1f} s')
        for line in kern.build_log.splitlines():
            if 'registers' in line or 'spill' in line or 'Compiling' in line:
                print('  ' + line.strip())
    gen = torch.Generator(device='cuda').manual_seed(0)
    for rows, c in LN_CASES:
        ln_times(rows, c, torch.bfloat16, gen)
    ln_times(*LN_CASES[0], torch.float32, gen)
    for case in CE_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            ce_times(*case, dtype, gen)
    if not args.times_only:
        for rows, c in LN_CASES:
            ln_block_sweep(rows, c, torch.bfloat16, gen)
        ln_host_breakdown(*LN_CASES[3], torch.bfloat16, gen)
        ln_host_breakdown(*LN_CASES[0], torch.bfloat16, gen)
    print('bench_ln_ce: ok')


if __name__ == '__main__':
    main()
