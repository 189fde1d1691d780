"""Time the loss, LayerNorm and resize-sum kernels on the card: K3/K4
(group KL), K5/K6 (seg CE), K7/K8 (pixel KL), K10/K11 (LayerNorm), K1
(resize-sum), the quick loop for work on them. ``chip_smoke.py`` holds
them to their limits against the plain versions, at the same shapes
(``tools/kernel_cases.py``); nothing is checked here.

    python -m segdistill_tpu_torch.tools.bench_kernels [--times-only]
        [--only ln ce gkl pkl k1] [--pdl-rounds N]

Builds only the sources of the families asked for (``csrc/layer_norm.cu``,
``seg_ce.cu``, ``group_kl.cu``, ``pixel_kl.cu``, ``resize_sum.cu``; one
``nvcc`` each, at once) and prints ptxas' registers and spills. Then

- K10 at every LayerNorm shape of the CGD (and PD) train step, batch 8 at
  512x512 in bf16 (the B0 student's and the frozen B3 teacher's,
  ``kernel_cases.LN_STEP_CASES``), and of a serving request in fp32 at
  batch 1 (``LN_SERVING_CASES``): the median device time (the calls queued
  behind a busy stream, so the host's time to launch them is left out),
  its plan, the launches, the bound and ``F.layer_norm``'s device time;
  K11 beside the library's backward at the B0 student's stages; the floor,
  an empty kernel queued on K10's grid and on one block; the sums of
  launches x time over a step;
- the B3 teacher's bf16 no-grad forward of the CGD step at batch 8, timed
  as one function queued behind a held stream that outlasts the host's
  issuing (asserted), its 89 K10 launches among its kernels; with
  ``--pdl-rounds N``, N rounds of K10 as a programmatic dependent launch
  off, on, on, off;
- K3/K4, K5/K6 and K7/K8 at the train step's bench shape and smaller ones:
  forward and backward device time and a backward call's host-clocked time,
  beside the bounds (the forwards' also beside the floor of their
  exponentials on the special-function units);
- K1 at the B0 head's shapes (batch 1 and 8, E = 256) and the B3
  teacher's (batch 8, E = 768), fp32 and bf16: device time and a call's
  host-clocked time, the plain version's device time, beside the bound;
- without ``--times-only``: K10 at each step shape under other plans
  (threads a block, rows in flight, programmatic dependent launch), K11's
  device time with other numbers of blocks
  per SM, and where the host time of a K10 and a K11 call goes (the launch
  alone, the autograd node, ``torch.autograd.grad`` through it) beside the
  library's node and an identity ``autograd.Function``, the least a Python
  node costs.

``--times-only`` goes through the wrappers' public functions alone: run
from another checkout with ``PYTHONPATH`` pointing at it
(``PYTHONPATH=<checkout> python <this file> --times-only``), it times that
checkout's kernels at this file's cases, so two trees can be compared
inside one process-pair on one card. Needs a CUDA device; prints the card's
name and power limit first.
"""

import argparse
import importlib.util
import pathlib
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from segdistill_tpu_torch.ops import group_kl as gk
from segdistill_tpu_torch.ops import layer_norm as ln
from segdistill_tpu_torch.ops import pixel_kl as pk
from segdistill_tpu_torch.ops import resize_sum as rs
from segdistill_tpu_torch.ops import seg_ce as sc
from segdistill_tpu_torch.ops.cuda_kernel import build_all
from segdistill_tpu_torch.utils.timing import cuda_ms, device_ms

# the case lists beside this file, whichever checkout PYTHONPATH names
_spec = importlib.util.spec_from_file_location(
    'kernel_cases', pathlib.Path(__file__).with_name('kernel_cases.py'))
kernel_cases = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kernel_cases)

# K11's block sweep and host breakdown: the B0 student's four stages
LN_CASES = [(rows, c) for name, rows, c, _, _ in kernel_cases.LN_STEP_CASES
            if name.startswith('B0 stage') and 'sr' not in name]
CE_CASES = kernel_cases.SEG_CE_CASES[:4]
# the bench shape, a non-integer ratio, odd sizes
GKL_CASES = [kernel_cases.GROUP_KL_CASES[i] for i in (0, 4, 5)]
PKL_CASES = kernel_cases.PIXEL_KL_CASES[:3]
RS_CASES = kernel_cases.RESIZE_SUM_CASES[:3]
LN_CALLS = 10
FAMILIES = ('ln', 'ce', 'gkl', 'pkl', 'k1')


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


def ln_times(name, rows, c, launches, dtype, gen, backward=False):
    """K10's device time on (rows, c) beside ``F.layer_norm``'s and the
    bound (and, with ``backward``, K11's beside the library's backward);
    -> K10's device ms."""
    x, w, b, g = _ln_inputs(rows, c, dtype, gen)
    eps = 1e-6
    lw, lb = w.to(dtype), b.to(dtype)
    with torch.no_grad():
        k10 = device_ms(lambda: ln.fused_layer_norm(x, w, b, eps),
                        calls=LN_CALLS)
        lib = device_ms(lambda: F.layer_norm(x, (c,), lw, lb, eps),
                        calls=LN_CALLS)
    fb, bb = kernel_cases.ln_bounds(rows, c, dtype)
    plan = ''
    if hasattr(ln, 'forward_plan'):  # this tree plans K10's launch
        plan = ln.forward_plan(rows, c, ln.DTYPE_CODES[dtype], ln.sm_count(0))
        plan = f' plan {tuple(plan)}'
    if hasattr(ln, 'PDL'):  # and launches it as a dependent launch
        kept, ln.PDL = ln.PDL, False
        with torch.no_grad():
            alone = device_ms(lambda: ln.fused_layer_norm(x, w, b, eps),
                              calls=LN_CALLS)
        ln.PDL = kept
        plan += f', {alone:.4f} ms without the dependent launch'
    line = (f'LN {name:16s} ({rows}, {c}) {str(dtype)[6:]:8s} x{launches:<3d} '
            f'K10 device {k10:.4f} ms | library {lib:.4f} | bound '
            f'{fb[0]:.4f} ({k10 / fb[0]:.2f}x){plan}')
    if backward:
        kb = _fwd_bwd_times(
            lambda a, ww, bb_: ln.fused_layer_norm(a, ww, bb_, eps), x,
            (w, b), g)[2]
        lbk = _fwd_bwd_times(lambda a, ww, bb_: F.layer_norm(
            a, (c,), ww, bb_, eps), x, (lw, lb), g)[2]
        line += (f' | K11 device {kb:.4f} ms, library backward {lbk:.4f}, '
                 f'bound {bb[0]:.4f}')
    print(line, flush=True)
    return k10


def _floor_ms(plan):
    """The queued device time of an empty kernel on K10's grid, and on one
    block of its threads."""
    def empty(blocks):
        return lambda: ln.EMPTY_KERNEL.launch(torch.device('cuda', 0),
                                              blocks, plan.threads)
    return (device_ms(empty(plan.blocks), calls=LN_CALLS),
            device_ms(empty(1), calls=LN_CALLS))


def ln_step_times(gen):
    """(a) and (b): every K10 shape of the CGD step (bf16) and of a serving
    request (fp32), with the launches, the bound, the library's time and,
    where this tree has it, the floor; the sums over a step."""
    totals = {'K10': 0.0, 'bound': 0.0, 'floor': 0.0}
    for cases, dtype, per in ((kernel_cases.LN_STEP_CASES, torch.bfloat16,
                               'step'),
                              (kernel_cases.LN_SERVING_CASES, torch.float32,
                               'request')):
        for name, rows, c, launches, _ in cases:
            k10 = ln_times(name, rows, c, launches, dtype, gen,
                           backward=name.startswith('B0 stage')
                           and dtype == torch.bfloat16)
            bound = kernel_cases.ln_bounds(rows, c, dtype)[0][0]
            floor = None
            if hasattr(ln, 'EMPTY_KERNEL'):
                plan = ln.forward_plan(rows, c, ln.DTYPE_CODES[dtype],
                                       ln.sm_count(0))
                floor, one = _floor_ms(plan)
                print(f'   floor ({rows}, {c}): empty kernel on K10\'s grid '
                      f'({plan.blocks} x {plan.threads}) {floor:.4f} ms, '
                      f'on one block {one:.4f}; max(bound, floor) '
                      f'{max(bound, floor):.4f}', flush=True)
            if per == 'step':
                totals['K10'] += launches * k10
                totals['bound'] += launches * bound
                if floor is not None:
                    totals['floor'] += launches * max(bound, floor)
    print(f'LN step sums (launches x ms): K10 {totals["K10"]:.4f} ms, bound '
          f'{totals["bound"]:.4f}, max(bound, floor) {totals["floor"]:.4f}',
          flush=True)
    # the widest norm, C = 1536, K10 and K11 in both dtypes
    for name, rows, c, launches, _, _ in kernel_cases.LN_WIDE_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            ln_times(name, rows, c, launches, dtype, gen, backward=True)


def queued_ms(fn, iters=5):
    """(median device ms of one ``fn()`` queued behind a held stream,
    median host ms to issue it, the hold in ms). The hold is sized from a
    first host-timed call and each round asserts that the host finished
    issuing before the hold ended, so the span is the device's alone."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host0 = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    a, c = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10_000_000)
    c.record()
    torch.cuda.synchronize()
    cycles_per_ms = 10_000_000 / a.elapsed_time(c)
    hold_cycles = int((3 * host0 + 10) * cycles_per_ms)
    spans, hosts, holds = [], [], []
    retries = 2
    while len(spans) < iters:
        torch.cuda.synchronize()
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        t0 = time.perf_counter()
        e0.record()
        torch.cuda._sleep(hold_cycles)
        e1.record()
        fn()
        host = (time.perf_counter() - t0) * 1e3
        e2.record()
        torch.cuda.synchronize()
        hold = e0.elapsed_time(e1)
        if not host < hold:
            if not retries:
                raise AssertionError(f'queued_ms: the host took {host:.1f} '
                                     f'ms to issue, the hold was {hold:.1f} '
                                     f'ms')
            retries -= 1
            hold_cycles *= 2
            continue
        spans.append(e1.elapsed_time(e2))
        hosts.append(host)
        holds.append(hold)
    return float(np.median(spans)), float(np.median(hosts)), \
        float(np.median(holds))


def _launch_k10(x, w, b, plan, pdl):
    """One K10 launch on (rows, C) ``x`` with the given plan."""
    rows, c = x.shape
    y = torch.empty_like(x)
    ln.FWD_KERNEL.launch(x.device, x.data_ptr(), c, w.data_ptr(),
                         b.data_ptr(), rows, c, 1e-6, ln.DTYPE_CODES[x.dtype],
                         y.data_ptr(), *plan, pdl)


def _sweep_plans(rows, c, code, sms):
    """K10's plans for (rows, c) beside the planner's: every instance that
    covers the row at 64-256 threads a block, the two-row instances'
    persistent grid at 4 and 8 blocks an SM."""
    from segdistill_tpu_torch.ops import ln_plan
    nvec = c // ln_plan.VEC[code]
    for lanes, nch, rif in ln_plan.INSTANCES[code]:
        if lanes * nch < nvec:
            continue
        for threads in (64, 128, 256):
            need = -(-rows // (threads // lanes))
            for per_sm in ((None,) if rif == 1 else (4, 8)):
                blocks = need if per_sm is None else min(need, sms * per_sm)
                yield ln_plan.Plan(lanes, nch, rif, threads, blocks)


def ln_plan_sweep(gen):
    """K10's device time at every step and serving shape under other
    plans (:func:`_sweep_plans`), the fastest first, and the planner's,
    also as a programmatic dependent launch."""
    for cases, dtype in ((kernel_cases.LN_STEP_CASES, torch.bfloat16),
                         (kernel_cases.LN_SERVING_CASES, torch.float32)):
        for name, rows, c, _, _ in cases:
            x, w, b, _ = _ln_inputs(rows, c, dtype, gen)
            code = ln.DTYPE_CODES[dtype]
            default = ln.forward_plan(rows, c, code, ln.sm_count(0))
            times = {}
            for p in [default] + list(_sweep_plans(rows, c, code,
                                                   ln.sm_count(0))):
                if p not in times:
                    times[p] = device_ms(
                        lambda: _launch_k10(x, w, b, p, False),
                        calls=LN_CALLS)
            pdl = device_ms(lambda: _launch_k10(x, w, b, default, True),
                            calls=LN_CALLS)
            ranked = sorted(times.items(), key=lambda kv: kv[1])
            print(f'LN sweep {name} ({rows}, {c}) {str(dtype)[6:]}: planned '
                  f'{tuple(default)} {times[default]:.4f} ms, as a '
                  f'programmatic dependent launch {pdl:.4f}; fastest: '
                  + ', '.join(f'{tuple(p)} {ms:.4f}' for p, ms in ranked[:8]),
                  flush=True)


def _teacher_segments(teacher, img, blocks_per_segment=6):
    """The teacher's forward (backbone and head) cut into pieces of at most
    ``blocks_per_segment`` transformer blocks, each a function of fixed
    inputs (those of one reference run), so that each piece's launches fit
    the launch queue behind a hold; -> (pieces, the reference's logits)."""
    from segdistill_tpu_torch.models.backbones.mix_transformer import \
        _channels_first
    bb = teacher.backbone
    cuts = []
    for s in range(1, 5):
        cuts.append(('embed', s, None))
        depth = len(getattr(bb, f'block{s}'))
        for lo in range(0, depth, blocks_per_segment):
            cuts.append(('blocks', s, (lo, min(lo + blocks_per_segment,
                                               depth))))
        cuts.append(('norm', s, None))
    cuts.append(('head', None, None))

    def run(cut, state):
        kind, s, span = cut
        x, hw, outs = state
        if kind == 'embed':
            x, h, w = getattr(bb, f'patch_embed{s}')(x)
            return x, (h, w), outs
        if kind == 'blocks':
            for blk in getattr(bb, f'block{s}')[span[0]:span[1]]:
                x = blk(x, *hw)
            return x, hw, outs
        if kind == 'norm':
            y = _channels_first(getattr(bb, f'norm{s}')(x), *hw)
            return y, None, outs + (y,)
        return teacher.decode_head(outs), None, outs

    pieces = []
    state = (img.to(bb.dtype), None, ())
    with torch.no_grad():
        for cut in cuts:
            frozen = state
            pieces.append(lambda c=cut, st=frozen: run(c, st))
            state = run(cut, state)
    return pieces, state[0]


def teacher_forward_times(rounds):
    """(c): the frozen B3 teacher's bf16 no-grad forward of the CGD step at
    batch 8, 512x512, its 89 K10 launches among its kernels, by device
    time: its pieces (:func:`_teacher_segments`; the whole forward's
    launches overflow the queue a hold can take) each queued behind a held
    stream, their spans summed. With ``rounds`` > 0 and a tree that has the
    switch, K10 as a programmatic dependent launch off and on, in rounds of
    off, on, on, off."""
    from segdistill_tpu_torch.apis import init_segmentor_state
    from segdistill_tpu_torch.tools.profile_train import CONFIG, OPTIONS
    model = init_segmentor_state(str(CONFIG), seed=0, device='cuda',
                                 cfg_options=OPTIONS)
    teacher = model.teacher
    gen = torch.Generator(device='cuda').manual_seed(0)
    img = torch.randn(8, 3, 512, 512, device='cuda', generator=gen)
    before = ln.FWD_KERNEL.launches
    with torch.no_grad():
        want = teacher(img)
    print(f'teacher forward: {ln.FWD_KERNEL.launches - before} K10 launches',
          flush=True)
    pieces, got = _teacher_segments(teacher, img)
    if not torch.equal(got, want):
        raise AssertionError('the teacher forward in pieces differs from '
                             'the whole')
    arms = [None]
    if rounds and hasattr(ln, 'PDL'):
        arms = [False, True, True, False] * rounds
    kept = getattr(ln, 'PDL', None)
    for pdl in arms:
        if pdl is not None:
            ln.PDL = pdl
        with torch.no_grad():
            parts = [queued_ms(p) for p in pieces]
        tag = '' if pdl is None else f' K10 PDL {"on " if pdl else "off"}'
        print(f'teacher forward (B3, bf16, batch 8, no grad){tag}: queued '
              f'device span {sum(p[0] for p in parts):.4f} ms in '
              f'{len(parts)} pieces (each issued inside its hold: host at '
              f'most {max(p[1] / p[2] for p in parts):.2f} of the hold)',
              flush=True)
    if kept is not None:
        ln.PDL = kept


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
          f'{bb[0]:.4f} ({bb[1]}) | K5 exp floor '
          f'{_exp_floor_ms(shape, out_hw, 1 + 1 / 8):.4f}', flush=True)


def _exp_floor_ms(shape, out_hw, per_value):
    """The special-function units' floor of a forward that takes
    ``per_value`` exponentials per upsampled value."""
    b, c = shape[:2]
    return per_value * b * c * out_hw[0] * out_hw[1] \
        / kernel_cases.PEAK_EXP2 * 1e3


def kl_times(tag, name, shape, out_hw, fused, dtype, gen, pixel_maps,
             teacher_hw=None):
    """Forward and backward device time of ``fused(xs, xt)`` on N(0, 1)
    maps (the teacher's of ``teacher_hw``, by default the student's size),
    and a backward call's host-clocked time; beside the bounds, the floor
    of the forward's two exponentials per value."""
    xs = torch.randn(shape, device='cuda', generator=gen).to(dtype)
    xt = torch.randn(tuple(shape[:2]) + tuple(teacher_hw or shape[2:]),
                     device='cuda', generator=gen).to(dtype)
    with torch.no_grad():
        fwd = device_ms(lambda: fused(xs, xt), calls=3)
    k = xs.clone().requires_grad_()
    loss = fused(k, xt)
    gbar = torch.ones((), device='cuda')

    def backward():
        torch.autograd.grad(loss, k, gbar, retain_graph=True)
    bwd = device_ms(backward, calls=3)
    call = cuda_ms(backward)
    fb, bb = kernel_cases.kl_bounds(shape, out_hw, dtype, pixel_maps,
                                    teacher_hw)
    teacher = f' teacher {tuple(teacher_hw)}' if teacher_hw else ''
    print(f'{tag} {name:18s} {shape}{teacher}->{out_hw} '
          f'{str(dtype)[6:]:8s} fwd device {fwd:.4f} ms | bwd device '
          f'{bwd:.4f} ms, call {call:.4f} | bounds {fb[0]:.4f} {bb[0]:.4f} '
          f'({bb[1]}) | fwd exp floor {_exp_floor_ms(shape, out_hw, 2):.4f}',
          flush=True)


def resize_sum_times(name, shapes, out_hw, dtype, gen):
    """K1's device time (10 calls queued behind a held stream) and a
    call's host-clocked time, and the plain version's device time, on
    N(0, 1) parts, beside the bound."""
    parts = [torch.randn(sh, device='cuda', generator=gen).to(dtype)
             for sh in shapes]
    with torch.no_grad():
        dev = device_ms(lambda: rs.fused_resize_sum(parts, out_hw))
        call = cuda_ms(lambda: rs.fused_resize_sum(parts, out_hw))
        plain = device_ms(lambda: rs.resize_sum_plain(parts, out_hw), calls=3)
    bound, by = kernel_cases.resize_sum_bound(shapes, out_hw, dtype)
    print(f'K1 {name:18s} {str(dtype)[6:]:8s} device {dev:.4f} ms '
          f'({dev / bound:.2f}x the bound) call {call:.4f} | plain device '
          f'{plain:.4f} | bound {bound:.4f} ({by})', flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--times-only', action='store_true')
    parser.add_argument('--only', nargs='*', default=FAMILIES,
                        choices=FAMILIES, help='the kernels to time')
    parser.add_argument('--pdl-rounds', type=int, default=0,
                        help='rounds of K10 as a programmatic dependent '
                             'launch off, on, on, off in the teacher forward')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('bench_kernels: needs a CUDA device')
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    print(f'kernels of {ln.__file__}', flush=True)
    only = set(args.only)
    # the kernels of the families asked for, one source each
    sources = {'ln': [ln.FWD_KERNEL, ln.BWD_KERNEL],
               'ce': [sc.FWD_KERNEL, sc.BWD_KERNEL],
               'gkl': [gk.FWD_KERNEL, gk.BWD_KERNEL],
               'pkl': [pk.FWD_KERNEL, pk.BWD_KERNEL], 'k1': [rs.KERNEL]}
    if hasattr(ln, 'EMPTY_KERNEL'):
        sources['ln'].append(ln.EMPTY_KERNEL)
    kernels = [k for f in FAMILIES if f in only for k in sources[f]]
    build_all(kernels)
    for kern in [ks[0] for f, ks in sources.items() if f in only]:
        print(f'{kern.source.name}: built in {kern.build_seconds:.1f} s')
        for line in kern.build_log.splitlines():
            if 'registers' in line or 'spill' in line or 'Compiling' in line:
                print('  ' + line.strip())
    gen = torch.Generator(device='cuda').manual_seed(0)
    if 'ln' in only:
        ln_step_times(gen)
    if 'ce' in only:
        for case in CE_CASES:
            for dtype in (torch.bfloat16, torch.float32):
                ce_times(*case, dtype, gen)
    if 'gkl' in only:
        for name, shape, out_hw, g, shuffle, _ in GKL_CASES:
            perm = torch.randperm(shape[1], device='cuda', generator=gen) \
                if shuffle else None
            for dtype in (torch.bfloat16, torch.float32):
                kl_times('K3/K4', name, shape, out_hw,
                         lambda a, t: gk.fused_group_kl_shuffled(
                             a, t, perm, out_hw, g, 2.0), dtype, gen, 0)
        # a teacher of another size (the two-geometry tiles or the gather
        # variants, as each case names), each beside the same-size pair of
        # the student's shape at the same output
        for name, shape, thw, out_hw, g, shuffle, *_ in \
                kernel_cases.GROUP_KL_TWO_SIZE_CASES:
            perm = torch.randperm(shape[1], device='cuda', generator=gen) \
                if shuffle else None
            for dtype in (torch.bfloat16, torch.float32):
                for teacher, tag in ((thw, name), (None, 'same size')):
                    kl_times('K3/K4', tag, shape, out_hw,
                             lambda a, t: gk.fused_group_kl_shuffled(
                                 a, t, perm, out_hw, g, 2.0)
                             if shuffle else gk.fused_group_kl(
                                 a, t, out_hw, g, 2.0),
                             dtype, gen, 0, teacher)
    if 'pkl' in only:
        for name, shape, thw, out_hw in kernel_cases.PIXEL_KL_TWO_SIZE_CASES:
            for dtype in (torch.bfloat16, torch.float32):
                for teacher, tag in ((thw, name), (None, 'same size')):
                    kl_times('K7/K8', tag, shape, out_hw,
                             lambda a, t: pk.fused_pixel_kl(a, t, out_hw,
                                                            1.0),
                             dtype, gen, 2, teacher)
        for name, shape, out_hw, _, _ in PKL_CASES:
            for dtype in (torch.bfloat16, torch.float32):
                kl_times('K7/K8', name, shape, out_hw,
                         lambda a, t: pk.fused_pixel_kl(a, t, out_hw, 1.0),
                         dtype, gen, 2)
    if 'k1' in only:
        for name, shapes, out_hw in RS_CASES:
            for dtype in (torch.float32, torch.bfloat16):
                resize_sum_times(name, shapes, out_hw, dtype, gen)
    if not args.times_only and 'ln' in only:
        if hasattr(ln, 'forward_plan'):
            ln_plan_sweep(gen)
        for rows, c in LN_CASES:
            ln_block_sweep(rows, c, torch.bfloat16, gen)
        ln_host_breakdown(*LN_CASES[3], torch.bfloat16, gen)
        ln_host_breakdown(*LN_CASES[0], torch.bfloat16, gen)
    if 'ln' in only:
        teacher_forward_times(args.pdl_rounds)
    print('bench_kernels: ok')


if __name__ == '__main__':
    main()
