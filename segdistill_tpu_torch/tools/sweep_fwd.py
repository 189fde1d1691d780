"""Time variants of the forward kernels' constants on the card: K3
(``gkl_fwd_tile``), K5 (``ce_fwd_tile``) and K7 (``pkl_fwd_tile``) rebuilt
with other rows a thread, window elements a thread (slots), units a step
(K5: channels; K7: channels of both maps) and blocks an SM, at the train
step's bench shape, (8, 150, 128, 128) -> 512², bf16 and fp32; and K1
(``resize_sum.cu``) with other rows a thread, at the B0 head's shapes and
the B3 teacher's.

    python -m segdistill_tpu_torch.tools.sweep_fwd [--out DIR] [--only K7 K1]

Each variant is a copy of ``csrc/`` (under ``--out``, by default
``build/sweep_fwd``) with the loss's ``static constexpr`` constants
replaced; all are built at once (one ``nvcc`` each), then timed by device
time in two rounds, the second in reverse order, each beside its loss's
relative error against the plain version (and K5's ``correct`` against the
plain count), which catches a variant that the plan or the source gets
wrong. It ends with the kernels of one call of each by name
(``torch.profiler``). Prints the card's name and power limit first; needs a
CUDA device. The wrappers' plans read the modules' ``FWD_*`` counts, which
are set to each variant's in turn.
"""

import argparse
import pathlib
import re
import shutil
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from segdistill_tpu_torch.ops import group_kl as gk
from segdistill_tpu_torch.ops import pixel_kl as pk
from segdistill_tpu_torch.ops import resize_sum as rs
from segdistill_tpu_torch.ops import seg_ce as sc
from segdistill_tpu_torch.ops.cuda_kernel import (BUILD_DIR, CSRC_DIR,
                                                  CudaKernel, build_all)
from segdistill_tpu_torch.tools import kernel_cases
from segdistill_tpu_torch.utils.timing import device_ms

# (rows a thread, slots, blocks an SM); the first is the source's own
K3_VARIANTS = [(32, 3, 4), (16, 4, 4), (16, 2, 4), (16, 2, 5), (8, 4, 4),
               (32, 3, 3)]
# (rows a thread, channels a step, slots, blocks an SM)
K5_VARIANTS = [(8, 8, 1, 2), (4, 8, 1, 3), (8, 4, 1, 3), (16, 4, 2, 2),
               (8, 8, 1, 3)]
# (rows a thread, units a step: 2 per channel, slots, blocks an SM)
K7_VARIANTS = [(8, 8, 1, 2), (4, 8, 1, 2), (8, 8, 1, 3), (4, 8, 1, 3),
               (4, 16, 1, 2), (4, 16, 1, 3), (8, 16, 1, 2)]
# K1's rows a thread; the first is the source's own
K1_VARIANTS = [16, 8, 32]
SHAPE, OUT_HW, GROUP, TAU = (8, 150, 128, 128), (512, 512), 10, 2.0
# the loss of each forward: its source, its entry point and its module
LOSSES = {'gkl_fwd_tile': ('group_kl.cu', 'group_kl_fwd', gk),
          'ce_fwd_tile': ('seg_ce.cu', 'seg_ce_fwd', sc),
          'pkl_fwd_tile': ('pixel_kl.cu', 'pixel_kl_fwd', pk),
          None: ('resize_sum.cu', 'resize_sum_fwd', rs)}


def _variant(out, tag, struct, consts):
    """A copy of csrc/ whose ``struct`` (None: K1's source, at namespace
    scope) has ``consts``."""
    source, symbol, mod = LOSSES[struct]
    d = out / re.sub(r'\W+', '_', tag)
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(CSRC_DIR, d)
    p = d / source
    s = p.read_text()
    a = s.index(f'struct {struct} {{') if struct else 0
    b = s.index('\n};\n', a) if struct else len(s)
    body = s[a:b]
    for name, value in consts.items():
        body, n = re.subn(rf'constexpr int {name} = \d+;',
                          f'constexpr int {name} = {value};', body)
        if n != 1:
            raise ValueError(f'{tag}: no single {name} in {struct}')
    # the tag changes the source's hash, so each variant builds its own
    p.write_text(f'// variant {tag}\n' + s[:a] + body + s[b:])
    kernel = mod.KERNEL if mod is rs else mod.FWD_KERNEL
    k = CudaKernel(tag, symbol, kernel.argtypes, 'variant')
    k.source = p
    return k


def _registers(kernel):
    log = kernel.build_log.splitlines()
    return ' | '.join(
        ' '.join(x.split('info    :')[-1].strip() for x in log[i + 1:i + 4]
                 if 'registers' in x or 'spill' in x)
        for i, line in enumerate(log)
        if 'Compiling entry' in line
        and ('fwd_tile' in line or 'resize_sum_kernel' in line))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--out', type=pathlib.Path,
                        default=BUILD_DIR.parent / 'sweep_fwd')
    parser.add_argument('--only', choices=('K3', 'K5', 'K7', 'K1'),
                        nargs='*', default=('K3', 'K5', 'K7', 'K1'))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('sweep_fwd: needs a CUDA device')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    k3, k5, k7 = {}, {}, {}
    for rows, slots, res in K3_VARIANTS if 'K3' in args.only else ():
        tag = f'K3 rows {rows} slots {slots} blocks/SM {res}'
        k3[tag] = (_variant(args.out, tag, 'gkl_fwd_tile',
                            dict(kRows=rows, kSlots=slots, kResident=res)),
                   dict(FWD_ROWS=rows, FWD_SLOTS=slots))
    for rows, units, slots, res in K5_VARIANTS if 'K5' in args.only \
            else ():
        tag = f'K5 rows {rows} units {units} slots {slots} blocks/SM {res}'
        k5[tag] = (_variant(args.out, tag, 'ce_fwd_tile',
                            dict(kRows=rows, kUnits=units, kSlots=slots,
                                 kResident=res)),
                   dict(FWD_ROWS=rows, FWD_UNITS=units, FWD_SLOTS=slots))
    for rows, units, slots, res in K7_VARIANTS if 'K7' in args.only \
            else ():
        tag = f'K7 rows {rows} units {units} slots {slots} blocks/SM {res}'
        k7[tag] = (_variant(args.out, tag, 'pkl_fwd_tile',
                            dict(kRows=rows, kUnits=units, kSlots=slots,
                                 kResident=res)),
                   dict(FWD_ROWS=rows, FWD_UNITS=units, FWD_SLOTS=slots))
    k1 = {}
    for rows in K1_VARIANTS if 'K1' in args.only else ():
        tag = f'K1 rows {rows}'
        k1[tag] = (_variant(args.out, tag, None, dict(kRows=rows)), {})
    variants = {**k3, **k5, **k7, **k1}
    build_all([k for k, _ in variants.values()])
    for tag, (k, _) in variants.items():
        print(f'{tag}: {_registers(k)}', flush=True)

    gen = torch.Generator(device='cuda').manual_seed(0)
    perm = torch.randperm(SHAPE[1], device='cuda', generator=gen)
    labels = torch.randint(0, SHAPE[1], (SHAPE[0],) + OUT_HW, device='cuda',
                           generator=gen)
    inputs = {}
    for dtype in (torch.bfloat16, torch.float32):
        xs, xt = (torch.randn(SHAPE, device='cuda', generator=gen).to(dtype)
                  for _ in range(2))
        want_kl = gk.group_kl_plain(xs, xt, perm, OUT_HW, GROUP, TAU).item()
        want_ce = [t.item() for t in sc.seg_ce_plain(xs, labels, OUT_HW,
                                                     SHAPE[1])]
        want_pkl = pk.pixel_kl_plain(xs, xt, OUT_HW, 1.0).item()
        inputs[dtype] = (xs, xt, want_kl, want_ce, want_pkl)

    def use(mod, variant):
        kernel, counts = variant
        mod.FWD_KERNEL = kernel
        for name, value in counts.items():
            setattr(mod, name, value)

    def run(tag, dtype):
        xs, xt, want_kl, want_ce, want_pkl = inputs[dtype]
        if tag in k3:
            use(gk, k3[tag])

            def fn():
                return gk.fused_group_kl_shuffled(xs, xt, perm, OUT_HW,
                                                  GROUP, TAU)
            with torch.no_grad():
                err = (f'loss rel err '
                       f'{abs(fn().item() - want_kl) / want_kl:.2e}')
        elif tag in k1:
            rs.KERNEL = k1[tag][0]
            for name, shapes, out_hw in kernel_cases.RESIZE_SUM_CASES[:3]:
                dt = torch.float32 if name.startswith('B0 head b1') else dtype
                parts = [torch.randn(s, device='cuda', generator=gen).to(dt)
                         for s in shapes]
                with torch.no_grad():
                    got = rs.fused_resize_sum(parts, out_hw)
                    err = (got.float() - rs.resize_sum_plain(
                        [p.float() for p in parts], out_hw).float()).abs() \
                        .max().item()
                    ms = device_ms(lambda: rs.fused_resize_sum(parts, out_hw))
                bound = kernel_cases.resize_sum_bound(shapes, out_hw, dt)[0]
                print(f'{str(dt)[6:]:8s} {tag:40s} {name:16s} {ms:.4f} ms '
                      f'({ms / bound:.2f}x the bound)  max abs err {err:.2e}',
                      flush=True)
            return
        elif tag in k7:
            use(pk, k7[tag])

            def fn():
                return pk.fused_pixel_kl(xs, xt, OUT_HW, 1.0)
            with torch.no_grad():
                err = (f'loss rel err '
                       f'{abs(fn().item() - want_pkl) / want_pkl:.2e}')
        else:
            use(sc, k5[tag])

            def fn():
                return sc.fused_seg_ce(xs, labels, OUT_HW, SHAPE[1])
            with torch.no_grad():
                ce, correct = fn()
            err = (f'ce rel err {abs(ce.item() - want_ce[0]) / want_ce[0]:.2e}'
                   f' correct {correct.item() - want_ce[1]:+.0f}')
        with torch.no_grad():
            ms = device_ms(fn, calls=3)
        print(f'{str(dtype)[6:]:8s} {tag:40s} {ms:.4f} ms  {err}', flush=True)

    tags = list(variants)
    for dtype in (torch.bfloat16, torch.float32):
        for order in (tags, tags[::-1]):
            for tag in order:
                run(tag, dtype)
    # the sources' own constants: the kernels of one call of each by name
    calls = []
    for mod, found in ((gk, k3), (sc, k5), (pk, k7)):
        if found:
            use(mod, next(iter(found.values())))
    xs, xt = inputs[torch.bfloat16][:2]
    if k3:
        calls.append(lambda: gk.fused_group_kl_shuffled(xs, xt, perm, OUT_HW,
                                                        GROUP, TAU))
    if k5:
        calls.append(lambda: sc.fused_seg_ce(xs, labels, OUT_HW, SHAPE[1]))
    if k7:
        calls.append(lambda: pk.fused_pixel_kl(xs, xt, OUT_HW, 1.0))
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            for call in calls:
                call()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows[e.name] = rows.get(e.name, 0.0) + e.device_time / 5 / 1e3
    for name, ms in sorted(rows.items(), key=lambda r: -r[1]):
        print(f'  {ms:.4f} ms  {name[:100]}')
    print('sweep_fwd: ok')


if __name__ == '__main__':
    main()
