"""Where one train step spends its time on a CUDA device: by default the
CGD step of ``configs/exp_tab5/segformer_CGD.py`` (MiT-B0 student, frozen
MiT-B3 teacher), bf16 backbones, batch 8 at 512x512, random weights from
seed 0, checkpoint paths cleared; or a segmentor's own step (a config
whose model is not an SDModule, e.g. ``configs/extra/*.py``: bf16
backbone, its optimizer):

    python -m segdistill_tpu_torch.tools.profile_train [--steps 5]
        [--config configs/exp_tab5/segformer_PD.py | --recipe ocrnet_hr18]
        [--batch 8]
        [--hw 512 1024]
        [--cfg-options model.cfg_s.backbone.fused_attention=train ...]
        [--ab model.cfg_s.backbone.fused_attention=False --pairs 5]
        [--trace-dir DIR]

1. The step's phases by CUDA events, ms per step: student forward with
   the head CE, teacher forward, distillation loss, backward, AdamW (a
   segmentor's own step: forward with the heads' losses, backward, the
   optimizer).
2. ``torch.profiler`` over ``--steps`` steps: wall and device-busy ms per
   step (the kernels' times summed, and the union of their intervals),
   kernels per step, copy kernels per step (the casts of the fp32
   weights among them), device time by kernel family, and the kernels
   hand-written kernels by function and the kernels that take the most
   device time.
3. With ``--ab OPTION=VALUE``: the model with that option added (the same
   weights) against the model without it: the profile of 2. for the
   second arm, then ``--pairs`` rounds of ``--steps`` timed steps each, in
   the order A B B A: ms per step of each round on the host clock, and
   each arm's median and peak memory.

The profiled steps of 2. (and of 3.) are also written as a Chrome trace
(``torch.profiler``'s ``export_chrome_trace``) to ``--trace-dir`` (by
default ``segdistill_trace`` in the temporary directory):
``train_step.json`` (``train_step_ab.json``); chrome://tracing or Perfetto
read them. This is the trace half of the JAX package's
``tools/profile_step.py``, whose ``--bench`` workload is this tool's
default and whose ``--report`` tables are 2.

``--recipe`` names a recipe of ``recipes.py`` in place of ``--config``: a
model fragment composed with the Cityscapes, HRF or DRIVE bases in memory
(e.g. ``ocrnet_hr18``, ``pspnet_s101-d8 --batch 2 --hw 512 1024``,
``fcn_unet_s5-d16 --batch 4 --hw 256 256``), or a multi-teacher CGD step
(``mt_cgd_aligned``, ``mt_cgd_random``: B0 <- B2 + B3 at batch 8, 512x512).
A multi-teacher model (SDModuleMT, from a recipe or a config file) gets bf16
backbones for the student and every teacher and its checkpoints cleared;
its phases are those of the CGD step, the teachers' forwards in one phase
(the random ensemble's: the one teacher each step draws), timed inside
its own ``forward_train``.
``--cfg-options`` values are Python literals (``None``, ``False``, 1.5) or
else strings. The first line is the card's name and power limit.
"""

import argparse
import ast
import os
import re
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..apis import init_segmentor_state, prepare_training
from ..config import Config
from ..engine import step_seed
from ..models.segmentors import parse_losses
from ..recipes import ALL_RECIPES, mt_bf16_options, recipe

CONFIG = Path(__file__).resolve().parents[2] / 'configs' / 'exp_tab5' / \
    'segformer_CGD.py'
# the configs' checkpoints are not in the repository
CLEARED = {'model.t_pretrain': None, 'model.s_pretrain': None,
           'model.cfg_s.pretrained': None}
# ... and bf16 backbones (an SDModuleMT's: recipes.mt_bf16_options)
OPTIONS = dict(CLEARED, **{'model.cfg_s.backbone.dtype': 'bfloat16',
                           'model.cfg_t.backbone.dtype': 'bfloat16'})
# a segmentor trained on its own (configs/extra): its backbone in bf16
OWN_OPTIONS = {'model.backbone.dtype': 'bfloat16'}
BATCH = 8
# kernel families, first match wins (device kernel names; K4, K6 and K8
# are the tile kernel tile_bwd with the losses gkl_tile, ce_tile, pkl_tile;
# K3, K5 and K7 the forward tile kernel fwd_tile with gkl_fwd_tile (after
# gkl_max), ce_fwd_tile and pkl_fwd_tile)
FAMILIES = [
    ('K3/K4 group_kl', r'gkl_'),
    ('K5/K6 seg_ce', r'ce_(fwd|bwd|finalize|tile)'),
    ('K7/K8 pixel_kl', r'pkl_'),
    ('K1 resize_sum', r'resize_sum_kernel'),
    ('K9 sra_attn_bwd', r'sra_bwd_'),
    ('K2 sra_attn', r'sra_fwd_'),
    ('K10/K11 layer_norm', r'ln_(fwd|bwd|sum_partials)'),
    ('GEMM', r'gemm|xmma|cutlass|sm90_|ampere_|matmul|nvjet'),
    ('batch norm', r'bn_fw|bn_bw|batch_norm|BatchNorm|welford'),
    ('convolution', r'conv|cudnn|implicit|winograd|dgrad|wgrad|fprop'),
    ('layer norm', r'layer_norm|LayerNorm'),
    # softmax_warp_* (short rows) and cunn_SoftMax* (long rows: the
    # attention heads' fp32 maps)
    ('softmax', r'(?i)softmax'),
    ('upsample backward', r'upsample\w*backward'),
    ('upsample', r'upsample'),
    ('optimizer', r'multi_tensor|adam|Adam|sgd'),
    ('pooling', r'pool'),
    ('point sampling', r'grid_sampler'),
    ('sort and top-k', r'sort|topk|radix'),
    ('reduction', r'reduce'),
    ('elementwise and copies', r'elementwise|vectorized|unrolled|copy|fill|'
                               r'cat|index|gather|scatter'),
]


def family(name):
    for label, pattern in FAMILIES:
        if re.search(pattern, name):
            return label
    return 'other'


def phase_times(model, optimizer, img, gt, steps):
    """Mean ms per step between CUDA events recorded at the phase edges
    (device time from the first kernel of a phase to its last, idle gaps
    included). A distiller's step is its own ``forward_train``: the edges
    inside it are recorded where the first teacher's forward starts (a
    wrapper of each teacher's ``forward_feats``; an SDModuleMT's random
    ensemble runs the one teacher it draws) and where the distillation
    loss starts (a wrapper of each ``DistillationLoss`` the model holds),
    and the wrappers are removed afterwards."""
    if not hasattr(model, 'distillation_loss'):
        return _own_phase_times(model, optimizer, img, gt, steps)
    names = ['student forward + head CE', 'teacher forward',
             'distillation loss', 'backward', 'AdamW']
    marks = {}

    def mark(edge):
        if edge not in marks:
            marks[edge] = torch.cuda.Event(enable_timing=True)
            marks[edge].record()

    def marked(edge, fn):
        def run(*args, **kwargs):
            mark(edge)
            return fn(*args, **kwargs)
        return run
    teachers = list(getattr(model, 'teachers', [])) or [model.teacher]
    if len(teachers) > 1:
        names[1] = 'teachers\' forwards'
    loss, per_teacher = model.distillation_loss, \
        list(getattr(model, 'per_teacher_losses', []))
    for teacher in teachers:
        teacher.forward_feats = marked('teacher', teacher.forward_feats)
    model.distillation_loss = marked('loss', loss)
    if per_teacher:
        model.per_teacher_losses[:] = [marked('loss', x) for x in per_teacher]
    rows = []
    try:
        for step in range(1, steps + 1):
            gen = torch.Generator(device=img.device).manual_seed(
                step_seed(0, step))
            marks.clear()
            mark('start')
            losses = model.forward_train(img, gt, step, generator=gen)
            total, _ = parse_losses(losses)
            mark('parsed')
            optimizer.zero_grad(set_to_none=True)
            total.backward()
            mark('backward')
            optimizer.step()
            mark('optimizer')
            rows.append([marks[k] for k in ('start', 'teacher', 'loss',
                                            'parsed', 'backward',
                                            'optimizer')])
    finally:
        for teacher in teachers:
            del teacher.forward_feats
        model.distillation_loss = loss
        if per_teacher:
            model.per_teacher_losses[:] = per_teacher
    _print_phases(names, rows)


def _own_phase_times(model, optimizer, img, gt, steps):
    """The phases of a segmentor's own step: forward with its heads'
    losses, backward, the optimizer."""
    names = ['forward + heads\' losses', 'backward', 'optimizer']
    rows = []
    for step in range(1, steps + 1):
        gen = torch.Generator(device=img.device).manual_seed(
            step_seed(0, step))
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        losses, _ = model.forward_train(img, gt, generator=gen)
        total, _ = parse_losses(losses)
        ev[1].record()
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        ev[2].record()
        optimizer.step()
        ev[3].record()
        rows.append(ev)
    _print_phases(names, rows)


def _print_phases(names, rows):
    torch.cuda.synchronize()
    ms = np.array([[a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
                   for ev in rows]).mean(axis=0)
    for name, t in zip(names, ms):
        print(f'  {name:28s} {t:8.3f} ms {t / ms.sum():6.1%}')
    print(f'  {"total":28s} {ms.sum():8.3f} ms')


def _union_ms(events):
    """Milliseconds of device time covered by at least one of ``events``."""
    total, start, end = 0.0, None, None
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total / 1e3


def profile_steps(state, train_step, img, gt, steps, top=20, trace=None):
    """Print the profile of ``steps`` steps; write them as a Chrome trace
    to the file ``trace`` where given."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            train_step(state, img, gt)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps * 1e3
    if trace is not None:
        prof.export_chrome_trace(trace)
        print(f'  trace written to {trace}')
    # kernels only: a GPU user annotation (Optimizer.step's range) spans
    # kernels that are counted on their own
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    busy_ms = sum(e.device_time for e in events) / steps / 1e3
    print(f'  wall {wall_ms:.3f} ms/step (profiled), device busy '
          f'{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}), '
          f'{len(events) / steps:.0f} kernels/step')
    # a kernel launched as a programmatic dependent launch (K10) starts
    # before the one ahead of it ends and waits inside its own time: the
    # union of the kernels' intervals counts that overlap once
    print(f'  device busy as the union of kernel intervals '
          f'{_union_ms(events) / steps:.3f} ms/step')
    # dtype casts (of the fp32 weights, mostly) and layout copies
    copies = [e for e in events if re.search(r'copy', e.name)]
    print(f'  copy kernels: {len(copies) / steps:.0f} per step, '
          f'{sum(e.device_time for e in copies) / steps / 1e3:.3f} ms')
    fams, rows = {}, {}
    for e in events:
        ms = e.device_time / steps / 1e3
        fams[family(e.name)] = fams.get(family(e.name), 0.0) + ms
        row = rows.setdefault(e.name, [0.0, 0])
        row[0] += ms
        row[1] += 1
    print('  device time by kernel family:')
    for name, ms in sorted(fams.items(), key=lambda r: -r[1]):
        print(f'    {ms:8.3f} ms {ms / busy_ms:6.1%}  {name}')
    # the hand-written kernels by function, template arguments folded but
    # for the tile kernels' loss (tile_bwd<ce_tile>, fwd_tile<ce_fwd_tile>,
    # fwd_tile<pkl_fwd_tile>; the two-geometry form folds into its loss's)
    own = {}
    for name, (ms, n) in rows.items():
        if re.match(r'K\d', family(name)):
            short = re.sub(r'void |\(anonymous namespace\)::|segdistill::',
                           '', name)
            fn = re.match(r'(\w+)(?:<[^,<>]*, (\w+_tile)(?:<[^<>]*>)?'
                          r'(?:, \w+)?\s*>)?', short)
            key = fn.group(1) + (f'<{fn.group(2)}>' if fn.group(2) else '') \
                if fn else name
            row = own.setdefault(key, [0.0, 0])
            row[0] += ms
            row[1] += n
    print('  hand-written kernels by function:')
    for name, (ms, n) in sorted(own.items(), key=lambda r: -r[1][0]):
        print(f'    {ms:8.3f} ms x{n // steps:3d}  {name}')
    print(f'  top {top} kernels:')
    for name, (ms, n) in sorted(rows.items(), key=lambda r: -r[1][0])[:top]:
        print(f'    {ms:8.3f} ms {ms / busy_ms:6.1%} x{n // steps:3d}  '
              f'{name[:90]}')


def _timed_ms(state, train_step, img, gt, steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        train_step(state, img, gt)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def ab_steps(arms, img, gt, steps, pairs):
    """``pairs`` rounds of A B B A, ``steps`` timed steps each: prints each
    round's ms per step, each arm's median and its peak memory."""
    ms = {tag: [] for tag in arms}
    peak = dict.fromkeys(arms, 0)
    (a, arm_a), (b, arm_b) = arms.items()
    for _ in range(pairs):
        for tag, arm in ((a, arm_a), (b, arm_b), (b, arm_b), (a, arm_a)):
            torch.cuda.reset_peak_memory_stats()
            ms[tag].append(_timed_ms(*arm, img, gt, steps))
            peak[tag] = max(peak[tag], torch.cuda.max_memory_allocated())
    for tag, values in ms.items():
        print(f'  {tag}: median {np.median(values):.3f} ms/step, '
              f'{len(img) * 1e3 / np.median(values):.2f} images/s, peak '
              f'memory {peak[tag] / 2**30:.2f} GiB; rounds '
              + ' '.join(f'{v:.3f}' for v in values))


def _option(text):
    key, _, value = text.partition('=')
    try:
        return key, ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return key, value


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--steps', type=int, default=5)
    parser.add_argument('--config', default=str(CONFIG))
    parser.add_argument('--recipe', choices=ALL_RECIPES,
                        help='a recipe of recipes.py, in place of --config')
    parser.add_argument('--cfg-options', nargs='*', default=[],
                        metavar='KEY=VALUE')
    parser.add_argument('--ab', metavar='KEY=VALUE')
    parser.add_argument('--pairs', type=int, default=5)
    parser.add_argument('--batch', type=int, default=BATCH,
                        help='images a step (the psp, swin and extra '
                             'configs train 2)')
    parser.add_argument('--hw', type=int, nargs=2, default=(512, 512),
                        help='the crop (the Cityscapes config: 512 1024)')
    parser.add_argument('--trace-dir', default=os.path.join(
        tempfile.gettempdir(), 'segdistill_trace'),
                        help="where the profiled steps' Chrome traces go")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_train needs a CUDA device')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    config = recipe(args.recipe) if args.recipe \
        else Config.fromfile(args.config)
    kind = config.model['type']
    base = dict(CLEARED, **mt_bf16_options(config)) \
        if kind == 'SDModuleMT' else OPTIONS if kind == 'SDModule' \
        else OWN_OPTIONS
    options = dict(base, **dict(map(_option, args.cfg_options)))
    print(f'{args.recipe or args.config} {options}')
    model = init_segmentor_state(config, seed=0, device='cuda',
                                 cfg_options=options)
    state, train_step = prepare_training(model)
    gen = torch.Generator(device='cuda').manual_seed(0)
    classes = getattr(model, 'student', model).num_classes
    img = torch.randn(args.batch, 3, *args.hw, device='cuda', generator=gen)
    gt = torch.randint(0, classes, (args.batch, *args.hw), device='cuda',
                       generator=gen)
    for _ in range(3):
        train_step(state, img, gt)
    torch.cuda.synchronize()
    print(f'== 1. phases of a step, batch {args.batch} at '
          f'{args.hw[0]}x{args.hw[1]}, bf16 backbones (CUDA events, mean of '
          f'{args.steps} steps)')
    phase_times(model, state.optimizer, img, gt, args.steps)
    print(f'== 2. torch.profiler over {args.steps} train steps')
    os.makedirs(args.trace_dir, exist_ok=True)
    profile_steps(state, train_step, img, gt, args.steps,
                  trace=os.path.join(args.trace_dir, 'train_step.json'))
    if args.ab:
        key, value = _option(args.ab)
        other = init_segmentor_state(config, seed=0, device='cuda',
                                     cfg_options=dict(options, **{key: value}))
        other.load_state_dict(model.state_dict())
        other_state, other_step = prepare_training(other)
        for _ in range(3):
            other_step(other_state, img, gt)
        print(f'== 3. with {key}={value!r}: torch.profiler over '
              f'{args.steps} train steps')
        profile_steps(other_state, other_step, img, gt, args.steps, top=8,
                      trace=os.path.join(args.trace_dir,
                                         'train_step_ab.json'))
        print(f'   A/B, {args.pairs} rounds of A B B A, {args.steps} steps '
              f'each (host clock)')
        ab_steps({'as configured': (state, train_step),
                  f'with {key}={value!r}': (other_state, other_step)},
                 img, gt, args.steps, args.pairs)


if __name__ == '__main__':
    main()
