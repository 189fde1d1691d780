"""Where one CGD distillation train step spends its time on a CUDA device:
MiT-B0 student, frozen MiT-B3 teacher, bf16 backbones, batch 8 at 512x512
(``configs/exp_tab5/segformer_CGD.py``, random weights from seed 0):

    python -m segdistill_tpu_torch.tools.profile_train [--steps 5]

1. The step's phases by CUDA events, ms per step: student forward with
   the head CE, teacher forward, CGD loss, backward, AdamW.
2. ``torch.profiler`` over ``--steps`` steps: wall and device-busy ms per
   step, kernels per step, device time by kernel family, and the kernels
   that take the most device time.

The first line is the card's name and power limit.
"""

import argparse
import re
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..apis import init_segmentor_state, prepare_training
from ..engine import step_seed
from ..models.segmentors import parse_losses

CONFIG = Path(__file__).resolve().parents[2] / 'configs' / 'exp_tab5' / \
    'segformer_CGD.py'
OPTIONS = {'model.t_pretrain': None, 'model.s_pretrain': None,
           'model.cfg_s.pretrained': None,
           'model.cfg_s.backbone.dtype': 'bfloat16',
           'model.cfg_t.backbone.dtype': 'bfloat16'}
BATCH = 8
# kernel families, first match wins (device kernel names)
FAMILIES = [
    ('K3/K4 group_kl', r'gkl_'),
    ('K5/K6 seg_ce', r'ce_(fwd|bwd|finalize)'),
    ('K1 resize_sum', r'resize_sum_kernel'),
    ('K2 sra_attn', r'sra_attn'),
    ('GEMM', r'gemm|xmma|cutlass|sm90_|ampere_|matmul'),
    ('convolution', r'conv|cudnn|implicit|winograd|dgrad|wgrad|fprop'),
    ('layer/batch norm', r'layer_norm|batch_norm|LayerNorm|BatchNorm|welford'),
    ('softmax', r'softmax'),
    ('upsample', r'upsample'),
    ('optimizer', r'multi_tensor|adam|Adam'),
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
    included)."""
    names = ['student forward + head CE', 'teacher forward', 'CGD loss',
             'backward', 'AdamW']
    rows = []
    for step in range(1, steps + 1):
        gen = torch.Generator(device=img.device).manual_seed(
            step_seed(0, step))
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        losses, s_feats = model.student.forward_train(
            img, gt, capture=model.student_layers, generator=gen)
        ev[1].record()
        with torch.no_grad():
            t_feats = model.teacher.forward_feats(img, model.teacher_layers)
        ev[2].record()
        losses.update(model.distillation_loss(
            s_feats, t_feats, gt, step, generator=gen,
            adapters=model.distill_adapters))
        total, _ = parse_losses(losses)
        ev[3].record()
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        ev[4].record()
        optimizer.step()
        ev[5].record()
        rows.append(ev)
    torch.cuda.synchronize()
    ms = np.array([[a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
                   for ev in rows]).mean(axis=0)
    for name, t in zip(names, ms):
        print(f'  {name:28s} {t:8.3f} ms {t / ms.sum():6.1%}')
    print(f'  {"total":28s} {ms.sum():8.3f} ms')


def profile_steps(state, train_step, img, gt, steps, top=20):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            train_step(state, img, gt)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps * 1e3
    # kernels only: a GPU user annotation (Optimizer.step's range) spans
    # kernels that are counted on their own
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    busy_ms = sum(e.device_time for e in events) / steps / 1e3
    print(f'  wall {wall_ms:.3f} ms/step (profiled), device busy '
          f'{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}), '
          f'{len(events) / steps:.0f} kernels/step')
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
    print(f'  top {top} kernels:')
    for name, (ms, n) in sorted(rows.items(), key=lambda r: -r[1][0])[:top]:
        print(f'    {ms:8.3f} ms {ms / busy_ms:6.1%} x{n // steps:3d}  '
              f'{name[:90]}')


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--steps', type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_train needs a CUDA device')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    model = init_segmentor_state(str(CONFIG), seed=0, device='cuda',
                                 cfg_options=OPTIONS)
    state, train_step = prepare_training(model)
    gen = torch.Generator(device='cuda').manual_seed(0)
    img = torch.randn(BATCH, 3, 512, 512, device='cuda', generator=gen)
    gt = torch.randint(0, 150, (BATCH, 512, 512), device='cuda',
                       generator=gen)
    for _ in range(3):
        train_step(state, img, gt)
    torch.cuda.synchronize()
    print(f'== 1. phases of a step, batch {BATCH}, bf16 backbones '
          f'(CUDA events, mean of {args.steps} steps)')
    phase_times(model, state.optimizer, img, gt, args.steps)
    print(f'== 2. torch.profiler over {args.steps} train steps')
    profile_steps(state, train_step, img, gt, args.steps)


if __name__ == '__main__':
    main()
