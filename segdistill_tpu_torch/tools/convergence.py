"""The miniature convergence run of ``docs/convergence.md``: evidence that
the framework trains, as opposed to taking numerically right single steps.

    python -m segdistill_tpu_torch.tools.convergence [--work-dir W]
        [--device cuda]

trains through ``tools.train``'s ``main`` on the committed structured
dataset (16 train / 4 val 64x64 images, 4 classes, chance mIoU 0.25), with
the doc's setup: a real ``mit_b0`` + ``SegFormerHead`` (embed 64, 4
classes), AdamW 3e-4, poly LR, batch 4, 240 iterations, evaluations at 120
and 240 (seed 42); then the +CGD run (seed 43): group size 2, alpha 3, tau
2 on ``decode_head.linear_pred``, the frozen teacher loaded from the
baseline run's checkpoint through ``t_pretrain``; then ``tools.test``
evaluates the CGD run's student. Held to the doc's criteria: (a) each
run's ``decode.loss_seg`` falls more than 2x (the least of the last three
logged values against the first); (b) each run's final val mIoU is above
0.40 and above its first evaluation's; (c) the CGD distillation loss
decreases (the mean of its last three logged values against its first
three); and ``tools.test`` reproduces the CGD run's last evaluation. The
last line of the output is a JSON summary of both runs.
"""

import argparse
import json
import os
import tempfile
from pathlib import Path

from . import test as test_cli
from . import train as train_cli

DATA_ROOT = Path(__file__).resolve().parents[2] / 'tests' / 'data' / \
    'convergence'
DISTILL = 'loss_decode_head.linear_pred<->decode_head.linear_pred_other'
ITERS = 240
MIOU_FLOOR = 0.40
MIOU_TOL = 1e-6  # tools.test against the run's own last evaluation

ENCODER = dict(
    type='EncoderDecoder',
    backbone=dict(type='mit_b0', drop_path_rate=0.0),
    decode_head=dict(
        type='SegFormerHead', in_channels=[32, 64, 160, 256],
        in_index=[0, 1, 2, 3], feature_strides=[4, 8, 16, 32],
        channels=64, dropout_ratio=0.1, num_classes=4,
        norm_cfg=dict(type='SyncBN', requires_grad=True),
        align_corners=False, decoder_params=dict(embed_dim=64)))

CONFIG = '''
img_norm_cfg = dict(mean=[123.675, 116.28, 103.53],
                    std=[58.395, 57.12, 57.375], to_rgb=True)
crop_size = (64, 64)
train_pipeline = [
    dict(type='LoadImageFromFile'),
    dict(type='LoadAnnotations', reduce_zero_label=True),
    dict(type='Resize', img_scale=(64, 64), ratio_range=(0.9, 1.1)),
    dict(type='RandomCrop', crop_size=crop_size, cat_max_ratio=0.95),
    dict(type='RandomFlip', prob=0.5),
    dict(type='Normalize', **img_norm_cfg),
    dict(type='Pad', size=crop_size, pad_val=0, seg_pad_val=255),
    dict(type='DefaultFormatBundle'),
    dict(type='Collect', keys=['img', 'gt_semantic_seg']),
]
test_pipeline = [
    dict(type='LoadImageFromFile'),
    dict(type='MultiScaleFlipAug', img_scale=(64, 64), flip=False,
         transforms=[
             dict(type='AlignedResize', keep_ratio=True, size_divisor=32),
             dict(type='Normalize', **img_norm_cfg),
             dict(type='ImageToTensor', keys=['img']),
             dict(type='Collect', keys=['img']),
         ])]
model = {model!r}
ds = dict(type='CustomDataset', data_root={data_root!r},
          img_suffix='.jpg', seg_map_suffix='.png',
          classes=('red', 'green', 'blue', 'yellow'),
          palette=[[200, 40, 40], [40, 180, 40], [40, 60, 200],
                   [210, 200, 50]],
          reduce_zero_label=True)
data = dict(
    samples_per_gpu=4, workers_per_gpu=2,
    train=dict(img_dir='img/train', ann_dir='ann/train',
               pipeline=train_pipeline, **ds),
    val=dict(img_dir='img/val', ann_dir='ann/val', pipeline=test_pipeline,
             **ds),
    test=dict(img_dir='img/val', ann_dir='ann/val', pipeline=test_pipeline,
              **ds))
optimizer = dict(type='AdamW', lr=3e-4, betas=(0.9, 0.999),
                 weight_decay=0.01)
lr_config = dict(policy='poly', power=1.0, min_lr=1e-5, warmup='linear',
                 warmup_iters=20, warmup_ratio=1e-3, by_epoch=False)
runner = dict(type='IterBasedRunner', max_iters={iters})
checkpoint_config = dict(interval={iters}, max_keep_ckpts=1)
evaluation = dict(interval={half}, metric='mIoU')
log_config = dict(interval=20, hooks=[dict(type='TextLoggerHook')])
'''


def cgd_model(t_pretrain):
    """The +CGD SDModule: the baseline's network as student and frozen
    teacher, the teacher's weights from ``t_pretrain``."""
    return dict(type='SDModule', cfg_s=ENCODER, cfg_t=ENCODER,
                distillation=[dict(student_layer='decode_head.linear_pred',
                                   teacher_layer='decode_head.linear_pred',
                                   loss_name='CGDLoss',
                                   loss_config=dict(group_size=2, alpha=3,
                                                    tau=2))],
                t_pretrain=t_pretrain, train_cfg=dict(),
                test_cfg=dict(mode='whole'))


def write_config(path, model):
    Path(path).write_text(CONFIG.format(model=model, data_root=str(DATA_ROOT),
                                        iters=ITERS, half=ITERS // 2))


def json_log(work_dir):
    """-> ({iter: train line}, {iter: val line}) of a run's JSON log."""
    (path,) = sorted(Path(work_dir).glob('*.log.json'))
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    return ({ln['iter']: ln for ln in lines if ln['mode'] == 'train'},
            {ln['iter']: ln for ln in lines if ln['mode'] == 'val'})


def summary(work_dir, distill=False):
    """A run's logged series: ``seg`` {iter: decode.loss_seg}, ``miou``
    {iter: val mIoU}, ``step_s`` {iter: the logged step time}, and with
    ``distill`` the CGD term {iter: loss}."""
    train, val = json_log(work_dir)
    out = {'seg': {i: ln['decode.loss_seg'] for i, ln in train.items()},
           'miou': {i: ln['mIoU'] for i, ln in val.items()},
           'step_s': {i: ln['time'] for i, ln in train.items()}}
    if distill:
        out['distill'] = {i: ln[DISTILL] for i, ln in train.items()}
    return out


def check(run, name):
    """Criteria (a), (b) and, where the run has a distillation term, (c)
    of ``docs/convergence.md``; raise AssertionError with the series."""
    seg = [run['seg'][i] for i in sorted(run['seg'])]
    miou = [run['miou'][i] for i in sorted(run['miou'])]
    if len(seg) < 10 or not min(seg[-3:]) < 0.5 * seg[0]:
        raise AssertionError(f'{name}: decode.loss_seg did not fall 2x: '
                             f'{seg}')
    if len(miou) < 2 or not (miou[-1] > MIOU_FLOOR and miou[-1] > miou[0]):
        raise AssertionError(f'{name}: final mIoU not above {MIOU_FLOOR} '
                             f'and the first evaluation: {run["miou"]}')
    if 'distill' in run:
        d = [run['distill'][i] for i in sorted(run['distill'])]
        if not sum(d[-3:]) / 3 < sum(d[:3]) / 3:
            raise AssertionError(f'{name}: the CGD loss did not decrease: '
                                 f'{d}')


def run(work_dir, device='cuda', on_run=None):
    """Both runs and the test under ``work_dir``; -> {'baseline': summary,
    'cgd': summary, 'test_miou': the test's mIoU}. ``on_run(name, fn)``,
    where given, runs each training (``fn()``) for the caller, e.g. to
    count kernel launches around it."""
    work_dir = Path(work_dir)
    on_run = on_run or (lambda name, fn: fn())
    base_cfg, base_work = work_dir / 'conv_base.py', work_dir / 'work_base'
    write_config(base_cfg, ENCODER)
    on_run('baseline', lambda: train_cli.main(
        [str(base_cfg), '--work-dir', str(base_work), '--seed', '42',
         '--device', device]))
    teacher = base_work / 'checkpoints' / f'iter_{ITERS}.pth'
    cgd_cfg, cgd_work = work_dir / 'conv_cgd.py', work_dir / 'work_cgd'
    write_config(cgd_cfg, cgd_model(str(teacher)))
    on_run('cgd', lambda: train_cli.main(
        [str(cgd_cfg), '--work-dir', str(cgd_work), '--seed', '43',
         '--device', device]))
    out = {'baseline': summary(base_work), 'cgd': summary(cgd_work, True)}
    metrics = test_cli.main([str(cgd_cfg), str(cgd_work), '--eval', 'mIoU',
                             '--device', device])
    out['test_miou'] = metrics['mIoU']
    return out


def report(out):
    """Print the doc's tables: the losses at 20/80/160/240 and the mIoU at
    120/240 of each run."""
    for name in ('baseline', 'cgd'):
        r = out[name]
        cols = 'decode.loss_seg' + (', CGD loss' if 'distill' in r else '')
        print(f'{name}: iter: {cols}')
        for i in sorted(r['seg']):
            if i in (20, 80, 160, 240):
                extra = f', {r["distill"][i]:.4f}' if 'distill' in r else ''
                print(f'  {i}: {r["seg"][i]:.4f}{extra}')
        print('  val mIoU: ' + ', '.join(
            f'{i}: {m:.4f}' for i, m in sorted(r['miou'].items())))
    print(f'tools.test on the CGD student: mIoU {out["test_miou"]:.6f}')


def main(argv=None):
    parser = argparse.ArgumentParser(description='the miniature '
                                     'convergence run')
    parser.add_argument('--work-dir', default=None,
                        help='default: a temporary directory')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        work = args.work_dir or tmp
        os.makedirs(work, exist_ok=True)
        out = run(work, args.device)
    report(out)
    check(out['baseline'], 'baseline')
    check(out['cgd'], 'CGD')
    last = out['cgd']['miou'][max(out['cgd']['miou'])]
    if not abs(out['test_miou'] - last) <= MIOU_TOL:
        raise AssertionError(f'tools.test gave mIoU {out["test_miou"]}, the '
                             f'last evaluation {last}')
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
