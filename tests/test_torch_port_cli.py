"""The port's command lines end to end on the CPU: ``python -m
segdistill_tpu_torch.tools.train`` for 8 iterations of CGD distillation on
the committed miniature dataset (a tiny MiT-b0 pair, 64x64 crops through the
real training pipeline, PhotoMetricDistortion included), with a checkpoint
and an evaluation every 4, then ``--resume-from`` the iteration-4 checkpoint
in a second work dir, then ``tools.test`` on the first.

Held to: the resumed run logs the uninterrupted run's losses for iterations
5-8 bitwise (the CPU step and the loader's stream are deterministic);
``tools.test`` prints the mIoU the last evaluation logged, to 1e-12 (the
same weights and images; integer histograms on both paths). The resume and
the test run in a subprocess that also checks that nothing of JAX or of the
JAX package was imported. Against the JAX package: its own ``tools/test.py``
reads the port's iteration-8 checkpoint (the reference ``.pth`` layout) under
the same config and must print the port's metrics to 1e-3 (measured equal;
one flipped pixel of the 3 x 64 x 64 moves aAcc by 8e-5).
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import torch_port_threads  # noqa: F401  (torch threads a test worker)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / 'tests' / 'data' / 'convergence'
KD_KEY = 'loss_decode_head.linear_pred<->decode_head.linear_pred_other'

CONFIG = '''
img_norm_cfg = dict(mean=[123.675, 116.28, 103.53],
                    std=[58.395, 57.12, 57.375], to_rgb=True)
crop_size = (64, 64)
enc = dict(
    type='EncoderDecoder',
    backbone=dict(type='mit_b0', drop_path_rate=0.1),
    decode_head=dict(
        type='SegFormerHead', in_channels=[32, 64, 160, 256],
        in_index=[0, 1, 2, 3], feature_strides=[4, 8, 16, 32],
        channels=32, dropout_ratio=0.1, num_classes=4,
        norm_cfg=dict(type='SyncBN', requires_grad=True),
        align_corners=False, decoder_params=dict(embed_dim=32)))
train_pipeline = [
    dict(type='LoadImageFromFile'),
    dict(type='LoadAnnotations', reduce_zero_label=True),
    dict(type='Resize', img_scale=(64, 64), ratio_range=(0.75, 1.25)),
    dict(type='RandomCrop', crop_size=crop_size, cat_max_ratio=0.9),
    dict(type='RandomFlip', prob=0.5),
    dict(type='PhotoMetricDistortion'),
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
             dict(type='RandomFlip'),
             dict(type='Normalize', **img_norm_cfg),
             dict(type='ImageToTensor', keys=['img']),
             dict(type='Collect', keys=['img']),
         ])]
model = dict(
    type='SDModule', cfg_s=enc, cfg_t=enc,
    distillation=[dict(student_layer='decode_head.linear_pred',
                       teacher_layer='decode_head.linear_pred',
                       loss_name='CGDLoss',
                       loss_config=dict(group_size=2, alpha=3, tau=2))],
    train_cfg=dict(), test_cfg=dict(mode='whole'))
ds = dict(type='CustomDataset', data_root={data_root!r},
          classes=('a', 'b', 'c', 'd'), reduce_zero_label=True)
data = dict(
    samples_per_gpu=2, workers_per_gpu=2,
    train=dict(type='RepeatDataset', times=4,
               dataset=dict(img_dir='img/train', ann_dir='ann/train',
                            pipeline=train_pipeline, **ds)),
    val=dict(img_dir='img/val', ann_dir='ann/val', pipeline=test_pipeline,
             **ds),
    test=dict(img_dir='img/val', ann_dir='ann/val', pipeline=test_pipeline,
              **ds))
optimizer = dict(type='AdamW', lr=0.001, weight_decay=0.01)
lr_config = dict(policy='poly', power=1.0, min_lr=0.0, by_epoch=False)
runner = dict(type='IterBasedRunner', max_iters=8)
checkpoint_config = dict(interval=4, max_keep_ckpts=2)
evaluation = dict(interval=4, metric='mIoU')
log_config = dict(interval=1)
'''

# run a command line's main() and then say what was imported
CHECKED = '''
import sys
from segdistill_tpu_torch.tools import {tool}
{tool}.main(sys.argv[1:])
bad = sorted(m for m in sys.modules if m.split('.')[0] in
             ('jax', 'jaxlib', 'flax', 'segdistill_tpu'))
assert not bad, bad
print('no jax')
'''


def _run(args, timeout=600):
    env = dict(os.environ, OMP_NUM_THREADS='2')
    res = subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr[-4000:]
    return res


def _json_log(work):
    (path,) = sorted(Path(work).glob('*.log.json'))
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    return ({ln['iter']: ln for ln in lines if ln['mode'] == 'train'},
            {ln['iter']: ln for ln in lines if ln['mode'] == 'val'})


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """(config path, work dir, the train run's output) of
    ``python -m segdistill_tpu_torch.tools.train --device cpu``."""
    tmp = tmp_path_factory.mktemp('cli')
    config = tmp / 'tiny_cgd.py'
    config.write_text(CONFIG.format(data_root=str(DATA)))
    work = tmp / 'work'
    res = _run(['-m', 'segdistill_tpu_torch.tools.train', str(config),
                '--work-dir', str(work), '--seed', '7', '--device', 'cpu'])
    return config, work, res


def test_train_cli_trains_checkpoints_and_evaluates(trained):
    config, work, res = trained
    train, val = _json_log(work)
    assert sorted(train) == list(range(1, 9)) and sorted(val) == [4, 8]
    for line in train.values():
        assert all(0 < line[k] < 1e3 for k in ('loss', 'decode.loss_seg'))
        assert line[KD_KEY] >= 0 and 'data_time' in line and 'lr' in line
    assert train[1]['lr'] == pytest.approx(1e-3) and train[8]['lr'] < 2e-4
    assert set(val[8]) >= {'mIoU', 'mAcc', 'aAcc', 'seconds'}
    assert sorted(os.listdir(work / 'checkpoints')) == [
        'iter_4.pth', 'iter_8.pth', 'meta.json']
    meta = json.loads((work / 'checkpoints' / 'meta.json').read_text())
    assert meta['iter'] == 8 and meta['CLASSES'] == ['a', 'b', 'c', 'd']
    assert len(meta['PALETTE']) == 4 and 'SDModule' in meta['config']
    assert 'segdistill_tpu_torch_version' in meta
    assert (work / config.name).is_file()           # the dumped config
    (text_log,) = work.glob('*.log')
    text = text_log.read_text()
    for needle in ('Environment info', 'PyTorch:', 'Iter [8/8]',
                   'Saved checkpoint at iter 4', 'Eval at iter 8'):
        assert needle in text, needle
    assert 'Iter [8/8]' in res.stderr


def test_resume_from_continues_the_run(trained, tmp_path):
    config, work, _ = trained
    # the same seed: a teacher without a checkpoint is drawn from it
    res = _run(['-c', CHECKED.format(tool='train'), str(config),
                '--work-dir', str(tmp_path), '--seed', '7', '--device',
                'cpu', '--resume-from',
                str(work / 'checkpoints' / 'iter_4.pth')])
    assert 'no jax' in res.stdout and 'at iter 4' in res.stderr
    first, first_val = _json_log(work)
    train, val = _json_log(tmp_path)
    assert sorted(train) == [5, 6, 7, 8] and sorted(val) == [8]
    for it, line in train.items():
        for key in ('loss', 'decode.loss_seg', KD_KEY, 'lr'):
            assert line[key] == first[it][key], (it, key)
    for key in ('mIoU', 'mAcc', 'aAcc'):
        assert val[8][key] == first_val[8][key], key
    # an explicit resume from a checkpoint that is not there fails
    res = subprocess.run(
        [sys.executable, '-m', 'segdistill_tpu_torch.tools.train',
         str(config), '--work-dir', str(tmp_path / 'w'), '--device', 'cpu',
         '--resume-from', str(tmp_path / 'nothing')], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert res.returncode != 0 and 'no checkpoint found' in res.stderr


def test_test_cli_reproduces_the_last_evaluation(trained):
    config, work, _ = trained
    res = _run(['-c', CHECKED.format(tool='test'), str(config), str(work),
                '--eval', 'mIoU', '--device', 'cpu'])
    lines = res.stdout.strip().splitlines()
    assert lines[-1] == 'no jax'
    metrics = ast.literal_eval(lines[-2])
    want = _json_log(work)[1][8]
    for key in ('mIoU', 'mAcc', 'aAcc'):
        assert metrics[key] == pytest.approx(want[key], abs=1e-12), key
    assert 0.0 < metrics['mIoU'] < 1.0
    assert 'CLASSES/PALETTE read from the checkpoint meta (4 classes)' \
        in res.stderr
    assert 'Summary: aAcc' in res.stderr


def test_jax_test_cli_agrees_on_the_port_checkpoint(trained):
    """``tools/test.py`` of the JAX package on the checkpoint the port's
    trainer wrote: the same config, data and student weights."""
    config, work, _ = trained
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    res = subprocess.run(
        [sys.executable, str(ROOT / 'tools' / 'test.py'), str(config),
         str(work / 'checkpoints' / 'iter_8.pth'), '--eval', 'mIoU'],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    metrics = ast.literal_eval(res.stdout.strip().splitlines()[-1])
    want = _json_log(work)[1][8]
    for key in ('mIoU', 'mAcc', 'aAcc'):
        assert metrics[key] == pytest.approx(want[key], abs=1e-3), key


def test_cli_flags():
    """The JAX command lines' flags plus ``--device`` (default cuda);
    ``--multi-host`` (off by default) asks for torchrun's process group
    (``test_torch_port_dist.py`` runs it)."""
    from segdistill_tpu_torch.tools import test as test_cli
    from segdistill_tpu_torch.tools import train as train_cli
    args = train_cli.parse_args(
        ['cfg.py', '--work-dir', 'w', '--load-from', 'a', '--resume-from',
         'b', '--no-validate', '--seed', '3', '--deterministic', '--options',
         'data.samples_per_gpu=4', 'model.t_pretrain=None'])
    assert args.device == 'cuda' and args.no_validate and args.seed == 3
    assert args.options == {'data.samples_per_gpu': 4,
                            'model.t_pretrain': None}
    args = test_cli.parse_args(['cfg.py', 'ckpt', '--eval', 'mIoU',
                                '--aug-test', '--options', 'a.b=1'])
    assert (args.device, args.checkpoint, args.aug_test) == ('cuda', 'ckpt',
                                                             True)
    for cli in (train_cli, test_cli):
        assert not cli.parse_args(['cfg.py']).multi_host
        assert cli.parse_args(['cfg.py', '--multi-host']).multi_host
        with pytest.raises(SystemExit):
            cli.parse_args(['cfg.py', '--multi-hosts'])
