"""Training API (counterpart of ``segdistill_tpu/apis/train.py``; reference
``mmseg/apis/train.py:14-138``).

:func:`init_segmentor_state` builds the model of a config (an SDModule for
the distillation configs) from a seed and loads the checkpoints the config
names; :func:`train_segmentor` trains it over an in-memory iterable of
``{'img', 'gt_semantic_seg'}`` batches (NCHW float images, (B, H, W)
integer labels). Datasets on disk, checkpointing and evaluation during
training are not ported yet.
"""

import os

import torch

from segdistill_tpu.config import Config

from ..engine import (IterBasedRunner, TrainState, build_lr_schedule,
                      build_optimizer, build_train_step)
from ..models import build_segmentor
from .inference import load_checkpoint


def _require_file(path, what):
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f'{what} {path!r} does not exist; put the checkpoint there or '
            f'clear the path in the config (cfg_options)')


def _load_pretrained(model):
    """The config's checkpoints: t_pretrain (reference layout, lenient, ref
    SD_structure.py:36), s_pretrain (strict), and a student backbone-only
    ``pretrained``, whose loading is not ported yet."""
    student = getattr(model, 'student', model)
    backbone_ckpt = getattr(model, 'student_pretrained', None)
    if getattr(model, 't_pretrain', None):
        _require_file(model.t_pretrain, 'the teacher checkpoint t_pretrain')
        load_checkpoint(model.teacher, model.t_pretrain, strict=False)
    if getattr(model, 's_pretrain', None):
        _require_file(model.s_pretrain, 'the student checkpoint s_pretrain')
        load_checkpoint(student, model.s_pretrain, strict=True)
    elif backbone_ckpt:
        _require_file(backbone_ckpt, 'the student backbone checkpoint '
                      'pretrained')
        raise NotImplementedError('loading a backbone-only pretrained '
                                  'checkpoint is not ported yet')


def init_segmentor_state(config, seed=0, device='cuda', cfg_options=None):
    """Build the config's model (path or :class:`Config`, with
    ``cfg_options`` merged into a copy), initialise it from
    ``torch.Generator().manual_seed(seed)``, load the checkpoints it names
    (a missing file raises) and move it to ``device`` in train mode.
    ``model.cfg`` is the merged config."""
    if isinstance(config, str):
        config = Config.fromfile(config)
    if cfg_options:
        config = config.copy()
        config.merge_from_dict(cfg_options)
    model_cfg = dict(config.model)
    if model_cfg.get('type') != 'SDModule' and model_cfg.get('pretrained'):
        _require_file(model_cfg['pretrained'], 'the backbone checkpoint '
                      'pretrained')
        raise NotImplementedError('loading a backbone-only pretrained '
                                  'checkpoint is not ported yet')
    model_cfg.pop('pretrained', None)
    model = build_segmentor(model_cfg)
    model.init_weights(torch.Generator().manual_seed(seed))
    _load_pretrained(model)
    model.cfg = config
    return model.to(device).train()


def _max_iters(cfg):
    return cfg.runner['max_iters'] if 'runner' in cfg else cfg['total_iters']


def prepare_training(model, cfg=None, seed=0):
    """-> (state, train_step): AdamW and the LR schedule from the config
    (``model.cfg`` by default), the state at step 0."""
    cfg = cfg or model.cfg
    schedule = build_lr_schedule(cfg.get('lr_config'), cfg.optimizer['lr'],
                                 _max_iters(cfg))
    optimizer = build_optimizer(cfg.optimizer, model)
    state = TrainState(model=model, optimizer=optimizer, seed=seed)
    return state, build_train_step(model, optimizer, schedule)


def train_segmentor(model, data, cfg=None, seed=0):
    """Train ``model`` over ``data`` (an iterable of batches) to the
    config's ``runner.max_iters``; -> the final state."""
    cfg = cfg or model.cfg
    state, train_step = prepare_training(model, cfg, seed)
    runner = IterBasedRunner(
        train_step, state, _max_iters(cfg),
        log_interval=cfg.get('log_config', {}).get('interval', 50))
    return runner.run(data)
