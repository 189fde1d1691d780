"""Training API (counterpart of ``segdistill_tpu/apis/train.py``; reference
``mmseg/apis/train.py:14-138``).

:func:`init_segmentor_state` builds the model of a config (an SDModule for
the distillation configs) from a seed and loads the checkpoints the config
names; :func:`train_segmentor` trains it over datasets built from the
config (the host loader, periodic checkpoints, resume, the eval hook), or
over an in-memory iterable of ``{'img', 'gt_semantic_seg'}`` batches (NCHW
float images, (B, H, W) integer labels). With ``distributed`` it trains
across the processes of the process group (``parallel``): DDP, the
rank's share of each global batch, the evaluation sharded.
"""

import os
import random

import numpy as np
import torch

from ..config import Config

from ..core.evaluation import EvalHook
from ..datasets import build_dataloader, build_dataset
from ..engine import (IterBasedRunner, TrainState, build_lr_schedule,
                      build_multi_train_step, build_optimizer,
                      build_train_step, load_weights, resume_latest)
from ..models import build_segmentor
from ..parallel import get_dist_info, wrap_model
from ..utils import get_root_logger
from .inference import load_backbone_checkpoint, load_checkpoint
from .test import fast_evaluate


def set_random_seed(seed, deterministic=True):
    """Seed python's, numpy's and torch's global generators (ref
    apis/train.py:14-29). The train step and the loader draw from their
    own generators, seeded from (seed, step) and (seed, stream position),
    so a run repeats either way; ``deterministic`` (the default, as in the
    JAX package) also asks cuDNN for deterministic algorithms."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False


def _require_file(path, what):
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f'{what} {path!r} does not exist; put the checkpoint there or '
            f'clear the path in the config (cfg_options)')


def _load_pretrained(model):
    """The config's checkpoints: t_pretrain (reference layout, lenient, ref
    SD_structure.py:36; an SDModuleMT's is a list, one file or None a
    teacher), s_pretrain (strict), and a student backbone-only
    ``pretrained`` (lenient, only where no s_pretrain is set)."""
    student = getattr(model, 'student', model)
    backbone_ckpt = getattr(model, 'student_pretrained', None)
    t_pretrain = getattr(model, 't_pretrain', None)
    if hasattr(model, 'teachers'):
        paths = list(t_pretrain or [None] * len(model.teachers))
        if len(paths) != len(model.teachers):
            raise ValueError(f't_pretrain names {len(paths)} checkpoints for '
                             f'{len(model.teachers)} teachers')
        for i, (teacher, path) in enumerate(zip(model.teachers, paths)):
            if path:
                _require_file(path, f'the checkpoint t_pretrain[{i}] of '
                              f'teacher {i}')
                load_checkpoint(teacher, path, strict=False)
    elif t_pretrain:
        _require_file(t_pretrain, 'the teacher checkpoint t_pretrain')
        load_checkpoint(model.teacher, t_pretrain, strict=False)
    if getattr(model, 's_pretrain', None):
        _require_file(model.s_pretrain, 'the student checkpoint s_pretrain')
        load_checkpoint(student, model.s_pretrain, strict=True)
    elif backbone_ckpt:
        _require_file(backbone_ckpt, 'the student backbone checkpoint '
                      'pretrained')
        load_backbone_checkpoint(student, backbone_ckpt)


def init_segmentor_state(config, seed=0, device='cuda', cfg_options=None):
    """Build the config's model (path or :class:`Config`, with
    ``cfg_options`` merged into a copy), initialise it from
    ``torch.Generator().manual_seed(seed)``, load the checkpoints it names
    (a missing file raises) and move it to ``device`` in train mode (a
    bare 'cuda' is the process's current card: ``cuda:<LOCAL_RANK>`` once
    ``parallel.init_distributed`` has run). ``model.cfg`` is the merged
    config."""
    if isinstance(config, str):
        config = Config.fromfile(config)
    if cfg_options:
        config = config.copy()
        config.merge_from_dict(cfg_options)
    model = build_segmentor(dict(config.model))
    # a segmentor's backbone checkpoint (a distillation config's student
    # has its own, under cfg_s)
    pretrained = getattr(model, 'pretrained', None)
    if pretrained:
        _require_file(pretrained, 'the backbone checkpoint pretrained')
    model.init_weights(torch.Generator().manual_seed(seed))
    _load_pretrained(model)
    if pretrained:
        load_backbone_checkpoint(model, pretrained)
    model.cfg = config
    return model.to(device).train()


def _max_iters(cfg):
    return cfg.runner['max_iters'] if 'runner' in cfg else cfg['total_iters']


def _steps_per_dispatch(cfg):
    """The config's ``runner.steps_per_dispatch``, 1 by default (as the JAX
    package's ``apis/train.py`` reads it)."""
    return int(cfg.runner.get('steps_per_dispatch', 1)) \
        if 'runner' in cfg else 1


def prepare_training(model, cfg=None, seed=0, distributed=False):
    """-> (state, train_step): the optimizer and the LR schedule from the
    config (``model.cfg`` by default), the state at step 0. The optimizer
    covers the parameters that require grad: the
    student and adapters, never a frozen teacher. With ``distributed`` the
    step's forward runs through DDP (``parallel.wrap_model``; the process
    group must exist).

    With the config's ``runner.steps_per_dispatch`` k above 1 the step is
    the k-step :func:`~..engine.build_multi_train_step` (a
    :class:`~..engine.MultiTrainStep`, called on (k, B, ...) batches; its
    ``step`` is the single step), with ``distributed`` through DDP too: on
    CPU tensors the DDP step k times, on the card replays of the DDP step
    captured in a CUDA graph (DDP's static graph, NCCL; gloo raises
    ``GraphCaptureError``)."""
    cfg = cfg or model.cfg
    k = _steps_per_dispatch(cfg)
    schedule = build_lr_schedule(cfg.get('lr_config'), cfg.optimizer['lr'],
                                 _max_iters(cfg))
    optimizer = build_optimizer(cfg.optimizer, model)
    state = TrainState(model=model, optimizer=optimizer, seed=seed)
    forward = wrap_model(model, cfg, static_graph=k > 1 and next(
        model.parameters()).is_cuda) if distributed else None
    if k > 1:
        return state, build_multi_train_step(model, optimizer, schedule, k,
                                             forward)
    return state, build_train_step(model, optimizer, schedule, forward)


def _checkpoint_meta(cfg, dataset):
    """Version, the config's text and the dataset's CLASSES and PALETTE
    (ref tools/train.py:145-153; read back by tools/test.py:131-135)."""
    from .. import __version__
    palette = getattr(dataset, 'PALETTE', None)
    return dict(
        segdistill_tpu_torch_version=__version__,
        config=cfg.pretty_text,
        CLASSES=list(getattr(dataset, 'CLASSES', None) or []) or None,
        PALETTE=np.asarray(palette).tolist() if palette is not None
        else None)


def train_segmentor(model, dataset, cfg=None, distributed=False,
                    validate=False, timestamp=None, seed=None):
    """Train ``model`` to the config's ``runner.max_iters``; -> the final
    state (ref apis/train.py:32-138).

    ``dataset``: a dataset (or a list, the first is trained on) built by
    ``build_dataset``: batches then come from the loader of
    ``data.loader_backend`` ('host' by default; 'native' or 'device' with
    the recipe ``data.aug_cfg``, which augment the batch as a whole and
    hand it over on the model's device) with ``data.samples_per_gpu`` and
    ``data.workers_per_gpu``, checkpoints go to
    ``cfg.work_dir`` (``checkpoint_config``), ``cfg.resume_from`` resumes
    strictly (a missing or corrupt checkpoint raises), ``cfg.auto_resume``
    from the work dir if it holds a checkpoint, ``cfg.load_from`` warm-starts
    the weights alone, and with ``validate`` the config's ``evaluation``
    runs :func:`fast_evaluate` on ``data.val`` at its interval. A resumed
    run continues the loader's stream where the checkpoint left it.

    With a ``timestamp`` and a work dir, every log line and evaluation
    is also appended to ``<work_dir>/<timestamp>.log.json``, one JSON
    object a line with unrounded values (mmcv's json log).

    With ``distributed``, every rank of the process group calls this: the
    step runs through DDP, each rank loads its ``samples_per_gpu`` of each
    global batch (``samples_per_gpu`` x world size) from its own stream,
    every rank evaluates its share of ``data.val``, and rank 0 alone
    writes the logs and checkpoints.

    With the config's ``runner.steps_per_dispatch`` k > 1 the runner
    takes full chunks of k steps through
    :func:`~..engine.build_multi_train_step` (on the card, replays of a
    CUDA graph of the step) and logs, saves and evaluates where a chunk
    crosses an interval, as the JAX runner does, on every rank.

    Or an iterable of in-memory batches (NCHW images), without any of
    that."""
    cfg = cfg or model.cfg
    if seed is None:
        seed = cfg.get('seed', None)
    if seed is None:  # the JAX package's defaults on its two paths
        seed = 42 if hasattr(_first(dataset), 'CLASSES') else 0
    state, train_step = prepare_training(model, cfg, seed, distributed)
    log_interval = cfg.get('log_config', {}).get('interval', 50)
    if not hasattr(_first(dataset), 'CLASSES'):  # in-memory batches
        return IterBasedRunner(train_step, state, _max_iters(cfg),
                               log_interval=log_interval).run(dataset)

    logger = get_root_logger()
    train_set = _first(dataset)
    work_dir = cfg.get('work_dir')
    if cfg.get('resume_from'):
        resume_latest(cfg['resume_from'], state, strict=True)
        logger.info(f'resumed from {cfg["resume_from"]} at iter '
                    f'{state.step}')
    elif work_dir and cfg.get('auto_resume', False):
        if resume_latest(work_dir, state)[1]:
            logger.info(f'auto-resumed at iter {state.step}')
    elif cfg.get('load_from'):
        load_weights(cfg['load_from'], state)
        logger.info(f'loaded weights from {cfg["load_from"]} (warm start, '
                    f'iter 0)')

    rank, world = get_dist_info() if distributed else (0, 1)
    loader = build_dataloader(
        train_set, cfg.data['samples_per_gpu'], cfg.data['workers_per_gpu'],
        shuffle=True, seed=state.seed, drop_last=True,
        loader_backend=cfg.data.get('loader_backend', 'host'),
        start_batch=state.step, process_index=rank, process_count=world,
        aug_cfg=cfg.data.get('aug_cfg'),
        device=next(state.model.parameters()).device)

    eval_hook = None
    if validate and cfg.get('evaluation'):
        val_set = build_dataset(cfg.data['val'], dict(test_mode=True))
        metric = cfg.evaluation.get('metric', 'mIoU')
        eval_hook = EvalHook(
            lambda st: fast_evaluate(st.model, val_set, metric=metric),
            interval=cfg.evaluation.get('interval', 2000),
            start_iter=state.step)

    ckpt_cfg = cfg.get('checkpoint_config', {})
    runner = IterBasedRunner(
        train_step, state, _max_iters(cfg), log_interval=log_interval,
        work_dir=work_dir,
        checkpoint_interval=ckpt_cfg.get('interval', 4000),
        max_keep_ckpts=ckpt_cfg.get('max_keep_ckpts', 1),
        eval_hook=eval_hook, meta=_checkpoint_meta(cfg, train_set),
        logger=logger, channels_last=True,
        json_log=os.path.join(work_dir, f'{timestamp}.log.json')
        if work_dir and timestamp else None,
        tensorboard=any(h.get('type') == 'TensorboardLoggerHook'
                        for h in cfg.get('log_config', {}).get('hooks', [])))
    return runner.run(loader)


def _first(dataset):
    return dataset[0] if isinstance(dataset, (list, tuple)) else dataset
