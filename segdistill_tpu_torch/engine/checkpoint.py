"""Checkpoints of a training run (counterpart of
``segdistill_tpu/engine/checkpoint.py``; reference: mmcv's CheckpointHook and
resume, ``apis/train.py:129-136``).

A checkpoint is one file, ``<work_dir>/checkpoints/iter_<step>.pth``, a
``torch.save`` of ``{'state_dict', 'adapters', 'optimizer', 'step', 'seed',
'meta'}``. ``state_dict`` is the student in the reference ``.pth`` layout
(weights and BN statistics), so ``apis.load_checkpoint`` and the JAX
package's ``load_pth_into_variables`` read the file as any published
checkpoint; ``adapters`` are the distillation's 1x1 channel adapters. The
frozen teacher is not saved: it comes from the config. The loss schedules
and each step's random draws are functions of ``step`` (and ``seed``), so
they need nothing else to resume. (The JAX package writes an orbax
directory per step; the content is the same.)

The meta (version, the config's text, the dataset's CLASSES and PALETTE,
the iteration; ref tools/train.py:145-153) is also written beside the
checkpoints as ``meta.json``, under the JAX sidecar's keys, and read back
at test time (ref tools/test.py:131-135).

Every loader takes a work dir (holding ``checkpoints/``), the
``checkpoints/`` dir, or one ``iter_<step>.pth`` file.

Across processes rank 0 alone writes, from the model itself (not its DDP
wrapper: no ``module.`` prefix), and every rank waits for the file before
it goes on; every rank resumes from the same file.
"""

import json
import logging
import os
import os.path as osp
import re

import torch

from ..parallel import barrier, is_main_process
from .optimizer import plain_state_dict

META_NAME = 'meta.json'
_ITER = re.compile(r'^iter_(\d+)\.pth$')


def _student(model):
    return getattr(model, 'student', model)


def _steps(ckpt_dir):
    """The steps that have a checkpoint in ``ckpt_dir``, ascending."""
    if not osp.isdir(ckpt_dir):
        return []
    found = (_ITER.match(name) for name in os.listdir(ckpt_dir))
    return sorted(int(m.group(1)) for m in found if m)


def _resolve(path):
    """-> (checkpoints dir, step or None) for a work dir, a checkpoints
    dir or one checkpoint file."""
    path = osp.abspath(path)
    sub = osp.join(path, 'checkpoints')
    if osp.isdir(sub):
        return sub, None
    m = _ITER.match(osp.basename(path))
    if m:
        return osp.dirname(path), int(m.group(1))
    return path, None


def save_checkpoint(work_dir, state, max_keep=1, meta=None):
    """Write ``state`` as ``checkpoints/iter_<step>.pth`` under
    ``work_dir``, keep the newest ``max_keep`` files, refresh ``meta.json``
    (on rank 0; the other ranks wait for it); -> the step."""
    if is_main_process():
        _save(work_dir, state, max_keep, meta)
    barrier()
    return int(state.step)


def _save(work_dir, state, max_keep, meta):
    ckpt_dir = osp.abspath(osp.join(work_dir, 'checkpoints'))
    os.makedirs(ckpt_dir, exist_ok=True)
    step = int(state.step)
    model = state.model
    adapters = getattr(model, 'distill_adapters', None)
    if meta is not None:
        meta = dict(meta, iter=step)
    payload = {
        'state_dict': _student(model).state_dict(),
        'adapters': adapters.state_dict() if adapters is not None else {},
        'optimizer': plain_state_dict(state.optimizer),
        'step': step, 'seed': int(state.seed), 'meta': meta}
    path = osp.join(ckpt_dir, f'iter_{step}.pth')
    # write beside, then rename: a reader never sees half a file
    torch.save(payload, path + '.tmp')
    os.replace(path + '.tmp', path)
    if max_keep and max_keep > 0:
        for old in _steps(ckpt_dir)[:-max_keep]:
            os.remove(osp.join(ckpt_dir, f'iter_{old}.pth'))
    if meta is not None:
        with open(osp.join(ckpt_dir, META_NAME), 'w') as f:
            json.dump(meta, f)


def load_meta(path):
    """The checkpoint meta (CLASSES, PALETTE, config, version, iter) or
    None."""
    ckpt_dir, _ = _resolve(path)
    meta_path = osp.join(ckpt_dir, META_NAME)
    if not osp.isfile(meta_path):
        return None
    with open(meta_path) as f:
        return json.load(f)


def checkpoint_file(path, step=None):
    """The checkpoint file that ``path`` names: the given or the latest
    step of a directory, or the file itself."""
    ckpt_dir, path_step = _resolve(path)
    if step is None:
        step = path_step
    if step is None:
        steps = _steps(ckpt_dir)
        if not steps:
            raise FileNotFoundError(f'no checkpoint found under {path!r}')
        step = steps[-1]
    file = osp.join(ckpt_dir, f'iter_{step}.pth')
    if not osp.isfile(file):
        raise FileNotFoundError(f'no checkpoint {file!r}')
    return file


def _read(path, step=None):
    return torch.load(checkpoint_file(path, step), map_location='cpu',
                      weights_only=True)


def _load_weights(model, ckpt):
    _student(model).load_state_dict(ckpt['state_dict'], strict=True)
    adapters = getattr(model, 'distill_adapters', None)
    if adapters is not None:
        adapters.load_state_dict(ckpt.get('adapters', {}), strict=True)


def load_checkpoint(path, state, step=None):
    """Restore ``state`` in place from a checkpoint: weights, BN
    statistics, adapters, optimizer moments, step and seed; -> ``state``."""
    ckpt = _read(path, step)
    _load_weights(state.model, ckpt)
    state.optimizer.load_state_dict(ckpt['optimizer'])
    state.step = int(ckpt['step'])
    state.seed = int(ckpt['seed'])
    return state


def load_weights(path, state):
    """Weights-only warm start (the reference's ``load_from``,
    apis/train.py:134-135): weights, BN statistics and adapters are
    replaced; step, seed and optimizer state stay fresh."""
    _load_weights(state.model, _read(path))
    return state


def resume_latest(path, state, strict=False):
    """Resume from the newest checkpoint under ``path`` if there is one;
    -> (state, resumed).

    ``strict=False`` is the reference's forgiving auto-resume
    (apis/train.py:129-133): nothing to resume, or a file that does not
    load, starts from scratch with a warning. An explicit ``--resume-from``
    passes ``strict=True``: a missing or corrupt checkpoint raises rather
    than silently restarting a long run at iteration 0."""
    try:
        return load_checkpoint(path, state), True
    except FileNotFoundError:
        if strict:
            raise
        return state, False
    except Exception as e:
        if strict:
            raise RuntimeError(f'failed to resume from {path!r}: {e}') from e
        logging.getLogger('segdistill_tpu_torch').warning(
            'auto-resume from %r failed (%s: %s); starting from scratch',
            path, type(e).__name__, e)
        return state, False
