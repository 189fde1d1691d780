"""The train step and an iteration-based runner (counterpart of
``segdistill_tpu/engine/runner.py``; reference: mmcv's IterBasedRunner as
``apis/train.py:91-138`` drives it).

One step: the loss step ``state.step + 1`` (the reference's ``cnt``
increments before the loss), the forward with a generator seeded from
(seed, step), ``parse_losses``, backward, the AdamW step at learning rate
``schedule(state.step)`` (update n uses ``schedule(n)``, n from 0, as
optax counts) and ``log_vars['lr']``. With the model's ``log_grad`` the
step also logs ``deg``, the angle between the segmentation-loss and the
distillation-loss gradients (ref SD_structure.py:92-134).

Across processes the forward runs through DDP (``parallel.wrap_model``),
which averages the gradients over the ranks in the backward; the
generator is keyed by (seed, step) alone, so every rank draws the same
channel permutation and teacher (and, as in the reference, the same
dropout masks); the log vars, ``deg`` included (each rank's own angle),
are averaged over the ranks in ``parse_losses``.

The runner logs at the log interval (with the time a step and its data
took), saves a checkpoint when a step crosses the checkpoint interval and
at the end, and calls the eval hook after every step or chunk (on every
rank: the evaluation is sharded). Rank 0 alone writes the JSON log, the
checkpoints and, with ``tensorboard`` (a ``TensorboardLoggerHook`` in the
config's ``log_config``), TensorBoard scalars under ``work_dir/tf_logs``:
each log var as ``train/<key>`` and the step's time as ``train/iter_time``
at every log line, as the JAX runner writes them; where
``torch.utils.tensorboard`` cannot be imported it warns and trains on.

Steps per dispatch (``runner.steps_per_dispatch`` = k, the JAX package's
``build_multi_train_step``): :func:`build_multi_train_step` runs k steps a
call over a stacked (k, B, ...) batch and returns the last step's log
vars; on CPU tensors the eager step k times, on the card replays of the
step captured in a CUDA graph (``engine/cuda_graph.py``), across
processes the DDP step (its all-reduces in the graph, under NCCL). The
runner takes
full chunks of k while they fit before ``max_iters`` and single steps
after (also from a resume point within k of the end), each computed as a
replay computes it (:meth:`MultiTrainStep.step`), draws k batches a
chunk (the loader's stream is unchanged), and tests the log, checkpoint and
eval intervals once a chunk, on crossings between its first and its last
step; ``time`` and ``data_time`` are divided by the steps since the last
log line.
"""

import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from ..models.segmentors import parse_losses
from ..ops.resize_sum import deterministic_adjoint
from ..parallel import is_main_process
from ..utils import get_root_logger
from .optimizer import make_capturable, set_lr
from .train_state import step_seed


def _is_seg(key):
    return 'loss_seg' in key


def _is_distill(key):
    return 'loss' in key and 'loss_seg' not in key and 'acc' not in key


def gradient_angle(losses, params):
    """Degrees between the gradients, over ``params``, of the summed
    segmentation losses and of the summed distillation losses (each loss
    averaged first); two backward passes that keep the graph."""
    grads = []
    for selector in (_is_seg, _is_distill):
        vals = [v.mean() for k, v in losses.items() if selector(k)]
        if vals and sum(vals).requires_grad:
            g = torch.autograd.grad(sum(vals), params, retain_graph=True,
                                    allow_unused=True)
        else:
            g = [None] * len(params)
        grads.append([torch.zeros_like(p) if a is None else a.float()
                      for a, p in zip(g, params)])
    g_seg, g_dist = grads
    dot = sum((a * b).sum() for a, b in zip(g_seg, g_dist))
    n1 = torch.sqrt(sum((a * a).sum() for a in g_seg))
    n2 = torch.sqrt(sum((b * b).sum() for b in g_dist))
    cos = dot / torch.clamp(n1 * n2, min=1e-12)
    # 3.1416, not pi: the reference's constant, kept so the numbers agree
    return torch.acos(torch.clamp(cos, -1.0, 1.0)) * 180.0 / 3.1416


def build_step_losses(model, optimizer, forward_train=None):
    """-> fn(img, gt, step, generator, perm=None, points=None,
    teacher_index=None) -> (total loss, log vars): the forward of a train
    step (a distiller's ``forward_train`` at ``step``, or a segmentor's),
    with the model's ``log_grad`` angle as the log var ``deg``."""
    if forward_train is None:
        forward_train = model.forward_train
    multi = hasattr(model, 'teachers')
    is_distill = multi or hasattr(model, 'teacher')
    log_grad = bool(getattr(model, 'log_grad', False))
    params = [p for group in optimizer.param_groups for p in group['params']]

    def step_losses(img, gt, step, generator, perm=None, points=None,
                    teacher_index=None):
        if is_distill:
            kw = dict(teacher_index=teacher_index) if multi else {}
            losses = forward_train(img, gt, step, generator=generator,
                                   perm=perm, **kw)
        else:
            losses, _ = forward_train(img, gt, generator=generator,
                                      points=points)
        if log_grad:
            # a log var, not a loss: parse_losses averages it over the ranks
            losses = dict(losses, deg=gradient_angle(losses, params))
        return parse_losses(losses)

    return step_losses


def build_train_step(model, optimizer, lr_schedule=None, forward_train=None):
    """-> fn(state, img, gt, perm=None, points=None, teacher_index=None) ->
    log_vars (0-d tensors on the model's device, and 'lr' as a float),
    updating ``state`` in place.

    ``model``: an SDModule (student + frozen teacher), an SDModuleMT
    (student + frozen teachers) or a bare EncoderDecoder (or a cascade).
    ``perm`` overrides the channel shuffle's draw, ``points`` a point
    head's draw of its training points, ``teacher_index`` a random
    ensemble's draw of the step's teacher. ``forward_train`` takes the
    place of ``model.forward_train``: the DDP wrapper of
    ``parallel.wrap_model`` across processes."""
    step_losses = build_step_losses(model, optimizer, forward_train)

    def train_step(state, img, gt, perm=None, points=None,
                   teacher_index=None):
        step = state.step + 1
        generator = torch.Generator(device=img.device)
        generator.manual_seed(step_seed(state.seed, step))
        model.train()
        lr = None if lr_schedule is None else lr_schedule(state.step)
        if lr is not None:
            set_lr(optimizer, lr)
        total, log_vars = step_losses(img, gt, step, generator, perm=perm,
                                      points=points,
                                      teacher_index=teacher_index)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        optimizer.step()
        state.step = step
        log_vars = {k: v.detach() for k, v in log_vars.items()}
        if lr is not None:
            log_vars['lr'] = lr
        return log_vars

    return train_step


class MultiTrainStep:
    """k train steps a call (:func:`build_multi_train_step`).

    :meth:`step`: the single step of the same run (the runner's steps
    outside full chunks). ``graphed``: on the card, the
    :class:`~.cuda_graph.GraphedTrainStep` made at the first call (its
    graphs, capture times and pool)."""

    def __init__(self, model, optimizer, lr_schedule, k, forward_train):
        self.ddp = forward_train if isinstance(
            forward_train, DistributedDataParallel) else None
        if self.ddp is not None and next(model.parameters()).is_cuda:
            from .cuda_graph import check_ddp_capture
            check_ddp_capture(model, dist.get_backend(),
                              forward_train.static_graph)
        self.model, self.optimizer = model, optimizer
        self.lr_schedule, self.forward_train = lr_schedule, forward_train
        self.k = int(k)
        self.eager_step = build_train_step(model, optimizer, lr_schedule,
                                           forward_train)
        self.graphed = None

    def step(self, state, img, gt, **kwargs):
        """One eager step of :func:`build_train_step`, computed as a replay
        computes it: on a CUDA tensor with the optimizer made capturable
        and K1's deterministic backward. A run's eager steps and its
        replays then agree, whatever iteration it resumes at."""
        if img.is_cuda:
            make_capturable(self.optimizer, img.device)
        with deterministic_adjoint():
            return self.eager_step(state, img, gt, **kwargs)

    def __call__(self, state, imgs, gts, perms=None):
        """-> the log vars of the chunk's last step. ``imgs``, ``gts``:
        (k, B, ...) on the model's device; ``perms`` (CPU tensors only):
        the k steps' channel permutations, as the single step's ``perm``.
        """
        if imgs.shape[0] != self.k or gts.shape[0] != self.k:
            raise ValueError(f'a chunk holds {self.k} batches, got '
                             f'{imgs.shape[0]} images and {gts.shape[0]} '
                             f'label maps')
        if imgs.device.type != 'cuda':
            for i in range(self.k):
                log_vars = self.eager_step(
                    state, imgs[i], gts[i],
                    perm=None if perms is None else perms[i])
            return log_vars
        if perms is not None:
            raise ValueError('a CUDA graph of the step draws its channel '
                             'permutations from the step\'s generator; '
                             'perms are taken on CPU tensors only')
        if self.graphed is None:
            from .cuda_graph import GraphedTrainStep
            self.graphed = GraphedTrainStep(
                self.model, self.optimizer, self.lr_schedule,
                build_step_losses(self.model, self.optimizer,
                                  self.forward_train), ddp=self.ddp)
        return self.graphed(state, imgs, gts)


def build_multi_train_step(model, optimizer, lr_schedule=None, k=1,
                           forward_train=None):
    """-> a :class:`MultiTrainStep`: fn(state, imgs, gts, perms=None) ->
    log_vars, k train steps over a stacked (k, B, ...) batch (counterpart of
    the JAX ``build_multi_train_step``, a ``lax.scan`` of the step).

    On CPU tensors it runs :func:`build_train_step`'s step k times. On CUDA
    tensors it replays the step captured in a CUDA graph
    (:class:`~.cuda_graph.GraphedTrainStep`): the host writes each step's
    inputs, learning rate, loss weights and seed, and launches one replay.
    ``forward_train``: the DDP wrapper across processes (on the card
    ``parallel.wrap_model(..., static_graph=True)``, whose all-reduces the
    graph holds; :func:`~.cuda_graph.check_ddp_capture` names what cannot
    be captured)."""
    return MultiTrainStep(model, optimizer, lr_schedule, k, forward_train)


class IterBasedRunner:
    """Runs ``train_step`` to ``max_iters`` over batches of
    ``{'img', 'gt_semantic_seg'}``, moved to the model's device.

    ``channels_last``: the batches' images are NHWC, as the dataset
    pipeline stacks them, and are permuted to NCHW on the device; in-memory
    batches are NCHW already. ``work_dir`` turns checkpoints on
    (``checkpoint_interval``, ``max_keep_ckpts``, ``meta``); ``eval_hook``
    is called with the state after every step. ``json_log`` names a file
    to which every log line and evaluation is appended as one JSON object
    (``{"mode": "train" or "val", "iter": n, ...}``, values unrounded).
    A ``train_step`` with a chunk size ``k`` above 1 (a
    :class:`MultiTrainStep`) takes the full chunks of k steps, and its
    ``step`` the single steps."""

    def __init__(self, train_step, state, max_iters, log_interval=50,
                 work_dir=None, checkpoint_interval=4000, max_keep_ckpts=1,
                 eval_hook=None, meta=None, logger=None,
                 channels_last=False, json_log=None, tensorboard=False):
        self.train_step = train_step
        self.chunk = max(1, int(getattr(train_step, 'k', 1)))
        self.single_step = train_step if self.chunk == 1 else train_step.step
        self.state = state
        self.max_iters = max_iters
        self.log_interval = log_interval
        self.work_dir = work_dir
        self.checkpoint_interval = checkpoint_interval
        self.max_keep_ckpts = max_keep_ckpts
        self.eval_hook = eval_hook
        self.meta = meta
        self.logger = logger or get_root_logger()
        self.channels_last = channels_last
        self.json_log = json_log
        self.tb_writer = None
        if tensorboard and work_dir and is_main_process():
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                self.logger.warning('torch.utils.tensorboard unavailable; '
                                    'continuing without TensorBoard logging')
            else:
                self.tb_writer = SummaryWriter(
                    os.path.join(work_dir, 'tf_logs'))

    def _json(self, mode, step, values):
        if self.json_log and is_main_process():
            with open(self.json_log, 'a') as f:
                f.write(json.dumps(dict(mode=mode, iter=step, **values))
                        + '\n')

    def _to_device(self, batch, device):
        """The batch's image (NHWC viewed as NCHW with ``channels_last``)
        and labels on ``device``. Host arrays are copied; tensors already
        there, as the native and device loaders hand them over, go through
        with no copy."""
        img = torch.as_tensor(batch['img']).to(device, non_blocking=True)
        if self.channels_last:
            img = img.permute(0, 3, 1, 2)
        gt = torch.as_tensor(batch['gt_semantic_seg']).to(
            device, non_blocking=True)
        return img, gt

    def _to_device_stacked(self, batches, device):
        """A chunk's batches stacked to (k, B, ...) on ``device``: one copy
        of each (host arrays stacked on the host, tensors where they lie),
        the images viewed as (k, B, C, H, W) with ``channels_last``."""
        def stack(key):
            values = [b[key] for b in batches]
            if all(isinstance(v, torch.Tensor) for v in values):
                return torch.stack(values).to(device, non_blocking=True)
            return torch.as_tensor(np.stack(values)).to(device,
                                                        non_blocking=True)
        imgs = stack('img')
        if self.channels_last:
            imgs = imgs.permute(0, 1, 4, 2, 3)
        return imgs, stack('gt_semantic_seg')

    def run(self, data_loader):
        from .checkpoint import save_checkpoint
        state = self.state
        self.logger.info(f'Start running, iter {state.step} -> '
                         f'{self.max_iters}')
        it = iter(data_loader)
        device = next(state.model.parameters()).device
        last_t = time.perf_counter()
        t_data, since_log = 0.0, 0
        saved_at = None
        chunk = self.chunk
        while state.step < self.max_iters:
            prev = state.step
            # full chunks of k; single steps where a chunk would pass the end
            n = chunk if prev + chunk <= self.max_iters else 1
            t0 = time.perf_counter()
            if n > 1:
                imgs, gts = self._to_device_stacked(
                    [next(it) for _ in range(n)], device)
                t_data += time.perf_counter() - t0
                log_vars = self.train_step(state, imgs, gts)
            else:
                img, gt = self._to_device(next(it), device)
                t_data += time.perf_counter() - t0
                log_vars = self.single_step(state, img, gt)
            since_log += n
            step = state.step
            if step // self.log_interval != prev // self.log_interval:
                values = {k: float(v) for k, v in log_vars.items()}  # syncs
                now = time.perf_counter()
                values['time'] = (now - last_t) / since_log
                values['data_time'] = t_data / since_log
                msg = ', '.join(f'{k}: {v:.4f}' for k, v in sorted(
                    values.items()) if k not in ('time', 'data_time'))
                self.logger.info(
                    f'Iter [{step}/{self.max_iters}] time: '
                    f'{values["time"]:.3f}, data_time: '
                    f'{values["data_time"]:.3f}, {msg}')
                self._json('train', step, values)
                if self.tb_writer is not None:
                    for k, v in log_vars.items():
                        self.tb_writer.add_scalar(f'train/{k}', values[k],
                                                  step)
                    self.tb_writer.add_scalar('train/iter_time',
                                              values['time'], step)
                last_t, t_data, since_log = time.perf_counter(), 0.0, 0
            if self.work_dir and (step // self.checkpoint_interval
                                  != prev // self.checkpoint_interval):
                save_checkpoint(self.work_dir, state,
                                max_keep=self.max_keep_ckpts, meta=self.meta)
                saved_at = step
                self.logger.info(f'Saved checkpoint at iter {step}')
            if self.eval_hook is not None:
                t0 = time.perf_counter()
                results = self.eval_hook.after_train_iter(state)
                if results is not None:
                    self.logger.info(f'Eval at iter {step}: {results}')
                    last_t = time.perf_counter()  # not a step's time
                    self._json('val', step,
                               dict(results, seconds=last_t - t0))
        if self.work_dir and saved_at != state.step:
            # the final checkpoint, unless the last step just wrote it
            save_checkpoint(self.work_dir, state,
                            max_keep=self.max_keep_ckpts, meta=self.meta)
        if self.tb_writer is not None:
            self.tb_writer.close()
        return state
