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

The runner logs at the log interval (with the time a step and its data
took), saves a checkpoint when a step crosses the checkpoint interval and
at the end, and calls the eval hook after every step. Steps per dispatch
(a CUDA graph of the step here) are not ported yet.
"""

import json
import time

import torch

from ..models.segmentors import parse_losses
from ..utils import get_root_logger
from .optimizer import set_lr
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


def build_train_step(model, optimizer, lr_schedule=None):
    """-> fn(state, img, gt, perm=None, points=None, teacher_index=None) ->
    log_vars (0-d tensors on the model's device, and 'lr' as a float),
    updating ``state`` in place.

    ``model``: an SDModule (student + frozen teacher), an SDModuleMT
    (student + frozen teachers) or a bare EncoderDecoder (or a cascade).
    ``perm`` overrides the channel shuffle's draw, ``points`` a point
    head's draw of its training points, ``teacher_index`` a random
    ensemble's draw of the step's teacher."""
    multi = hasattr(model, 'teachers')
    is_distill = multi or hasattr(model, 'teacher')
    log_grad = bool(getattr(model, 'log_grad', False))
    params = [p for group in optimizer.param_groups for p in group['params']]

    def train_step(state, img, gt, perm=None, points=None,
                   teacher_index=None):
        step = state.step + 1
        generator = torch.Generator(device=img.device)
        generator.manual_seed(step_seed(state.seed, step))
        model.train()
        lr = None if lr_schedule is None else lr_schedule(state.step)
        if lr is not None:
            set_lr(optimizer, lr)
        if is_distill:
            kw = dict(teacher_index=teacher_index) if multi else {}
            losses = model.forward_train(img, gt, step, generator=generator,
                                         perm=perm, **kw)
        else:
            losses, _ = model.forward_train(img, gt, generator=generator,
                                            points=points)
        total, log_vars = parse_losses(losses)
        if log_grad:
            log_vars['deg'] = gradient_angle(losses, params)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        optimizer.step()
        state.step = step
        log_vars = {k: v.detach() for k, v in log_vars.items()}
        if lr is not None:
            log_vars['lr'] = lr
        return log_vars

    return train_step


class IterBasedRunner:
    """Runs ``train_step`` to ``max_iters`` over batches of
    ``{'img', 'gt_semantic_seg'}``, moved to the model's device.

    ``channels_last``: the batches' images are NHWC, as the dataset
    pipeline stacks them, and are permuted to NCHW on the device; in-memory
    batches are NCHW already. ``work_dir`` turns checkpoints on
    (``checkpoint_interval``, ``max_keep_ckpts``, ``meta``); ``eval_hook``
    is called with the state after every step. ``json_log`` names a file
    to which every log line and evaluation is appended as one JSON object
    (``{"mode": "train" or "val", "iter": n, ...}``, values unrounded)."""

    def __init__(self, train_step, state, max_iters, log_interval=50,
                 work_dir=None, checkpoint_interval=4000, max_keep_ckpts=1,
                 eval_hook=None, meta=None, logger=None,
                 channels_last=False, json_log=None):
        self.train_step = train_step
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

    def _json(self, mode, step, values):
        if self.json_log:
            with open(self.json_log, 'a') as f:
                f.write(json.dumps(dict(mode=mode, iter=step, **values))
                        + '\n')

    def _to_device(self, batch, device):
        img = torch.as_tensor(batch['img']).to(device, non_blocking=True)
        if self.channels_last:
            img = img.permute(0, 3, 1, 2)
        gt = torch.as_tensor(batch['gt_semantic_seg']).to(
            device, non_blocking=True)
        return img, gt

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
        while state.step < self.max_iters:
            t0 = time.perf_counter()
            img, gt = self._to_device(next(it), device)
            t_data += time.perf_counter() - t0
            prev = state.step
            log_vars = self.train_step(state, img, gt)
            since_log += 1
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
        return state
