"""The train step and an iteration-based runner (counterpart of
``segdistill_tpu/engine/runner.py``; reference: mmcv's IterBasedRunner as
``apis/train.py:91-138`` drives it).

One step: the loss step ``state.step + 1`` (the reference's ``cnt``
increments before the loss), the forward with a generator seeded from
(seed, step), ``parse_losses``, backward, the AdamW step at learning rate
``schedule(state.step)`` (update n uses ``schedule(n)``, n from 0, as
optax counts) and ``log_vars['lr']``. The runner keeps the log-interval
hook; checkpoints, the eval hook and steps per dispatch are not ported yet.
"""

import logging
import time

import torch

from ..models.segmentors import parse_losses
from .optimizer import set_lr
from .train_state import step_seed


def build_train_step(model, optimizer, lr_schedule=None):
    """-> fn(state, img, gt, perm=None) -> log_vars (0-d tensors on the
    model's device, and 'lr' as a float), updating ``state`` in place.

    ``model``: an SDModule (student + frozen teacher) or a bare
    EncoderDecoder. ``perm`` overrides the channel shuffle's draw."""
    is_distill = hasattr(model, 'teacher')

    def train_step(state, img, gt, perm=None):
        step = state.step + 1
        generator = torch.Generator(device=img.device)
        generator.manual_seed(step_seed(state.seed, step))
        model.train()
        lr = None if lr_schedule is None else lr_schedule(state.step)
        if lr is not None:
            set_lr(optimizer, lr)
        if is_distill:
            losses = model.forward_train(img, gt, step, generator=generator,
                                         perm=perm)
        else:
            losses, _ = model.forward_train(img, gt, generator=generator)
        total, log_vars = parse_losses(losses)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        optimizer.step()
        state.step = step
        log_vars = {k: v.detach() for k, v in log_vars.items()}
        if lr is not None:
            log_vars['lr'] = lr
        return log_vars

    return train_step


logger = logging.getLogger(__name__)


class IterBasedRunner:
    """Runs ``train_step`` to ``max_iters`` over batches of
    ``{'img', 'gt_semantic_seg'}``, moved to the model's device, and logs
    at the log interval."""

    def __init__(self, train_step, state, max_iters, log_interval=50):
        self.train_step = train_step
        self.state = state
        self.max_iters = max_iters
        self.log_interval = log_interval

    def run(self, data_loader):
        it = iter(data_loader)
        device = next(self.state.model.parameters()).device
        last_t = time.perf_counter()
        since_log = 0
        while self.state.step < self.max_iters:
            batch = next(it)
            img = torch.as_tensor(batch['img']).to(device)
            gt = torch.as_tensor(batch['gt_semantic_seg']).to(device)
            prev = self.state.step
            log_vars = self.train_step(self.state, img, gt)
            since_log += 1
            step = self.state.step
            if step // self.log_interval != prev // self.log_interval:
                msg = ', '.join(f'{k}: {float(v):.4f}'
                                for k, v in sorted(log_vars.items()))
                now = time.perf_counter()
                logger.info(f'Iter [{step}/{self.max_iters}] time: '
                            f'{(now - last_t) / since_log:.3f}, {msg}')
                last_t, since_log = now, 0
        return self.state
