"""The optimizers with mmcv's paramwise multipliers (counterpart of
``segdistill_tpu/engine/optimizer.py``; reference: mmcv's
DefaultOptimizerConstructor as ``optimizer = dict(type=..., ...,
paramwise_cfg=dict(custom_keys=...))`` drives it, e.g.
``local_configs/exp_tab5/segformer_CGD.py:60-64`` and the SGD of
``_base_/schedules/schedule_*k.py``).

``custom_keys`` are sorted reverse-alphabetically and the first that is a
substring of a parameter's dotted state-dict name gives its
``(lr_mult, decay_mult)``. Each distinct pair is one param group with
weight decay ``wd * decay_mult``; :func:`set_lr` gives each group
``lr * lr_mult``.

AdamW: torch's decoupled step ``p -= lr_g * (adam + wd_g * p)`` is the JAX
package's optax chain (adam, + wd*decay_mult*p, * lr_mult, * -lr).

SGD and Adam are ``torch.optim.SGD`` and ``torch.optim.Adam``, as mmcv
builds them for the reference: the weight decay is added to the gradient
*before* the momentum (SGD) or the moments (Adam). The JAX package adds it
after them (``optax.trace`` or ``scale_by_adam``, then ``+ wd * p``), a
decay that never enters the momentum buffer: at momentum 0.9 it is ~10x
weaker in steady state. The port follows the reference; without weight
decay the two are the same update.

A CUDA graph of the step (``engine/cuda_graph.py``) holds an optimizer
whose learning rates are device scalars (:func:`make_capturable`): Adam and
AdamW in torch's capturable form, SGD as :class:`CapturableSGD`.
"""

import torch


def paramwise_labels(names, custom_keys):
    """{name: (lr_mult, decay_mult)} by substring match."""
    sorted_keys = sorted(custom_keys, reverse=True)
    labels = {}
    for name in names:
        lr_mult, decay_mult = 1.0, 1.0
        for key in sorted_keys:
            if key in name:
                lr_mult = custom_keys[key].get('lr_mult', 1.0)
                decay_mult = custom_keys[key].get('decay_mult', 1.0)
                break
        labels[name] = (float(lr_mult), float(decay_mult))
    return labels


def build_optimizer(optimizer_cfg, model):
    """-> ``torch.optim.AdamW``, ``SGD`` or ``Adam`` over ``model``'s
    parameters that require grad, one param group per distinct (lr_mult,
    decay_mult)."""
    cfg = dict(optimizer_cfg)
    opt_type = cfg.pop('type')
    if opt_type not in ('AdamW', 'SGD', 'Adam'):
        raise NotImplementedError(f'optimizer {opt_type}: AdamW, SGD and '
                                  f'Adam are ported')
    base_lr = cfg.pop('lr')
    weight_decay = cfg.pop('weight_decay', 0.0)
    custom_keys = dict((cfg.pop('paramwise_cfg', None) or {})
                       .get('custom_keys', {}))
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    groups = {}
    for name, (lr_mult, decay_mult) in paramwise_labels(
            params, custom_keys).items():
        groups.setdefault((lr_mult, decay_mult), []).append(params[name])
    param_groups = [dict(params=ps, lr=base_lr * lm, lr_mult=lm,
                         weight_decay=weight_decay * dm)
                    for (lm, dm), ps in groups.items()]
    if opt_type == 'SGD':
        return torch.optim.SGD(param_groups, lr=base_lr,
                               momentum=cfg.pop('momentum', 0.0),
                               nesterov=cfg.pop('nesterov', False),
                               weight_decay=weight_decay)
    adam = torch.optim.AdamW if opt_type == 'AdamW' else torch.optim.Adam
    return adam(param_groups, lr=base_lr,
                betas=tuple(cfg.pop('betas', (0.9, 0.999))),
                eps=cfg.pop('eps', 1e-8), weight_decay=weight_decay)


def set_lr(optimizer, lr):
    """The step's learning rate, times each group's ``lr_mult``; a group
    whose learning rate is a device scalar (a CUDA graph's optimizer,
    :func:`make_capturable`) has it written in place."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group['lr']):
            group['lr'].fill_(lr * group['lr_mult'])
        else:
            group['lr'] = lr * group['lr_mult']


class CapturableSGD(torch.optim.SGD):
    """``torch.optim.SGD`` whose step reads each group's learning rate from
    a device scalar (:func:`make_capturable` turns an SGD into this class):
    no value goes to the host, so a CUDA graph holds the step.

    The update is torch's, operation for operation, with the learning rate
    applied by ``addcmul_`` with the scalar in place of ``add_`` with
    ``alpha=-lr`` (the same product, rounded once): weight decay added to
    the gradient before the momentum, ``nesterov``, ``maximize``; no
    ``dampening``. Momentum buffers are made as zeros, not as a copy of the
    first gradient: ``0 * momentum + grad`` is that copy, so a graph's
    warm-up, which leaves zeroed buffers, does not change the first step."""

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group['params'] if p.grad is not None]
            if params:
                self._group_step(group, params)
        return loss

    def _group_step(self, group, params):
        grads = [p.grad for p in params]
        if group['maximize']:
            grads = torch._foreach_neg(grads)
        weight_decay, momentum = group['weight_decay'], group['momentum']
        if weight_decay != 0:
            grads = torch._foreach_add(grads, params, alpha=weight_decay)
        if momentum != 0:
            states = [self.state[p] for p in params]
            for p, st in zip(params, states):
                if st.get('momentum_buffer') is None:
                    st['momentum_buffer'] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
            bufs = [st['momentum_buffer'] for st in states]
            torch._foreach_mul_(bufs, momentum)
            torch._foreach_add_(bufs, grads)
            grads = torch._foreach_add(grads, bufs, alpha=momentum) \
                if group['nesterov'] else bufs
        torch._foreach_addcmul_(params, grads, [group['lr']] * len(params),
                                value=-1)


def make_capturable(optimizer, device):
    """Turn an optimizer into the form a CUDA graph can hold: each group's
    learning rate a float64 scalar on ``device`` that :func:`set_lr` writes
    before each replay (a float, or a tensor elsewhere, as a loaded state
    holds it, is moved there) and ``capturable=True``. Adam and AdamW then
    keep their step counters on the device (those of a loaded state are
    moved there); an SGD without dampening (no config sets it, and the JAX
    package's momentum has none) becomes a :class:`CapturableSGD`.
    Idempotent."""
    if isinstance(optimizer, torch.optim.SGD):
        if any(g['dampening'] != 0 for g in optimizer.param_groups):
            raise NotImplementedError(
                'SGD with dampening has no capturable form: steps per '
                'dispatch on the card take SGD without dampening')
        optimizer.__class__ = CapturableSGD
    elif not isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        raise NotImplementedError(
            f'{type(optimizer).__name__} has no capturable form: steps per '
            f'dispatch on the card take SGD, Adam or AdamW')
    for group in optimizer.param_groups:
        group['capturable'] = True
        group['lr'] = torch.as_tensor(group['lr'], dtype=torch.float64,
                                      device=device)
        for p in group['params']:
            state = optimizer.state.get(p, {})
            step = state.get('step')
            if step is not None and (not torch.is_tensor(step)
                                     or step.device != p.device):
                state['step'] = torch.as_tensor(
                    step, dtype=torch.float32).to(p.device)


def plain_state_dict(optimizer):
    """``optimizer.state_dict()`` with its groups in the plain form
    whatever the optimizer's: float learning rates and, where the key is
    there, ``capturable=False``. A checkpoint then loads into a run of
    any steps per dispatch; :func:`make_capturable` turns it back."""
    state = optimizer.state_dict()
    for group in state['param_groups']:
        group['lr'] = float(group['lr'])
        if 'capturable' in group:
            group['capturable'] = False
    return state
