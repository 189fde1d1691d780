"""AdamW with mmcv's paramwise multipliers (counterpart of
``segdistill_tpu/engine/optimizer.py``; reference: mmcv's
DefaultOptimizerConstructor as ``optimizer = dict(type='AdamW', ...,
paramwise_cfg=dict(custom_keys=...))`` drives it, e.g.
``local_configs/exp_tab5/segformer_CGD.py:60-64``).

``custom_keys`` are sorted reverse-alphabetically and the first that is a
substring of a parameter's dotted state-dict name gives its
``(lr_mult, decay_mult)``. Each distinct pair is one param group with
weight decay ``wd * decay_mult``; :func:`set_lr` gives each group
``lr * lr_mult``. Torch's decoupled step ``p -= lr_g * (adam + wd_g * p)``
is then the JAX package's optax chain (adam, + wd*decay_mult*p,
* lr_mult, * -lr).
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
    """-> ``torch.optim.AdamW`` over ``model``'s parameters that require
    grad, one param group per distinct (lr_mult, decay_mult)."""
    cfg = dict(optimizer_cfg)
    opt_type = cfg.pop('type')
    if opt_type != 'AdamW':
        raise NotImplementedError(f'optimizer {opt_type}: only AdamW is '
                                  f'ported')
    base_lr = cfg.pop('lr')
    weight_decay = cfg.pop('weight_decay', 0.0)
    custom_keys = dict((cfg.pop('paramwise_cfg', None) or {})
                       .get('custom_keys', {}))
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    groups = {}
    for name, (lr_mult, decay_mult) in paramwise_labels(
            params, custom_keys).items():
        groups.setdefault((lr_mult, decay_mult), []).append(params[name])
    return torch.optim.AdamW(
        [dict(params=ps, lr=base_lr * lm, lr_mult=lm,
              weight_decay=weight_decay * dm)
         for (lm, dm), ps in groups.items()],
        lr=base_lr, betas=tuple(cfg.pop('betas', (0.9, 0.999))),
        eps=cfg.pop('eps', 1e-8), weight_decay=weight_decay)


def set_lr(optimizer, lr):
    """The step's learning rate, times each group's ``lr_mult``."""
    for group in optimizer.param_groups:
        group['lr'] = lr * group['lr_mult']
