"""LR schedules (counterpart of ``segdistill_tpu/engine/lr_schedule.py``;
reference: mmcv's LrUpdaterHook as ``lr_config`` configures it, e.g.
``local_configs/exp_tab5/segformer_CGD.py:66-70``).

A schedule is a plain function of the step. mmcv's warmup: during
warmup, ``lr = base * (1 - (1 - iter/warmup_iters) * (1 - warmup_ratio))``
(linear), then the main policy.
"""


def build_lr_schedule(lr_config, base_lr, max_iters):
    """-> fn(step) -> lr (a float)."""
    cfg = dict(lr_config or {})
    policy = cfg.pop('policy', 'fixed')
    warmup = cfg.pop('warmup', None)
    warmup_iters = cfg.pop('warmup_iters', 0)
    warmup_ratio = cfg.pop('warmup_ratio', 0.1)

    if policy == 'poly':
        power = cfg.pop('power', 1.0)
        min_lr = cfg.pop('min_lr', 0.0)

        def main(step):
            coeff = (1.0 - step / max_iters) ** power
            return (base_lr - min_lr) * coeff + min_lr
    elif policy == 'step':
        steps = cfg.pop('step')
        gamma = cfg.pop('gamma', 0.1)
        steps = [steps] if isinstance(steps, int) else list(steps)

        def main(step):
            return base_lr * gamma ** sum(step >= s for s in steps)
    elif policy == 'fixed':
        def main(step):
            return base_lr
    else:
        raise NotImplementedError(f'lr policy {policy}')
    if warmup not in (None, 'linear', 'exp', 'constant'):
        raise NotImplementedError(f'warmup {warmup}')
    if warmup is None:
        return lambda step: float(main(float(step)))

    def schedule(step):
        step = float(step)
        if step >= warmup_iters:
            return float(main(step))
        frac = min(max(step / max(warmup_iters, 1), 0.0), 1.0)
        if warmup == 'linear':
            return base_lr * (1.0 - (1.0 - frac) * (1.0 - warmup_ratio))
        if warmup == 'exp':
            return base_lr * warmup_ratio ** (1.0 - frac)
        return base_lr * warmup_ratio

    return schedule
