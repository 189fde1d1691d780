"""Periodic evaluation during training (counterpart of
``segdistill_tpu/core/evaluation/eval_hooks.py``; reference
``mmseg/core/evaluation/eval_hooks.py:7-107``).

The hook fires when a step crosses a multiple of ``interval``. It is seeded
with the iteration the runner starts from (0, or a resumed step), so the
first call compares against the true previous step whatever the stride
between calls; the JAX hook guesses ``step - 1`` there.
"""


class EvalHook:

    def __init__(self, eval_fn, interval=2000, by_epoch=False, start_iter=0,
                 **eval_kwargs):
        if by_epoch:
            raise NotImplementedError('iteration-based training only')
        self.eval_fn = eval_fn
        self.interval = interval
        self.eval_kwargs = eval_kwargs
        self.latest_results = None
        self._prev_step = int(start_iter)

    def after_train_iter(self, runner_state):
        step = int(runner_state.step)
        prev, self._prev_step = self._prev_step, step
        if step // self.interval == prev // self.interval:
            return None
        self.latest_results = self.eval_fn(runner_state, **self.eval_kwargs)
        return self.latest_results
