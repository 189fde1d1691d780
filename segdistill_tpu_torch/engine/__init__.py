from .lr_schedule import build_lr_schedule
from .optimizer import build_optimizer, paramwise_labels, set_lr
from .runner import IterBasedRunner, build_train_step
from .train_state import TrainState, step_seed

__all__ = ['build_lr_schedule', 'build_optimizer', 'paramwise_labels',
           'set_lr', 'IterBasedRunner', 'build_train_step', 'TrainState',
           'step_seed']
