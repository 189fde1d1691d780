from .checkpoint import (checkpoint_file, load_checkpoint, load_meta,
                         load_weights, resume_latest, save_checkpoint)
from .lr_schedule import build_lr_schedule
from .optimizer import build_optimizer, paramwise_labels, set_lr
from .runner import IterBasedRunner, build_train_step, gradient_angle
from .train_state import TrainState, step_seed

__all__ = ['checkpoint_file', 'load_checkpoint', 'load_meta', 'load_weights',
           'resume_latest', 'save_checkpoint', 'build_lr_schedule',
           'build_optimizer', 'paramwise_labels', 'set_lr',
           'IterBasedRunner', 'build_train_step', 'gradient_angle',
           'TrainState', 'step_seed']
