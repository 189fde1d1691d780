from .checkpoint import (checkpoint_file, load_checkpoint, load_meta,
                         load_weights, resume_latest, save_checkpoint)
from .lr_schedule import build_lr_schedule
from .optimizer import (build_optimizer, make_capturable, paramwise_labels,
                        set_lr)
from .runner import (IterBasedRunner, MultiTrainStep, build_multi_train_step,
                     build_train_step, gradient_angle)
from .train_state import TrainState, step_seed

__all__ = ['checkpoint_file', 'load_checkpoint', 'load_meta', 'load_weights',
           'resume_latest', 'save_checkpoint', 'build_lr_schedule',
           'build_optimizer', 'make_capturable', 'paramwise_labels', 'set_lr',
           'IterBasedRunner', 'MultiTrainStep', 'build_multi_train_step',
           'build_train_step', 'gradient_angle',
           'TrainState', 'step_seed']
