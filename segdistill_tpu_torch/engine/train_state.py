"""Training state (counterpart of ``segdistill_tpu/engine/train_state.py``).

The model and the optimizer hold the weights, BN statistics and moments,
and update in place; the state adds the step counter and the seed from
which each step's random draws are seeded.
"""

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    seed: int = 0
    step: int = 0


def step_seed(seed, step):
    """A 63-bit seed for the random draws of ``step``, a function of
    (seed, step) alone: resuming at a step repeats its draws."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])
