"""Activation recompute of one block (the port's counterpart of the JAX
package's ``nn.remat(Block)``, MiT's ``with_cp``): the block runs under
``torch.utils.checkpoint``, which keeps its input and recomputes the rest in
the backward.

The block's dropout and drop-path masks come from the step's
``torch.Generator``, which ``checkpoint`` does not save (its
``preserve_rng_state`` covers the default generators alone, and saving the
card's is refused inside a CUDA graph capture). The block gets a
:class:`DrawTape` in the generator's place: the first run draws each mask
from the generator and keeps it, every recompute takes the kept masks in
the same order. The generator's stream of draws is then the one the step
draws without recompute, eagerly and in a graph, and a recompute leaves
the generator as it is.

The checkpoint is the non-reentrant one: a tensor that leaves the block
through a tap (``attn.Q``, ``FEA``; :func:`.taps.tap`) gets its gradient,
and ``torch.autograd.grad`` (the train step's ``log_grad``) runs through
it. A recompute records no tap: the tap sink is gone when the forward's
capture ends.
"""

import torch
from torch.utils.checkpoint import checkpoint


class DrawTape:
    """Stands for ``generator`` inside a recomputed block: the masks of the
    first run, drawn from ``generator``, handed out again in order at each
    later run (:meth:`rewind` starts a run)."""

    def __init__(self, generator):
        self.generator = generator
        self.masks = []
        self.runs = 0
        self.taken = 0

    def rewind(self):
        self.runs += 1
        self.taken = 0

    def mask(self, shape, dtype, device, keep):
        """A Bernoulli(``keep``) mask of ``shape``: drawn at the first run,
        the same tensor at a recompute."""
        if self.runs <= 1:
            mask = torch.empty(shape, dtype=dtype, device=device)
            mask.bernoulli_(keep, generator=self.generator)
            self.masks.append(mask)
            return mask
        self.taken += 1
        return self.masks[self.taken - 1]


def recomputed(block, x, *args, generator=None):
    """``block(x, *args, generator)``, its activations recomputed in the
    backward (:mod:`recompute`'s note)."""
    tape = None if generator is None else DrawTape(generator)

    def run(x):
        if tape is not None:
            tape.rewind()
        return block(x, *args, tape)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)
