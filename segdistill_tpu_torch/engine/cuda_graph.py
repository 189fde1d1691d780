"""The train step captured in a CUDA graph and replayed: steps per dispatch
on the card (the counterpart of the JAX package's ``lax.scan`` of k steps,
``build_multi_train_step``).

One graph holds one step: forward, distillation loss, backward, optimizer
step and BN statistics, with every hand-written kernel the eager step
launches. A chunk of k steps is k replays. Before each replay the host
copies the step's batch into the graph's input slots and writes the step's
scalars: each param group's learning rate (a float64 device scalar of the
capturable optimizer), each KL loss's alpha (a float32 device scalar) and
the seed of the step's generator, which the graph holds
(``CUDAGraph.register_generator_state``): a replay draws the dropout masks
and the channel permutation that the eager step at that step draws.

What a step decides on the host is part of a graph's key: the batch's
shapes, dtypes and strides, each channel shuffle's choice between a fresh
permutation and the identity (``step % interval``) and a random ensemble's
teacher. One graph is captured for each key that occurs, at its first
occurrence; all of them share one memory pool (a replay reads only the
model, the optimizer and its input slots, so they may run in any order).

K1's backward runs in its deterministic form
(``ops.resize_sum.deterministic_adjoint``), so that two replays agree
bitwise. A backbone that recomputes its blocks (MiT's ``with_cp``) does so
inside the graph's backward, its kernels with it, from the masks its
forward drew (``models/utils/recompute.py``).

A capture runs the step eagerly on the capture stream first
(``CAPTURE_WARMUP`` times), which makes the optimizer's state, the
kernels' libraries and their registries (``ops.cuda_kernel.TICKETS``,
``ops.layer_norm.WORKSPACES``, ``ops.resize_sum.RESIZE_MATRICES``) on
that stream, then puts back the parameters, buffers and optimizer state
it found (state the warm-up made goes back to 0, the state of a fresh
optimizer), so the warm-up moves
nothing. A capture that fails raises :class:`GraphCaptureError` naming the
operation; nothing falls back to the eager step. Where the optimizer's
state was replaced after a capture (a checkpoint loaded), the graphs,
which read the old tensors, are dropped and captured anew.

Across processes the graph holds the DDP step (``parallel.wrap_model(...,
static_graph=True)``): DDP's gradient all-reduces, SyncBN's, the log vars'
mean and EMANet's bases, each an NCCL collective launched on the capture
stream. PyTorch's notes on graphs and DDP ask for 11 DDP iterations
before a capture (DDP reads timing events on the host at its first 10):
the warm-up takes as many more steps as the DDP wrapper has not yet run.
:func:`check_ddp_capture` names the DDP steps that cannot be captured.
"""

import contextlib
import time
import traceback

import torch

from ..distill.losses import KLDLoss
from ..models.segmentors.sd_module import draw_teacher_index
from ..ops import cuda_kernel, layer_norm, resize_sum
from .optimizer import make_capturable, set_lr
from .train_state import step_seed

# eager steps on the capture stream before each capture
CAPTURE_WARMUP = 2
# DDP iterations before the first capture of a DDP step
DDP_ITERATIONS_BEFORE_CAPTURE = 11


class GraphCaptureError(RuntimeError):
    """A train step that a CUDA graph cannot hold."""


def check_ddp_capture(model, backend, static_graph):
    """Raise :class:`GraphCaptureError` where the DDP step of ``model``
    over a process group of ``backend`` cannot be captured: gloo's
    collectives run on the host, and without ``static_graph`` DDP
    all-reduces a map of the used parameters that it fills and reads on
    the host. A random ensemble is captured: its one distillation entry's
    adapters take part at every step, whichever teacher is drawn, and the
    teachers are frozen, so the trained parameters that DDP's static graph
    fixes at the first step are those of every step; a graph is captured
    for each teacher drawn (:meth:`GraphedTrainStep.key`)."""
    if backend != 'nccl':
        raise GraphCaptureError(
            f'steps per dispatch across processes on the card capture the '
            f'DDP step in a CUDA graph, and {backend} collectives cannot be '
            f'captured (they run on the host): use NCCL, one card a rank, '
            f'or runner.steps_per_dispatch=1')
    if not static_graph:
        raise GraphCaptureError(
            'a CUDA graph of the DDP step needs DDP\'s static graph '
            '(parallel.wrap_model(..., static_graph=True)): without it DDP '
            'fills and reads a map of the used parameters on the host')


def kl_criteria(model):
    """The KL losses (alpha schedules, channel shuffles) of a distiller's
    distillation entries, a random ensemble's per teacher included."""
    losses = [getattr(model, 'distillation_loss', None)]
    losses += list(getattr(model, 'per_teacher_losses', []))
    return [e['criterion'] for loss in losses if loss is not None
            for e in loss.entries if isinstance(e['criterion'], KLDLoss)]


def _where(exc):
    """The innermost frame of ``exc``'s traceback, and the innermost one in
    this package: the operation a capture refused."""
    frames = traceback.extract_tb(exc.__traceback__)
    if not frames:
        return 'an unknown operation'
    inner = frames[-1]
    ours = [f for f in frames if 'segdistill_tpu_torch' in f.filename]
    where = f'{inner.filename}:{inner.lineno} ({inner.line})'
    if ours and ours[-1] is not inner:
        where += f', called from {ours[-1].filename}:{ours[-1].lineno} ' \
                 f'({ours[-1].line})'
    return where


class GraphedTrainStep:
    """fn(state, imgs, gts) -> the log vars of the last of ``imgs.shape[0]``
    steps, each a replay of the step's CUDA graph.

    ``step_losses``: ``runner.build_step_losses``' forward. The optimizer
    is made capturable (:func:`~.optimizer.make_capturable`) at the first
    call. ``graphs``: {key: (graph, its log vars, image slot, label slot,
    teacher)}; ``capture_seconds``: each capture's time, warm-up
    included. ``ddp``: the DDP wrapper that ``step_losses`` runs, if any
    (the warm-up brings its iterations to DDP_ITERATIONS_BEFORE_CAPTURE)."""

    def __init__(self, model, optimizer, lr_schedule, step_losses,
                 ddp=None):
        self.model = model
        self.ddp = ddp
        self.optimizer = optimizer
        self.lr_schedule = lr_schedule
        self.step_losses = step_losses
        self.criteria = kl_criteria(model)
        self.shuffles = [c for c in self.criteria if c.shuffle_config]
        self.n_teachers = len(model.teachers) \
            if getattr(model, 'random_ensemble', False) else 0
        self.graphs = {}
        self.capture_seconds = []
        self.pool = None
        self.stream = None
        self.generator = None
        self.alphas = []

    def _setup(self, device):
        make_capturable(self.optimizer, device)
        self.graphs = {}
        self.pool = None
        self.stream = torch.cuda.Stream(device)
        self.generator = torch.Generator(device=device)
        self.alphas = [torch.zeros((), dtype=torch.float32, device=device)
                       for _ in self.criteria]
        self.held = self._held()

    def _held(self):
        """What the graphs read of the optimizer: its state and each
        group's learning-rate tensor."""
        return [self.optimizer.state] + [g['lr'] for g in
                                         self.optimizer.param_groups]

    def key(self, state, step, img, gt):
        """What the host decides for ``step`` on this batch."""
        key = (tuple(img.shape), img.dtype, img.stride(), tuple(gt.shape),
               gt.dtype, gt.stride())
        key += tuple(step % c.shuffle_config['interval'] == 0
                     for c in self.shuffles)
        if self.n_teachers:
            key += (draw_teacher_index(step_seed(state.seed, step),
                                       self.n_teachers),)
        return key

    def write(self, state, step):
        """The scalars of ``step`` (the state's next): learning rates,
        alphas, the generator's seed; -> the learning rate."""
        lr = None if self.lr_schedule is None \
            else self.lr_schedule(state.step)
        if lr is not None:
            set_lr(self.optimizer, lr)
        for criterion, alpha in zip(self.criteria, self.alphas):
            alpha.fill_(criterion.alpha_at(step))
        self.generator.manual_seed(step_seed(state.seed, step))
        return lr

    @contextlib.contextmanager
    def _device_alphas(self):
        for criterion, alpha in zip(self.criteria, self.alphas):
            criterion.alpha_tensor = alpha
        try:
            yield
        finally:
            for criterion in self.criteria:
                criterion.alpha_tensor = None

    def _body(self, img, gt, step, teacher_index):
        """The step without ``zero_grad``: the backward writes the
        gradients, which are None when it is captured."""
        with self._device_alphas(), resize_sum.deterministic_adjoint():
            total, log_vars = self.step_losses(img, gt, step, self.generator,
                                               teacher_index=teacher_index)
            total.backward()
        self.optimizer.step()
        return {k: v.detach() for k, v in log_vars.items()}

    def _state_tensors(self):
        """The trained parameters, every buffer and the optimizer state."""
        tensors = [p for p in self.model.parameters() if p.requires_grad]
        tensors += list(self.model.buffers())
        for group in self.optimizer.param_groups:
            for p in group['params']:
                tensors += [v for v in self.optimizer.state.get(p, {})
                            .values() if torch.is_tensor(v)]
        return list({id(t): t for t in tensors}.values())

    @torch.no_grad()
    def _restore(self, saved):
        kept = {id(t) for t, _ in saved}
        for t, value in saved:
            t.copy_(value)
        for t in self._state_tensors():
            if id(t) not in kept:  # made by the warm-up: a fresh state
                t.zero_()

    def _warmup(self):
        if self.ddp is None:
            return CAPTURE_WARMUP
        return max(CAPTURE_WARMUP,
                   DDP_ITERATIONS_BEFORE_CAPTURE - self.ddp.module.calls)

    def _capture(self, state, step, key, img, gt):
        t0 = time.perf_counter()
        device = img.device
        slot_img, slot_gt = torch.empty_like(img), torch.empty_like(gt)
        slot_img.copy_(img)
        slot_gt.copy_(gt)
        teacher = key[-1] if self.n_teachers else None
        self.model.train()
        saved = [(t, t.detach().clone()) for t in self._state_tensors()]
        stream = self.stream
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            for _ in range(self._warmup()):
                self.write(state, step)
                self.optimizer.zero_grad(set_to_none=True)
                self._body(slot_img, slot_gt, step, teacher)
            self._restore(saved)
            self.optimizer.zero_grad(set_to_none=True)
        torch.cuda.current_stream(device).wait_stream(stream)
        torch.cuda.synchronize(device)
        del saved
        registries = (len(cuda_kernel.TICKETS), len(layer_norm.WORKSPACES),
                      len(resize_sum.RESIZE_MATRICES))
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=stream,
                                  capture_error_mode='thread_local'):
                out = self._body(slot_img, slot_gt, step, teacher)
        except Exception as exc:
            raise GraphCaptureError(
                f'the train step cannot be captured in a CUDA graph: '
                f'{_where(exc)} failed: {exc}') from exc
        if registries != (len(cuda_kernel.TICKETS),
                          len(layer_norm.WORKSPACES),
                          len(resize_sum.RESIZE_MATRICES)):
            raise GraphCaptureError(
                'a kernel registry (ops.cuda_kernel.TICKETS, '
                'ops.layer_norm.WORKSPACES or '
                'ops.resize_sum.RESIZE_MATRICES) made an entry inside the '
                'capture: its tensor would live in the graph\'s pool')
        self.pool = graph.pool()
        self.graphs[key] = (graph, out, slot_img, slot_gt, teacher)
        self.capture_seconds.append(time.perf_counter() - t0)

    def __call__(self, state, imgs, gts):
        if self.stream is None or any(
                a is not b for a, b in zip(self.held, self._held())):
            self._setup(imgs.device)
        lr = None
        for img, gt in zip(imgs, gts):
            step = state.step + 1
            key = self.key(state, step, img, gt)
            if key not in self.graphs:
                self._capture(state, step, key, img, gt)
            graph, out, slot_img, slot_gt, _ = self.graphs[key]
            slot_img.copy_(img, non_blocking=True)
            slot_gt.copy_(gt, non_blocking=True)
            lr = self.write(state, step)
            graph.replay()
            state.step = step
        # the next replay overwrites the graph's outputs
        log_vars = {k: v.clone() for k, v in out.items()}
        if lr is not None:
            log_vars['lr'] = lr
        return log_vars
