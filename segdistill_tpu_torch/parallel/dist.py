"""Data parallelism across processes (counterpart of
``segdistill_tpu/parallel/mesh.py``; reference: mmcv's ``init_dist``,
``get_dist_info`` and ``MMDistributedDataParallel`` as
``tools/dist_train.sh`` drives them, SURVEY §2.10).

One process a device, started by torchrun (or :mod:`.launch`), each with
its share of the global batch. The parts of the reference's data
parallelism and where they are in the port:

* the process group, from torchrun's environment: :func:`init_distributed`
  (:func:`process_group` around a command line);
* gradients averaged over ranks: DDP around the train forward
  (:func:`wrap_model`, used by ``engine/runner.py``'s train step);
* SyncBN statistics over all ranks: ``models/utils/norm.py``;
* the log scalars averaged over ranks: ``models/segmentors/base.py``;
* the rank's share of each global batch: ``datasets/builder.py``;
* evaluation sharded by image, the histograms summed:
  ``apis/test.py``;
* rank 0 alone writes: ``utils/logger.py``, ``engine/checkpoint.py``.

Without a process group every function here is the one-process case,
rank 0 of 1, and no collective runs. Every collective of the port is an
``all_reduce`` or a ``broadcast``, which gloo also carries for CUDA
tensors (two ranks sharing one card, where NCCL refuses).
"""

import contextlib
import datetime
import os

import torch
import torch.distributed as dist
from torch import nn

# how long a collective waits for the other ranks before it raises: a rank
# that failed leaves the others waiting in their next collective
TIMEOUT = datetime.timedelta(minutes=10)


def init_distributed(backend=None, timeout=TIMEOUT):
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); -> (rank, world size).

    ``backend``: NCCL where CUDA is available, else gloo. With CUDA the
    process takes card ``LOCAL_RANK`` (modulo the cards there are: ranks
    that share a card need gloo; NCCL refuses two ranks on one device)."""
    for key in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT'):
        if key not in os.environ:
            raise RuntimeError(
                f'{key} is not set: start the processes with torchrun '
                f'(torchrun --nproc-per-node N -m ... --multi-host)')
    rank, world = int(os.environ['RANK']), int(os.environ['WORLD_SIZE'])
    if torch.cuda.is_available():
        local = int(os.environ.get('LOCAL_RANK', rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    dist.init_process_group(backend, init_method='env://', rank=rank,
                            world_size=world, timeout=timeout)
    return rank, world


@contextlib.contextmanager
def process_group(backend=None, timeout=TIMEOUT):
    """Inside the block, torchrun's process group: joined here and
    destroyed at the end, unless the process already has one, which is
    used and left as it is. Yields (rank, world size)."""
    if dist.is_available() and dist.is_initialized():
        yield get_dist_info()
        return
    init_distributed(backend, timeout)
    try:
        yield get_dist_info()
    finally:
        dist.destroy_process_group()


def get_dist_info():
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main_process():
    return get_dist_info()[0] == 0


def synced():
    """Whether there is a process group of more than one rank to
    synchronise with."""
    return get_dist_info()[1] > 1


def barrier():
    if synced():
        dist.barrier()


def all_reduce_mean(tensor):
    """The mean of ``tensor`` over the ranks, the same bits on every rank;
    ``tensor`` itself without a group of more than one rank."""
    rank, world = get_dist_info()
    if world == 1:
        return tensor
    out = tensor.detach().clone()
    dist.all_reduce(out)
    return out.div_(world)


class TrainForward(nn.Module):
    """The module DDP wraps: its ``forward`` is the model's
    ``forward_train`` (DDP prepares the gradient averaging only inside its
    own ``forward``). It holds the model as ``model``; a checkpoint is
    written from the model itself, without this prefix. ``calls``: its
    forwards, DDP's iterations."""

    def __init__(self, model):
        super().__init__()
        self.model = model
        self.calls = 0

    def forward(self, *args, **kwargs):
        self.calls += 1
        return self.model.forward_train(*args, **kwargs)


# DDP's runtime statistics: recorded at its first 10 iterations and then
# once in this many (a host read of CUDA events, which no CUDA graph can
# hold): never again, for a DDP whose step is captured
NO_RUNTIME_STATS = 2**31 - 1


def wrap_model(model, cfg=None, static_graph=False):
    """DDP around ``model``'s train forward (mmseg's
    ``MMDistributedDataParallel``): buffers are not broadcast
    (``broadcast_buffers=False``: each rank's SyncBN statistics are already
    global), and ``find_unused_parameters`` is the config's, by default
    True as in the reference, which sets it for its frozen teacher (the
    port's teachers hold no trained parameter). Raises without a process
    group.

    ``static_graph``: the form a CUDA graph of the step holds
    (``engine/cuda_graph.py``), as PyTorch's notes on graphs and DDP ask:
    DDP's static graph (the parameters that take part are found at the
    first iteration and fixed; the search of the autograd graph and the
    all-reduce of the used-parameter map, copied from the host, go), built
    on a side stream for a model on the card, with its runtime statistics
    off after the first 10 iterations."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError('distributed training needs a process group: '
                           'call init_distributed() (--multi-host)')
    device = next(model.parameters()).device
    find_unused = (cfg or {}).get('find_unused_parameters', True)
    kwargs = dict(device_ids=[device.index] if device.type == 'cuda'
                  else None, broadcast_buffers=False)
    if not static_graph:
        return nn.parallel.DistributedDataParallel(
            TrainForward(model), find_unused_parameters=find_unused,
            **kwargs)
    side = torch.cuda.Stream(device) if device.type == 'cuda' else None
    with torch.cuda.stream(side):  # None: the CPU, no stream to choose
        ddp = nn.parallel.DistributedDataParallel(
            TrainForward(model), static_graph=True, **kwargs)
    if side is not None:
        torch.cuda.current_stream(device).wait_stream(side)
    ddp._set_ddp_runtime_logging_sample_rate(NO_RUNTIME_STATS)
    return ddp
