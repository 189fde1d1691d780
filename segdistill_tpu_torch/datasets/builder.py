"""Dataset and pipeline registries, ``build_dataset`` and the host data
loader (counterpart of ``segdistill_tpu/datasets/builder.py``; reference
``mmseg/datasets/builder.py:21-169``).

The loader is a prefetching iterator: samples are read and augmented by a
thread pool (numpy and torch release the GIL in their kernels), and
collated batches wait in a bounded queue for the train loop. Three
backends share its order, rank shards and seeds (``LOADER_BACKENDS``):
'host' runs the dataset's pipeline a sample and yields numpy batches;
'native' decodes on the threads and augments the batch in one call into
the C++ core (``native/fastaug.cpp``, the GIL released); 'device' decodes
and pads on the threads and augments the batch on the card
(``data/device_aug.py``). The last two yield tensors on their device.
"""

import copy
import math
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..parallel import get_dist_info
from ..registry import Registry, build_from_cfg

DATASETS = Registry('dataset')
PIPELINES = Registry('pipeline')


def getitem_with_rng(dataset, idx, rng):
    """Fetch ``dataset[idx]`` passing the per-sample RNG when the dataset
    supports it (framework datasets/wrappers do; ad-hoc test datasets may
    not — they fall back to index-only access)."""
    import inspect
    try:
        accepts = 'rng' in inspect.signature(
            dataset.__getitem__).parameters
    except (TypeError, ValueError):
        accepts = False
    if accepts:
        return dataset.__getitem__(idx, rng=rng)
    return dataset[idx]


def _concat_dataset(cfg, default_args=None):
    """Expand list-valued img_dir/ann_dir/split into a ConcatDataset
    (ref builder.py:34-58)."""
    from .dataset_wrappers import ConcatDataset
    img_dir = cfg['img_dir']
    ann_dir = cfg.get('ann_dir', None)
    split = cfg.get('split', None)
    num_img_dir = len(img_dir) if isinstance(img_dir, (list, tuple)) else 1
    if ann_dir is not None:
        num_ann_dir = len(ann_dir) if isinstance(ann_dir, (list, tuple)) \
            else 1
    else:
        num_ann_dir = 0
    if split is not None:
        num_split = len(split) if isinstance(split, (list, tuple)) else 1
    else:
        num_split = 0
    if num_img_dir > 1:
        assert num_ann_dir in (num_img_dir, 0)
        assert num_split in (num_img_dir, 0)
    else:
        assert num_split == num_ann_dir or num_ann_dir <= 1
    num_dset = max(num_split, num_img_dir)

    datasets = []
    for i in range(num_dset):
        data_cfg = copy.deepcopy(cfg)
        if isinstance(img_dir, (list, tuple)):
            data_cfg['img_dir'] = img_dir[i]
        if isinstance(ann_dir, (list, tuple)):
            data_cfg['ann_dir'] = ann_dir[i]
        if isinstance(split, (list, tuple)):
            data_cfg['split'] = split[i]
        datasets.append(build_dataset(data_cfg, default_args))
    return ConcatDataset(datasets)


def build_dataset(cfg, default_args=None):
    """(ref builder.py:61-75)."""
    from .dataset_wrappers import ConcatDataset, RepeatDataset
    if isinstance(cfg, (list, tuple)):
        return ConcatDataset([build_dataset(c, default_args) for c in cfg])
    if cfg['type'] == 'RepeatDataset':
        return RepeatDataset(build_dataset(cfg['dataset'], default_args),
                             cfg['times'])
    if cfg['type'] == 'ConcatDataset':
        return ConcatDataset(
            [build_dataset(c, default_args) for c in cfg['datasets']])
    if isinstance(cfg.get('img_dir'), (list, tuple)) or isinstance(
            cfg.get('split'), (list, tuple)):
        return _concat_dataset(cfg, default_args)
    return build_from_cfg(cfg, DATASETS, default_args)


def default_collate(samples):
    """Stack same-shaped arrays; keep metas as a list of dicts."""
    batch = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if key == 'img_metas':
            batch[key] = vals
        elif isinstance(vals[0], np.ndarray):
            batch[key] = np.stack(vals, axis=0)
        else:
            batch[key] = vals
    return batch


class _Failure:
    """What the producer hands over when it raised."""

    def __init__(self, error):
        self.error = error


class DataLoader:
    """Host prefetching loader with the JAX loader's epoch order, rank
    shards and per-sample seeds: the same ``seed`` gives the same stream
    of samples in both packages. ``start_batch`` skips that many batches
    of the rank's stream without loading them, keeping their order and
    seeds: a run resumed at step n goes on with the batches an
    uninterrupted run would have seen (the JAX loader restarts its stream
    on resume).

    * train (``shuffle=True``): infinite stream; a fresh permutation per
      epoch (seeded by epoch, the same on every rank), cut into global
      batches of ``samples_per_gpu * process_count``, of which rank
      ``process_index`` takes the ``process_index``-th block.
    * eval: one sequential pass, ``drop_last=False``, sharded the same way.

    A sample's seed is keyed by (seed, rank, its position in the rank's
    stream).
    """

    PREFETCH = 4    # collated batches waiting for the train loop

    def __init__(self, dataset, samples_per_gpu=1, num_workers=2,
                 shuffle=True, seed=42, drop_last=True, start_batch=0,
                 process_index=0, process_count=1):
        self.dataset = dataset
        self.batch_size = samples_per_gpu
        self.num_workers = max(num_workers, 1)
        self.shuffle = shuffle
        self.seed = seed if seed is not None else 0
        self.drop_last = drop_last
        self.start_batch = int(start_batch)
        self.rank, self.world = int(process_index), int(process_count)

    def __len__(self):
        n = len(self.dataset)
        global_batch = self.batch_size * self.world
        if self.drop_last:
            return n // global_batch
        return (n + global_batch - 1) // global_batch

    def _epoch_indices(self, epoch):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + epoch)
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        global_batch = self.batch_size * self.world
        if self.drop_last:
            order = order[:n // global_batch * global_batch]
        first = self.rank * self.batch_size
        return [order[i + first:i + first + self.batch_size]
                for i in range(0, len(order), global_batch)]

    def _load(self, idx, sample_seed):
        # one private RandomState per sample: deterministic by
        # (seed, position-in-stream) and safe under thread concurrency —
        # seeding the process-global numpy RNG from pool threads (the
        # reference's per-worker-process model, ref builder.py:155-169)
        # would race here
        rng = np.random.RandomState(sample_seed) \
            if sample_seed is not None else None
        return getitem_with_rng(self.dataset, int(idx), rng)

    def _collate(self, samples, seeds):
        """The producer's batch from the loaded ``samples`` and their
        seeds."""
        del seeds
        return default_collate(samples)

    def _deliver(self, batch):
        """The batch as the consumer yields it, on the consumer's thread
        (and so on the train step's CUDA stream)."""
        return batch

    def __iter__(self):
        # eager (non-generator) so the empty-epoch check raises at iter()
        # time, not at the first next()
        n = len(self.dataset)
        global_batch = self.batch_size * self.world
        if self.drop_last and n < global_batch:
            # would yield ZERO batches per epoch — the producer would spin
            # through empty epochs forever while the consumer blocks
            raise ValueError(
                f'dataset has {n} samples but the global batch is '
                f'{global_batch} ({self.batch_size} a rank x {self.world} '
                f'rank(s)) with drop_last=True: no full batch can ever be '
                f'formed. Lower samples_per_gpu or grow the dataset.')
        return self._iterate()

    def _iterate(self):
        q = queue.Queue(maxsize=self.PREFETCH)
        stop = threading.Event()

        def put(item):
            """Hand ``item`` over unless the consumer has gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def producer():
            try:
                produce()
            except Exception as e:  # handed to the consumer to raise
                put(_Failure(e))

        def produce():
            epoch = 0
            counter = 0
            to_skip = self.start_batch
            with ThreadPoolExecutor(self.num_workers) as pool:
                while not stop.is_set():
                    for batch_idx in self._epoch_indices(epoch):
                        if stop.is_set():
                            return
                        if len(batch_idx) == 0:  # an eval pass's tail
                            continue
                        # SeedSequence keys (seed, rank, stream position),
                        # the JAX loader's
                        seeds = [int(np.random.SeedSequence(
                                     (self.seed, self.rank, counter + j)
                                     ).generate_state(1)[0])
                                 if self.shuffle else None
                                 for j in range(len(batch_idx))]
                        counter += len(batch_idx)
                        if to_skip > 0:
                            to_skip -= 1
                            continue
                        samples = list(pool.map(self._load, batch_idx,
                                                seeds))
                        put(self._collate(samples, seeds))
                    if not self.shuffle:
                        put(None)
                        return
                    epoch += 1

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, _Failure):
                    raise RuntimeError('the data loader failed') \
                        from batch.error
                yield self._deliver(batch)
        finally:
            stop.set()


def _load_only_view(dataset):
    """A shallow copy of ``dataset`` whose pipeline keeps only the loading
    transforms: the raw (img, gt) source of the batch augmentation
    backends. ``RepeatDataset`` and ``ConcatDataset`` are copied with a
    view of what they wrap."""
    from .dataset_wrappers import ConcatDataset, RepeatDataset
    from .pipelines import Compose
    view = copy.copy(dataset)
    if isinstance(dataset, RepeatDataset):
        view.dataset = _load_only_view(dataset.dataset)
        return view
    if isinstance(dataset, ConcatDataset):
        view.datasets = [_load_only_view(d) for d in dataset.datasets]
        return view
    loads = [t for t in dataset.pipeline.transforms
             if type(t).__name__ in ('LoadImageFromFile',
                                     'LoadAnnotations')]
    if len(loads) != 2:
        raise ValueError(
            "loader_backend='native'/'device' needs a train pipeline "
            'containing LoadImageFromFile + LoadAnnotations; got '
            f'{[type(t).__name__ for t in dataset.pipeline.transforms]}')
    view.pipeline = Compose(loads)
    return view


def _batch_seed(seeds):
    """The batch's seed: its first sample's, as in the JAX loaders."""
    return int(seeds[0]) if seeds and seeds[0] is not None else 0


def _layout(specs):
    """[(name, dtype, shape)] -> ([(name, dtype, shape, offset, bytes)],
    total bytes): the parts of one byte buffer, each 64-byte aligned."""
    parts, offset = [], 0
    for name, dtype, shape in specs:
        n = math.prod(shape) * dtype.itemsize
        parts.append((name, dtype, tuple(shape), offset, n))
        offset += -(-n // 64) * 64
    return parts, offset


def _views(buf, layout):
    """{name: typed view} of the flat uint8 tensor ``buf`` by ``layout``."""
    return {name: buf[off:off + n].view(dtype).view(shape)
            for name, dtype, shape, off, n in layout}


class _BatchAugLoader(DataLoader):
    """A loader whose samples are only decoded on the threads and whose
    batch is augmented as a whole; it yields ``{'img': (B, h, w, 3)
    float32, 'gt_semantic_seg': (B, h, w) int32}`` tensors on ``device``
    (default the card; without one it raises). Order, shards, seeds and
    ``start_batch`` are the host loader's.

    The producer packs everything a batch sends to the device into one
    host buffer, pinned where it goes to the card, and the consumer copies
    it there in one asynchronous copy: one pinned allocation a batch
    (which PyTorch's caching host allocator serves from the blocks of
    earlier batches once their copies are done) and one copy."""

    def __init__(self, dataset, device=None, **kwargs):
        super().__init__(_load_only_view(dataset), **kwargs)
        self.device = torch.device('cuda' if device is None else device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError(f'{type(self).__name__} augments for '
                               f'{self.device}, but there is no CUDA device')
        # a copy from pageable memory waits for the stream; one from
        # pinned memory does not
        self.pin = self.device.type == 'cuda'

    def _decode(self, idx):
        """Sample ``idx`` through the loading transforms alone (BGR)."""
        return getitem_with_rng(self.dataset, int(idx), None)

    def _packed(self, specs):
        """A fresh host buffer for ``specs`` ([(name, dtype, shape)]) ->
        (buffer, layout, {name: typed view})."""
        layout, nbytes = _layout(specs)
        buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.pin)
        return buf, layout, _views(buf, layout)

    def _deliver(self, batch):
        """The packed buffer on the device -> its typed views there."""
        buf, layout = batch
        return _views(buf.to(self.device, non_blocking=True), layout)


class NativeAugDataLoader(_BatchAugLoader):
    """``loader_backend='native'``: the threads decode, then one OpenMP
    call into the C++ core (:class:`..native.FastAugBatch`) augments the
    whole batch into the batch's pinned buffer (the GIL released
    meanwhile), which the consumer copies to the device. Deterministic by
    (seed, rank, position) on the core's own random stream, the JAX
    package's ``NativeAugDataLoader``'s: the same (batch seed, decoded
    samples) give bitwise the same batch in both packages."""

    def __init__(self, dataset, aug_cfg=None, **kwargs):
        from ..native import FastAugBatch
        super().__init__(dataset, **kwargs)
        self.aug = FastAugBatch(**(aug_cfg or {}))

    def _load(self, idx, sample_seed):
        res = self._decode(idx)
        return (np.ascontiguousarray(res['img'][..., ::-1]),  # -> RGB
                np.ascontiguousarray(res['gt_semantic_seg'], np.uint8))

    def _collate(self, samples, seeds):
        ch, cw = self.aug.crop_size
        b = len(samples)
        buf, layout, out = self._packed(
            [('img', torch.float32, (b, ch, cw, 3)),
             ('gt_semantic_seg', torch.int32, (b, ch, cw))])
        self.aug(samples, seed=_batch_seed(seeds),
                 out=(out['img'].numpy(), out['gt_semantic_seg'].numpy()))
        return buf, layout


class DeviceAugDataLoader(_BatchAugLoader):
    """``loader_backend='device'``: the threads decode and pad each sample
    onto a fixed canvas (:class:`..data.PrepareCanvas`), the producer
    draws the batch's random values from a ``torch.Generator`` seeded by
    the batch seed and packs them with the canvases into the batch's
    pinned buffer, and the consumer copies that to the device and augments
    it there (:meth:`..data.DeviceAugPipeline.apply`), on the train step's
    stream. ``aug_cfg`` takes the canvas's ``img_scale`` and ``canvas`` and
    the pipeline's arguments."""

    CANVAS_KEYS = ('img', 'gt_semantic_seg', 'valid_hw')

    def __init__(self, dataset, aug_cfg=None, **kwargs):
        from ..data import DeviceAugPipeline, PrepareCanvas
        super().__init__(dataset, **kwargs)
        aug_cfg = dict(aug_cfg or {})
        canvas_cfg = {k: aug_cfg.pop(k) for k in ('img_scale', 'canvas')
                      if k in aug_cfg}
        self.canvas = PrepareCanvas(**canvas_cfg)
        self.aug = DeviceAugPipeline(**aug_cfg)

    def _load(self, idx, sample_seed):
        return self.canvas(self._decode(idx))

    def _collate(self, samples, seeds):
        draws = self.aug.draw(torch.Generator().manual_seed(
            _batch_seed(seeds)), len(samples))
        first = samples[0]
        buf, layout, views = self._packed(
            [(k, torch.from_numpy(first[k]).dtype,
              (len(samples),) + first[k].shape) for k in self.CANVAS_KEYS]
            + [(k, v.dtype, v.shape) for k, v in draws.items()])
        for k in self.CANVAS_KEYS:
            stacked = views[k].numpy()
            for i, sample in enumerate(samples):
                stacked[i] = sample[k]
        for k, v in draws.items():
            views[k].copy_(v)
        return buf, layout

    def _deliver(self, batch):
        parts = super()._deliver(batch)
        img, gt = self.aug.apply(parts, *[parts[k]
                                          for k in self.CANVAS_KEYS])
        return {'img': img, 'gt_semantic_seg': gt}


LOADER_BACKENDS = {
    'host': DataLoader,
    'native': NativeAugDataLoader,
    'device': DeviceAugDataLoader,
}


def build_dataloader(dataset, samples_per_gpu, workers_per_gpu, shuffle=True,
                     seed=None, drop_last=True, loader_backend='host',
                     start_batch=0, process_index=None, process_count=None,
                     aug_cfg=None, device=None):
    """(ref builder.py:78-152). The loader yields the rank's
    ``samples_per_gpu`` samples of each global batch; the rank and the
    world size are the process group's (``parallel.get_dist_info``) unless
    given.

    ``loader_backend`` picks the augmentation engine
    (``LOADER_BACKENDS``): 'host' (the dataset's pipeline a sample, numpy
    batches), 'native' (the C++ core, built with g++ at first use) or
    'device' (on ``device``, default the card); the last two are train
    loaders (``shuffle=True``), take their recipe from ``aug_cfg`` and
    yield tensors on ``device``."""
    if loader_backend not in LOADER_BACKENDS:
        raise ValueError(f'unknown loader_backend {loader_backend!r}; '
                         f'choose from {sorted(LOADER_BACKENDS)}')
    if loader_backend != 'host' and not shuffle:
        raise ValueError('the native and device loader backends are '
                         'train-only (shuffle=True)')
    extra = {}
    if loader_backend != 'host':
        extra = dict(aug_cfg=aug_cfg, device=device)
    rank, world = get_dist_info()
    return LOADER_BACKENDS[loader_backend](
        dataset, samples_per_gpu=samples_per_gpu,
        num_workers=workers_per_gpu, shuffle=shuffle,
        seed=seed if seed is not None else 42,
        drop_last=drop_last and shuffle, start_batch=start_batch,
        process_index=rank if process_index is None else process_index,
        process_count=world if process_count is None else process_count,
        **extra)
