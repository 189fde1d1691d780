"""Dataset and pipeline registries, ``build_dataset`` and the host data
loader (counterpart of ``segdistill_tpu/datasets/builder.py``; reference
``mmseg/datasets/builder.py:21-169``).

The loader is a prefetching iterator: samples are read and augmented by a
thread pool (numpy and torch release the GIL in their kernels), and
collated numpy batches wait in a bounded queue for the train loop to move
to the device. The JAX package's native (C++) and on-device augmentation
loaders are not ported yet; ``loader_backend`` other than 'host' raises.
"""

import copy
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

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


class DataLoader:
    """Host prefetching loader with the JAX loader's epoch order and
    per-sample seeds: the same ``seed`` gives the same stream of samples
    in both packages (one process; sharding a batch over processes comes
    with multi-GPU training). ``start_batch`` skips that many batches of
    the stream without loading them, keeping their order and seeds: a run
    resumed at step n goes on with the batches an uninterrupted run would
    have seen (the JAX loader restarts its stream on resume).

    * train (``shuffle=True``): infinite stream; a fresh permutation per
      epoch (seeded by epoch).
    * eval: one sequential pass, ``drop_last=False``.
    """

    PREFETCH = 4    # collated batches waiting for the train loop

    def __init__(self, dataset, samples_per_gpu=1, num_workers=2,
                 shuffle=True, seed=42, drop_last=True, start_batch=0):
        self.dataset = dataset
        self.batch_size = samples_per_gpu
        self.num_workers = max(num_workers, 1)
        self.shuffle = shuffle
        self.seed = seed if seed is not None else 0
        self.drop_last = drop_last
        self.start_batch = int(start_batch)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self, epoch):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + epoch)
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        if self.drop_last:
            order = order[:n // self.batch_size * self.batch_size]
        return [order[i:i + self.batch_size]
                for i in range(0, len(order), self.batch_size)]

    def _load(self, idx, sample_seed):
        # one private RandomState per sample: deterministic by
        # (seed, position-in-stream) and safe under thread concurrency —
        # seeding the process-global numpy RNG from pool threads (the
        # reference's per-worker-process model, ref builder.py:155-169)
        # would race here
        rng = np.random.RandomState(sample_seed) \
            if sample_seed is not None else None
        return getitem_with_rng(self.dataset, int(idx), rng)

    def __iter__(self):
        # eager (non-generator) so the empty-epoch check raises at iter()
        # time, not at the first next()
        n = len(self.dataset)
        if self.drop_last and n < self.batch_size:
            # would yield ZERO batches per epoch — the producer would spin
            # through empty epochs forever while the consumer blocks
            raise ValueError(
                f'dataset has {n} samples but the batch is '
                f'{self.batch_size} with drop_last=True: no full batch can '
                f'ever be formed. Lower samples_per_gpu or grow the '
                f'dataset.')
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
            epoch = 0
            counter = 0
            to_skip = self.start_batch
            with ThreadPoolExecutor(self.num_workers) as pool:
                while not stop.is_set():
                    for batch_idx in self._epoch_indices(epoch):
                        if stop.is_set():
                            return
                        # SeedSequence keys (seed, rank, stream position),
                        # the JAX loader's key with its rank 0
                        seeds = [int(np.random.SeedSequence(
                                     (self.seed, 0, counter + j)
                                     ).generate_state(1)[0])
                                 if self.shuffle else None
                                 for j in range(len(batch_idx))]
                        counter += len(batch_idx)
                        if to_skip > 0:
                            to_skip -= 1
                            continue
                        samples = list(pool.map(self._load, batch_idx,
                                                seeds))
                        put(default_collate(samples))
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
                yield batch
        finally:
            stop.set()


def build_dataloader(dataset, samples_per_gpu, workers_per_gpu, shuffle=True,
                     seed=None, drop_last=True, loader_backend='host',
                     start_batch=0):
    """(ref builder.py:78-152). The loader yields ``samples_per_gpu``
    samples a batch (one device here). Only the 'host' backend is ported."""
    if loader_backend != 'host':
        raise NotImplementedError(
            f"loader_backend {loader_backend!r}: only the 'host' loader is "
            f'ported yet')
    return DataLoader(dataset, samples_per_gpu=samples_per_gpu,
                      num_workers=workers_per_gpu, shuffle=shuffle,
                      seed=seed if seed is not None else 42,
                      drop_last=drop_last and shuffle,
                      start_batch=start_batch)
