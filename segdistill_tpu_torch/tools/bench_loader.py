"""Images per second of the three train loader backends on one recipe:

    python -m segdistill_tpu_torch.tools.bench_loader [--backends host
        native device] [--num-images 64] [--batch 8] [--batches 50]
        [--repeats 2] [--workers 6] [--device cuda]

(the counterpart of the JAX package's ``tools/bench_loader.py`` and
``tools/benchmark_loader.py``). A seeded ADE-like dataset of ``.npy``
files (uint8 BGR images of a few sizes around 512x683, label maps of
0..150 in blocks of ~64 px, 0 unlabelled) is written to a temporary
directory, and each backend runs through ``build_dataloader`` with the
ADE20K recipe: Resize to (2048, 512) at ratio 0.5-2.0, a 512x512 crop at
``cat_max_ratio`` 0.75, flip, PhotoMetricDistortion, Normalize and Pad
('host': the dataset's pipeline a sample; 'native': the C++ core;
'device': the canvas on the threads and the augmentation on ``--device``).

Each backend's batches are timed until they lie on ``--device`` (the
host loader's numpy batches are copied there, as the train loop copies
them). The clock starts after ``DataLoader.PREFETCH + 1`` batches of
warm-up: the first batch pays the device's start (CUDA's lazy module
loading), and the producer may meanwhile fill the prefetch queue, which
those batches drain. It stops after ``--batches`` more, the device
synchronised. The backends run in turn, ``--repeats`` rounds of each in
the order given. One JSON line a run: the round, images/s, images,
seconds, batches, batch size, workers, the device and, on a card, its
name and power limit. Without a card and without ``--device cpu`` it exits
with an error.
"""

import argparse
import json
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..datasets import LOADER_BACKENDS, build_dataloader, build_dataset

IMAGE_HW = [(512, 683), (683, 512), (480, 640), (512, 512)]
NUM_CLASSES = 150
CROP = (512, 512)
IMG_SCALE = (2048, 512)
RATIO_RANGE = (0.5, 2.0)
CAT_MAX_RATIO = 0.75
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)


def write_dataset(root, n, seed=11, shapes=IMAGE_HW, split=''):
    """``n`` seeded ADE-like ``.npy`` pairs under ``root``/{img,ann}/
    ``split``, of ``shapes`` in turn, and the class names in
    ``root``/classes.txt."""
    rng = np.random.RandomState(seed)
    root = Path(root)
    for sub in ('img', 'ann'):
        (root / sub / split).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        blocks = rng.randint(0, NUM_CLASSES + 1, (-(-h // 64), -(-w // 64)))
        ann = np.kron(blocks, np.ones((64, 64), np.int64))[:h, :w]
        img = (rng.randint(0, 256, (h, w, 3)) + ann[..., None] * [1, 2, 3]) \
            % 256
        name = f's{i:03d}.npy'
        np.save(root / 'img' / split / name, img.astype(np.uint8))
        np.save(root / 'ann' / split / name, ann.astype(np.uint8))
    (root / 'classes.txt').write_text(
        '\n'.join(f'class{i}' for i in range(NUM_CLASSES)) + '\n')


def train_pipeline(crop=CROP, img_scale=IMG_SCALE):
    return [
        dict(type='LoadImageFromFile'),
        dict(type='LoadAnnotations', reduce_zero_label=True),
        dict(type='Resize', img_scale=img_scale, ratio_range=RATIO_RANGE),
        dict(type='RandomCrop', crop_size=crop, cat_max_ratio=CAT_MAX_RATIO),
        dict(type='RandomFlip', prob=0.5),
        dict(type='PhotoMetricDistortion'),
        dict(type='Normalize', **NORM),
        dict(type='Pad', size=crop, pad_val=0, seg_pad_val=255),
        dict(type='DefaultFormatBundle'),
        dict(type='Collect', keys=['img', 'gt_semantic_seg']),
    ]


def aug_cfg(backend, crop=CROP, img_scale=IMG_SCALE):
    """The recipe above as the native and device backends take it; the
    device canvas is the ratio-1.0 bound, (h, w) = (512, 2048) for
    ADE20K."""
    cfg = dict(crop_size=crop, img_scale=img_scale, ratio_range=RATIO_RANGE,
               cat_max_ratio=CAT_MAX_RATIO)
    if backend == 'device':
        cfg['canvas'] = (min(img_scale), max(img_scale))
    return cfg


def build(root, backend, batch, workers, device, crop=CROP,
          img_scale=IMG_SCALE):
    dataset = build_dataset(dict(
        type='CustomDataset', data_root=str(root), img_dir='img',
        ann_dir='ann', img_suffix='.npy', seg_map_suffix='.npy',
        reduce_zero_label=True, classes=str(Path(root) / 'classes.txt'),
        pipeline=train_pipeline(crop, img_scale)))
    kwargs = {}
    if backend != 'host':
        kwargs = dict(aug_cfg=aug_cfg(backend, crop, img_scale),
                      device=device)
    return build_dataloader(dataset, batch, workers, shuffle=True, seed=3,
                            loader_backend=backend, process_index=0,
                            process_count=1, **kwargs)


def run_backend(loader, batches, device):
    """-> (images, seconds) of ``batches`` batches after
    ``loader.PREFETCH + 1`` of warm-up, each on ``device`` when the clock
    stops."""
    def on_device(batch):
        return [torch.as_tensor(batch[k]).to(device, non_blocking=True)
                for k in ('img', 'gt_semantic_seg')]

    def fence():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    it = iter(loader)
    try:
        for _ in range(loader.PREFETCH + 1):
            on_device(next(it))
        fence()
        t0 = time.perf_counter()
        n = 0
        for _ in range(batches):
            n += on_device(next(it))[0].shape[0]
        fence()
        return n, time.perf_counter() - t0
    finally:
        it.close()


def card():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--backends', nargs='+', default=list(
        LOADER_BACKENDS), choices=list(LOADER_BACKENDS))
    parser.add_argument('--num-images', type=int, default=64)
    parser.add_argument('--batch', type=int, default=8)
    parser.add_argument('--batches', type=int, default=50,
                        help='timed batches a run, after the warm-up')
    parser.add_argument('--repeats', type=int, default=2,
                        help='rounds of the backends in turn')
    parser.add_argument('--workers', type=int, default=6)
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--crop', type=int, default=CROP[0],
                        help='the square crop (512 for ADE20K)')
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise SystemExit('bench_loader: no CUDA device (pass --device cpu '
                         'to run on the host)')
    name = card() if device.type == 'cuda' else 'cpu'
    crop = (args.crop, args.crop)
    # the ADE20K bound scaled with the crop: (2048, 512) at 512
    img_scale = (IMG_SCALE[0] * args.crop // CROP[0],
                 IMG_SCALE[1] * args.crop // CROP[0])
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_dataset(root, args.num_images)
        written = time.perf_counter() - t0
        out = []
        for repeat in range(args.repeats):
            for backend in args.backends:
                loader = build(root, backend, args.batch, args.workers,
                               device, crop, img_scale)
                n, seconds = run_backend(loader, args.batches, device)
                line = dict(backend=backend, repeat=repeat,
                            images_per_s=n / seconds, images=n,
                            seconds=seconds, batches=args.batches,
                            batch=args.batch, workers=args.workers,
                            crop=list(crop), device=str(device), card=name,
                            dataset_seconds=written)
                print(json.dumps(line), flush=True)
                out.append(line)
    return out


if __name__ == '__main__':
    main()
