"""Evaluation loop, whole- or slide-mode per the model's ``test_cfg``
(counterpart of ``segdistill_tpu/apis/test.py``).

Per sample: logits at network resolution -> crop of any padding ->
bilinear resize to ``ori_shape`` -> softmax -> flip undone -> average over
views -> argmax. Everything up to the argmax runs on the model's device
(the JAX device path ``_jit_inference_to_ori`` does the same; its host path
resizes with cv2). Only the int64 label map comes back to the host, or,
from :func:`fast_evaluate`, four class histograms per image.

With ``batch_size`` above 1, :func:`single_device_test` buckets the
samples (the JAX ``_batched_test``): single-view samples by (network input
shape, valid crop, ``ori_shape``), and a bucket of at least
``DEVICE_RESIZE_MIN_GROUP`` runs in chunks of ``batch_size`` through one
forward each, the padding cropped, the logits resized to ``ori_shape``,
the argmax taken on the device and only the int label maps copied back;
one chunk is enqueued before the previous chunk's labels are read. The
rest take the per-image path.

With ``out_dir``, :func:`single_device_test` also writes each image with
its label map painted over it (``show_result``) as a PNG, as the
reference's ``single_gpu_test`` does; the JAX package takes the argument
and writes nothing.

Across processes rank r takes images r, r + world, ... (the JAX
package's ``multi_device_test``), and :func:`fast_evaluate` sums the ranks'
histograms with one all-reduce (the JAX package all-gathers them and
sums): every rank returns the metrics of the whole dataset.
"""

import contextlib
import os
import os.path as osp

import numpy as np
import torch
import torch.distributed as dist

from ..core.evaluation import (confusion_histograms, metrics_from_histograms,
                               prepare_label)
from ..ops import resize
from ..parallel import get_dist_info
from ..utils import image as imutil

# the smallest bucket that runs batched (the JAX package's default); a
# smaller one takes the per-image path
DEVICE_RESIZE_MIN_GROUP = 2


def _as_lists(data):
    imgs = data['img'] if isinstance(data['img'], list) else [data['img']]
    metas = data['img_metas'] if isinstance(data['img_metas'], list) \
        else [data['img_metas']]
    return imgs, metas


def image_to_device(img, device):
    """HWC float image -> (1, 3, H, W) float32 on ``device``."""
    x = torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32))
    return x.to(device, non_blocking=True).permute(2, 0, 1)[None]


@torch.no_grad()
def _predict_on_device(model, imgs, metas):
    """Test-time-augmented prediction of one sample -> (ori_h, ori_w)
    int64 label map on the model's device."""
    device = next(model.parameters()).device
    ori_hw = tuple(metas[0]['ori_shape'][:2])
    acc = None
    for img, meta in zip(imgs, metas):
        logits = model.inference_logits(image_to_device(img, device))
        h, w = meta['img_shape'][:2]
        logits = resize(logits[:, :, :h, :w], size=ori_hw, mode='bilinear',
                        align_corners=model.align_corners)
        probs = logits.float().softmax(dim=1)
        if meta.get('flip', False):
            horizontal = meta.get('flip_direction',
                                  'horizontal') == 'horizontal'
            probs = probs.flip(dims=(3,) if horizontal else (2,))
        acc = probs if acc is None else acc + probs
    return acc.argmax(dim=1)[0]


def _predict_one(model, imgs, metas):
    """:func:`_predict_on_device` -> int64 label map on the host."""
    return _predict_on_device(model, imgs, metas).cpu().numpy().astype(
        np.int64)


@contextlib.contextmanager
def _eval_mode(model):
    """Eval mode inside, the mode the model came in afterwards (an
    evaluation in the middle of training)."""
    was_training = model.training
    model.eval()
    try:
        yield
    finally:
        model.train(was_training)


def single_device_test(model, dataset, show=False, out_dir=None,
                       batch_size=1):
    """-> one label map per sample of ``dataset``: a ``CustomDataset`` in
    test mode or any sequence of pipeline outputs ({'img': ...,
    'img_metas': ...}) (ref test.py:35-101). With ``batch_size`` above 1
    the samples are bucketed by shape and batched (:func:`_batched_test`);
    the maps are the per-image ones but for argmax near-ties, which
    another batch size may break the other way. With ``out_dir`` every
    image is painted with its map (:func:`paint_result`) and written to
    ``<out_dir>/<image name>.png``. ``show`` is accepted for the
    reference's signature; no window is drawn."""
    palette = getattr(dataset, 'PALETTE', None)
    with _eval_mode(model):
        if batch_size > 1:
            loaded = [_as_lists(dataset[i]) for i in range(len(dataset))]
            results = _batched_test(model, loaded, batch_size)
            if out_dir:
                for i, (sample, result) in enumerate(zip(loaded, results)):
                    paint_result(model, *sample, result, out_dir, i, palette)
            return results
        results = []
        for i in range(len(dataset)):
            sample = _as_lists(dataset[i])
            results.append(_predict_one(model, *sample))
            if out_dir:
                paint_result(model, *sample, results[-1], out_dir, i,
                             palette)
        return results


def _input_image(img, meta):
    """The network input of a sample back as the uint8 BGR image it came
    from: normalisation undone, padding cropped, resized to ``ori_shape``
    (the reference's ``tensor2imgs`` and resize)."""
    img = np.asarray(img, np.float32)
    norm = meta.get('img_norm_cfg')
    if norm is not None:
        img = img * np.asarray(norm['std'], np.float32) \
            + np.asarray(norm['mean'], np.float32)
        if norm.get('to_rgb', False):
            img = img[..., ::-1]
    h, w = meta['img_shape'][:2]
    img = np.clip(np.rint(img[:h, :w]), 0, 255).astype(np.uint8)
    ori_h, ori_w = meta['ori_shape'][:2]
    return imutil.imresize(img, (ori_w, ori_h))


def paint_result(model, imgs, metas, result, out_dir, index=0,
                 palette=None):
    """Write the sample's first view with ``result`` painted over it
    (``model.show_result``) to ``<out_dir>/<ori_filename's stem>.png``
    (``<index>.png`` for a sample without a file name); -> the path."""
    name = metas[0].get('ori_filename') or f'{index:06d}'
    path = osp.join(out_dir, osp.splitext(name)[0] + '.png')
    os.makedirs(osp.dirname(path) or '.', exist_ok=True)
    painted = model.show_result(_input_image(imgs[0], metas[0]), result,
                                palette=palette)
    imutil.imwrite(painted, path)
    return path


def _bucket_key(imgs, metas):
    """A single-view, unflipped sample's bucket: (network input shape,
    valid crop, ori_shape); None for a test-time-augmented one."""
    if len(imgs) != 1 or metas[0].get('flip', False):
        return None
    return (tuple(np.shape(imgs[0])), tuple(metas[0]['img_shape'][:2]),
            tuple(metas[0]['ori_shape'][:2]))


@torch.no_grad()
def _labels_to_ori(model, batch, crop_hw, ori_hw):
    """(B, 3, H, W) -> (B, ori_h, ori_w) int32 label maps, on the device:
    logits, padding cropped, bilinear resize to ``ori_hw``, argmax."""
    h, w = crop_hw
    logits = model.inference_logits(batch)[:, :, :h, :w]
    logits = resize(logits, size=ori_hw, mode='bilinear',
                    align_corners=model.align_corners)
    return logits.argmax(dim=1).to(torch.int32)


def _batched_test(model, loaded, batch_size):
    """Shape-bucketed evaluation (the JAX ``_batched_test``) of the loaded
    samples ((views, metas) each): each bucket of at least
    ``DEVICE_RESIZE_MIN_GROUP`` single-view samples runs in chunks of
    ``batch_size``; the tail chunk is not padded to ``batch_size``.
    Test-time-augmented samples and singleton buckets take the per-image
    path (which also resizes on the device). A chunk's labels are copied
    into pinned memory without blocking, and read after the next chunk
    has been enqueued."""
    device = next(model.parameters()).device
    pin = device.type == 'cuda'
    buckets = {}
    for i, (imgs, metas) in enumerate(loaded):
        buckets.setdefault(_bucket_key(imgs, metas), []).append(i)
    results = [None] * len(loaded)
    pending = None  # (indices, host labels, event)

    def drain():
        chunk, labels, event = pending
        if event is not None:
            event.synchronize()
        for j, i in enumerate(chunk):
            results[i] = labels[j].numpy().astype(np.int64)

    for key, indices in buckets.items():
        if key is None or len(indices) < DEVICE_RESIZE_MIN_GROUP:
            for i in indices:
                results[i] = _predict_one(model, *loaded[i])
            continue
        _, crop_hw, ori_hw = key
        for start in range(0, len(indices), batch_size):
            chunk = indices[start:start + batch_size]
            host = torch.from_numpy(np.stack(
                [np.asarray(loaded[i][0][0], np.float32) for i in chunk]))
            if pin:
                host = host.pin_memory()
            batch = host.to(device, non_blocking=True).permute(0, 3, 1, 2)
            labels = _labels_to_ori(model, batch, crop_hw, ori_hw)
            out = torch.empty(labels.shape, dtype=labels.dtype,
                              pin_memory=pin)
            out.copy_(labels, non_blocking=True)
            event = None
            if pin:
                event = torch.cuda.Event()
                event.record()
            if pending is not None:
                drain()
            pending = (chunk, out, event)
    if pending is not None:
        drain()
    return results


def multi_device_test(model, dataset):
    """-> (indices, label maps) of this rank's share of ``dataset``:
    images rank, rank + world, ... (all of them in one process)."""
    rank, world = get_dist_info()
    indices = list(range(rank, len(dataset), world))
    with _eval_mode(model):
        return indices, [_predict_one(model, *_as_lists(dataset[i]))
                         for i in indices]


def fast_evaluate(model, dataset, metric='mIoU', ignore_index=255):
    """Histogram evaluation of ``model`` over a ``CustomDataset`` in test
    mode -> {'mIoU', 'mAcc', 'aAcc'} (or 'mDice' for ``metric='mDice'``).

    Each image of the rank's share (:func:`multi_device_test`'s) is
    predicted on the model's device and compared there with its label
    map: four C-long histograms per image come back, never a label map,
    and across processes the ranks' sums are summed by one all-reduce. The
    sums are exact integers, so the result equals
    ``dataset.evaluate(single_device_test(model, dataset))`` on every rank.
    The model is left in the mode it came in."""
    if metric not in ('mIoU', 'mDice'):
        raise KeyError(f'metric {metric} is not supported')
    num_classes = len(dataset.CLASSES)
    device = next(model.parameters()).device
    rank, world = get_dist_info()
    total = torch.zeros(4, num_classes, dtype=torch.int64, device=device)
    with _eval_mode(model):
        for idx, gt in enumerate(dataset.get_gt_seg_maps()):
            if idx % world != rank:
                continue
            pred = _predict_on_device(model, *_as_lists(dataset[idx]))
            label = torch.from_numpy(prepare_label(
                gt, dataset.label_map, dataset.reduce_zero_label,
                ignore_index)).to(device)
            total += torch.stack(confusion_histograms(
                pred, label, num_classes, ignore_index))
    if world > 1:
        dist.all_reduce(total)
    total = total.cpu().numpy().astype(np.float64)
    all_acc, acc, per_class = metrics_from_histograms(*total, (metric,))
    return {metric: float(np.nanmean(per_class)),
            'mAcc': float(np.nanmean(acc)), 'aAcc': float(all_acc)}
