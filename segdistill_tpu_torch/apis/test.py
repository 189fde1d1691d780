"""Evaluation loop, whole- or slide-mode per the model's ``test_cfg``
(counterpart of ``segdistill_tpu/apis/test.py``).

Per sample: logits at network resolution -> crop of any padding ->
bilinear resize to ``ori_shape`` -> softmax -> flip undone -> average over
views -> argmax. Everything up to the argmax runs on the model's device
(the JAX device path ``_jit_inference_to_ori`` does the same; its host path
resizes with cv2). Only the int64 label map comes back to the host, or,
from :func:`fast_evaluate`, four class histograms per image.
"""

import contextlib

import numpy as np
import torch

from ..core.evaluation import (confusion_histograms, metrics_from_histograms,
                               prepare_label)
from ..ops import resize


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


def single_device_test(model, dataset):
    """-> one label map per sample of ``dataset``: a ``CustomDataset`` in
    test mode or any sequence of pipeline outputs ({'img': ...,
    'img_metas': ...}) (ref test.py:35-101)."""
    with _eval_mode(model):
        return [_predict_one(model, *_as_lists(dataset[i]))
                for i in range(len(dataset))]


def fast_evaluate(model, dataset, metric='mIoU', ignore_index=255):
    """Histogram evaluation of ``model`` over a ``CustomDataset`` in test
    mode -> {'mIoU', 'mAcc', 'aAcc'} (or 'mDice' for ``metric='mDice'``).

    Each image is predicted on the model's device and compared there with
    its label map: four C-long histograms per image come back, never a
    label map. The sums are exact integers, so the result equals
    ``dataset.evaluate(single_device_test(model, dataset))``. The model is
    left in the mode it came in."""
    if metric not in ('mIoU', 'mDice'):
        raise KeyError(f'metric {metric} is not supported')
    num_classes = len(dataset.CLASSES)
    device = next(model.parameters()).device
    total = torch.zeros(4, num_classes, dtype=torch.int64, device=device)
    with _eval_mode(model):
        for idx, gt in enumerate(dataset.get_gt_seg_maps()):
            pred = _predict_on_device(model, *_as_lists(dataset[idx]))
            label = torch.from_numpy(prepare_label(
                gt, dataset.label_map, dataset.reduce_zero_label,
                ignore_index)).to(device)
            total += torch.stack(confusion_histograms(
                pred, label, num_classes, ignore_index))
    total = total.cpu().numpy().astype(np.float64)
    all_acc, acc, per_class = metrics_from_histograms(*total, (metric,))
    return {metric: float(np.nanmean(per_class)),
            'mAcc': float(np.nanmean(acc)), 'aAcc': float(all_acc)}
