"""Segmentation metrics (counterpart of
``segdistill_tpu/core/evaluation/metrics.py``; reference
``mmseg/core/evaluation/metrics.py:5-229``): the numpy host path, including
the ``label_map`` remap and ``reduce_zero_label``, and
:func:`confusion_histograms`, the same four class histograms of one image
as a torch histogram on the prediction's device, so that an evaluation
brings 4 x C integers per image back to the host and not a label map."""

import numpy as np
import torch


def intersect_and_union(pred_label, label, num_classes, ignore_index,
                        label_map=None, reduce_zero_label=False):
    """Per-image (intersect, union, pred, label) class areas
    (ref metrics.py:5-59)."""
    if isinstance(pred_label, str):
        pred_label = np.load(pred_label)
    pred_label = np.asarray(pred_label)
    label = np.asarray(label)

    if label_map:
        label = label.copy()
        for old_id, new_id in label_map.items():
            label[label == old_id] = new_id
    if reduce_zero_label:
        label = label.astype(np.int64)
        label[label == 0] = 255
        label = label - 1
        label[label == 254] = 255

    mask = label != ignore_index
    pred_label = pred_label[mask]
    label = label[mask]

    intersect = pred_label[pred_label == label]
    area_intersect = np.bincount(intersect, minlength=num_classes)[
        :num_classes].astype(np.float64)
    area_pred = np.bincount(pred_label, minlength=num_classes)[
        :num_classes].astype(np.float64)
    area_label = np.bincount(label, minlength=num_classes)[
        :num_classes].astype(np.float64)
    area_union = area_pred + area_label - area_intersect
    return area_intersect, area_union, area_pred, area_label


def total_intersect_and_union(results, gt_seg_maps, num_classes,
                              ignore_index, label_map=None,
                              reduce_zero_label=False):
    """Class areas summed over a result list (ref metrics.py:62-102)."""
    total = [np.zeros(num_classes, np.float64) for _ in range(4)]
    for result, gt in zip(results, gt_seg_maps):
        quad = intersect_and_union(result, gt, num_classes, ignore_index,
                                   label_map, reduce_zero_label)
        for t, q in zip(total, quad):
            t += q
    return tuple(total)


def metrics_from_histograms(total_intersect, total_union, total_pred,
                            total_label, metrics=('mIoU',), nan_to_num=None):
    """-> [all_acc, per-class acc, per-class IoU and/or Dice]."""
    with np.errstate(divide='ignore', invalid='ignore'):
        all_acc = total_intersect.sum() / total_label.sum()
        acc = total_intersect / total_label
        ret = [all_acc, acc]
        for metric in metrics:
            if metric == 'mIoU':
                ret.append(total_intersect / total_union)
            elif metric == 'mDice':
                ret.append(2 * total_intersect / (total_pred + total_label))
    if nan_to_num is not None:
        ret = [np.nan_to_num(r, nan=nan_to_num) for r in ret]
    return ret


def eval_metrics(results, gt_seg_maps, num_classes, ignore_index,
                 metrics='mIoU', nan_to_num=None, label_map=None,
                 reduce_zero_label=False):
    """-> (all_acc, acc, iou and/or dice) per class (ref metrics.py:179-229).
    """
    if isinstance(metrics, str):
        metrics = [metrics]
    if not set(metrics).issubset({'mIoU', 'mDice'}):
        raise KeyError(f'metrics {metrics} is not supported')
    totals = total_intersect_and_union(results, gt_seg_maps, num_classes,
                                       ignore_index, label_map,
                                       reduce_zero_label)
    return metrics_from_histograms(*totals, metrics, nan_to_num)


def mean_iou(results, gt_seg_maps, num_classes, ignore_index,
             nan_to_num=None, label_map=None, reduce_zero_label=False):
    """(ref metrics.py:105-140)."""
    return eval_metrics(results, gt_seg_maps, num_classes, ignore_index,
                        'mIoU', nan_to_num, label_map, reduce_zero_label)


def mean_dice(results, gt_seg_maps, num_classes, ignore_index,
              nan_to_num=None, label_map=None, reduce_zero_label=False):
    """(ref metrics.py:142-176)."""
    return eval_metrics(results, gt_seg_maps, num_classes, ignore_index,
                        'mDice', nan_to_num, label_map, reduce_zero_label)


def prepare_label(label, label_map=None, reduce_zero_label=False,
                  ignore_index=255):
    """The ``label_map`` remap and ``reduce_zero_label`` shift of
    :func:`intersect_and_union`, as an int64 numpy array."""
    label = np.asarray(label).astype(np.int64)
    if label_map:
        for old_id, new_id in label_map.items():
            label[label == old_id] = new_id
    if reduce_zero_label:
        label[label == 0] = 255
        label = label - 1
        label[label == 254] = 255
    return label


def confusion_histograms(pred, label, num_classes, ignore_index=255):
    """(intersect, union, pred, label) class histograms of integer tensors
    ``pred`` and ``label`` of one shape, each (num_classes,) int64 on their
    device; pixels whose label is ``ignore_index`` count nowhere."""
    pred = pred.reshape(-1).long()
    label = label.reshape(-1).long()
    valid = label != ignore_index
    # ignored pixels, and classes past the range, land in one spare bin
    spare = torch.full_like(label, num_classes)
    in_range = (label >= 0) & (label < num_classes)
    safe_label = torch.where(valid & in_range, label, spare)
    safe_pred = torch.where(valid & (pred >= 0) & (pred < num_classes),
                            pred, spare)
    agree = valid & (pred == label)
    area_label = torch.bincount(safe_label,
                                minlength=num_classes + 1)[:num_classes]
    area_pred = torch.bincount(safe_pred,
                               minlength=num_classes + 1)[:num_classes]
    area_intersect = torch.bincount(torch.where(agree, safe_label, spare),
                                    minlength=num_classes + 1)[:num_classes]
    area_union = area_pred + area_label - area_intersect
    return area_intersect, area_union, area_pred, area_label
