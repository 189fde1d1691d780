"""Evaluation loop, whole- or slide-mode per the model's ``test_cfg``
(counterpart of ``segdistill_tpu/apis/test.py``).

Per sample: logits at network resolution -> crop of any padding ->
bilinear resize to ``ori_shape`` -> softmax -> flip undone -> average over
views -> argmax. Everything up to the argmax runs on the model's device
(the JAX device path ``_jit_inference_to_ori`` does the same; its host path
resizes with cv2). Only the int64 label map comes back to the host.
"""

import numpy as np
import torch

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
def _predict_one(model, imgs, metas):
    """Test-time-augmented prediction of one sample -> (ori_h, ori_w)
    int64 label map (host numpy)."""
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
    return acc.argmax(dim=1)[0].cpu().numpy().astype(np.int64)


def single_device_test(model, dataset):
    """-> one label map per sample of ``dataset``, a sequence of pipeline
    outputs ({'img': ..., 'img_metas': ...}) (ref test.py:35-101)."""
    return [_predict_one(model, *_as_lists(dataset[i]))
            for i in range(len(dataset))]
