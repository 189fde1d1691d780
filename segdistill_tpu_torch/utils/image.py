"""Host-side image ops with mmcv semantics, without OpenCV (counterpart of
``segdistill_tpu/utils/image.py``).

Resizing runs torch ``F.interpolate`` (``antialias=False``) on CPU tensors:
bilinear with align_corners=False is cv2's ``INTER_LINEAR`` and 'nearest'
its ``INTER_NEAREST``. cv2 computes uint8 bilinear with 11-bit fixed-point
weights while this rounds a float result, so a uint8 pixel may differ from
cv2's by one intensity level.
"""

import os.path as osp

import numpy as np
import torch
import torch.nn.functional as F


def imread(path):
    """Read an HWC BGR uint8 image. ``.npy`` arrays load with numpy; other
    formats are decoded with OpenCV, imported only here."""
    if not osp.isfile(path):
        raise FileNotFoundError(f'img file does not exist: {path}')
    if path.endswith('.npy'):
        return np.load(path)
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise OSError(f'failed to decode image: {path}')
    return img


def imresize(img, size, interpolation='bilinear'):
    """size is (w, h) -- the mmcv convention. Keeps the input's dtype."""
    arr = np.asarray(img)
    out_w, out_h = size
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if arr.ndim == 2:
        t = t[..., None]
    x = t.permute(2, 0, 1)[None]
    x = x.double() if arr.dtype == np.float64 else x.float()
    if interpolation == 'nearest':
        y = F.interpolate(x, size=(out_h, out_w), mode='nearest')
    elif interpolation == 'bilinear':
        y = F.interpolate(x, size=(out_h, out_w), mode='bilinear',
                          align_corners=False, antialias=False)
    else:
        raise ValueError(f'unsupported interpolation {interpolation!r}')
    y = y[0].permute(1, 2, 0).numpy()
    if np.issubdtype(arr.dtype, np.integer):
        info = np.iinfo(arr.dtype)
        y = np.clip(np.rint(y), info.min, info.max)
    y = y.astype(arr.dtype)
    if arr.ndim == 2:
        y = y[..., 0]
    return y


def rescale_size(old_size, scale):
    """Keep-ratio target size. ``scale``: a float factor or a (long,
    short) pair, order-insensitive (mmcv semantics)."""
    w, h = old_size
    if isinstance(scale, (float, int)):
        scale_factor = scale
    elif isinstance(scale, (tuple, list)):
        max_long, max_short = max(scale), min(scale)
        scale_factor = min(max_long / max(h, w), max_short / min(h, w))
    else:
        raise TypeError(f'invalid scale type {type(scale)}')
    return (int(w * scale_factor + 0.5), int(h * scale_factor + 0.5))


def imrescale(img, scale, interpolation='bilinear'):
    h, w = img.shape[:2]
    return imresize(img, rescale_size((w, h), scale),
                    interpolation=interpolation)


def imflip(img, direction='horizontal'):
    if direction == 'horizontal':
        return np.flip(img, axis=1)
    if direction == 'vertical':
        return np.flip(img, axis=0)
    raise ValueError(direction)


def imnormalize(img, mean, std, to_rgb=True):
    img = np.asarray(img).astype(np.float32)
    if to_rgb:
        img = img[..., ::-1]
    return (img - np.asarray(mean, np.float32)) \
        / np.asarray(std, np.float32)
