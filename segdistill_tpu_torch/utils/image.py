"""Host-side image ops with mmcv semantics, without OpenCV (counterpart of
``segdistill_tpu/utils/image.py``).

Bilinear resizing runs torch ``F.interpolate`` (``antialias=False``,
align_corners=False: cv2's ``INTER_LINEAR``) on CPU tensors. cv2 computes
uint8 bilinear with 11-bit fixed-point weights while this rounds a float
result, so a uint8 pixel may differ from cv2's by one intensity level.
'nearest' gathers with cv2's ``INTER_NEAREST`` index rule, exactly. The
uint8 BGR <-> HSV conversions repeat OpenCV's arithmetic (its 12-bit
division tables one way, its float32 sector formula the other) in numpy;
see :func:`hsv2bgr` for how close.
"""

import os.path as osp

import numpy as np
import torch
import torch.nn.functional as F


def imread(path, flag='color'):
    """Read an image: ``flag`` 'color' gives HWC BGR uint8, 'grayscale' HW,
    'unchanged' what the file holds (a label map stays single-channel).
    ``.npy`` arrays load with numpy alone, as stored; other formats are
    decoded with OpenCV, imported only here."""
    if not osp.isfile(path):
        raise FileNotFoundError(f'img file does not exist: {path}')
    if flag not in ('color', 'grayscale', 'unchanged'):
        raise ValueError(flag)
    if path.endswith('.npy'):
        return np.load(path)
    import cv2
    img = cv2.imread(path, {'color': cv2.IMREAD_COLOR,
                            'grayscale': cv2.IMREAD_GRAYSCALE,
                            'unchanged': cv2.IMREAD_UNCHANGED}[flag])
    if img is None:
        raise OSError(f'failed to decode image: {path}')
    return img


def _nearest_index(n_in, n_out):
    """Source index of each output index under OpenCV's ``INTER_NEAREST``:
    floor(dst * (1 / (n_out / n_in))) in double precision."""
    inv = 1.0 / (float(n_out) / float(n_in))
    return np.minimum(np.floor(np.arange(n_out) * inv).astype(np.int64),
                      n_in - 1)


def imresize(img, size, interpolation='bilinear'):
    """size is (w, h) -- the mmcv convention. Keeps the input's dtype.
    'nearest' picks OpenCV's source pixels exactly (label maps). A resize
    to the image's own size is a copy (both interpolations are the
    identity there, exactly)."""
    arr = np.asarray(img)
    out_w, out_h = size
    if interpolation not in ('bilinear', 'nearest'):
        raise ValueError(f'unsupported interpolation {interpolation!r}')
    if (out_h, out_w) == arr.shape[:2]:
        return arr.copy()
    if interpolation == 'nearest':
        rows = _nearest_index(arr.shape[0], out_h)
        cols = _nearest_index(arr.shape[1], out_w)
        return np.ascontiguousarray(arr[rows[:, None], cols[None, :]])
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if arr.ndim == 2:
        t = t[..., None]
    x = t.permute(2, 0, 1)[None]
    x = x.double() if arr.dtype == np.float64 else x.float()
    y = F.interpolate(x, size=(out_h, out_w), mode='bilinear',
                      align_corners=False, antialias=False)
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


def impad(img, shape, pad_val=0):
    """Pad to ``shape`` (h, w) at the bottom and the right (mmcv's
    ``impad``); an image already that large is returned as it is."""
    pad_h = max(shape[0] - img.shape[0], 0)
    pad_w = max(shape[1] - img.shape[1], 0)
    if pad_h == 0 and pad_w == 0:
        return img
    width = ((0, pad_h), (0, pad_w)) + ((0, 0),) * (img.ndim - 2)
    return np.pad(img, width, mode='constant', constant_values=pad_val)


def impad_to_multiple(img, divisor, pad_val=0):
    pad_h = int(np.ceil(img.shape[0] / divisor)) * divisor
    pad_w = int(np.ceil(img.shape[1] / divisor)) * divisor
    return impad(img, (pad_h, pad_w), pad_val=pad_val)


_HSV_SHIFT = 12
_SDIV = np.zeros(256, np.int64)
_HDIV = np.zeros(256, np.int64)
_SDIV[1:] = np.rint((255 << _HSV_SHIFT) / np.arange(1, 256, dtype=np.float64))
_HDIV[1:] = np.rint((180 << _HSV_SHIFT)
                    / (6.0 * np.arange(1, 256, dtype=np.float64)))


def bgr2hsv(img):
    """uint8 BGR -> uint8 HSV with H in [0, 180), as OpenCV's
    ``COLOR_BGR2HSV`` computes it for 8-bit images (integer arithmetic
    with 12-bit fixed-point division tables)."""
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


# which of (v, p, q, t) each of b, g, r takes in the six hue sectors
_SECTOR = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                    [2, 1, 0]])


def hsv2bgr(img):
    """uint8 HSV (H in [0, 180)) -> uint8 BGR, as OpenCV's
    ``COLOR_HSV2BGR`` computes it for 8-bit images: the float32 sector
    formula, scaled by 255 and truncated as OpenCV 5 does (OpenCV 4 rounds
    to nearest there, so against it a value may sit one level lower).
    Against OpenCV 5.0 about 2 values in 10^4 differ, by one level, where
    the float32 product lands within an ulp of an integer."""
    h = img[..., 0].astype(np.float32) * np.float32(6.0 / 180.0)
    s = img[..., 1].astype(np.float32) * np.float32(1.0 / 255.0)
    v = img[..., 2].astype(np.float32) * np.float32(1.0 / 255.0)
    h = np.where(h >= 6.0, h - np.float32(6.0), h)
    sector = np.floor(h).astype(np.int64)
    f = h - sector.astype(np.float32)
    one = np.float32(1.0)
    tab = np.stack([v, v * (one - s), v * (one - s * f),
                    v * (one - s * (one - f))], axis=-1)
    idx = _SECTOR[np.clip(sector, 0, 5)]
    bgr = np.take_along_axis(tab, idx, axis=-1)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr)
    return np.clip(np.floor(bgr * np.float32(255.0)), 0, 255).astype(np.uint8)
