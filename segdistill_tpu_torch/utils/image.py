"""Host-side image ops with mmcv semantics, without OpenCV (counterpart of
``segdistill_tpu/utils/image.py``).

Files: :func:`imread` tells the format by the file's first bytes, as
OpenCV does: PNG goes through the port's own codec (``utils/png.py``:
numpy and zlib), ``.npy`` arrays through numpy, anything else (JPEG) through
OpenCV, imported only then. :func:`imwrite` writes PNG and ``.npy`` the
same way. So label maps, converted datasets and painted results need
neither OpenCV nor pillow.

Bilinear resizing runs torch ``F.interpolate`` (``antialias=False``,
align_corners=False: cv2's ``INTER_LINEAR``) on CPU tensors. cv2 computes
uint8 bilinear with 11-bit fixed-point weights while this rounds a float
result, so a uint8 pixel may differ from cv2's by one intensity level.
'nearest' gathers with cv2's ``INTER_NEAREST`` index rule, exactly. The
uint8 BGR <-> HSV conversions repeat OpenCV's arithmetic (its 12-bit
division tables one way, its float32 sector formula the other) in numpy;
see :func:`hsv2bgr` for how close. :func:`bgr2gray` and :func:`clahe`
repeat OpenCV's uint8 arithmetic exactly; :func:`imrotate` its float32
warp (see there for how close).
"""

import os.path as osp

import numpy as np
import torch
import torch.nn.functional as F

from . import png

_NPY_MAGIC = b'\x93NUMPY'
_FLAGS = ('color', 'grayscale', 'unchanged')


def imread(path, flag='color', backend=None):
    """Read an image: ``flag`` 'color' gives HWC BGR uint8, 'grayscale' HW,
    'unchanged' what the file holds (a label map stays single-channel), as
    OpenCV gives them. ``backend='pillow'`` with 'unchanged' reads a
    palette PNG's indices, as pillow does (OpenCV expands the palette to
    BGR); it changes nothing else. The format is told by the first bytes:
    PNG and ``.npy`` (returned as stored) need no OpenCV, other formats
    are decoded with OpenCV, imported only here."""
    if not osp.isfile(path):
        raise FileNotFoundError(f'img file does not exist: {path}')
    if flag not in _FLAGS:
        raise ValueError(flag)
    with open(path, 'rb') as f:
        head = f.read(len(png.SIGNATURE))
        f.seek(0)
        if head.startswith(_NPY_MAGIC):
            return np.load(f)
        data = f.read()
    if data.startswith(png.SIGNATURE):
        return png.decode_png(data, flag, indices=backend == 'pillow')
    import cv2
    img = cv2.imdecode(np.frombuffer(data, np.uint8),
                       {'color': cv2.IMREAD_COLOR,
                        'grayscale': cv2.IMREAD_GRAYSCALE,
                        'unchanged': cv2.IMREAD_UNCHANGED}[flag])
    if img is None:
        raise OSError(f'failed to decode image: {path}')
    return img


def imwrite(img, path, palette=None):
    """Write ``img`` to ``path`` by its suffix: ``.png`` with the port's
    encoder (gray uint8 / uint16, BGR, BGRA; with ``palette``, (n, 3) RGB,
    a palette image of indices), ``.npy`` with numpy, other formats with
    OpenCV, imported only then. -> True, as ``cv2.imwrite``."""
    suffix = osp.splitext(path)[1].lower()
    if suffix == '.png':
        data = png.encode_png(img, palette=palette)
        with open(path, 'wb') as f:
            f.write(data)
        return True
    if palette is not None:
        raise ValueError('a palette is written only to .png')
    if suffix == '.npy':
        np.save(path, np.asarray(img))
        return True
    import cv2
    return bool(cv2.imwrite(path, img))


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


# OpenCV 5's uint8 RGB -> gray weights of 1/2^15 (OpenCV 4 used 14 bits:
# 4899, 9617, 1868)
_R2Y, _G2Y, _B2Y = 9798, 19235, 3735
_GRAY_SHIFT = 15


def _to_gray(img, b, g, r, keepdim):
    img = np.asarray(img)
    x = [img[..., i] for i in (b, g, r)]
    if img.dtype == np.uint8:
        b_, g_, r_ = (c.astype(np.int32) for c in x)
        out = ((b_ * _B2Y + g_ * _G2Y + r_ * _R2Y
                + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT).astype(np.uint8)
    else:
        b_, g_, r_ = (c.astype(np.float32) for c in x)
        out = (b_ * np.float32(0.114) + g_ * np.float32(0.587)
               + r_ * np.float32(0.299)).astype(img.dtype)
    return out[..., None] if keepdim else out


def bgr2gray(img, keepdim=False):
    """BGR -> gray as ``cv2.COLOR_BGR2GRAY``: uint8 in OpenCV 5's 15-bit
    fixed point (exact), other types with the float weights 0.114, 0.587,
    0.299."""
    return _to_gray(img, 0, 1, 2, keepdim)


def rgb2gray(img, keepdim=False):
    """RGB -> gray as ``cv2.COLOR_RGB2GRAY`` (:func:`bgr2gray`'s
    arithmetic)."""
    return _to_gray(img, 2, 1, 0, keepdim)


def _fma32(a, b, c):
    """float32 a * b + c rounded once (a fused multiply-add): the float32
    product is exact in float64."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def rotation_matrix(center, angle, scale=1.0):
    """``cv2.getRotationMatrix2D``: (2, 3) float64, ``angle`` in degrees,
    counter-clockwise."""
    a = np.deg2rad(angle)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _inverse_affine(matrix):
    """OpenCV's inversion of a (2, 3) map in ``warpAffine``."""
    m = np.asarray(matrix, np.float64).ravel().copy()
    det = m[0] * m[4] - m[1] * m[3]
    det = 1.0 / det if det != 0 else 0.0
    a11, a22 = m[4] * det, m[0] * det
    m[0], m[1], m[3], m[4] = a11, m[1] * -det, m[3] * -det, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def warp_affine(img, matrix, size, interpolation='bilinear', border_value=0):
    """``cv2.warpAffine`` with ``BORDER_CONSTANT`` as OpenCV 4.11 and later
    compute it: the inverse map in float32, a row's source position
    ``fma(M0, x, float(y * M1 + M2))``, 'nearest' its rounded (half to
    even) position, 'bilinear' three float32 lerps (fused multiply-adds)
    of the four neighbours, a neighbour off the image ``border_value``
    (a number is OpenCV's ``Scalar(v)``: v in the first channel, 0 in the
    others), rounded half to even and saturated. ``size`` is (w, h)."""
    if interpolation not in ('bilinear', 'nearest'):
        raise ValueError(f'unsupported interpolation {interpolation!r}')
    img = np.asarray(img)
    w, h = size
    m = _inverse_affine(matrix).astype(np.float32)
    xs = np.arange(w, dtype=np.float32)[None]
    ys = np.arange(h, dtype=np.float32)[:, None]
    sx = _fma32(m[0], xs, ys * m[1] + m[2])
    sy = _fma32(m[3], xs, ys * m[4] + m[5])
    src_h, src_w = img.shape[:2]
    src = img.reshape(src_h, src_w, -1)
    # OpenCV's Scalar: a number fills the first channel, the rest are 0
    values = np.ravel(np.asarray(border_value, np.float64))[:src.shape[2]]
    cval = np.zeros(src.shape[2])
    cval[:len(values)] = values
    if interpolation == 'nearest':
        ix = np.rint(sx).astype(np.int64)
        iy = np.rint(sy).astype(np.int64)
        inside = (ix >= 0) & (ix < src_w) & (iy >= 0) & (iy < src_h)
        picked = src[np.clip(iy, 0, src_h - 1), np.clip(ix, 0, src_w - 1)]
        out = np.where(inside[..., None], picked, cval.astype(src.dtype))
        return out.reshape((h, w) + img.shape[2:])
    pad = np.empty((src_h + 2, src_w + 2, src.shape[2]), np.float32)
    pad[...] = cval.astype(np.float32)
    pad[1:-1, 1:-1] = src
    ix = np.floor(sx).astype(np.int64)
    iy = np.floor(sy).astype(np.int64)
    alpha = (sx - ix.astype(np.float32))[..., None]
    beta = (sy - iy.astype(np.float32))[..., None]
    rows0 = np.clip(iy + 1, 0, src_h + 1)
    rows1 = np.clip(iy + 2, 0, src_h + 1)
    cols0 = np.clip(ix + 1, 0, src_w + 1)
    cols1 = np.clip(ix + 2, 0, src_w + 1)
    p00, p01 = pad[rows0, cols0], pad[rows0, cols1]
    p10, p11 = pad[rows1, cols0], pad[rows1, cols1]
    top = _fma32(alpha, p01 - p00, p00)
    bottom = _fma32(alpha, p11 - p10, p10)
    out = np.rint(_fma32(beta, bottom - top, top))
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        out = np.clip(out, info.min, info.max)
    return out.astype(img.dtype).reshape((h, w) + img.shape[2:])


def imrotate(img, angle, center=None, scale=1.0, border_value=0,
             interpolation='bilinear', auto_bound=False):
    """Rotate by ``angle`` degrees clockwise about ``center`` (the image's
    by default), mmcv's ``imrotate``: :func:`rotation_matrix` of
    ``-angle``, with ``auto_bound`` the canvas grown to hold the whole
    rotated image, then :func:`warp_affine`. Against OpenCV 5.0's
    ``warpAffine`` 'nearest' is exact and 'bilinear' within one level (a
    value off by one where OpenCV's vector and scalar loops round a
    position differently)."""
    h, w = img.shape[:2]
    if center is None:
        center = ((w - 1) * 0.5, (h - 1) * 0.5)
    matrix = rotation_matrix(center, -angle, scale)
    if auto_bound:
        cos, sin = np.abs(matrix[0, 0]), np.abs(matrix[0, 1])
        new_w = h * sin + w * cos
        new_h = h * cos + w * sin
        matrix[0, 2] += (new_w - w) * 0.5
        matrix[1, 2] += (new_h - h) * 0.5
        w, h = int(np.round(new_w)), int(np.round(new_h))
    return warp_affine(img, matrix, (w, h), interpolation, border_value)


def clahe(img, clip_limit=40.0, tile_grid_size=(8, 8)):
    """Contrast-limited adaptive histogram equalisation of a uint8 gray
    image, OpenCV's ``createCLAHE(clip_limit, tile_grid_size).apply`` to
    the value: the image padded (``BORDER_REFLECT_101``, at the bottom and
    the right, unless both sides divide by the grid) to whole tiles, a
    histogram a tile clipped at ``max(int(clip_limit * area / 256), 1)``
    with the excess spread as a batch a bin plus a stepped residual, the
    cumulative histogram scaled by 255 / area (float32, rounded) as the
    tile's table, and every pixel interpolated bilinearly (float32)
    between the tables of its four nearest tiles."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape
    tiles_x, tiles_y = tile_grid_size
    ext = img
    if w % tiles_x or h % tiles_y:
        ext = np.pad(img, ((0, tiles_y - h % tiles_y),
                           (0, tiles_x - w % tiles_x)), mode='reflect')
    th, tw = ext.shape[0] // tiles_y, ext.shape[1] // tiles_x
    area = th * tw
    tiles = ext[:tiles_y * th, :tiles_x * tw].reshape(
        tiles_y, th, tiles_x, tw).transpose(0, 2, 1, 3).reshape(
        tiles_y * tiles_x, area)
    offsets = np.arange(tiles_y * tiles_x)[:, None] * 256
    hist = np.bincount((tiles + offsets).ravel(),
                       minlength=256 * tiles_y * tiles_x).reshape(-1, 256)
    if clip_limit > 0:
        limit = max(int(clip_limit * area / 256), 1)
        excess = np.maximum(hist - limit, 0).sum(1)
        hist = np.minimum(hist, limit) + (excess // 256)[:, None]
        for k, residual in enumerate(excess % 256):
            if residual:
                step = max(256 // int(residual), 1)
                hist[k, np.arange(0, 256, step)[:int(residual)]] += 1
    scale = np.float32(255) / np.float32(area)
    lut = np.clip(np.rint(np.cumsum(hist, 1).astype(np.float32) * scale),
                  0, 255).astype(np.uint8).reshape(tiles_y, tiles_x, 256)

    def axis(n, tile, tiles):
        pos = np.arange(n, dtype=np.float32) * (np.float32(1) / tile) \
            - np.float32(0.5)
        first = np.floor(pos).astype(np.int64)
        frac = pos - first.astype(np.float32)
        return (np.maximum(first, 0), np.minimum(first + 1, tiles - 1),
                frac, np.float32(1) - frac)

    y1, y2, ya, ya1 = axis(h, np.float32(th), tiles_y)
    x1, x2, xa, xa1 = axis(w, np.float32(tw), tiles_x)
    v = img.astype(np.int64)
    y1, y2 = y1[:, None], y2[:, None]
    ya, ya1 = ya[:, None], ya1[:, None]
    l11 = lut[y1, x1, v].astype(np.float32)
    l12 = lut[y1, x2, v].astype(np.float32)
    l21 = lut[y2, x1, v].astype(np.float32)
    l22 = lut[y2, x2, v].astype(np.float32)
    res = (l11 * xa1 + l12 * xa) * ya1 + (l21 * xa1 + l22 * xa) * ya
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)
