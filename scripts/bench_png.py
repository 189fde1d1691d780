"""Milliseconds to decode a PNG: the port's codec (``utils/png.py``)
against OpenCV's and pillow's readers, on files that OpenCV and pillow
write:

    python scripts/bench_png.py [--repeats 5] [--seed 0]

The files are made from ``--seed``: a photo-like 1024x2048 BGR image (a
Cityscapes ``leftImg8bit`` frame's size; smooth colour with noise), written
by OpenCV with its default filter, by OpenCV with libpng's adaptive choice
of filter a row (``IMWRITE_PNG_ALL_FILTERS``) and by pillow (adaptive);
and label maps of 512x683 (ADE20K) and 1024x2048 (Cityscapes ``gtFine``),
irregular regions of class ids, written by pillow as 8-bit gray.

Each reader decodes the file's bytes from memory (the file read is not
timed) under the flag the loader uses ('color' for images, 'unchanged' for
labels): the port's ``decode_png``, ``cv2.imdecode`` and pillow's
``Image.open(...).convert`` / ``np.asarray``. One untimed call each, then
the median of ``--repeats``. One JSON line a file: its filter types (rows
of None, Sub, Up, Average, Paeth), its bytes, each reader's median ms and
the ratio of the port's to OpenCV's. Needs OpenCV and pillow, which the
port itself needs neither of to read PNG; so this script lies outside the
package.
"""

import argparse
import io
import json
import statistics
import sys
import time
import zlib
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from segdistill_tpu_torch.utils import png  # noqa: E402


def _photo(rng, h, w):
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 3)).astype(
        np.float32)
    img = cv2.resize(base, (w, h)) + rng.normal(0, 4, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _label(rng, h, w, classes):
    """Regions of the nearest of 60 seeds, at a quarter of the size and
    then repeated: staircase borders, as label maps hold."""
    qh, qw = -(-h // 4), -(-w // 4)
    seeds = rng.uniform(0, 1, (60, 2)) * (qh, qw)
    yy, xx = np.mgrid[0:qh, 0:qw]
    dist = ((yy[..., None] - seeds[:, 0]) ** 2
            + (xx[..., None] - seeds[:, 1]) ** 2)
    ids = rng.integers(0, classes, 60).astype(np.uint8)[dist.argmin(-1)]
    return np.repeat(np.repeat(ids, 4, 0), 4, 1)[:h, :w]


def _files(seed):
    rng = np.random.default_rng(seed)
    photo = _photo(rng, 1024, 2048)
    out = []
    for name, params in (('image_cv2_default', []),
                         ('image_cv2_adaptive',
                          [cv2.IMWRITE_PNG_FILTER,
                           cv2.IMWRITE_PNG_ALL_FILTERS])):
        ok, buf = cv2.imencode('.png', photo, params)
        assert ok
        out.append((name, buf.tobytes(), 'color'))
    for name, arr in (('image_pillow', photo[..., ::-1]),
                      ('label_ade_pillow', _label(rng, 512, 683, 150)),
                      ('label_cityscapes_pillow',
                       _label(rng, 1024, 2048, 19))):
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(arr)).save(buf, format='PNG')
        out.append((name, buf.getvalue(),
                    'color' if arr.ndim == 3 else 'unchanged'))
    return out


def _filters(data):
    width, height, depth, ctype, _, idat = png._header(data)
    stride = (width * png._CHANNELS[ctype] * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return np.bincount(raw.reshape(height, stride + 1)[:, 0],
                       minlength=5).tolist()


def _median_ms(fn, repeats):
    fn()
    times = []
    for _ in range(repeats):
        start = time.perf_counter()
        fn()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--repeats', type=int, default=5)
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args(argv)
    cv_flags = {'color': cv2.IMREAD_COLOR, 'unchanged': cv2.IMREAD_UNCHANGED}
    for name, data, flag in _files(args.seed):
        ours = png.decode_png(data, flag)
        buf = np.frombuffer(data, np.uint8)
        assert np.array_equal(ours, cv2.imdecode(buf, cv_flags[flag])), name
        pil_mode = 'RGB' if flag == 'color' else None

        def pil():
            im = Image.open(io.BytesIO(data))
            return np.asarray(im.convert(pil_mode) if pil_mode else im)

        line = dict(file=name, filters=_filters(data), bytes=len(data),
                    shape=list(ours.shape))
        line['port_ms'] = _median_ms(lambda: png.decode_png(data, flag),
                                     args.repeats)
        line['cv2_ms'] = _median_ms(
            lambda: cv2.imdecode(buf, cv_flags[flag]), args.repeats)
        line['pillow_ms'] = _median_ms(pil, args.repeats)
        line['port_over_cv2'] = line['port_ms'] / line['cv2_ms']
        print(json.dumps(line), flush=True)


if __name__ == '__main__':
    main()
