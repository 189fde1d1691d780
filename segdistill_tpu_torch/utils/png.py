"""A PNG codec on numpy, zlib and struct alone, so that label maps and
painted results can be read and written where neither OpenCV nor pillow is
installed.

:func:`decode_png` reads non-interlaced files of bit depth 8 and 16 (1, 2
and 4 too for gray and palette files) in colour types 0 (gray), 2 (RGB), 3
(palette), 4 (gray + alpha) and 6 (RGBA), and hands the pixels over as
OpenCV's ``imread`` does: 'color' gives 8-bit BGR (16-bit samples keep
their high byte, alpha is dropped, gray is repeated), 'grayscale' 8-bit
gray (colour through libpng's truncating 0.299 / 0.587 weights, as
OpenCV's PNG reader asks libpng for), 'unchanged' the file's own depth in
BGR / BGRA order, a palette expanded to BGR; ``indices=True`` gives a
palette file's indices instead, as pillow does. Sub-byte gray is scaled
to 0-255 as libpng expands it. A tRNS chunk is ignored.

:func:`encode_png` writes gray (8 or 16 bit), BGR, BGRA (stored as RGB and
RGBA, as OpenCV writes them) and, given a palette, palette images; every
row with filter type None.

Each row of a PNG is filtered against the row above and the pixel to its
left. Rows of filter None, Sub and Up are undone a row at a time in numpy.
In Average and Paeth rows a byte depends on the one to its left. A Paeth
row is a running sum except where the byte above differs from the one
above and to the left, and only those bytes are stepped through in
Python; Average rows step through every byte. Where that would cost more
(a photo, whose rows differ almost everywhere), the rest of those rows
are undone together along anti-diagonals of (row, pixel), which hold no
two cells that depend on each other: one numpy step a diagonal (rows +
width steps).
"""

import struct
import zlib

import numpy as np

SIGNATURE = b'\x89PNG\r\n\x1a\n'
# colour type -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# libpng's png_set_rgb_to_gray(png, 1, 0.299, 0.587) weights of 1/32768
# (each truncated from its 1e-5 fixed-point form)
_GRAY_R, _GRAY_G = 9797, 19234
_GRAY_B = 32768 - _GRAY_R - _GRAY_G


def _chunks(data):
    """Yield (type, payload) of every chunk, checking each CRC."""
    if data[:8] != SIGNATURE:
        raise ValueError('not a PNG file (no PNG signature)')
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack('>I', data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack('>I', data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + payload) & 0xffffffff != crc:
            raise OSError(f'corrupt PNG: bad CRC in chunk {kind!r}')
        yield kind, payload
        if kind == b'IEND':
            return
        pos += 12 + length
    raise OSError('truncated PNG: no IEND chunk')


def _paeth(a, b, c):
    bc, ac = b - c, a - c
    pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_diagonal(rows, kinds, prev, bpp):
    """Undo the filters (any of 0-4) of ``rows`` (n, stride) given the row
    above (``prev``), along anti-diagonals. Cell (r, u) is row r's pixel u
    (of ``bpp`` bytes); it needs (r, u - 1), (r - 1, u) and (r - 1, u - 1),
    which lie on the two diagonals before its own. A Sub, Up or None row is
    Paeth with b and c, a and c, or all three taken as 0."""
    n, stride = rows.shape
    units = stride // bpp
    # S[r + u + 1, r] holds cell (r - 1, u) (row 0: the row above; u = -1:
    # the zeros left of the image), so a diagonal is a contiguous row of S
    skew = np.zeros((n + units + 1, n + 1, bpp), np.int16)
    filt = np.zeros(skew.shape, np.uint8)

    def cells(arr):  # arr viewed as [row, unit + 1]
        e, r, b = arr.strides
        return np.lib.stride_tricks.as_strided(
            arr, (n + 1, units + 1, bpp), (e + r, e, b))

    cells(skew)[0, 1:] = prev.reshape(units, bpp)
    cells(filt)[1:, 1:] = rows.reshape(n, units, bpp)
    kind = np.r_[np.int16(0), kinds.astype(np.int16)][:, None]
    paeth_only = bool((kinds == 4).all())
    avg = kind == 3
    has_avg = bool(avg.any())
    ma, mb, mc = ((kind == 1) | (kind == 4), (kind == 2) | (kind == 4),
                  kind == 4)
    for e in range(2, n + units + 1):
        lo, hi = max(1, e - units), min(n, e - 1)
        a = skew[e - 1, lo:hi + 1]
        b = skew[e - 1, lo - 1:hi]
        c = skew[e - 2, lo - 1:hi]
        if paeth_only:
            pred = _paeth(a, b, c)
        else:
            rs = slice(lo, hi + 1)
            pred = _paeth(a * ma[rs], b * mb[rs], c * mc[rs])
            if has_avg:
                pred = np.where(avg[rs], (a + b) >> 1, pred)
        pred += filt[e, lo:hi + 1]
        skew[e, lo:hi + 1] = pred & 255
    return cells(skew)[1:, 1:].astype(np.uint8).reshape(n, stride)


def _paeth_row(row, prev, bpp):
    """Undo one Paeth row given the row above -> (the row, the bytes
    stepped through in Python). Where the byte above equals the one above
    and to the left (b == c) the predictor is the left byte, so between two
    bytes where they differ (few in a label map) the row is a running sum;
    only those bytes are stepped through."""
    f = row.reshape(-1, bpp)
    b = prev.reshape(-1, bpp)
    c = np.zeros_like(b)
    c[1:] = b[:-1]
    total = np.cumsum(f, axis=0, dtype=np.uint8)
    hit = b != c
    us, ks = np.nonzero(hit)  # in row order
    fs, bs, cs, ts = (arr[us, ks].tolist() for arr in (f, b, c, total))
    before = np.where(us > 0, total[us - 1, ks], 0).tolist()
    xs, last_x, last_t = [], [0] * bpp, [0] * bpp
    for i, k in enumerate(ks.tolist()):
        a = (last_x[k] + before[i] - last_t[k]) & 255
        bb, cc = bs[i], cs[i]
        pa, pb, pc = abs(bb - cc), abs(a - cc), abs(a + bb - 2 * cc)
        x = (fs[i] + (a if pa <= pb and pa <= pc else bb if pb <= pc
                      else cc)) & 255
        xs.append(x)
        last_x[k], last_t[k] = x, ts[i]
    at = np.zeros_like(f)
    at[us, ks] = xs
    # each byte: the last byte at or before it where b != c, and the sum
    start = np.maximum.accumulate(
        np.where(hit, np.arange(len(f))[:, None], -1), axis=0)
    since = np.maximum(start, 0)
    out = np.where(start >= 0, np.take_along_axis(at, since, 0)
                   - np.take_along_axis(total, since, 0) + total, total)
    return out.reshape(-1), len(xs)


def _unfilter_row(row, kind, prev, bpp):
    """Undo one row's filter given the row above -> (the row, the bytes
    stepped through in Python)."""
    if kind == 0:
        return row, 0
    if kind == 1:
        return np.cumsum(row.reshape(-1, bpp), axis=0,
                         dtype=np.uint8).reshape(-1), 0
    if kind == 2:
        return row + prev, 0
    if kind == 4:
        return _paeth_row(row, prev, bpp)
    out = bytearray(row.tobytes())
    up = prev.tolist()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + up[i]) >> 1)) & 255
    return np.frombuffer(out, np.uint8), len(out)


# one diagonal step costs about as much as this many bytes stepped through
# in Python
_DIAGONAL_BYTES = 64


def _unfilter(rows, kinds, bpp):
    """Undo the scanline filters of ``rows`` (H, stride) uint8. Average
    and Paeth rows go a row at a time while the bytes they step through in
    Python, extrapolated over the rest of them, cost less than the
    diagonals from here to the last of them; else those rows go along
    diagonals."""
    height, stride = rows.shape
    bad = np.flatnonzero(kinds > 4)
    if bad.size:
        raise OSError(f'corrupt PNG: filter type {kinds[bad[0]]} in row '
                      f'{bad[0]}')
    slow = np.flatnonzero(kinds >= 3)
    last = slow[-1] + 1 if slow.size else 0
    out = np.empty_like(rows)
    prev = np.zeros(stride, np.uint8)
    stepped = done = 0  # bytes stepped through, Average / Paeth rows undone
    i = 0
    while i < height:
        if kinds[i] >= 3:
            guess = stepped / max(done, 1) * (slow.size - done)
            if guess >= _DIAGONAL_BYTES * (last - i + stride // bpp):
                out[i:last] = _unfilter_diagonal(rows[i:last], kinds[i:last],
                                                 prev, bpp)
                prev, i = out[last - 1], last
                continue
        prev, steps = _unfilter_row(rows[i], kinds[i], prev, bpp)
        out[i] = prev
        done, stepped = done + (kinds[i] >= 3), stepped + steps
        i += 1
    return out


def _header(data):
    """-> (width, height, depth, colour type, palette or None, IDAT
    bytes)."""
    header, palette, idat = None, None, []
    for kind, payload in _chunks(data):
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', payload)
        elif kind == b'PLTE':
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b'IDAT':
            idat.append(payload)
    if header is None:
        raise OSError('corrupt PNG: no IHDR chunk')
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise ValueError(f'unsupported PNG: colour type {ctype} at bit '
                         f'depth {depth}')
    if interlace:
        raise ValueError('interlaced (Adam7) PNG files are not supported; '
                         'write the file without interlacing')
    if ctype == 3 and palette is None:
        raise OSError('corrupt PNG: a palette image without PLTE')
    return width, height, depth, ctype, palette, b''.join(idat)


def _samples(data):
    """-> (samples (H, W, channels) uint8 or uint16, colour type, depth,
    palette)."""
    width, height, depth, ctype, palette, idat = _header(data)
    channels = _CHANNELS[ctype]
    stride = (width * channels * depth + 7) // 8
    bpp = max(1, channels * depth // 8)
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    if raw.size < height * (stride + 1):
        raise OSError('truncated PNG: too little image data')
    raw = raw[:height * (stride + 1)].reshape(height, stride + 1)
    rows = _unfilter(raw[:, 1:], raw[:, 0], bpp)
    if depth == 16:
        px = rows.view('>u2').astype(np.uint16)
    elif depth == 8:
        px = rows
    else:
        bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        px = (bits * weights).sum(-1, dtype=np.uint8)
        if ctype == 0:  # libpng scales sub-byte gray to 0..255
            px = px * np.uint8(255 // ((1 << depth) - 1))
    return px[:, :width * channels].reshape(height, width, channels), \
        ctype, depth, palette


def _to_8bit(px):
    return (px >> 8).astype(np.uint8) if px.dtype == np.uint16 else px


def _rgb_to_gray(rgb):
    """libpng's truncating rgb_to_gray on 8-bit RGB; gray pixels stay."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    gray = (_GRAY_R * r + _GRAY_G * g + _GRAY_B * b) >> 15
    gray = np.where((r == g) & (r == b), r, gray)
    return gray.astype(np.uint8)


def decode_png(data, flag='color', indices=False):
    """PNG bytes -> an array as OpenCV's ``imread`` gives it under
    ``flag`` ('color', 'grayscale' or 'unchanged'); with ``indices`` a
    palette file under 'unchanged' gives its (H, W) uint8 indices."""
    px, ctype, depth, palette = _samples(data)
    if ctype == 3:
        if indices and flag == 'unchanged':
            return px[..., 0]
        px = palette[np.minimum(px[..., 0], len(palette) - 1)]
    if flag == 'unchanged':
        if px.shape[-1] == 1:
            return px[..., 0]
        if px.shape[-1] == 2:  # gray + alpha -> BGRA
            return np.ascontiguousarray(px[..., [0, 0, 0, 1]])
        order = [2, 1, 0] if px.shape[-1] == 3 else [2, 1, 0, 3]
        return np.ascontiguousarray(px[..., order])
    px = _to_8bit(px)
    colour = px.shape[-1] >= 3
    if flag == 'color':
        if colour:
            return np.ascontiguousarray(px[..., [2, 1, 0]])
        return np.ascontiguousarray(np.repeat(px[..., :1], 3, axis=-1))
    if flag == 'grayscale':
        return _rgb_to_gray(px[..., :3]) if colour else \
            np.ascontiguousarray(px[..., 0])
    raise ValueError(flag)


def _chunk(kind, payload):
    return (struct.pack('>I', len(payload)) + kind + payload
            + struct.pack('>I', zlib.crc32(kind + payload) & 0xffffffff))


def encode_png(img, palette=None):
    """An array -> PNG bytes: (H, W) or (H, W, 1) gray, (H, W, 3) BGR,
    (H, W, 4) BGRA, uint8 or uint16 (stored RGB / RGBA, big-endian, as
    OpenCV writes them); with ``palette`` ((n, 3) RGB, n <= 256) a uint8
    (H, W) array of indices is written as a palette image."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f'PNG holds uint8 or uint16 samples, not {img.dtype}')
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] not in
                                  (3, 4)):
        raise ValueError(f'cannot write an array of shape {img.shape} as '
                         f'PNG')
    height, width = img.shape[:2]
    chunks = []
    if palette is not None:
        palette = np.asarray(palette, np.uint8).reshape(-1, 3)
        if img.ndim != 2 or img.dtype != np.uint8 or len(palette) > 256:
            raise ValueError('a palette image is (H, W) uint8 indices and '
                             'at most 256 colours')
        if img.size and int(img.max()) >= len(palette):
            raise ValueError(f'index {int(img.max())} is past the palette '
                             f'of {len(palette)} colours')
        ctype, samples = 3, img
        chunks.append(_chunk(b'PLTE', palette.tobytes()))
    elif img.ndim == 2:
        ctype, samples = 0, img
    else:
        ctype = 2 if img.shape[2] == 3 else 6
        order = [2, 1, 0] if ctype == 2 else [2, 1, 0, 3]
        samples = img[..., order]
    depth = 16 if samples.dtype == np.uint16 else 8
    rows = np.ascontiguousarray(samples.astype('>u2') if depth == 16
                                else samples).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8),
                          rows.view(np.uint8)], axis=1)
    ihdr = struct.pack('>IIBBBBB', width, height, depth, ctype, 0, 0, 0)
    return (SIGNATURE + _chunk(b'IHDR', ihdr) + b''.join(chunks)
            + _chunk(b'IDAT', zlib.compress(raw.tobytes()))
            + _chunk(b'IEND', b''))
