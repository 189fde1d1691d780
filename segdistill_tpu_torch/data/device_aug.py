"""Train-time augmentation of a whole batch on the card (counterpart of
``segdistill_tpu/data/device_aug.py``).

The host pipeline runs its geometric and photometric chain per sample in
Python threads. Here the work is split in two:

* host, per sample (:class:`PrepareCanvas`): keep-ratio rescale to the
  ratio-1.0 bound ((2048, 512) for ADE20K) and padding onto a fixed
  canvas, with the port's ``utils/image.py`` (no cv2);
* device, per batch (:class:`DeviceAugPipeline`): a random scale per
  sample, the crop with the reference's 10-candidate ``cat_max_ratio``
  rejection (ref transforms.py:768-777), a horizontal flip,
  PhotoMetricDistortion in float on cv2's uint8 HSV convention (H in
  [0, 180)), then normalisation.

:meth:`DeviceAugPipeline.draw` takes every random value of a batch from a
``torch.Generator`` on the host, and :meth:`DeviceAugPipeline.apply` is
deterministic: plain tensor operations on the canvases' device, with no
host synchronisation (the candidate is chosen on the device by an argmax
and a gather). The JAX package draws from ``jax.random``; the port's
stream is its own, and its tests inject the JAX draws into ``apply``.

The JAX package applies the scale and crop as dense (crop x canvas)
sampling matrices and two matmuls a sample. ``apply`` computes the same
source position, ``off / r + (o + 0.5) / r - 0.5`` clipped to the canvas,
and reads it with gathers: the image's two taps a side and a lerp, rows
first as the matmuls sum; the label's nearest index
``round(src - 0.5 + 1e-6)`` (half to even, as ``jnp.round``). The label
maps are equal to the JAX package's; the images agree to fp32 rounding.
"""

import numpy as np
import torch

from ..utils import image as imutil

_HUE_SECTORS = 6


class PrepareCanvas:
    """Host transform to a fixed-shape canvas: 'img' (canvas_h, canvas_w,
    3) uint8 RGB, 'gt_semantic_seg' uint8 and 'valid_hw' (2,) int32.

    Replaces Resize/RandomCrop/RandomFlip/PhotoMetricDistortion/
    Normalize/Pad of the train pipeline. An image that does not fit the
    canvas after the rescale (a portrait one) is transposed first. Takes
    BGR, as the loading transform gives it, and writes the channels
    reversed straight into the canvas (one strided copy of each channel,
    not a reversed copy of the whole canvas)."""

    def __init__(self, img_scale=(2048, 512), canvas=(512, 2048),
                 seg_pad_val=255):
        self.img_scale = tuple(img_scale)
        self.canvas = tuple(canvas)
        self.seg_pad_val = seg_pad_val

    def __call__(self, results):
        img = imutil.imrescale(results['img'], self.img_scale)
        gt = imutil.imrescale(results['gt_semantic_seg'], self.img_scale,
                              interpolation='nearest')
        h, w = img.shape[:2]
        ch, cw = self.canvas
        if h > ch or w > cw:  # portrait: swap the canvas orientation
            img = np.transpose(img, (1, 0, 2))
            gt = np.transpose(gt, (1, 0))
            h, w = img.shape[:2]
        if h > ch or w > cw:
            raise ValueError(f'a {h}x{w} rescaled image does not fit the '
                             f'{ch}x{cw} canvas either way')
        canvas = np.zeros((ch, cw, 3), img.dtype)
        for c in range(3):  # BGR -> RGB, the padding 0
            canvas[:h, :w, c] = img[..., 2 - c]
        labels = np.full((ch, cw), self.seg_pad_val, gt.dtype)
        labels[:h, :w] = gt
        results['img'] = canvas
        results['gt_semantic_seg'] = labels
        results['valid_hw'] = np.array([h, w], np.int32)
        return results


def _floor_mod(x, m):
    """``x mod m`` with the sign of ``m`` (``jnp.remainder``): fmod, plus
    ``m`` where the two signs differ."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


def _rgb_to_hsv(img):
    """cv2's uint8 HSV convention on float RGB in [0, 255]: H in [0, 180),
    S and V in [0, 255]."""
    r, g, b = img.unbind(-1)
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = mx - mn
    safe = torch.where(diff == 0, torch.ones_like(diff), diff)
    h = torch.where(mx == r, _floor_mod((g - b) / safe, 6.0),
                    torch.where(mx == g, (b - r) / safe + 2.0,
                                (r - g) / safe + 4.0))
    h = torch.where(diff == 0, torch.zeros_like(h), h) * 30.0
    s = torch.where(mx == 0, torch.zeros_like(mx),
                    diff / torch.where(mx == 0, torch.ones_like(mx), mx)) \
        * 255.0
    return h, s, mx


def _hsv_to_rgb(h, s, v):
    h = h / 30.0  # back to [0, 6)
    s = s / 255.0
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    sector = _floor_mod(i.to(torch.int32), _HUE_SECTORS)
    # (r, g, b) of sectors 0..5
    table = ((v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
             (v, p, q))
    out = []
    for c in range(3):
        acc = table[_HUE_SECTORS - 1][c]
        for k in range(_HUE_SECTORS - 2, -1, -1):
            acc = torch.where(sector == k, table[k][c], acc)
        out.append(acc)
    return torch.stack(out, dim=-1)


def _per_sample(x):
    """(B,) -> (B, 1, 1, 1), to broadcast over (B, h, w, 3)."""
    return x.reshape(-1, 1, 1, 1)


class DeviceAugPipeline:
    """The batch augmentation: :meth:`draw` on the host, :meth:`apply` on
    the canvases' device."""

    DRAW_KEYS = ('ratio', 'offsets', 'flip', 'brightness', 'brightness_delta',
                 'contrast_first', 'contrast', 'contrast_alpha',
                 'saturation', 'saturation_alpha', 'hue', 'hue_delta')

    def __init__(self, crop_size=(512, 512), ratio_range=(0.5, 2.0),
                 cat_max_ratio=0.75, ignore_index=255, flip_prob=0.5,
                 brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18,
                 mean=(123.675, 116.28, 103.53),
                 std=(58.395, 57.12, 57.375), max_cat_tries=10,
                 num_classes=256):
        self.crop_size = tuple(crop_size)
        self.ratio_range = tuple(ratio_range)
        self.cat_max_ratio = cat_max_ratio
        self.ignore_index = ignore_index
        self.flip_prob = flip_prob
        self.brightness_delta = brightness_delta
        self.contrast_range = tuple(contrast_range)
        self.saturation_range = tuple(saturation_range)
        self.hue_delta = hue_delta
        self.mean = tuple(float(m) for m in mean)
        self.std = tuple(float(s) for s in std)
        self.max_cat_tries = max_cat_tries
        self.num_classes = num_classes
        self._norms = {}  # device -> (mean, std) tensors there

    def draw(self, generator, batch):
        """Every random value of a batch of ``batch``, from ``generator``
        (a CPU ``torch.Generator``) -> {name: CPU tensor}: the scale
        ``ratio`` (B,); ``offsets`` (B, tries, 2) in [0, 1), times the
        margins in :meth:`apply`; the ``flip`` gate; the brightness gate
        and delta; whether the contrast runs first (before the HSV steps)
        or last, its gate and alpha; the saturation gate and alpha; the
        hue gate and delta. Gates are bool, values float32."""
        def uniform(lo, hi, *shape):
            return lo + (hi - lo) * torch.rand(batch, *shape,
                                               generator=generator)

        def gate(p=0.5):
            return torch.rand(batch, generator=generator) < p

        lo, hi = self.ratio_range
        bd = float(self.brightness_delta)
        hd = float(self.hue_delta)
        return {
            'ratio': uniform(lo, hi),
            'offsets': torch.rand(batch, self.max_cat_tries, 2,
                                  generator=generator),
            'flip': gate(self.flip_prob),
            'brightness': gate(), 'brightness_delta': uniform(-bd, bd),
            'contrast_first': gate(), 'contrast': gate(),
            'contrast_alpha': uniform(*self.contrast_range),
            'saturation': gate(),
            'saturation_alpha': uniform(*self.saturation_range),
            'hue': gate(), 'hue_delta': uniform(-hd, hd)}

    # ------------------------------------------------------ geometric
    def _source(self, size, ratio, offset, in_size):
        """Source positions (B, ..., size) of output pixels 0..size-1 at
        scale ``ratio`` (B, 1...) and ``offset`` (resized coordinates),
        clipped to [0, in_size - 1]: the JAX sampling matrices' rows."""
        o = torch.arange(size, dtype=torch.float32, device=ratio.device)
        src = offset / ratio + (o + 0.5) / ratio - 0.5
        return src.clamp(0.0, in_size - 1.0)

    @staticmethod
    def _nearest(src, in_size):
        return torch.round(src - 0.5 + 1e-6).clamp(0, in_size - 1).long()

    def _crop_labels(self, gt, rows, cols):
        """gt (B, H, W) int64; rows (B, K, h), cols (B, K, w) long -> (B,
        K, h, w): the labels at each candidate's nearest positions."""
        B, H, W = gt.shape
        K = rows.shape[1]
        flat = gt.reshape(B, 1, H * W).expand(B, K, H * W)
        idx = (rows[..., :, None] * W + cols[..., None, :]).reshape(B, K, -1)
        return torch.gather(flat, 2, idx).reshape(B, K, rows.shape[2],
                                                  cols.shape[2])

    def _pick(self, gt, ratio, offs):
        """The first candidate crop whose labels pass the ``cat_max_ratio``
        test (more than one class, none above the ratio; the last try is
        taken regardless) -> (B,) indices, chosen on the device."""
        ch, cw = self.crop_size
        B, H, W = gt.shape
        r = ratio[:, None, None]
        rows = self._nearest(self._source(ch, r, offs[..., 0:1], H), H)
        cols = self._nearest(self._source(cw, r, offs[..., 1:2], W), W)
        crops = self._crop_labels(gt, rows, cols).reshape(B, -1, ch * cw)
        n = self.num_classes
        valid = (crops != self.ignore_index) & (crops >= 0) & (crops < n)
        # one histogram a (sample, candidate); invalid pixels go to bin n
        bins = torch.where(valid, crops, torch.full_like(crops, n))
        slots = B * self.max_cat_tries
        base = torch.arange(slots, device=gt.device)
        flat = (base.reshape(B, -1, 1) * (n + 1) + bins).reshape(-1)
        # scatter_add, not bincount: bincount reads its input's maximum
        # back to the host
        hists = torch.zeros(slots * (n + 1), dtype=torch.int64,
                            device=gt.device).scatter_add_(
            0, flat, torch.ones_like(flat)).reshape(B, -1, n + 1)[..., :n]
        tot = hists.sum(-1).clamp_min(1)
        top = hists.max(-1).values
        nlab = (hists > 0).sum(-1)
        ok = (nlab > 1) & (top / tot < self.cat_max_ratio)
        ok = torch.cat([ok, torch.ones_like(ok[:, :1])], dim=1)
        first = ok.to(torch.int32).argmax(dim=1)
        return first.clamp_max(self.max_cat_tries - 1)

    def _crop(self, img, gt, ratio, off, valid_hw):
        """The chosen crop: img (B, H, W, 3) uint8, gt (B, H, W) int64,
        off (B, 2) -> (B, ch, cw, 3) float32 and (B, ch, cw) int64, pixels
        past the resized valid extent set to 0 / ``ignore_index``."""
        ch, cw = self.crop_size
        B, H, W, _ = img.shape
        r = ratio[:, None]
        src_h = self._source(ch, r, off[:, 0:1], H)
        src_w = self._source(cw, r, off[:, 1:2], W)
        # two taps a side; rows are interpolated first, as the JAX
        # package's first matmul sums over them
        h0 = src_h.floor().long()
        w0 = src_w.floor().long()
        h1 = (h0 + 1).clamp_max(H - 1)
        w1 = (w0 + 1).clamp_max(W - 1)
        fh = (src_h - h0)[:, :, None, None]
        fw = (src_w - w0)[:, None, :, None]
        bidx = torch.arange(B, device=img.device)[:, None, None]

        def tap(hi, wi):
            return img[bidx, hi[:, :, None], wi[:, None, :]].to(
                torch.float32)

        t0 = (1 - fh) * tap(h0, w0) + fh * tap(h1, w0)
        t1 = (1 - fh) * tap(h0, w1) + fh * tap(h1, w1)
        crop_img = (1 - fw) * t0 + fw * t1
        rows = self._nearest(src_h, H)
        cols = self._nearest(src_w, W)
        crop_gt = self._crop_labels(gt, rows[:, None], cols[:, None])[:, 0]
        vh = valid_hw[:, 0].to(torch.float32) * ratio
        vw = valid_hw[:, 1].to(torch.float32) * ratio
        yy = torch.arange(ch, dtype=torch.float32, device=img.device)
        xx = torch.arange(cw, dtype=torch.float32, device=img.device)
        inside = ((off[:, 0:1] + yy) < vh[:, None])[:, :, None] \
            & ((off[:, 1:2] + xx) < vw[:, None])[:, None, :]
        crop_img = torch.where(inside[..., None], crop_img,
                               torch.zeros_like(crop_img))
        crop_gt = torch.where(inside, crop_gt,
                              torch.full_like(crop_gt, self.ignore_index))
        return crop_img, crop_gt

    # ------------------------------------------------------ photometric
    def _photometric(self, d, img):
        """ref transforms.py:1099-1215: brightness, contrast (first or
        last), saturation and hue, each behind its gate."""
        def clip(x):
            return x.clamp(0.0, 255.0)

        def where(gate, a, b):
            return torch.where(_per_sample(gate), a, b)

        img = where(d['brightness'],
                    clip(img + _per_sample(d['brightness_delta'])), img)
        alpha = _per_sample(d['contrast_alpha'])
        img = where(d['contrast_first'] & d['contrast'], clip(img * alpha),
                    img)
        h, s, v = _rgb_to_hsv(img)
        sat = clip(s * d['saturation_alpha'].reshape(-1, 1, 1))
        img = where(d['saturation'], _hsv_to_rgb(h, sat, v), img)
        h, s, v = _rgb_to_hsv(img)
        hue = _floor_mod(h + d['hue_delta'].reshape(-1, 1, 1), 180.0)
        img = where(d['hue'], _hsv_to_rgb(hue, s, v), img)
        return where(~d['contrast_first'] & d['contrast'], clip(img * alpha),
                     img)

    def apply(self, draws, img_canvas, gt_canvas, valid_hw):
        """img_canvas (B, Hc, Wc, 3) uint8 RGB, gt_canvas (B, Hc, Wc)
        uint8, valid_hw (B, 2) int, all on one device, and :meth:`draw`'s
        values -> (img (B, ch, cw, 3) float32 normalised, gt (B, ch, cw)
        int32) on that device."""
        dev = img_canvas.device
        d = {k: draws[k].to(dev, non_blocking=True) for k in self.DRAW_KEYS}
        mean, std = self._norm(dev)
        ch, cw = self.crop_size
        ratio = d['ratio'].to(torch.float32)
        gt = gt_canvas.to(torch.int64)
        valid_hw = valid_hw.to(dev, non_blocking=True)
        rh = valid_hw[:, 0].to(torch.float32) * ratio
        rw = valid_hw[:, 1].to(torch.float32) * ratio
        margins = torch.stack([(rh - ch).clamp_min(0.0),
                               (rw - cw).clamp_min(0.0)], dim=-1)
        offs = d['offsets'].to(torch.float32) * margins[:, None, :]
        if self.cat_max_ratio < 1.0:
            pick = self._pick(gt, ratio, offs)
        else:
            pick = torch.zeros(gt.shape[0], dtype=torch.long, device=dev)
        off = torch.gather(offs, 1, pick.reshape(-1, 1, 1).expand(-1, 1, 2)
                           )[:, 0]
        img, gt = self._crop(img_canvas, gt, ratio, off, valid_hw)
        flip = d['flip']
        img = torch.where(_per_sample(flip), img.flip(2), img)
        gt = torch.where(flip.reshape(-1, 1, 1), gt.flip(2), gt)
        img = self._photometric(d, img)
        return (img - mean) / std, gt.to(torch.int32)

    def _norm(self, device):
        """The mean and std on ``device``, made once, each copied from
        pinned memory (a copy from pageable memory waits for the
        stream)."""
        if device not in self._norms:
            out = []
            for v in (self.mean, self.std):
                t = torch.tensor(v, dtype=torch.float32)
                if device.type == 'cuda':
                    t = t.pin_memory()
                out.append(t.to(device, non_blocking=True))
            self._norms[device] = tuple(out)
        return self._norms[device]
