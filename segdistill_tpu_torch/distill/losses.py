"""Knowledge-distillation losses (counterpart of
``segdistill_tpu/distill/losses.py``; reference
``mmseg/models/distillation/losses.py:9-238``).

KLDLoss pipeline: the alpha schedule (warmup, early decay) as a pure
function of the step -> bilinear resize of both maps to the label size ->
channel shuffle (a fresh permutation only on steps that are a multiple of
the interval, the identity otherwise) -> the transform ('pixel': (B, C, H,
W) -> (B, H*W, C); 'channel': pad C to a multiple of group_size with -1e9,
then (B, C/g, g*H*W)) -> ``KL(softmax(t/tau) || softmax(s/tau))`` summed
and divided by the number of distributions (``numel/last_dim``). No tau^2
factor: the reference has none.

Either transform with a bilinear, align_corners=False resize (or none) on
NCHW maps goes through a fused loss on every device, kernels on CUDA (which
take any output size) and their plain versions on the CPU: 'pixel' through
:func:`fused_pixel_kl` (K7/K8), divided by B*H*W, with no shuffle, since a
permutation of both maps' channels permutes the terms within each
per-pixel softmax; 'channel' through :func:`fused_group_kl_shuffled` (with
a shuffle) or :func:`fused_group_kl` (K3/K4). Other settings run the plain
pipeline in float32. The permutation is an input: a caller may pass
``perm``; otherwise an interval step draws it from ``generator`` (seeded
from the run's seed and the step by the train step).

ATLoss and IFVDLoss (ref losses.py:175-238) are plain PyTorch, as the JAX
package computes them.
"""

import torch
import torch.nn.functional as F

from ..ops import resize
from ..ops.group_kl import fused_group_kl, fused_group_kl_shuffled
from ..ops.pixel_kl import fused_pixel_kl

TRANSFORMS = ('pixel', 'channel')


def _kl_div_sum(log_s, p_t):
    """torch.nn.KLDivLoss(reduction='sum'): sum(t*log(t) - t*log_s), with
    0*log(0) == 0."""
    return (torch.xlogy(p_t, p_t) - p_t * log_s).sum()


def _ramp(mode, alpha_0, frac, exp_scale=1.0):
    if mode == 'linear':
        return alpha_0 * frac
    if mode == 'exp':
        return exp_scale * alpha_0 ** frac
    if mode == 'jump':
        return 0.0
    raise ValueError(mode)


class KLDLoss:
    """Configurable KL distillation loss (ref losses.py:9-113).

    ``alpha_tensor``: while a CUDA graph of the train step is captured or
    its step runs eagerly beside it (``engine/cuda_graph.py``), a float32
    device scalar that takes the place of ``alpha_at(step)`` and is written
    before each replay; otherwise None."""

    alpha_tensor = None

    def __init__(self, alpha=1, tau=1, resize_config=None,
                 shuffle_config=None, transform_config=None,
                 warmup_config=None, earlydecay_config=None):
        if transform_config and transform_config['loss_type'] \
                not in TRANSFORMS:
            raise ValueError(f"unknown transform "
                             f"{transform_config['loss_type']!r}; the loss "
                             f"takes loss_type in {TRANSFORMS}")
        self.alpha_0 = float(alpha)
        self.tau = float(tau)
        self.resize_config = resize_config
        self.shuffle_config = shuffle_config
        self.transform_config = transform_config
        self.warmup_config = warmup_config
        self.earlydecay_config = earlydecay_config

    def alpha_at(self, step):
        """alpha at ``step``, a pure function of the step counter."""
        step = float(step)
        alpha = self.alpha_0
        if self.warmup_config:
            w = float(self.warmup_config['warmup_iters'])
            warm = _ramp(self.warmup_config['mode'], self.alpha_0, step / w)
            if step < w:
                alpha = warm
        if self.earlydecay_config:
            s = float(self.earlydecay_config['earlydecay_start'])
            e = float(self.earlydecay_config['earlydecay_end'])
            decay = _ramp(self.earlydecay_config['mode'], self.alpha_0,
                          (e - step) / (e - s), exp_scale=0.001)
            if s < step < e:
                alpha = decay
            elif step >= e:
                alpha = 0.0
        return alpha

    def shuffle_idx(self, C, step, generator=None, device=None):
        """The shared channel permutation of ``step``: fresh on steps that
        hit the interval (ref losses.py:35-42), the identity otherwise."""
        if step % self.shuffle_config['interval']:
            return torch.arange(C, device=device)
        if generator is None:
            raise ValueError('the channel shuffle draws its permutation '
                             'from an explicit torch.Generator; pass '
                             'generator=... or perm=...')
        return torch.randperm(C, generator=generator,
                              device=generator.device).to(device)

    def _fused_out_hw(self, x_student, gt):
        """The fused path's output size, or None where the plain pipeline
        runs."""
        if not self.transform_config or x_student.ndim != 4:
            return None
        if not self.resize_config:
            return tuple(x_student.shape[-2:])
        if self.resize_config['mode'] != 'bilinear' \
                or self.resize_config.get('align_corners', False):
            return None
        return tuple(gt.shape[-2:])

    def __call__(self, x_student, x_teacher, gt, step, generator=None,
                 perm=None):
        alpha = self.alpha_at(step) if self.alpha_tensor is None \
            else self.alpha_tensor
        out_hw = self._fused_out_hw(x_student, gt)
        if out_hw is not None and \
                self.transform_config['loss_type'] == 'pixel':
            loss = fused_pixel_kl(x_student, x_teacher, out_hw, self.tau)
            return alpha * loss / (x_student.shape[0] * out_hw[0] * out_hw[1])
        C = x_student.shape[1]
        if self.shuffle_config and perm is None:
            perm = self.shuffle_idx(C, step, generator, x_student.device)
        if out_hw is not None:
            g = self.transform_config['group_size']
            if self.shuffle_config:
                loss = fused_group_kl_shuffled(x_student, x_teacher, perm,
                                               out_hw, g, self.tau)
            else:
                loss = fused_group_kl(x_student, x_teacher, out_hw, g,
                                      self.tau)
            return alpha * loss
        x_s, x_t = x_student.float(), x_teacher.float()
        if self.resize_config:
            kw = dict(size=tuple(gt.shape[-2:]),
                      mode=self.resize_config['mode'],
                      align_corners=self.resize_config['align_corners'])
            x_s, x_t = resize(x_s, **kw), resize(x_t, **kw)
        if self.shuffle_config:
            perm = perm.to(x_s.device, torch.long)
            x_s, x_t = x_s[:, perm], x_t[:, perm]
        if self.transform_config:
            x_s, x_t = self._transform(x_s), self._transform(x_t)
        kl = _kl_div_sum(F.log_softmax(x_s / self.tau, dim=-1),
                         F.softmax(x_t / self.tau, dim=-1))
        return alpha * kl / (x_s.numel() / x_s.shape[-1])

    def _transform(self, x):
        B, C, H, W = x.shape
        if self.transform_config['loss_type'] == 'pixel':
            return x.permute(0, 2, 3, 1).reshape(B, H * W, C)
        g = self.transform_config['group_size']
        if C % g:
            pad = x.new_full((B, g - C % g, H, W), -1e9)
            x = torch.cat([x, pad], dim=1)
        return x.reshape(B, -1, g * H * W)


class PDLoss(KLDLoss):
    """Pixel-wise distillation preset (ref losses.py:115-128)."""

    def __init__(self):
        super().__init__(
            alpha=1, tau=1,
            resize_config={'mode': 'bilinear', 'align_corners': False},
            transform_config={'loss_type': 'pixel'})


class CDLoss(KLDLoss):
    """Channel-wise distillation preset (ref losses.py:130-143)."""

    def __init__(self):
        super().__init__(
            alpha=1, tau=1,
            resize_config={'mode': 'bilinear', 'align_corners': False},
            transform_config={'loss_type': 'channel', 'group_size': 1})


class CGDLoss(KLDLoss):
    """Channel Group Distillation, the paper's method
    (ref losses.py:145-158)."""

    def __init__(self, group_size=10, alpha=3, tau=2):
        super().__init__(
            alpha=alpha, tau=tau,
            resize_config={'mode': 'bilinear', 'align_corners': False},
            shuffle_config={'interval': 1000},
            transform_config={'loss_type': 'channel',
                              'group_size': group_size})


class CGDLossWS(KLDLoss):
    """CGD with a linear warmup and early decay of alpha
    (ref losses.py:160-173; takes CGDLoss's keyword arguments, as the JAX
    package does, so ``psp_CGD+WS.py`` builds)."""

    def __init__(self, group_size=10, alpha=3, tau=2):
        super().__init__(
            alpha=alpha, tau=tau,
            resize_config={'mode': 'bilinear', 'align_corners': False},
            shuffle_config={'interval': 1000},
            transform_config={'loss_type': 'channel',
                              'group_size': group_size},
            warmup_config={'mode': 'linear', 'warmup_iters': 2000},
            earlydecay_config={'mode': 'linear', 'earlydecay_start': 110000,
                               'earlydecay_end': 120000})


class ATLoss:
    """Attention transfer: the MSE of the channel means plus the per-pixel
    channel-softmax KL at tau 1 (ref losses.py:175-197)."""

    def __call__(self, x_student, x_teacher, gt, step, generator=None,
                 perm=None):
        del gt, step, generator, perm
        if x_student.shape != x_teacher.shape:
            # the reference's MSELoss raises here too (a PSP student at
            # stride 8 against a teacher at stride 4), as does the JAX loss
            raise ValueError(f'ATLoss compares maps of one shape, got '
                             f'{tuple(x_student.shape)} and '
                             f'{tuple(x_teacher.shape)}')
        x_s, x_t = x_student.float(), x_teacher.float()
        loss_at = (x_s.mean(dim=1) - x_t.mean(dim=1)).square().mean()
        loss_pd = _kl_div_sum(F.log_softmax(x_s, dim=1),
                              F.softmax(x_t, dim=1))
        return loss_at + loss_pd / (x_s.numel() / x_s.shape[1])


class IFVDLoss:
    """Intra-class feature variation distillation (ref losses.py:199-238):
    the per-pixel KL with the teacher resized to the student's size, plus
    10 x the MSE between the two maps' cosine similarities to their class
    centres (the mean feature of each label, at the labels nearest-resized
    to the feature size; pixels without a valid label are their own
    centre). The reference's per-class loop is a one-hot segment mean, as
    in the JAX package."""

    def __call__(self, x_student, x_teacher, gt, step, generator=None,
                 perm=None):
        del step, generator, perm
        feat_s = x_student.float()
        hw = tuple(feat_s.shape[-2:])
        feat_t = resize(x_teacher.float(), size=hw, mode='bilinear',
                        align_corners=False)
        B, C = feat_t.shape[:2]
        loss_pd = _kl_div_sum(F.log_softmax(feat_s, dim=1),
                              F.softmax(feat_t, dim=1)) / (feat_s.numel() / C)
        gt_map = gt if gt.ndim == 3 else gt[:, 0]
        labels = resize(gt_map.float(), size=hw, mode='nearest').long()
        valid = (labels >= 0) & (labels < C)
        idx = torch.where(valid, labels, torch.zeros_like(labels))
        onehot = F.one_hot(idx, C).float() * valid[..., None]
        counts = onehot.sum(dim=(1, 2))                        # (B, class)
        gather_idx = idx.reshape(B, 1, -1).expand(B, C, -1)

        def centers(feat):
            sums = torch.einsum('bchw,bhwi->bci', feat, onehot)
            mu = sums / (counts[:, None, :] + 1e-6)          # (B, C, class)
            gathered = torch.gather(mu, 2, gather_idx).reshape(feat.shape)
            return torch.where(valid[:, None], gathered, feat)

        def cos(a, b):
            # torch CosineSimilarity(dim=1): each norm floored at eps=1e-8
            na = a.norm(dim=1).clamp_min(1e-8)
            nb = b.norm(dim=1).clamp_min(1e-8)
            return (a * b).sum(dim=1) / (na * nb)

        loss_ifvd = 10.0 * (cos(feat_s, centers(feat_s))
                            - cos(feat_t, centers(feat_t))).square().mean()
        return loss_ifvd + loss_pd


DISTILL_LOSSES = {
    'KLDLoss': KLDLoss,
    'PDLoss': PDLoss,
    'CDLoss': CDLoss,
    'CGDLoss': CGDLoss,
    'CGDLossWS': CGDLossWS,
    'ATLoss': ATLoss,
    'IFVDLoss': IFVDLoss,
}
