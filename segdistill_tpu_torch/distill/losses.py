"""Knowledge-distillation losses (counterpart of
``segdistill_tpu/distill/losses.py``; reference
``mmseg/models/distillation/losses.py:9-173``).

KLDLoss pipeline: the alpha schedule (warmup, early decay) as a pure
function of the step -> bilinear resize of both maps to the label size ->
channel shuffle (a fresh permutation only on steps that are a multiple of
the interval, the identity otherwise) -> the 'channel' transform (pad C to
a multiple of group_size with -1e9, then (B, C/g, g*H*W)) ->
``KL(softmax(t/tau) || softmax(s/tau))`` summed and divided by the number
of distributions (``numel/last_dim``). No tau^2 factor: the reference has
none.

The channel transform with a bilinear, align_corners=False resize (or
none) goes through :func:`fused_group_kl_shuffled` (with a shuffle) or
:func:`fused_group_kl` on every device: kernels K3/K4 on CUDA, which take
any output size, and their plain versions on the CPU. Other settings run
the plain pipeline in float32. The permutation is an input: a caller may
pass ``perm``; otherwise an interval step draws it from ``generator``
(seeded from the run's seed and the step by the train step). The 'pixel'
transform and the PD/AT/IFVD losses are not ported yet.
"""

import torch
import torch.nn.functional as F

from ..ops import resize
from ..ops.group_kl import fused_group_kl, fused_group_kl_shuffled


def _ramp(mode, alpha_0, frac, exp_scale=1.0):
    if mode == 'linear':
        return alpha_0 * frac
    if mode == 'exp':
        return exp_scale * alpha_0 ** frac
    if mode == 'jump':
        return 0.0
    raise ValueError(mode)


class KLDLoss:
    """Configurable KL distillation loss (ref losses.py:9-113)."""

    def __init__(self, alpha=1, tau=1, resize_config=None,
                 shuffle_config=None, transform_config=None,
                 warmup_config=None, earlydecay_config=None):
        if transform_config and transform_config['loss_type'] != 'channel':
            raise NotImplementedError(
                f"the {transform_config['loss_type']!r} transform is not "
                f"ported yet; the ported loss takes loss_type='channel'")
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
        alpha = self.alpha_at(step)
        C = x_student.shape[1]
        if self.shuffle_config and perm is None:
            perm = self.shuffle_idx(C, step, generator, x_student.device)
        out_hw = self._fused_out_hw(x_student, gt)
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
            x_s, x_t = self._channel_groups(x_s), self._channel_groups(x_t)
        log_s = F.log_softmax(x_s / self.tau, dim=-1)
        p_t = F.softmax(x_t / self.tau, dim=-1)
        kl = (torch.xlogy(p_t, p_t) - p_t * log_s).sum()
        return alpha * kl / (x_s.numel() / x_s.shape[-1])

    def _channel_groups(self, x):
        B, C, H, W = x.shape
        g = self.transform_config['group_size']
        if C % g:
            pad = x.new_full((B, g - C % g, H, W), -1e9)
            x = torch.cat([x, pad], dim=1)
        return x.reshape(B, -1, g * H * W)


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


DISTILL_LOSSES = {
    'KLDLoss': KLDLoss,
    'CDLoss': CDLoss,
    'CGDLoss': CGDLoss,
    'CGDLossWS': CGDLossWS,
}
