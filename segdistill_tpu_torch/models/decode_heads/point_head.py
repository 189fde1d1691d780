"""PointHead, PointRend's refinement stage (counterpart of
``segdistill_tpu/models/decode_heads/point_head.py``; reference
``mmseg/models/decode_heads/point_head.py:12-349``).

A cascade head: ``forward(inputs, prev_output, generator, points)`` takes
the first stage's logits. Logits and features are NCHW; a point set is
(B, P, 2) in [0, 1]^2, (x, y) order.

* :func:`point_sample` is ``F.grid_sample`` at ``2 p - 1`` (align_corners
  False, zero padding), the reference's mmcv op; features are sampled in
  float32, so the point MLP runs in float32, as in the JAX package.
* Training (ref :258-305): ``num_points * oversample_ratio`` uniform
  points, the ``importance_sample_ratio`` share of them most uncertain
  (negative margin of the top two logits), the rest uniform; drawn from
  the step's ``torch.Generator``, or given as ``points`` (the parity tests
  inject the JAX package's). It returns (point logits (B, K, P), points);
  the loss is a plain CE at the labels sampled nearest (round half to
  even) at the points, (B, K, P, 1) against (B, P, 1): no kernel.
* Test (ref :204-246): ``subdivision_steps`` times, upsample x
  ``scale_factor``, take the ``min(H*W, subdivision_num_points)`` most
  uncertain positions and write their refined logits there. The positions
  come from a stable descending sort, so a tie on the k-th value keeps the
  lower index, as ``lax.top_k`` does.

Module names are the reference's: ``fcs.{k}`` (ConvModules of Conv1d) and
``fc_seg`` (Conv1d); there is no ``conv_seg``.
"""

import torch
import torch.nn.functional as F

from ...ops import resize
from ..builder import HEADS, build_loss
from ..losses import accuracy
from ..utils import ConvModule, Dropout
from ..utils.conv_module import Conv1d
from .ocr_head import BaseCascadeDecodeHead
from .psp_head import init_conv_modules


def point_sample(feat, points, align_corners=False, mode='bilinear'):
    """Sample (B, C, H, W) ``feat`` at (B, P, 2) ``points`` in [0, 1]^2 ->
    (B, C, P), grid_sample's semantics with zero padding."""
    grid = (2.0 * points - 1.0).unsqueeze(2).to(feat.dtype)
    return F.grid_sample(feat, grid, mode=mode,
                         align_corners=align_corners)[..., 0]


def calculate_uncertainty(logits):
    """-(top1 - top2) over the class axis 1 of (B, K, ...) logits, in
    float32 (ref :14-31)."""
    top2 = logits.float().topk(2, dim=1).values
    return top2[:, 1] - top2[:, 0]


def top_positions(scores, k):
    """The indices of the ``k`` largest of each row of ``scores`` (B, N),
    the lower index first among equal values (``lax.top_k``'s rule)."""
    return scores.sort(dim=1, descending=True, stable=True).indices[:, :k]


@HEADS.register_module()
class PointHead(BaseCascadeDecodeHead):

    CLS_LAYER = 'fc_seg'

    def __init__(self, num_fcs=3, coarse_pred_each_layer=True,
                 num_points=2048, oversample_ratio=3,
                 importance_sample_ratio=0.75, subdivision_steps=2,
                 subdivision_num_points=8196, scale_factor=2, **kwargs):
        kwargs.setdefault('input_transform', 'multiple_select')  # ref :69
        kwargs.setdefault('conv_cfg', dict(type='Conv1d'))
        super().__init__(**kwargs)
        self.coarse_pred_each_layer = coarse_pred_each_layer
        self.num_points = num_points
        self.oversample_ratio = oversample_ratio
        self.importance_sample_ratio = importance_sample_ratio
        self.subdivision_steps = subdivision_steps
        self.subdivision_num_points = subdivision_num_points
        self.scale_factor = scale_factor
        in_ch = sum(self.in_channels) + self.num_classes
        fcs = []
        for _ in range(num_fcs):
            fcs.append(ConvModule(in_ch, self.channels, 1,
                                  conv_cfg=self.conv_cfg,
                                  norm_cfg=self.norm_cfg,
                                  act_cfg=self.act_cfg))
            in_ch = self.channels + (self.num_classes
                                     if coarse_pred_each_layer else 0)
        self.fcs = torch.nn.ModuleList(fcs)
        self.fc_seg = Conv1d(in_ch, self.num_classes, 1)
        # the reference's nn.Dropout over points (not whole channels)
        self.dropout = Dropout(self.dropout.p) if self.dropout is not None \
            else None

    @torch.no_grad()
    def init_weights(self, generator):
        """ConvModules as mmcv's; ``fc_seg`` N(0, 0.001), zero bias."""
        init_conv_modules(self, generator)
        self.fc_seg.weight.normal_(0, 0.001, generator=generator)
        torch.nn.init.zeros_(self.fc_seg.bias)

    def _point_logits(self, x, prev_output, points, generator):
        """The point MLP at ``points`` (ref :117-121): fine features of
        every input map and the coarse logits, (B, K, P)."""
        fine = torch.cat([point_sample(f.float(), points, self.align_corners)
                          for f in x], dim=1)
        coarse = point_sample(prev_output.float(), points,
                              self.align_corners)
        h = torch.cat([fine, coarse], dim=1)
        for fc in self.fcs:
            h = fc(h)
            if self.coarse_pred_each_layer:
                h = torch.cat([h, coarse], dim=1)
        if self.dropout is not None:
            h = self.dropout(h, generator)
        return self.fc_seg(h)

    @torch.no_grad()
    def get_points_train(self, prev_output, generator):
        """Oversample -> the most uncertain -> uniform fill (ref
        :258-305), drawn from ``generator``."""
        if generator is None:
            raise ValueError('the training points are drawn from an explicit '
                             'torch.Generator; pass generator=... or points')
        B = prev_output.shape[0]
        n_over = int(self.num_points * self.oversample_ratio)
        n_unc = int(self.importance_sample_ratio * self.num_points)
        dev = prev_output.device
        coords = torch.rand(B, n_over, 2, device=dev, generator=generator)
        unc = calculate_uncertainty(point_sample(
            prev_output.float(), coords, self.align_corners))
        idx = top_positions(unc, n_unc)
        picked = coords.gather(1, idx.unsqueeze(-1).expand(-1, -1, 2))
        n_rand = self.num_points - n_unc
        if n_rand > 0:
            picked = torch.cat([picked, torch.rand(
                B, n_rand, 2, device=dev, generator=generator)], dim=1)
        return picked

    def get_points_test(self, refined):
        """The ``min(H*W, subdivision_num_points)`` most uncertain
        positions of ``refined`` (B, K, H, W) and their centres' coordinates
        (ref :307-349)."""
        B, _, H, W = refined.shape
        k = min(H * W, self.subdivision_num_points)
        idx = top_positions(calculate_uncertainty(refined).reshape(B, H * W),
                            k)
        coords = torch.stack([0.5 / W + (idx % W).float() / W,
                              0.5 / H + (idx // W).float() / H], dim=-1)
        return idx, coords

    def forward(self, inputs, prev_output, generator=None, points=None):
        x = self._transform_inputs(inputs)
        if not isinstance(x, (list, tuple)):
            x = [x]
        if self.training:
            if points is None:
                points = self.get_points_train(prev_output.detach(),
                                               generator)
            return (self._point_logits(x, prev_output, points, generator),
                    points)
        refined = prev_output
        for _ in range(self.subdivision_steps):
            B, K, H, W = refined.shape
            refined = resize(refined, size=(H * self.scale_factor,
                                            W * self.scale_factor),
                             mode='bilinear',
                             align_corners=self.align_corners)
            idx, coords = self.get_points_test(refined)
            logits = self._point_logits(x, prev_output, coords, generator)
            flat = refined.reshape(B, K, -1).scatter(
                2, idx.unsqueeze(1).expand(-1, K, -1),
                logits.to(refined.dtype))
            refined = flat.view(refined.shape)
        return refined

    def losses(self, outs, seg_label, seg_weight=None):
        """CE of the point logits at the labels sampled nearest at the
        points (ref :165-201, :248-256): 'loss_point', 'acc_point'."""
        del seg_weight
        point_logits, points = outs
        if seg_label.ndim == 4:
            seg_label = seg_label[:, 0]
        label = point_sample(seg_label.unsqueeze(1).float(), points.float(),
                             self.align_corners, mode='nearest')[:, 0]
        label = label.long().unsqueeze(-1)                  # (B, P, 1)
        logits = point_logits.unsqueeze(-1)                 # (B, K, P, 1)
        loss_fn = build_loss(self._loss_cfg())
        return {'loss_point': loss_fn(logits, label,
                                      ignore_index=self.ignore_index),
                'acc_point': accuracy(logits, label)}
