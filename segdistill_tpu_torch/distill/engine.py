"""Distillation engine: config parsing and loss dispatch (counterpart of
``segdistill_tpu/distill/engine.py``; reference
``mmseg/models/distillation/opts.py:13-112``).

The config surface is the reference's: a ``distillation`` list of dicts
with ``student_layer`` / ``teacher_layer`` / ``loss_name`` /
``loss_config`` (and ``channel_nums`` for a cross-width pair, which gets a
trainable 1x1 channel adapter). Loss keys are
``loss_{student}<->{teacher}_{info}`` (opts.py:105-110).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from .losses import DISTILL_LOSSES


def convert_tap(name, value):
    """The JAX engine turns its NHWC conv taps into the reference's NCHW;
    the port's taps are NCHW already (attention and token taps keep the
    reference's layout on both sides), so this is the identity."""
    del name
    return value


def _layer_list(entry_layer):
    return list(entry_layer) if isinstance(entry_layer, list) \
        else [entry_layer]


def needed_layers(distillation):
    """(student layer names, teacher layer names) the config consumes
    (ref opts.py:36-46)."""
    student_layers, teacher_layers = [], []
    for entry in distillation:
        student_layers += _layer_list(entry['student_layer'])
        teacher_layers += _layer_list(entry['teacher_layer'])
    return student_layers, teacher_layers


class ChannelAdapter(nn.Module):
    """Trainable 1x1 channel map from the student's width to the teacher's
    (ref Conv1d, opts.py:115-125): channel axis 1 of an NCHW tap, the last
    axis of a (B, N, C) token tap. ``weight`` is (c_t, c_s)."""

    def __init__(self, c_s, c_t):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_t, c_s))
        self.bias = nn.Parameter(torch.empty(c_t))

    @torch.no_grad()
    def init_weights(self, generator):
        """U(-1/sqrt(c_s), 1/sqrt(c_s)) for weight and bias, torch
        Conv1d's default (the JAX ``_init_adapters``)."""
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        self.weight.uniform_(-bound, bound, generator=generator)
        self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        w, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        if x.ndim == 4:
            return F.conv2d(x, w[:, :, None, None], b)
        return F.linear(x, w, b)


def build_adapters(distillation):
    """{'adapter_<i>': ChannelAdapter} for the entries with
    ``channel_nums``."""
    return nn.ModuleDict({
        f'adapter_{i}': ChannelAdapter(*entry['channel_nums'])
        for i, entry in enumerate(distillation)
        if entry.get('channel_nums') is not None})


class DistillationLoss:
    """Builds the criteria from the config and computes the distillation
    loss dict (ref contract: opts.py:74-112)."""

    def __init__(self, distillation):
        self.entries = []
        for entry in distillation:
            loss_name = entry['loss_name']
            loss_config = entry['loss_config']
            if isinstance(loss_config, tuple):
                loss_config = loss_config[0]
            if loss_name not in DISTILL_LOSSES:
                raise KeyError(
                    f'unknown distillation loss {loss_name}; '
                    f'registered: {sorted(DISTILL_LOSSES)}')
            if isinstance(entry['student_layer'], list):
                raise NotImplementedError(
                    'paired-layer criteria are dead code in the reference '
                    '(losses.py:239-927); no registered loss uses them')
            criterion = DISTILL_LOSSES[loss_name](**dict(loss_config))
            self.entries.append(dict(entry, criterion=criterion))

    def __call__(self, student_features, teacher_features, gt_semantic_seg,
                 step, generator=None, perm=None, adapters=None):
        losses = {}
        for i, entry in enumerate(self.entries):
            s_layer, t_layer = entry['student_layer'], entry['teacher_layer']
            x_s = convert_tap(s_layer,
                              _lookup(student_features, s_layer, 'student'))
            x_t = convert_tap(t_layer,
                              _lookup(teacher_features, t_layer, 'teacher'))
            if adapters is not None and f'adapter_{i}' in adapters:
                x_s = adapters[f'adapter_{i}'](x_s)
            loss = entry['criterion'](x_s, x_t, gt_semantic_seg, step,
                                      generator=generator, perm=perm)
            loss_cfg = entry.get('loss_config') or {}
            loss_info = entry.get('loss_info')
            if loss_info is None:
                loss_info = loss_cfg.get('transform_config', 'other') \
                    if isinstance(loss_cfg, dict) else 'other'
            losses[f'loss_{s_layer}<->{t_layer}_{loss_info}'] = loss
        return losses


def _lookup(features, layer, role):
    if layer not in features:
        raise KeyError(
            f'{role} layer {layer!r} has no feature tap; available taps: '
            f'{sorted(getattr(features, "seen", features))}')
    return features[layer]
