"""Model registries and build functions, under the JAX package's type
names (counterpart of ``segdistill_tpu/models/builder.py``)."""

from ..registry import Registry, build_from_cfg

BACKBONES = Registry('backbone')
HEADS = Registry('head')
NECKS = Registry('neck')
SEGMENTORS = Registry('segmentor')
LOSSES = Registry('loss')


def build(cfg, registry, default_args=None):
    if isinstance(cfg, list):
        return [build_from_cfg(c, registry, default_args) for c in cfg]
    return build_from_cfg(cfg, registry, default_args)


def build_backbone(cfg):
    return build(cfg, BACKBONES)


def build_neck(cfg):
    return build(cfg, NECKS)


def build_head(cfg):
    return build(cfg, HEADS)


def build_loss(cfg):
    return build(cfg, LOSSES)


def build_segmentor(cfg, train_cfg=None, test_cfg=None):
    return build(cfg, SEGMENTORS,
                 dict(train_cfg=train_cfg, test_cfg=test_cfg))
