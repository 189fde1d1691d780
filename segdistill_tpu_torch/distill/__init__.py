from .engine import (ChannelAdapter, DistillationLoss, build_adapters,
                     convert_tap, needed_layers)
from .losses import (DISTILL_LOSSES, CDLoss, CGDLoss, CGDLossWS, KLDLoss)

__all__ = ['ChannelAdapter', 'DistillationLoss', 'build_adapters',
           'convert_tap', 'needed_layers', 'DISTILL_LOSSES', 'CDLoss',
           'CGDLoss', 'CGDLossWS', 'KLDLoss']
