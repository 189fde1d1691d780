from .engine import (ChannelAdapter, DistillationLoss, build_adapters,
                     convert_tap, needed_layers)
from .losses import (DISTILL_LOSSES, ATLoss, CDLoss, CGDLoss, CGDLossWS,
                     IFVDLoss, KLDLoss, PDLoss)

__all__ = ['ChannelAdapter', 'DistillationLoss', 'build_adapters',
           'convert_tap', 'needed_layers', 'DISTILL_LOSSES', 'ATLoss',
           'CDLoss', 'CGDLoss', 'CGDLossWS', 'IFVDLoss', 'KLDLoss', 'PDLoss']
