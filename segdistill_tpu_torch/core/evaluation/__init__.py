from .class_names import get_classes, get_palette
from .eval_hooks import EvalHook
from .metrics import (confusion_histograms, eval_metrics,
                      intersect_and_union, mean_dice, mean_iou,
                      metrics_from_histograms,
                      prepare_label, total_intersect_and_union)

__all__ = ['get_classes', 'get_palette', 'EvalHook', 'confusion_histograms',
           'eval_metrics', 'intersect_and_union', 'mean_dice', 'mean_iou',
           'metrics_from_histograms', 'prepare_label',
           'total_intersect_and_union']
