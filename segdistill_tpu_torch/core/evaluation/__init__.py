from .metrics import (eval_metrics, intersect_and_union, mean_iou,
                      metrics_from_histograms, total_intersect_and_union)

__all__ = ['eval_metrics', 'intersect_and_union', 'mean_iou',
           'metrics_from_histograms', 'total_intersect_and_union']
