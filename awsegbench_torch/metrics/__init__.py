"""Evaluation metrics: streaming accumulators on the device and the
reference's facades (counterpart of ``awsegbench/metrics``)."""

from .calibration import (ConfidenceCalibration, ece_bin_update,
                          ece_bin_update_per_weather, ece_from_bins)
from .disagreement import (EnsembleDisagreementMetrics, auroc_exact,
                           auroc_from_histogram, auroc_histogram_update,
                           disagreement_map, jensen_shannon_divergence,
                           variance_map)
from .iou import (IoUMetrics, confusion_matrix, confusion_matrix_per_weather,
                  iou_from_confusion, pixel_accuracy_from_confusion)
from .robustness import RobustnessMetrics

__all__ = [
    'IoUMetrics', 'confusion_matrix', 'iou_from_confusion',
    'pixel_accuracy_from_confusion', 'ConfidenceCalibration',
    'ece_bin_update', 'ece_bin_update_per_weather', 'ece_from_bins',
    'confusion_matrix_per_weather', 'EnsembleDisagreementMetrics',
    'disagreement_map', 'variance_map', 'jensen_shannon_divergence',
    'auroc_exact', 'auroc_histogram_update', 'auroc_from_histogram',
    'RobustnessMetrics',
]
