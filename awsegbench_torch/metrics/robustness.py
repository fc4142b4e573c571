"""The robustness metrics facade (counterpart of
``awsegbench/metrics/robustness.py``): IoU, calibration and disagreement
together, with the reference's degradation ratio and summary, quirks
included:

* the degradation ratio is clamped at 0 and is 1.0 when the clean mIoU is
  0;
* the summary averages the degradations, ECEs and AUROCs over weathers.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .calibration import ConfidenceCalibration
from .disagreement import EnsembleDisagreementMetrics
from .iou import IoUMetrics

ADVERSE_WEATHERS = ('fog', 'rain', 'snow', 'night')


class RobustnessMetrics:
    def __init__(self, num_classes: int = 19,
                 weather_conditions: Sequence[str] | None = None) -> None:
        self.num_classes = num_classes
        self.weather_conditions = list(weather_conditions or
                                       ['clean', *ADVERSE_WEATHERS])
        self.iou_metrics = IoUMetrics(num_classes)
        self.calibration_metrics = ConfidenceCalibration()
        self.ensemble_metrics = EnsembleDisagreementMetrics()

    def compute_miou(self, predictions, targets) -> float:
        return self.iou_metrics.compute_iou(predictions, targets)['mean_iou']

    def compute_weather_specific_metrics(self, predictions_dict: dict,
                                         targets_dict: dict
                                         ) -> dict[str, float]:
        metrics: dict[str, float] = {}
        for weather in self.weather_conditions:
            if weather in predictions_dict and weather in targets_dict:
                preds, tgts = predictions_dict[weather], targets_dict[weather]
                if len(preds) > 0 and len(tgts) > 0:
                    metrics[f'miou_{weather}'] = self.compute_miou(preds, tgts)
        return metrics

    @staticmethod
    def compute_robustness_degradation_ratio(clean_miou: float,
                                             adverse_miou: float) -> float:
        if clean_miou == 0:
            return 1.0
        return max(0.0, (clean_miou - adverse_miou) / clean_miou)

    def compute_comprehensive_metrics(self, predictions, targets,
                                      ensemble_predictions=None,
                                      weather_condition: str = 'clean'
                                      ) -> dict[str, float]:
        metrics: dict[str, float] = {}
        metrics['mean_iou'] = self.iou_metrics.compute_iou(
            predictions, targets)['mean_iou']
        metrics['pixel_accuracy'] = self.iou_metrics.compute_pixel_accuracy(
            predictions, targets)
        metrics['expected_calibration_error'] = \
            self.calibration_metrics.compute_ece(predictions, targets)
        if ensemble_predictions and len(ensemble_predictions) >= 2:
            metrics['ensemble_disagreement_auroc'] = (
                self.ensemble_metrics.compute_disagreement_auroc(
                    ensemble_predictions, targets))
        metrics[f'miou_{weather_condition}'] = metrics['mean_iou']
        return metrics

    def create_robustness_summary(self, weather_metrics: dict[str, dict]
                                  ) -> dict[str, float]:
        summary: dict[str, float] = {}
        clean_miou = weather_metrics.get('clean', {}).get('mean_iou', 0.0)
        for weather in ADVERSE_WEATHERS:
            if weather in weather_metrics:
                summary[f'robustness_degradation_{weather}'] = (
                    self.compute_robustness_degradation_ratio(
                        clean_miou,
                        weather_metrics[weather].get('mean_iou', 0.0)))
        degradations = [summary[f'robustness_degradation_{w}']
                        for w in ADVERSE_WEATHERS
                        if f'robustness_degradation_{w}' in summary]
        if degradations:
            summary['robustness_degradation_ratio'] = float(
                np.mean(degradations))
        eces = [m.get('expected_calibration_error', 0.0)
                for m in weather_metrics.values()]
        if eces:
            summary['expected_calibration_error'] = float(np.mean(eces))
        aurocs = [m.get('ensemble_disagreement_auroc', 0.5)
                  for m in weather_metrics.values()]
        if aurocs:
            summary['ensemble_disagreement_auroc'] = float(np.mean(aurocs))
        return summary
