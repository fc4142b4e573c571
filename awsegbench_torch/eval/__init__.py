"""Evaluation: the robustness sweep, its report and the benchmark's eval
step."""

from .evaluator import Evaluator, generate_evaluation_report

__all__ = ["Evaluator", "generate_evaluation_report"]
