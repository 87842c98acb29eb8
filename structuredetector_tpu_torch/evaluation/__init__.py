"""Detection metrics."""

from .evaluator import Evaluation, Evaluations, Evaluator

__all__ = ["Evaluation", "Evaluations", "Evaluator"]
