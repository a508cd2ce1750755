"""Evaluators: a metric over a label column and a prediction column
(mirrors ``distkeras_tpu/inference/evaluators.py``, ``Evaluator`` :21 and
``AccuracyEvaluator`` :37)."""

from __future__ import annotations

from typing import Callable, Union

import torch

from distkeras_tpu_torch.data.dataset import Dataset, coerce_column
from distkeras_tpu_torch.ops.metrics import get_metric


class Evaluator:
    """``evaluate(dataset)``: the metric of ``(label_col,
    prediction_col)`` as a float."""

    def __init__(self, metric: Union[str, Callable],
                 label_col: str = "label",
                 prediction_col: str = "prediction"):
        self.metric = get_metric(metric)
        self.label_col = label_col
        self.prediction_col = prediction_col

    def evaluate(self, dataset: Dataset) -> float:
        y_true = torch.from_numpy(coerce_column(dataset[self.label_col]))
        y_pred = torch.from_numpy(
            coerce_column(dataset[self.prediction_col]))
        return float(self.metric(y_true, y_pred))


class AccuracyEvaluator(Evaluator):
    """Accuracy of the prediction column against the labels."""

    def __init__(self, label_col: str = "label",
                 prediction_col: str = "prediction"):
        super().__init__("accuracy", label_col=label_col,
                         prediction_col=prediction_col)
