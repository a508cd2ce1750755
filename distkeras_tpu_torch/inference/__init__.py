"""Inference of the port: batched predictors that append a prediction
column (``predictors``) and offline evaluators over dataset columns
(``evaluators``)."""

from distkeras_tpu_torch.inference.evaluators import (AccuracyEvaluator,
                                                      Evaluator)
from distkeras_tpu_torch.inference.predictors import (ModelPredictor,
                                                      Predictor,
                                                      StreamingPredictor)

__all__ = ["AccuracyEvaluator", "Evaluator", "ModelPredictor", "Predictor",
           "StreamingPredictor"]
