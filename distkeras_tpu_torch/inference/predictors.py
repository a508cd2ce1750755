"""Predictors: batched inference that appends a prediction column
(mirrors ``distkeras_tpu/inference/predictors.py``, ``Predictor`` :29 and
``ModelPredictor`` :118).

``Predictor.predict(dataset)`` returns the dataset with the model's
eval-mode output (with the running statistics) appended as
``output_col``, float32 (JAX's ``user_float``). The port runs on the
model's one device: a batch is ``batch_size_per_device`` rows, the last
one zero-padded to that size so every forward has one shape. JAX shards
the batch over a mesh and can shard the weights (``mesh=``,
``tp_axis=``, ``ep_axis=``); those raise here (ROADMAP Queue 1 item 10).
``StreamingPredictor`` needs the prefetcher of ``utils/prefetch`` and
waits with it (item 11).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from distkeras_tpu_torch.data.dataset import Dataset, coerce_column
from distkeras_tpu_torch.models.core import Model, eval_mode, user_float

#: the multi-device ROADMAP item, named in errors
MESH_ITEM = ("ROADMAP, Queue 1 item 10 (a mesh of cards: batch and "
             "weight sharding)")


class Predictor:
    """Batched inference on the model's device (JAX :29): ``predict(
    dataset)`` returns the dataset with ``output_col`` appended."""

    def __init__(self, keras_model: Model, features_col: str = "features",
                 output_col: str = "prediction",
                 batch_size_per_device: int = 128, mesh=None,
                 tp_axis: Optional[str] = None,
                 ep_axis: Optional[str] = None):
        for name, given in (("mesh", mesh), ("tp_axis", tp_axis),
                            ("ep_axis", ep_axis)):
            if given is not None:
                raise NotImplementedError(
                    f"Predictor({name}=) is not ported yet (the port "
                    f"predicts on one card): {MESH_ITEM}")
        self.model = keras_model
        self.features_col = features_col
        self.output_col = output_col
        self.batch_size_per_device = int(batch_size_per_device)

    # the one shared dtype policy (training and inference agree)
    _coerce = staticmethod(coerce_column)

    @staticmethod
    def _pad_to(xb: np.ndarray, size: int):
        """Zero-pad the batch axis to ``size``; returns ``(padded,
        pad)``."""
        pad = size - len(xb)
        if pad:
            xb = np.concatenate(
                [xb, np.zeros((pad,) + xb.shape[1:], xb.dtype)])
        return xb, pad

    @torch.no_grad()
    def predict(self, dataset: Dataset) -> Dataset:
        model = self.model
        X = self._coerce(dataset[self.features_col])
        b = self.batch_size_per_device
        params = model.params
        outs = []
        with eval_mode(model.module):
            for i in range(0, len(X), b):
                xb, pad = self._pad_to(X[i:i + b], b)
                y = model.module.apply(
                    params, torch.from_numpy(xb).to(model.device))
                y = user_float(y).cpu().numpy()
                outs.append(y[:b - pad] if pad else y)
        return dataset.with_column(self.output_col,
                                   np.concatenate(outs, axis=0))


class ModelPredictor(Predictor):
    """``Predictor`` with a user-named output column (JAX :118), a class
    of its own so that reference code ports one to one."""

    def __init__(self, keras_model: Model, features_col: str = "features",
                 output_col: str = "prediction", **kwargs):
        super().__init__(keras_model, features_col=features_col,
                         output_col=output_col, **kwargs)
