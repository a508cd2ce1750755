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
``StreamingPredictor`` (JAX :129) predicts an unbounded stream of
batches: a ``utils.prefetch.Prefetcher`` pads the next batch and stages
it on the device (pinned, non-blocking) while the current one computes.
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


class StreamingPredictor(Predictor):
    """Inference over an unbounded stream of batches (JAX :129; the
    reference's Kafka streaming example without the transport): each
    batch is zero-padded to ``batch_size``, so every forward has one
    shape, and a background thread stages the next batch on the device
    while the current one computes. ``predict_stream(source)`` yields
    one output array per input batch, in order."""

    def __init__(self, keras_model: Model, batch_size: int = 256,
                 mesh=None, **kwargs):
        super().__init__(keras_model, mesh=mesh,
                         batch_size_per_device=batch_size, **kwargs)
        self.batch_size = int(batch_size)

    def predict_stream(self, source):
        """``source``: a lazy iterable of ``[n_i, ...]`` feature arrays
        (``n_i <= batch_size``), consumed one batch at a time on the
        staging thread. Yields ``[n_i, ...]`` float32 predictions in
        order. A source or size error re-raises here with its own type;
        closing the generator early ends the staging thread without
        dropping results already staged."""
        from distkeras_tpu_torch.utils.prefetch import Prefetcher, to_device
        model = self.model
        params = model.params

        def stage(batch):
            xb = self._coerce(batch)
            if len(xb) > self.batch_size:
                raise ValueError(
                    f"stream batch of {len(xb)} exceeds "
                    f"batch_size {self.batch_size}")
            return self._pad_to(xb, self.batch_size)

        def place(item):
            xb, pad = item
            return to_device(xb, model.device), pad

        pf = Prefetcher(stage, source, depth=2, name="predict_stream",
                        place=place)
        # the staging thread, for callers that check it ended
        self._stage_thread = pf._thread
        with pf:
            for _, (xb, pad) in pf:
                with torch.no_grad(), eval_mode(model.module):
                    y = user_float(model.module.apply(params, xb))
                y = y.cpu().numpy()
                yield y[:self.batch_size - pad] if pad else y
