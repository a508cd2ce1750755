"""Predictors: batched inference that appends a prediction column
(mirrors ``distkeras_tpu/inference/predictors.py``, ``Predictor`` :29 and
``ModelPredictor`` :118).

``Predictor.predict(dataset)`` returns the dataset with the model's
eval-mode output (with the running statistics) appended as
``output_col``, float32 (JAX's ``user_float``). Without a mesh the port
runs on the model's one device: a batch is ``batch_size_per_device``
rows, the last one zero-padded to that size so every forward has one
shape. With ``mesh=`` (a ``parallel.mesh.Mesh`` over the ranks of a
world; every rank calls ``predict`` with the same dataset) the batch of
``batch_size_per_device`` rows per index of the mesh's FIRST axis is
sharded over that axis, each rank predicts its rows, and the rows are
gathered, so every rank returns the whole column; ``tp_axis``/
``ep_axis`` shard the weights by the SPMD trainer's rules
(``parallel.sharding``) instead of replicating them.
``StreamingPredictor`` (JAX :129) predicts an unbounded stream of
batches: a ``utils.prefetch.Prefetcher`` pads the next batch and stages
it on the device (pinned, non-blocking) while the current one computes;
with ``mesh=`` the batch size must divide over the first axis (JAX
:146-157).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from distkeras_tpu_torch.data.dataset import Dataset, coerce_column
from distkeras_tpu_torch.models.core import Model, eval_mode, user_float


class Predictor:
    """Batched inference (JAX :29): ``predict(dataset)`` returns the
    dataset with ``output_col`` appended. ``tp_axis``/``ep_axis`` shard
    the model's params over those axes of ``mesh`` (the SPMD trainer's
    rules) instead of replicating them (without a mesh there is nothing
    to shard over); the batch is sharded over the mesh's FIRST axis
    either way."""

    def __init__(self, keras_model: Model, features_col: str = "features",
                 output_col: str = "prediction",
                 batch_size_per_device: int = 128, mesh=None,
                 tp_axis: Optional[str] = None,
                 ep_axis: Optional[str] = None):
        self.model = keras_model
        self.features_col = features_col
        self.output_col = output_col
        self.batch_size_per_device = int(batch_size_per_device)
        self.mesh = mesh
        self.tp_axis = tp_axis
        self.ep_axis = ep_axis
        self._sharded = None

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

    def _global_batch(self) -> int:
        if self.mesh is None:
            return self.batch_size_per_device
        return self.batch_size_per_device \
            * self.mesh.shape[self.mesh.axis_names[0]]

    def _forward_fn(self):
        """``fwd(xb [global batch, ...] on the device) -> output``: the
        model's eval forward, on this rank's rows under a mesh."""
        model = self.model
        if self.mesh is None:
            params = model.params

            def fwd(xb):
                with eval_mode(model.module):
                    return model.module.apply(params, xb)
            return fwd
        if self._sharded is None:
            from distkeras_tpu_torch.parallel.sharding import (
                Placement, param_specs, shard_params, use_plan)
            from distkeras_tpu_torch.utils.tree import tree_leaves
            mesh = self.mesh
            specs = param_specs(model.module, model.params, mesh,
                                tp_axis=self.tp_axis, ep_axis=self.ep_axis)
            local = shard_params(model.params, specs, mesh)
            placement = Placement(mesh, self.tp_axis,
                                  (mesh.axis_names[0],))
            plan = use_plan(model.module, specs, tree_leaves(local),
                            placement)
            self._sharded = (local, placement, plan)
        local, placement, plan = self._sharded

        def fwd(xb):
            from distkeras_tpu_torch.parallel.sharding import (gather_rows,
                                                               placed,
                                                               use_params)
            from distkeras_tpu_torch.utils.tree import (tree_leaves,
                                                        tree_unflatten)
            row, rows = placement.data_block()
            n = xb.shape[0] // rows
            with placed(placement), eval_mode(model.module):
                use = tree_unflatten(local, use_params(plan,
                                                       tree_leaves(local)))
                y = model.module.apply(use, xb[row * n:(row + 1) * n])
                return gather_rows(y)
        return fwd

    @torch.no_grad()
    def predict(self, dataset: Dataset) -> Dataset:
        model = self.model
        X = self._coerce(dataset[self.features_col])
        b = self._global_batch()
        fwd = self._forward_fn()
        outs = []
        for i in range(0, len(X), b):
            xb, pad = self._pad_to(X[i:i + b], b)
            y = fwd(torch.from_numpy(xb).to(model.device))
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
    one output array per input batch, in order. With ``mesh=`` the
    batch shards over the mesh's first axis, which must divide it."""

    def __init__(self, keras_model: Model, batch_size: int = 256,
                 mesh=None, **kwargs):
        n_batch = 1
        if mesh is not None:
            # batch shards over the FIRST mesh axis only (same semantics
            # as Predictor.predict); other axes hold tp/ep shards
            n_batch = mesh.shape[mesh.axis_names[0]]
            if batch_size % n_batch:
                raise ValueError(
                    f"batch_size {batch_size} must divide over the "
                    f"{mesh.axis_names[0]!r} axis ({n_batch})")
        super().__init__(keras_model, mesh=mesh,
                         batch_size_per_device=batch_size // n_batch,
                         **kwargs)
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
        fwd = self._forward_fn()

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
                with torch.no_grad():
                    y = user_float(fwd(xb))
                y = y.cpu().numpy()
                yield y[:self.batch_size - pad] if pad else y
