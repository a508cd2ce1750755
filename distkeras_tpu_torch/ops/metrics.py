"""Training metrics as batched tensor functions ``(y_true, y_pred) ->
scalar``.

Mirrors ``distkeras_tpu/ops/metrics.py`` :19-72 and :184-209
(``accuracy``, ``top_k_accuracy``, the registry and ``metric_name``),
including its label rule: one-hot label encodings are FLOATING-point;
an integer multi-dim label array (the ``[B, S]`` targets of an LM) is
always read as class ids, never argmaxed. ``precision``, ``recall``,
``f1`` and ``auc`` wait for a later slice.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

from distkeras_tpu_torch.ops import losses

_LATER = ("precision", "recall", "f1", "auc")


def _class_vectors(y_true, y_pred):
    """Flat integer class vectors ``(t, p, k)`` from one-hot or integer
    labels and probability/logit vectors, sigmoid scores or integer
    predictions; ``k`` is the class count a vector width implies, or
    None. Binary float scores are thresholded at 0.5 when every value
    lies in [0, 1] (probabilities) and at 0.0 otherwise (logits)."""
    k = None
    if y_pred.ndim > 1 and y_pred.shape[-1] > 1:
        k = y_pred.shape[-1]
        y_pred = y_pred.argmax(-1)
    elif y_pred.is_floating_point():
        k = 2
        is_prob = ((y_pred >= 0.0) & (y_pred <= 1.0)).all()
        y_pred = y_pred >= torch.where(is_prob, 0.5, 0.0)
    if y_true.ndim > 1 and y_true.shape[-1] > 1 and \
            y_true.is_floating_point():
        k = max(k or 0, y_true.shape[-1])
        y_true = y_true.argmax(-1)
    return (y_true.reshape(-1).to(torch.int32),
            y_pred.reshape(-1).to(torch.int32), k)


def accuracy(y_true, y_pred):
    """Classification accuracy (see ``_class_vectors`` for the accepted
    shapes and encodings)."""
    t, p, _ = _class_vectors(y_true, y_pred)
    return (p == t).float().mean()


def top_k_accuracy(y_true, y_pred, k: int = 5):
    # the one-hot rule of _class_vectors: floating labels only
    if y_true.ndim > 1 and y_true.shape[-1] > 1 and \
            y_true.is_floating_point():
        y_true = y_true.argmax(-1)
    # a stable ascending sort, as jnp.argsort: among tied scores the
    # later indices land in the top k
    topk = torch.argsort(y_pred, dim=-1, stable=True)[..., -k:]
    hit = (topk == y_true[..., None].to(topk.dtype)).any(-1)
    return hit.float().mean()


METRICS = {
    "accuracy": accuracy,
    "top_5_accuracy": lambda t, p: top_k_accuracy(t, p, 5),
    "mse": losses.mean_squared_error,
}


def metric_name(metric: Union[str, Callable]) -> str:
    """History key of a metric spec."""
    if isinstance(metric, str):
        return metric
    return getattr(metric, "__name__", "metric")


def get_metric(metric: Union[str, Callable]):
    if callable(metric):
        return metric
    if metric in _LATER:
        raise NotImplementedError(
            f"metric {metric!r} is not ported yet: ROADMAP, Queue 1 item "
            "'training: the rest of the Trainer surface'")
    try:
        return METRICS[metric]
    except KeyError:
        raise ValueError(f"Unknown metric {metric!r}; known: "
                         f"{sorted(METRICS)}")
