"""Training metrics as batched tensor functions ``(y_true, y_pred) ->
scalar``.

Mirrors ``distkeras_tpu/ops/metrics.py``: ``accuracy``,
``top_k_accuracy``, the macro ``precision``/``recall``/``f1`` over a
confusion count (``_prf`` :85) and the rank-statistic ``auc`` (:142),
the registry and ``metric_name``, including the label rule: one-hot
label encodings are FLOATING-point; an integer multi-dim label array
(the ``[B, S]`` targets of an LM) is always read as class ids, never
argmaxed. Where JAX reads the class count of a concrete array on the
host (``_concrete_max`` :75), so does the port: a macro metric on the
card reads its inputs' largest class once a call.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

from distkeras_tpu_torch.ops import losses

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


def _concrete_max(x):
    """``max(x) + 1`` read on the host, or None for an empty vector
    (JAX's ``_concrete_max`` returns None where no value is known)."""
    if x.numel() == 0:
        return None
    return int(x.max()) + 1


def _one_hot(x, k):
    """JAX's ``one_hot`` in float32: a class outside ``[0, k)`` gives an
    all-zero row."""
    return (x.long()[:, None] == torch.arange(k, device=x.device)).float()


def _prf(y_true, y_pred):
    """Macro ``(precision, recall)`` over the classes present in
    ``y_true``, from a confusion count. The class count comes from a
    vector width where there is one, else from the data; labels or
    predictions beyond a vector-implied count raise rather than drop
    out of the average."""
    t, p, k = _class_vectors(y_true, y_pred)
    kt, kp = _concrete_max(t), _concrete_max(p)
    if k is None:  # both plain integer vectors: infer from the data
        if kt is None or kp is None:
            raise ValueError(
                "precision/recall/f1 on two integer class VECTORS cannot "
                "infer the class count of an empty input; pass "
                "logits/one-hot")
        k = max(kt, kp, 2)
    else:
        for nm, kk in (("labels", kt), ("predictions", kp)):
            if kk is not None and kk > k:
                raise ValueError(
                    f"{nm} contain class {kk - 1} but the vector-encoded "
                    f"side only covers {k} classes")
    t1, p1 = _one_hot(t, k), _one_hot(p, k)
    tp = (t1 * p1).sum(0)
    pred_k = p1.sum(0)
    true_k = t1.sum(0)
    prec = tp / pred_k.clamp(min=1.0)
    rec = tp / true_k.clamp(min=1.0)
    # the macro average runs over the classes present in y_true
    present = (true_k > 0).float()
    denom = present.sum().clamp(min=1.0)
    return (prec * present).sum() / denom, (rec * present).sum() / denom


def precision(y_true, y_pred):
    """Macro-averaged precision over the classes present in ``y_true``."""
    return _prf(y_true, y_pred)[0]


def recall(y_true, y_pred):
    """Macro-averaged recall over the classes present in ``y_true``."""
    return _prf(y_true, y_pred)[1]


def f1(y_true, y_pred):
    """Macro F1 (the harmonic mean of the macro precision and recall)."""
    p, r = _prf(y_true, y_pred)
    return 2.0 * p * r / (p + r).clamp(min=1e-12)


def auc(y_true, y_pred):
    """Binary ROC-AUC as the rank statistic (Mann-Whitney U), ties
    counted half. ``y_pred`` is a ``[N]`` score (probability or logit)
    or an ``[N, 2]`` pair (the class-1 margin is used); ``y_true`` 0/1
    labels. A full-dataset metric: batch-wise AUCs of a training history
    are biased toward 0.5 on imbalanced data."""
    y_true = y_true.reshape(-1).float()
    if y_true.shape[0] >= 2 ** 24:
        # float32 rank arithmetic loses integers beyond 2^24
        raise ValueError(
            f"auc supports up to 2^24 rows (got {y_true.shape[0]}); "
            "evaluate on a subsample")
    s = y_pred
    if s.ndim > 1 and s.shape[-1] == 2:
        s = s[..., 1] - s[..., 0]
    s = s.reshape(-1).float()
    # average ranks: a value whose equal group occupies sorted positions
    # lo+1..hi gets the midpoint rank (lo + hi + 1) / 2
    sorted_s = torch.sort(s).values
    lo = torch.searchsorted(sorted_s, s, right=False).float()
    hi = torch.searchsorted(sorted_s, s, right=True).float()
    ranks = (lo + hi + 1.0) / 2.0
    npos = y_true.sum()
    nneg = y_true.shape[0] - npos
    u = (ranks * y_true).sum() - npos * (npos + 1.0) / 2.0
    return torch.where((npos > 0) & (nneg > 0), u / (npos * nneg),
                       torch.full_like(u, 0.5))


METRICS = {
    "accuracy": accuracy,
    "top_5_accuracy": lambda t, p: top_k_accuracy(t, p, 5),
    "mse": losses.mean_squared_error,
    "precision": precision,
    "recall": recall,
    "f1": f1,
    "auc": auc,
}


def metric_name(metric: Union[str, Callable]) -> str:
    """History key of a metric spec."""
    if isinstance(metric, str):
        return metric
    return getattr(metric, "__name__", "metric")


def get_metric(metric: Union[str, Callable]):
    if callable(metric):
        return metric
    try:
        return METRICS[metric]
    except KeyError:
        raise ValueError(f"Unknown metric {metric!r}; known: "
                         f"{sorted(METRICS)}")
