"""Loss functions of the port (Keras-name registry), ``(y_true, y_pred)
-> scalar`` mean over the batch.

Mirrors ``distkeras_tpu/ops/losses.py`` :24-114 and :264-307: the same
names, the ``(y_true, y_pred)`` argument order, ``EPS = 1e-7`` clipping
of probabilities, and elementwise math in float32 whatever the model's
compute dtype (bf16 logits are cast to float32 before ``log_softmax``).
The per-sample forms return ``(loss_per_sample, class_index)`` with the
batch dims of ``y_true`` (``[B]``, or ``[B, S]`` for token-level
models). ``fused_linear_cross_entropy``, ``with_label_smoothing`` and
``with_class_weight`` wait for a later slice.
"""

from __future__ import annotations

from typing import Callable, Union

import torch
import torch.nn.functional as F

EPS = 1e-7

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _ps_categorical(y_true, y_pred):
    p = y_pred.float().clamp(EPS, 1.0 - EPS)
    ls = -(y_true.float() * torch.log(p)).sum(-1)
    return ls, y_true.argmax(-1)


def _ps_categorical_logits(y_true, y_pred):
    logp = F.log_softmax(y_pred.float(), dim=-1)
    ls = -(y_true.float() * logp).sum(-1)
    return ls, y_true.argmax(-1)


def _ps_sparse(y_true, y_pred):
    cls = y_true.long()
    p = y_pred.float().clamp(EPS, 1.0 - EPS)
    ls = -torch.log(p).gather(-1, cls[..., None])[..., 0]
    return ls, cls


def _ps_sparse_logits(y_true, y_pred):
    cls = y_true.long()
    logp = F.log_softmax(y_pred.float(), dim=-1)
    ls = -logp.gather(-1, cls[..., None])[..., 0]
    return ls, cls


def _ps_binary(y_true, y_pred):
    t = y_true.float()
    p = y_pred.float().reshape(t.shape).clamp(EPS, 1.0 - EPS)
    ls = -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))
    return ls, t.long()


def _ps_binary_logits(y_true, y_pred):
    t = y_true.float()
    x = y_pred.float().reshape(t.shape)
    ls = torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-x.abs()))
    return ls, t.long()


def mean_squared_error(y_true, y_pred):
    return (y_pred.float() - y_true.float()).square().mean()


def mean_absolute_error(y_true, y_pred):
    return (y_pred.float() - y_true.float()).abs().mean()


def categorical_crossentropy(y_true, y_pred):
    """One-hot targets vs probability outputs (post-softmax)."""
    return _ps_categorical(y_true, y_pred)[0].mean()


def categorical_crossentropy_from_logits(y_true, y_pred):
    """One-hot targets vs raw logits."""
    return _ps_categorical_logits(y_true, y_pred)[0].mean()


def sparse_categorical_crossentropy(y_true, y_pred):
    """Integer targets vs probability outputs."""
    return _ps_sparse(y_true, y_pred)[0].mean()


def sparse_categorical_crossentropy_from_logits(y_true, y_pred):
    return _ps_sparse_logits(y_true, y_pred)[0].mean()


def masked_sparse_categorical_crossentropy_from_logits(y_true, y_pred):
    """Sparse CE over logits where labels ``< 0`` are ignored; the mean
    runs over the kept positions only."""
    mf = (y_true >= 0).float()
    ls, _ = _ps_sparse_logits(y_true.clamp(min=0), y_pred)
    return (ls * mf).sum() / mf.sum().clamp(min=1.0)


def binary_crossentropy(y_true, y_pred):
    return _ps_binary(y_true, y_pred)[0].mean()


def binary_crossentropy_from_logits(y_true, y_pred):
    return _ps_binary_logits(y_true, y_pred)[0].mean()


def hinge(y_true, y_pred):
    t = y_true.float()
    # 0/1 binary labels become -1/+1 (a tensor select, no host sync)
    is_binary = ((t == 0.0) | (t == 1.0)).all()
    t = torch.where(is_binary, 2.0 * t - 1.0, t)
    return torch.clamp(1.0 - t * y_pred.float(), min=0.0).mean()


LOSSES = {
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error,
    "mean_absolute_error": mean_absolute_error,
    "categorical_crossentropy": categorical_crossentropy,
    "categorical_crossentropy_from_logits":
        categorical_crossentropy_from_logits,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "sparse_categorical_crossentropy_from_logits":
        sparse_categorical_crossentropy_from_logits,
    "masked_sparse_categorical_crossentropy_from_logits":
        masked_sparse_categorical_crossentropy_from_logits,
    "binary_crossentropy": binary_crossentropy,
    "binary_crossentropy_from_logits": binary_crossentropy_from_logits,
    "hinge": hinge,
}


def get_loss(loss: Union[str, LossFn]) -> LossFn:
    if callable(loss):
        return loss
    try:
        return LOSSES[loss]
    except KeyError:
        raise ValueError(f"Unknown loss {loss!r}; known: {sorted(LOSSES)}")
