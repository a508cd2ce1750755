"""Loss functions of the port (Keras-name registry), ``(y_true, y_pred)
-> scalar`` mean over the batch.

Mirrors ``distkeras_tpu/ops/losses.py``: the same names, the
``(y_true, y_pred)`` argument order, ``EPS = 1e-7`` clipping of
probabilities, and elementwise math in float32 whatever the model's
compute dtype (bf16 logits are cast to float32 before ``log_softmax``).
The per-sample forms return ``(loss_per_sample, class_index)`` with the
batch dims of ``y_true`` (``[B]``, or ``[B, S]`` for token-level
models). ``with_label_smoothing`` (:309) and ``with_class_weight``
(:357) wrap a registry loss by name. ``fused_linear_cross_entropy``
(:202) is the vocab projection fused with a chunked cross-entropy
(``_FusedLinearXent``, JAX's custom VJP ``_fused_linear_xent`` :122):
the ``[N, V]`` logits exist one chunk of tokens at a time. Its products
are ``torch.mm`` in the compute dtype with float32 accumulation (JAX
computes them outside any Pallas kernel with
``preferred_element_type=float32``).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
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


# --- the vocab projection fused with a chunked cross-entropy ----------------

def _mm32(a, b) -> torch.Tensor:
    """``a @ b`` in float32 from operands in the compute dtype: bf16 on
    the card multiplies on the tensor cores with float32 accumulation
    (two bf16 values' product is exact in float32, so only the order of
    the sum differs from the float32 product); anything else is the
    float32 product of the (exactly) widened operands."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _FusedLinearXent(torch.autograd.Function):
    """``mean over labels >= 0 of logsumexp(h @ w) - (h @ w)[label]``
    over ``nc`` equal token chunks. The forward keeps only the per-token
    float32 logsumexp; the backward recomputes each chunk's logits, and
    sums ``dW`` in float32 across chunks (JAX :122-197). Labels below
    zero drop out of the sum and of the mean's denominator."""

    @staticmethod
    def forward(ctx, h, w, labels, nc: int, cdt: torch.dtype):
        c = h.shape[0] // nc
        wc = w.to(cdt)
        total = h.new_zeros((), dtype=torch.float32)
        count = h.new_zeros((), dtype=torch.float32)
        lses = []
        for i in range(nc):
            h_c, l_c = h[i * c:(i + 1) * c], labels[i * c:(i + 1) * c]
            logits = _mm32(h_c.to(cdt), wc)
            m = logits.max(-1).values
            lse = m + torch.log(torch.exp(logits - m[:, None]).sum(-1))
            tl = logits.gather(1, l_c.clamp(min=0)[:, None])[:, 0]
            mask = (l_c >= 0).float()
            total = total + ((lse - tl) * mask).sum()
            count = count + mask.sum()
            lses.append(lse)
        count = count.clamp(min=1.0)
        ctx.save_for_backward(h, w, labels, torch.cat(lses), count)
        ctx.nc, ctx.cdt = nc, cdt
        return total / count

    @staticmethod
    def backward(ctx, gbar):
        h, w, labels, lse, count = ctx.saved_tensors
        nc, cdt = ctx.nc, ctx.cdt
        c = h.shape[0] // nc
        wc = w.to(cdt)
        gscale = gbar.float() / count
        dk = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dhs = []
        for i in range(nc):
            h_c = h[i * c:(i + 1) * c].to(cdt)
            l_c = labels[i * c:(i + 1) * c]
            logits = _mm32(h_c, wc)
            p = torch.exp(logits - lse[i * c:(i + 1) * c, None])
            g_tok = gscale * (l_c >= 0).float()
            dlog = p * g_tok[:, None]
            # one add into one distinct position a row: deterministic
            dlog.scatter_add_(1, l_c.clamp(min=0)[:, None], -g_tok[:, None])
            dlog_c = dlog.to(cdt)
            dhs.append(_mm32(dlog_c, wc.t()))
            dk += _mm32(h_c.t(), dlog_c)
        d_h = torch.cat(dhs).to(h.dtype)
        return d_h, dk.to(w.dtype), None, None, None


def fused_linear_cross_entropy(hidden, kernel, y_true, *,
                               num_chunks: int = 8,
                               ignore_index: Optional[int] = None,
                               compute_dtype=None):
    """Softmax cross-entropy fused with the final vocab projection,
    chunked over tokens with the logits recomputed in the backward (JAX
    :202): ``hidden [..., d]`` and ``kernel [d, V]`` give the mean
    cross-entropy of the labels ``y_true [...]`` without the whole
    ``[N, V]`` logits tensor. ``ignore_index`` (a negative sentinel, or
    None) turns on the masked contract: every label ``< 0`` drops out of
    the sum and the mean's denominator (with None, labels must be valid
    class ids; a negative one is dropped, not clamped). The products run
    in ``compute_dtype`` (default: ``hidden``'s floating dtype, else
    bf16) with float32 accumulation. A token count that ``num_chunks``
    does not divide is zero-padded up to a multiple with label -1."""
    if ignore_index is not None and ignore_index >= 0:
        raise ValueError(
            f"ignore_index must be a negative sentinel (labels < 0 are "
            f"ignored) or None, got {ignore_index}")
    d = hidden.shape[-1]
    h = hidden.reshape(-1, d)
    labels = y_true.reshape(-1).long()
    n = h.shape[0]
    nc = max(1, min(int(num_chunks), n))
    pad = (-n) % nc
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    if compute_dtype is None:
        compute_dtype = hidden.dtype if hidden.is_floating_point() \
            else torch.bfloat16
    from distkeras_tpu_torch.models.core import torch_dtype
    return _FusedLinearXent.apply(h, kernel, labels, nc,
                                  torch_dtype(compute_dtype))


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


def with_label_smoothing(loss: Union[str, LossFn],
                         label_smoothing: float) -> LossFn:
    """Keras ``label_smoothing`` for the categorical crossentropies (JAX
    :309): the target distribution becomes ``y * (1 - s) + s / K``
    (integer targets are one-hot expanded first)."""
    s = float(label_smoothing)
    if not 0.0 <= s < 1.0:
        raise ValueError(f"label_smoothing must be in [0, 1), got {s}")
    smoothable = {
        "categorical_crossentropy": _ps_categorical,
        "categorical_crossentropy_from_logits": _ps_categorical_logits,
        "sparse_categorical_crossentropy": _ps_categorical,
        "sparse_categorical_crossentropy_from_logits":
            _ps_categorical_logits,
    }
    if not isinstance(loss, str) or loss not in smoothable:
        raise ValueError(
            f"label_smoothing needs a categorical crossentropy name, one "
            f"of {sorted(smoothable)}; got {loss!r}")
    per_sample = smoothable[loss]
    sparse = loss.startswith("sparse")

    def fn(y_true, y_pred):
        k = y_pred.shape[-1]
        if sparse:
            # JAX's one_hot: an out-of-range id is an all-zero row
            y_true = (y_true.long()[..., None] == torch.arange(
                k, device=y_true.device))
        y_true = y_true.float() * (1.0 - s) + s / k
        return per_sample(y_true, y_pred)[0].mean()

    fn.__name__ = f"{loss}_smoothed_{s}"
    return fn


_PER_SAMPLE = {
    "categorical_crossentropy": _ps_categorical,
    "categorical_crossentropy_from_logits": _ps_categorical_logits,
    "sparse_categorical_crossentropy": _ps_sparse,
    "sparse_categorical_crossentropy_from_logits": _ps_sparse_logits,
    "binary_crossentropy": _ps_binary,
    "binary_crossentropy_from_logits": _ps_binary_logits,
}


def with_class_weight(loss: Union[str, LossFn], class_weight) -> LossFn:
    """Keras ``class_weight`` (JAX :357): each sample's loss scaled by
    the weight of its TRUE class, then the mean. ``class_weight`` is
    ``{class: weight}`` (unlisted classes weigh 1.0) or a dense weight
    array indexed by class. Classification registry losses only."""
    if not isinstance(loss, str) or loss not in _PER_SAMPLE:
        raise ValueError(
            f"class_weight needs a classification loss name, one of "
            f"{sorted(_PER_SAMPLE)}; got {loss!r}")
    if isinstance(class_weight, dict):
        idx = np.asarray([int(k) for k in class_weight], np.int64)
        vals = np.asarray([float(class_weight[k]) for k in class_weight],
                          np.float32)
        if (idx < 0).any():
            raise ValueError(f"negative class in class_weight: {idx.min()}")
        dense = None
    else:
        dense = np.asarray(class_weight, np.float32)
    per_sample = _PER_SAMPLE[loss]
    binary = loss.startswith("binary")

    def fn(y_true, y_pred):
        ls, cls = per_sample(y_true, y_pred)
        # the table is sized from the class count the loss sees, so an
        # out-of-table class never clamps onto a neighbour's weight
        n = 2 if binary else y_pred.shape[-1]
        if dense is not None:
            if len(dense) != n:
                raise ValueError(
                    f"class_weight array has {len(dense)} entries but the "
                    f"loss sees {n} classes")
            tbl = dense
        else:
            if idx.size and idx.max() >= n:
                raise ValueError(
                    f"class_weight has class {idx.max()} but the loss "
                    f"sees only {n} classes")
            tbl = np.ones((n,), np.float32)
            tbl[idx] = vals
        tbl = torch.from_numpy(tbl).to(ls.device)
        return (ls * tbl[cls]).mean()

    fn.__name__ = f"{loss}_class_weighted"
    return fn
