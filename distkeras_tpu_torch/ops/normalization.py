"""BatchNorm's training-mode apply with JAX's two-reduction backward
(mirrors ``distkeras_tpu/ops/normalization.py``).

The forward is ``(x - mean) * rsqrt(var + eps) * scale + offset`` in
float32, cast back to ``x.dtype``; ``mean`` and ``var`` are the batch
moments of ``x``, computed by the caller (``models.layers.BatchNorm``)
and treated as constants here. The backward (JAX ``_bn_bwd`` :64-88)
folds the moments' dependence on ``x`` into ``dx`` in closed form with
two reductions:

    sum_g  = sum(g)            -> d_offset
    sum_gx = sum(g * xhat)     -> d_scale
    dx     = scale * rinv * (g - sum_g / n - xhat * sum_gx / n)

and returns nothing for the moments. ``d_scale``/``d_offset`` are the
local sums. Cross-replica moments (JAX's ``axis_name``) are not ported:
``BatchNorm(axis_name=)`` raises (ROADMAP Queue 1 item 10).

There is no kernel here: JAX computes this in plain XLA, and the port in
plain PyTorch (elementwise launches and two reductions each way).
"""

from __future__ import annotations

from typing import Sequence

import torch


class _BNTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, offset, mean, var, eps, axes):
        rinv = torch.rsqrt(var + eps)
        y = ((x.float() - mean) * (rinv * scale) + offset).to(x.dtype)
        ctx.save_for_backward(x, scale, mean, rinv)
        ctx.axes = axes
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, mean, rinv = ctx.saved_tensors
        axes = ctx.axes
        gf = g.float()
        xhat = (x.float() - mean) * rinv
        sum_g = gf.sum(dim=axes)
        sum_gx = (gf * xhat).sum(dim=axes)
        n = 1
        for a in axes:
            n *= x.shape[a]
        dx = ((scale * rinv) * (gf - sum_g / n - xhat * (sum_gx / n))) \
            .to(x.dtype)
        return dx, sum_gx, sum_g, None, None, None, None


def bn_train_apply(x: torch.Tensor, scale: torch.Tensor,
                   offset: torch.Tensor, mean: torch.Tensor,
                   var: torch.Tensor, eps: float,
                   axes: Sequence[int]) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps) * scale + offset`` in float32, cast
    to ``x.dtype``, with JAX's closed-form backward. ``mean``/``var``
    must be the float32 moments of ``x`` over ``axes``; no gradient flows
    into them."""
    return _BNTrain.apply(x, scale, offset, mean.detach(), var.detach(),
                          float(eps), tuple(int(a) for a in axes))
