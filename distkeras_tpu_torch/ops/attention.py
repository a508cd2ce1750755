"""Attention building blocks: the finite mask value, rotary embeddings
and plain scaled dot-product attention.

Mirrors ``distkeras_tpu/ops/attention.py``. Layout is BSHD
(``[batch, seq, heads, head_dim]``) unless a function says otherwise;
softmax math runs in float32 whatever the input dtype; ``NEG_INF`` is a
large FINITE negative so a fully masked row gives zeros and a finite
log-sum-exp, never NaN.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -0.7 * float(np.finfo(np.float32).max)


def rope_frequencies(head_dim: int, base: float = 10000.0,
                     device=None) -> torch.Tensor:
    """Inverse RoPE frequencies: ``[head_dim // 2]`` float32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (base ** exps)


def apply_rope(x: torch.Tensor, positions=None, base: float = 10000.0,
               layout: str = "bshd", scale: float = 1.0) -> torch.Tensor:
    """Rotary position embedding on a BSHD (default) or BHSD tensor, in
    the INTERLEAVED even/odd form: feature pairs ``(x[2i], x[2i+1])``
    rotate together (not the half-split form).

    ``positions``: ``[S]`` or ``[B, S]`` integer positions (default
    ``0..S-1``); ``scale > 1`` is linear position interpolation."""
    if layout == "bhsd":
        b, h, s, d = x.shape
    else:
        b, s, h, d = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    pos = torch.as_tensor(positions, device=x.device).to(torch.float32)
    if scale != 1.0:
        pos = pos / scale
    if pos.ndim == 1:
        pos = pos[None, :]
    freqs = rope_frequencies(d, base, device=x.device)
    angles = pos[..., None] * freqs                      # [B?, S, D/2]
    if layout == "bhsd":
        cos = torch.cos(angles)[:, None, :, :]
        sin = torch.sin(angles)[:, None, :, :]
    else:
        cos = torch.cos(angles)[:, :, None, :]
        sin = torch.sin(angles)[:, :, None, :]
    x1 = x[..., 0::2].to(torch.float32)
    x2 = x[..., 1::2].to(torch.float32)
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def dot_product_attention(q, k, v, *, causal: bool = False,
                          mask=None, scale: Optional[float] = None,
                          window: Optional[int] = None,
                          segment_ids=None) -> torch.Tensor:
    """Plain attention, BSHD in and out: scores in float32, the finite
    mask, softmax, probabilities cast to V's dtype for the value mix.

    ``segment_ids`` ``[B, S]`` (packed sequences, JAX :43-80) restricts
    attention to positions with EQUAL ids, ANDed with the causal and
    window masks; give padding its own id (e.g. -1) and mask it in the
    loss (``losses.masked_sparse_categorical_crossentropy_from_logits``).
    ``mask``: a boolean tensor broadcastable to the ``[B, H, Sq, Sk]``
    scores, True where attention is allowed, ANDed with the others
    (JAX :79).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qp = torch.arange(q.shape[1], device=q.device)[:, None]
        kp = torch.arange(k.shape[1], device=q.device)[None, :]
        allowed = qp >= kp
        if window is not None:
            allowed = allowed & (kp > qp - window)
        s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
    if segment_ids is not None:
        seg = torch.as_tensor(segment_ids, device=q.device)
        same = seg[:, :, None] == seg[:, None, :]
        s = torch.where(same[:, None], s, torch.full_like(s, NEG_INF))
    if mask is not None:
        allowed = torch.as_tensor(mask, device=q.device).to(torch.bool)
        s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)
