"""Flash-attention forward: the hand-written CUDA kernel
(``csrc/flash_fwd.cu``) and its plain PyTorch version.

Replaces ``distkeras_tpu/ops/flash_attention.py`` ``_flash_forward``
(the ``pl.pallas_call`` at :321, body ``_fwd_kernel`` :125) on the
serving path: the one-pass prompt prefill and both passes of a chunked
prefill (the causal diagonal and the non-causal pass over the cache
prefix, which needs the log-sum-exp). Training's backward kernels and
``segment_ids`` are not part of this slice.

``flash_forward`` takes q ``[B, Sq, H, D]`` and k/v ``[B, Sk, Hkv, D]``
(``layout="bshd"``) or the head-major ``[B, H, S, D]``
(``layout="bhsd"``); ``H`` must be a multiple of ``Hkv`` (grouped
queries read their shared K/V head directly, nothing is expanded). It
returns ``out`` in q's layout and dtype and ``lse`` ``[B, H, Sq]``
float32. A CPU tensor goes to ``flash_forward_reference``; a CUDA
tensor goes to the kernel or raises.

Numerics shared by both versions: scores in float32 from the stored
dtype, the finite ``NEG_INF`` mask (a fully masked row gives a finite
lse near ``NEG_INF``, never NaN), unnormalised probabilities cast to V's
dtype before the value product, the row sum kept in float32.
"""

from __future__ import annotations

from typing import Optional

import torch

from distkeras_tpu_torch import kernels
from distkeras_tpu_torch.ops.attention import NEG_INF

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is instantiated for
KERNEL_HEAD_DIMS = (32, 64, 128)


def _heads_major(x: torch.Tensor, layout: str) -> torch.Tensor:
    return x.transpose(1, 2) if layout == "bshd" else x


def _check(q, k, v, causal: bool, window, layout: str):
    if layout not in ("bshd", "bhsd"):
        raise ValueError(f"layout must be 'bshd' or 'bhsd', got {layout!r}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k and v must be 4-D")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError("q, k, v must share one dtype: float32 or bfloat16 "
                        f"(got {q.dtype}, {k.dtype}, {v.dtype})")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    qh, kh = _heads_major(q, layout), _heads_major(k, layout)
    b, h, sq, d = qh.shape
    if kh.shape[0] != b or kh.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch or head_dim")
    if h % kh.shape[1]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{kh.shape[1]} kv heads")
    if causal and sq != kh.shape[2]:
        # the kernel puts query 0 at key position 0; every causal call of
        # the serving path is square, so no other origin is supported
        raise ValueError(f"causal attention needs Sq == Sk, got {sq} "
                         f"and {kh.shape[2]}")
    if window is not None and (not causal or int(window) < 1):
        raise ValueError("window must be >= 1 and requires causal=True")


def flash_forward(q, k, v, *, scale: float, causal: bool,
                  window: Optional[int] = None, layout: str = "bshd"):
    """Blockwise online-softmax attention; returns ``(out, lse)``."""
    _check(q, k, v, causal, window, layout)
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, scale=scale, causal=causal,
                                       window=window, layout=layout)
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward runs on cuda or cpu tensors, "
                         f"got {q.device}")
    return _launch(q, k, v, float(scale), bool(causal), window, layout)


def _launch(q, k, v, scale, causal, window, layout):
    qh, kh, vh = (_heads_major(x, layout) for x in (q, k, v))
    b, h, sq, d = qh.shape
    hkv, sk = kh.shape[1], kh.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel supports head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along head_dim")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    oh = _heads_major(out, layout)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if sq == 0:
        return out, lse
    strides = []
    for x in (qh, kh, vh, oh):            # (batch, seq, head) element strides
        strides += [x.stride(0), x.stride(2), x.stride(1)]
    lib = kernels.library("flash_fwd")
    err = lib.dkt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _DTYPES[q.dtype], b, h, h // hkv, sq, sk, d,
        *strides, scale, int(causal), 0 if window is None else int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(lib, err, "flash_fwd")
    kernels.count_launch("flash_fwd")
    return out, lse


def flash_forward_reference(q, k, v, *, scale: float, causal: bool,
                            window: Optional[int] = None,
                            layout: str = "bshd"):
    """The plain PyTorch version of the kernel: the whole masked score
    matrix at once, same masks and rounding points."""
    _check(q, k, v, causal, window, layout)
    qh, kh, vh = (_heads_major(x, layout) for x in (q, k, v))
    g = qh.shape[1] // kh.shape[1]
    if g > 1:
        kh = kh.repeat_interleave(g, dim=1)
        vh = vh.repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) * scale
    sq, sk = s.shape[-2], s.shape[-1]
    if causal:
        qp = torch.arange(sq, device=q.device)[:, None]
        kp = torch.arange(sk, device=q.device)[None, :]
        allowed = kp <= qp
        if window is not None:
            allowed = allowed & (kp > qp - int(window))
        s = s.masked_fill(~allowed, NEG_INF)
    if sk == 0:
        m = torch.full(s.shape[:-1] + (1,), NEG_INF, device=q.device)
    else:
        m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhqk,bhkd->bhqd", e.to(v.dtype).float(),
                     vh.float()) / l
    lse = (m + torch.log(l))[..., 0]
    out = o.transpose(1, 2) if layout == "bshd" else o
    return out.to(q.dtype).contiguous(), lse
