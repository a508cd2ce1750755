"""Flash attention: the hand-written CUDA kernels (forward,
``csrc/flash_fwd.cu``; backward dq and dk/dv, ``csrc/flash_bwd.cu``),
their plain PyTorch versions and the differentiable ``flash_attention``.

Replaces ``distkeras_tpu/ops/flash_attention.py``: ``_flash_forward``
(the ``pl.pallas_call`` at :321, body ``_fwd_kernel`` :125) on the
serving path (the one-pass prompt prefill and both passes of a chunked
prefill: the causal diagonal and the non-causal pass over the cache
prefix, which needs the log-sum-exp) and in training; and
``_flash_backward_pallas`` :515 (dq at :585, body ``_bwd_dq_kernel``
:349; dk/dv at :619, body ``_bwd_dkv_kernel`` :440) behind the
``torch.autograd.Function`` that mirrors the JAX ``custom_vjp``
(``_flash_fwd_rule`` :714, ``_flash_bwd_rule`` :721).

``segment_ids`` ``[B, S]`` (packed sequences; any integer dtype, cast
to int32) restrict attention to pairs with equal ids, ANDed with the
causal and window masks, in the forward and both backward kernels
(``_fwd_kernel`` :188-189, ``_bwd_dq_kernel._mask`` :386-387,
``_bwd_dkv_kernel._mask`` :480-481). Ids compare by equality only: they
need not be sorted or contiguous, and -1 is an ordinary id (pad tokens
labelled -1 attend to each other, as in JAX; the loss masks them). With
ids, Sq must equal Sk (one id per position, as JAX's ``_seg_blocks``
pads one array to both lengths). All-equal ids give bitwise the result
of no ids. ``kv_segment_ids`` ``[B, Sk]`` are the KEY side's ids when
they differ from the queries' (a ring-attention hop attends a shard's
queries to another shard's keys, whose ids travel with them): pairs
are admitted where ``segment_ids[b, q] == kv_segment_ids[b, k]``. They
default to ``segment_ids``, so every call without them is unchanged
bitwise; the kernels read the two through separate pointers.

``flash_forward`` takes q ``[B, Sq, H, D]`` and k/v ``[B, Sk, Hkv, D]``
(``layout="bshd"``) or the head-major ``[B, H, S, D]``
(``layout="bhsd"``); ``H`` must be a multiple of ``Hkv`` (grouped
queries read their shared K/V head directly, nothing is expanded; the
dk/dv kernel sums each group's gradient itself). It returns ``out`` in
q's layout and dtype and ``lse`` ``[B, H, Sq]`` float32. A CPU tensor
goes to the plain version; a CUDA tensor goes to the kernel or raises.

Numerics shared by the kernels and their plain versions: scores in
float32 from the stored dtype, the finite ``NEG_INF`` mask (a fully
masked row gives a finite lse near ``NEG_INF``, never NaN),
unnormalised probabilities cast to V's dtype before the value product,
the row sum kept in float32; in the backward, ``delta = rowsum(dO*O)``
in float32 and the Pallas kernels' rounding points (``dS`` cast to k's
dtype before ``dS.K`` and to q's before ``dS^T.Q``, ``P`` to dO's before
``P^T.dO``).

The forward and backward kernels in bf16 at head_dim 64 and 128 run
their products on Hopper's tensor cores (``wgmma``, operands brought by
TMA into a ring of shared-memory stages, the P and dS tiles fed from
registers) and take the exp as ``exp2`` of a prescaled argument (a few
float32 ulps from ``torch.exp``, far below the bf16 rounding of P);
float32, and bf16 at head_dim 32, keep CUDA-core kernels. None adds
atomically: the same inputs give the same bits (``csrc/flash_fwd.cu``
and ``csrc/flash_bwd.cu`` have the designs).
"""

from __future__ import annotations

from typing import Optional

import torch

from distkeras_tpu_torch import kernels
from distkeras_tpu_torch.ops.attention import NEG_INF

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is instantiated for
KERNEL_HEAD_DIMS = (8, 12, 16, 32, 64, 128)


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


def _segments(segment_ids, q, k, layout, kv_segment_ids=None):
    """The ids as the int32 contiguous ``[B, S]`` tensors the kernels and
    plain versions read: ``(q-side, k-side)``, the k side None when it
    is the q side (None stays None)."""
    seg = _segment_side(segment_ids, q, k, layout)
    if kv_segment_ids is None:
        return seg, None
    if seg is None:
        raise ValueError("kv_segment_ids need segment_ids (the query "
                         "side's ids)")
    return seg, _segment_side(kv_segment_ids, q, k, layout)


def _segment_side(segment_ids, q, k, layout):
    if segment_ids is None:
        return None
    seg = torch.as_tensor(segment_ids)
    if seg.dtype.is_floating_point or seg.dtype.is_complex \
            or seg.dtype == torch.bool:
        raise TypeError(f"segment_ids must be integers, got {seg.dtype}")
    qh, kh = _heads_major(q, layout), _heads_major(k, layout)
    b, sq, sk = qh.shape[0], qh.shape[2], kh.shape[2]
    if tuple(seg.shape) != (b, sq):
        raise ValueError(f"segment_ids must be [B, Sq] = [{b}, {sq}], got "
                         f"{tuple(seg.shape)}")
    if sq != sk:
        raise ValueError(f"segment_ids need Sq == Sk (one id per "
                         f"position), got {sq} and {sk}")
    if seg.device != q.device:
        raise ValueError(f"segment_ids on {seg.device}, q on {q.device}")
    return seg.to(torch.int32).contiguous()


def _seg_args(seg, kv_seg=None):
    """The kernels' q-side and k-side id pointers (null without ids) and
    their batch stride (both ``[B, S]`` contiguous, Sq == Sk): one array
    serves both sides unless the k side has its own."""
    if seg is None:
        return [None, None, 0]
    kv = seg if kv_seg is None else kv_seg
    return [seg.data_ptr(), kv.data_ptr(), seg.stride(0)]


def _allowed(sq, sk, causal, window, seg, device, kv_seg=None):
    """The admitted (query, key) pairs, broadcastable to ``[B, H, Sq,
    Sk]``, or None when every pair is admitted."""
    allowed = None
    if causal:
        qp = torch.arange(sq, device=device)[:, None]
        kp = torch.arange(sk, device=device)[None, :]
        allowed = kp <= qp
        if window is not None:
            allowed = allowed & (kp > qp - int(window))
    if seg is not None:
        kv = seg if kv_seg is None else kv_seg
        same = (seg[:, :, None] == kv[:, None, :])[:, None]
        allowed = same if allowed is None else allowed & same
    return allowed


def flash_forward(q, k, v, *, scale: float, causal: bool,
                  window: Optional[int] = None, layout: str = "bshd",
                  segment_ids=None, kv_segment_ids=None):
    """Blockwise online-softmax attention; returns ``(out, lse)``."""
    _check(q, k, v, causal, window, layout)
    seg, kv_seg = _segments(segment_ids, q, k, layout, kv_segment_ids)
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, scale=scale, causal=causal,
                                       window=window, layout=layout,
                                       segment_ids=seg,
                                       kv_segment_ids=kv_seg)
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward runs on cuda or cpu tensors, "
                         f"got {q.device}")
    return _launch(q, k, v, float(scale), bool(causal), window, layout, seg,
                   kv_seg)


def _launch(q, k, v, scale, causal, window, layout, seg, kv_seg=None):
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
        *_seg_args(seg, kv_seg),
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(lib, err, "flash_fwd")
    kernels.count_launch("flash_fwd")
    return out, lse


def flash_forward_reference(q, k, v, *, scale: float, causal: bool,
                            window: Optional[int] = None,
                            layout: str = "bshd", segment_ids=None,
                            kv_segment_ids=None):
    """The plain PyTorch version of the kernel: the whole masked score
    matrix at once, same masks and rounding points."""
    _check(q, k, v, causal, window, layout)
    seg, kv_seg = _segments(segment_ids, q, k, layout, kv_segment_ids)
    qh, kh, vh = (_heads_major(x, layout) for x in (q, k, v))
    g = qh.shape[1] // kh.shape[1]
    if g > 1:
        kh = kh.repeat_interleave(g, dim=1)
        vh = vh.repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) * scale
    sq, sk = s.shape[-2], s.shape[-1]
    allowed = _allowed(sq, sk, causal, window, seg, q.device, kv_seg)
    if allowed is not None:
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


def _check_backward(q, out, lse, dout, delta, layout):
    qh = _heads_major(q, layout)
    b, h, sq, _ = qh.shape
    for name, x in (("out", out), ("dout", dout)):
        if x.shape != q.shape or x.device != q.device:
            raise ValueError(f"{name} {tuple(x.shape)} must match q "
                             f"{tuple(q.shape)} on {q.device}")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != (b, h, sq) or x.dtype != torch.float32 \
                or x.device != q.device:
            raise ValueError(f"{name} must be float32 [{b}, {h}, {sq}] on "
                             f"{q.device}, got {x.dtype} {tuple(x.shape)}")


def flash_backward(q, k, v, out, lse, dout, delta, *, scale: float,
                   causal: bool, window: Optional[int] = None,
                   layout: str = "bshd", segment_ids=None,
                   kv_segment_ids=None):
    """Gradients ``(dq, dk, dv)`` of ``flash_forward``'s ``out`` for the
    cotangent ``dout``, recomputed blockwise from ``lse`` (the forward's)
    and ``delta = rowsum(dout * out)`` ``[B, H, Sq]`` float32. Each comes
    back in its input's layout and dtype; grouped K/V heads get the sum
    over their query heads."""
    _check(q, k, v, causal, window, layout)
    _check_backward(q, out, lse, dout, delta, layout)
    seg, kv_seg = _segments(segment_ids, q, k, layout, kv_segment_ids)
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, out, lse, dout, delta,
                                        scale=scale, causal=causal,
                                        window=window, layout=layout,
                                        segment_ids=seg,
                                        kv_segment_ids=kv_seg)
    if q.device.type != "cuda":
        raise ValueError(f"flash_backward runs on cuda or cpu tensors, "
                         f"got {q.device}")
    args = (q, k, v, lse.contiguous(), dout, delta.contiguous(),
            float(scale), bool(causal), window, layout, seg, kv_seg)
    return launch_dq(*args) + launch_dkv(*args)


def _strides(x, layout):
    """(batch, seq, head) element strides of a tensor in ``layout``."""
    xh = _heads_major(x, layout)
    return [xh.stride(0), xh.stride(2), xh.stride(1)]


def _backward_args(q, k, v, lse, dout, delta, layout, segment_ids,
                   kv_segment_ids):
    """Shapes, checks and the shared launcher arguments of the two
    backward kernels."""
    if q.device.type != "cuda":
        raise ValueError(f"the backward kernels take cuda tensors, got "
                         f"{q.device}")
    qh, kh = _heads_major(q, layout), _heads_major(k, layout)
    b, h, sq, d = qh.shape
    hkv, sk = kh.shape[1], kh.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel supports head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    for name, x in (("q", q), ("k", k), ("v", v), ("dout", dout)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along head_dim")
    if not (lse.is_contiguous() and delta.is_contiguous()):
        raise ValueError("lse and delta must be contiguous")
    pointers = [x.data_ptr() for x in (q, k, v, dout, lse, delta)]
    sizes = [_DTYPES[q.dtype], b, h, h // hkv, sq, sk, d]
    strides = sum((_strides(x, layout) for x in (q, k, v, dout)), [])
    seg = _seg_args(*_segments(segment_ids, q, k, layout, kv_segment_ids))
    return pointers, sizes, strides, seg, sq == 0 or sk == 0


def launch_dq(q, k, v, lse, dout, delta, scale, causal, window, layout,
              segment_ids=None, kv_segment_ids=None):
    """The dq kernel (K1dq) on CUDA tensors: returns ``(dq,)``."""
    pointers, sizes, strides, seg, empty = _backward_args(
        q, k, v, lse, dout, delta, layout, segment_ids, kv_segment_ids)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    if empty:
        return (dq.zero_(),)
    lib = kernels.library("flash_bwd_dq")
    err = lib.dkt_flash_bwd_dq(
        *pointers, dq.data_ptr(), *sizes, *strides, *_strides(dq, layout),
        float(scale), int(causal), 0 if window is None else int(window),
        *seg, torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(lib, err, "flash_bwd_dq")
    kernels.count_launch("flash_bwd_dq")
    return (dq,)


def launch_dkv(q, k, v, lse, dout, delta, scale, causal, window, layout,
               segment_ids=None, kv_segment_ids=None):
    """The dk/dv kernel (K1dkv) on CUDA tensors: returns ``(dk, dv)``,
    each grouped K/V head summed over its query heads."""
    pointers, sizes, strides, seg, empty = _backward_args(
        q, k, v, lse, dout, delta, layout, segment_ids, kv_segment_ids)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if empty:
        return dk.zero_(), dv.zero_()
    lib = kernels.library("flash_bwd_dkv")
    err = lib.dkt_flash_bwd_dkv(
        *pointers, dk.data_ptr(), dv.data_ptr(), *sizes, *strides,
        *_strides(dk, layout), *_strides(dv, layout), float(scale),
        int(causal), 0 if window is None else int(window), *seg,
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(lib, err, "flash_bwd_dkv")
    kernels.count_launch("flash_bwd_dkv")
    return dk, dv


def flash_backward_reference(q, k, v, out, lse, dout, delta, *,
                             scale: float, causal: bool,
                             window: Optional[int] = None,
                             layout: str = "bshd", segment_ids=None,
                             kv_segment_ids=None):
    """The plain PyTorch version of the two backward kernels: the whole
    recomputed probability matrix at once, with the kernels' masks and
    rounding points; grouped K/V gradients summed over their group in
    float32."""
    _check(q, k, v, causal, window, layout)
    _check_backward(q, out, lse, dout, delta, layout)
    seg, kv_seg = _segments(segment_ids, q, k, layout, kv_segment_ids)
    qh, kh, vh, gh = (_heads_major(x, layout) for x in (q, k, v, dout))
    b, h, sq, d = qh.shape
    hkv, sk = kh.shape[1], kh.shape[2]
    g = h // hkv
    kx, vx = kh, vh
    if g > 1:
        kx = kh.repeat_interleave(g, dim=1)
        vx = vh.repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kx.float()) * scale
    allowed = _allowed(sq, sk, causal, window, seg, q.device, kv_seg)
    if allowed is not None:
        s = s.masked_fill(~allowed, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dout.dtype).float(),
                      gh.float())
    dp = torch.einsum("bhqd,bhkd->bhqk", gh.float(), vx.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).float(),
                      kx.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(),
                      qh.float()) * scale
    if g > 1:
        dk = dk.view(b, hkv, g, sk, d).sum(2)
        dv = dv.view(b, hkv, g, sk, d).sum(2)

    def back(x, like):
        x = x.transpose(1, 2) if layout == "bshd" else x
        return x.to(like.dtype).contiguous()

    return back(dq, q), back(dk, k), back(dv, v)


def attention_delta(out, dout, layout: str = "bshd") -> torch.Tensor:
    """``delta = rowsum(dout * out)`` ``[B, H, Sq]`` in float32 (the
    flash trick: ``sum_j P_ij dP_ij``), as the JAX package computes it
    outside its kernels (``_flash_backward_pallas`` :537)."""
    prod = (dout.float() * out.float()).sum(-1)
    return (prod.transpose(1, 2) if layout == "bshd" else prod).contiguous()


class _FlashAttention(torch.autograd.Function):
    """Forward: the flash forward, saving q, k, v, out, lse and the
    segment ids (the JAX ``_flash_fwd_rule``). Backward: ``delta`` and
    the two backward kernels (``_flash_bwd_rule`` with
    ``bwd="pallas"``); the ids get no gradient (JAX's float0)."""

    @staticmethod
    def forward(ctx, q, k, v, seg, kv_seg, scale, causal, window, layout):
        out, lse = flash_forward(q, k, v, scale=scale, causal=causal,
                                 window=window, layout=layout,
                                 segment_ids=seg, kv_segment_ids=kv_seg)
        ctx.save_for_backward(q, k, v, out, lse, seg, kv_seg)
        ctx.config = (scale, causal, window, layout)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, seg, kv_seg = ctx.saved_tensors
        scale, causal, window, layout = ctx.config
        dout = dout.contiguous()
        dq, dk, dv = flash_backward(
            q, k, v, out, lse, dout, attention_delta(out, dout, layout),
            scale=scale, causal=causal, window=window, layout=layout,
            segment_ids=seg, kv_segment_ids=kv_seg)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    window: Optional[int] = None, layout: str = "bshd",
                    scale: Optional[float] = None, segment_ids=None,
                    kv_segment_ids=None):
    """Differentiable flash attention (``distkeras_tpu`` ``flash_attention``
    :746): ``out`` in q's layout and dtype. The forward is
    ``flash_forward``; the gradient runs the dq and dk/dv kernels on the
    card and their plain version on the CPU. ``scale`` defaults to
    ``head_dim ** -0.5``. ``segment_ids`` ``[B, S]``: packed sequences;
    ``kv_segment_ids`` the keys' own ids (see the module docstring)."""
    seg, kv_seg = _segments(segment_ids, q, k, layout, kv_segment_ids)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, seg, kv_seg, float(scale),
                                 bool(causal), window, layout)
