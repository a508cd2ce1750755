"""Paged decode attention: the hand-written CUDA kernel
(``csrc/paged_decode.cu``) and its plain PyTorch version.

Replaces ``distkeras_tpu/ops/paged_attention.py``
``paged_decode_attention`` (:244, the ``pl.pallas_call`` at :365, body
``_kernel`` :131) for float pages: K/V are read through the page table
with no materialised logical view; grouped queries, ``W >= 1``
window-causal rows, a sliding window and sentinel table entries are
supported. int8/int4 scale planes and the tree ``anc`` mask come with
the quantization and speculation slices (ROADMAP, kernel queue).

Shapes: q ``[S, W, Hkv, G, D]`` float32; k/v pages ``[N, Hkv, page_len,
D]`` float32 or bfloat16; ``t`` ``[S]`` int32 window start positions;
``table`` ``[S, P]`` int32 page tables, an entry ``>= N`` is the
unallocated sentinel. Window row ``j`` of slot ``s`` attends cache
positions ``<= t[s] + j`` (and ``> t[s] + j - window`` with SWA).
Returns ``[S, W, Hkv, G, D]`` float32.
"""

from __future__ import annotations

from typing import Optional

import torch

from distkeras_tpu_torch import kernels
from distkeras_tpu_torch.ops.attention import NEG_INF

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is instantiated for
KERNEL_HEAD_DIMS = (32, 64, 128)


def _check(q, k_pages, v_pages, t, table, k_scale, v_scale, anc):
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "quantized (int8/int4) pages are not ported yet: ROADMAP, "
            "kernel queue item K3-int8/int4")
    if anc is not None:
        raise NotImplementedError(
            "the tree ancestor mask is not ported yet: ROADMAP, kernel "
            "queue item K3-anc")
    if q.ndim != 5:
        raise ValueError(f"q must be [S, W, Hkv, G, D], got {tuple(q.shape)}")
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {q.dtype}")
    if k_pages.shape != v_pages.shape or k_pages.ndim != 4:
        raise ValueError("k/v pages must be [N, Hkv, page_len, D] alike")
    if k_pages.dtype != v_pages.dtype or k_pages.dtype not in _DTYPES:
        raise TypeError(f"pages must be float32 or bfloat16, "
                        f"got {k_pages.dtype}/{v_pages.dtype}")
    s, _w, hkv, _g, d = q.shape
    if k_pages.shape[1] != hkv or k_pages.shape[3] != d:
        raise ValueError(f"pages {tuple(k_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if t.shape != (s,) or table.ndim != 2 or table.shape[0] != s:
        raise ValueError(f"t must be [{s}] and table [{s}, P], got "
                         f"{tuple(t.shape)} and {tuple(table.shape)}")
    devs = {x.device for x in (q, k_pages, v_pages, t, table)}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")


def paged_decode_attention(q, k_pages, v_pages, t, table, *,
                           scale: Optional[float] = None,
                           window: Optional[int] = None,
                           k_scale=None, v_scale=None, anc=None):
    """Window decode attention straight off the page pool."""
    _check(q, k_pages, v_pages, t, table, k_scale, v_scale, anc)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pages, v_pages, t, table, scale=scale, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu "
                         f"tensors, got {q.device}")
    return _launch(q, k_pages, v_pages, t, table, float(scale), window)


def _launch(q, k_pages, v_pages, t, table, scale, window):
    s, w, hkv, g, d = q.shape
    n, _, page_len, _ = k_pages.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"paged kernel supports head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if w * g > 64:
        raise ValueError(f"paged kernel takes at most 64 rows per kv head "
                         f"(W*G), got {w * g}")
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("t", t), ("table", table)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if t.dtype != torch.int32 or table.dtype != torch.int32:
        raise TypeError("t and table must be int32")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("pages must start on a 16-byte boundary (the "
                         "kernel reads them 16 bytes at a time)")
    out = torch.empty_like(q)
    if s == 0:
        return out
    lib = kernels.library("paged_decode")
    err = lib.dkt_paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), t.data_ptr(),
        table.data_ptr(), out.data_ptr(), _DTYPES[k_pages.dtype], s, w,
        hkv, g, d, page_len, table.shape[1], n, scale,
        0 if window is None else int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(lib, err, "paged_decode")
    kernels.count_launch("paged_decode")
    return out


def gather_pages(pages, table):
    """Each slot's pages in logical order as one contiguous
    ``[S, Hkv, P * page_len, D]`` view; sentinel entries clamp to the
    last physical page (their positions are masked by the caller)."""
    n = pages.shape[0]
    pg = pages[table.long().clamp(0, n - 1)]     # [S, P, Hkv, pl, D]
    s, p, h, pl, d = pg.shape
    return pg.permute(0, 2, 1, 3, 4).reshape(s, h, p * pl, d)


def paged_decode_attention_reference(q, k_pages, v_pages, t, table, *,
                                     scale: float,
                                     window: Optional[int] = None):
    """The plain PyTorch version: ``gather_pages`` plus the masked
    softmax, with the kernel's masks (positions on sentinel pages are
    masked like positions past the window row) and rounding points."""
    s, w, hkv, g, d = q.shape
    n, _, page_len, _ = k_pages.shape
    k = gather_pages(k_pages, table)
    v = gather_pages(v_pages, table)
    length = k.shape[2]
    sc = torch.einsum("swhgd,shld->shgwl", q.float(), k.float()) * scale
    pos = torch.arange(length, device=q.device)
    row_pos = t.long()[:, None] + torch.arange(w, device=q.device)
    valid = pos[None, None, :] <= row_pos[:, :, None]          # [S, W, L]
    if window is not None:
        valid = valid & (pos[None, None, :] > (row_pos - int(window))
                         [:, :, None])
    live = (table.long() < n).repeat_interleave(page_len, dim=1)  # [S, L]
    valid = valid & live[:, None, :]
    sc = sc.masked_fill(~valid[:, None, None], NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    e = torch.exp(sc - m)
    l = e.sum(dim=-1, keepdim=True)
    o = torch.einsum("shgwl,shld->swhgd", e.to(v.dtype).float(), v.float())
    return o / l.permute(0, 3, 1, 2, 4)
