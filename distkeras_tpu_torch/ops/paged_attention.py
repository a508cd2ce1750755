"""Paged decode attention: the hand-written CUDA kernel
(``csrc/paged_decode.cuh``) and its plain PyTorch version.

Replaces ``distkeras_tpu/ops/paged_attention.py``
``paged_decode_attention`` (:244, the ``pl.pallas_call`` at :365, body
``_kernel`` :131): K/V are read through the page table with no
materialised logical view; grouped queries, ``W >= 1`` window-causal
rows, a sliding window, sentinel table entries, and quantized pages:
int8 pages and packed int4 pages with float32 per-token scale planes,
and the tree ancestor mask of tree speculation (``anc``, the Pallas
``_kernel`` :177-195; K3-anc), each page variant with a launcher and a
launch count of its own.

Shapes: q ``[S, W, Hkv, G, D]`` float32; k/v pages ``[N, Hkv, page_len,
D]`` float32, bfloat16 or int8, or int4 packed two positions per byte as
``[N, Hkv, page_len/2, D]`` int8 (byte row ``r`` holds position ``r`` in
its low nibble and ``r + page_len/2`` in its high nibble); ``k_scale`` /
``v_scale`` ``[N, Hkv, page_len]`` float32 for quantized pages (an int4
pool is told apart, as in JAX, by a scale plane twice as long as the
payload's rows); ``t`` ``[S]`` int32 window start positions; ``table``
``[S, P]`` int32 page tables, an entry ``>= N`` is the unallocated
sentinel. Window row ``j`` of slot ``s`` attends cache positions ``<=
t[s] + j`` (and ``> t[s] + j - window`` with SWA). With ``anc`` (``[S,
W, W]`` bool) row ``i`` instead attends the committed prefix (``< t[s]``)
and window column ``j``'s position ``t[s] + j`` iff ``anc[s, i, j]``;
with SWA its own position is ``t[s] + depth``, ``depth`` its ancestor
count minus one (a lower-triangular ``anc`` is the window-causal mask).
The kernel takes at most 64 rows (``W * G``) per kv head. Returns ``[S,
W, Hkv, G, D]`` float32. Quantized pages follow the Pallas order: the score
is multiplied by ``k_scale`` after the D contraction, the probabilities
by ``v_scale`` before the value contraction (the row sum takes them
unscaled).
"""

from __future__ import annotations

from typing import Optional

import torch

from distkeras_tpu_torch import kernels
from distkeras_tpu_torch.ops.attention import NEG_INF

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is instantiated for
KERNEL_HEAD_DIMS = (8, 12, 16, 32, 64, 128)
#: query rows (W * G) one block scores per kv head
KERNEL_MAX_ROWS = 64
#: positions a block stages per step (a split is a whole number of them)
CHUNK_POSITIONS = 128
#: blocks per SM the split aims for (splits past a short context idle)
BLOCKS_PER_SM = 8
#: the most logical pages one split owns (its page ids are staged)
MAX_SPLIT_PAGES = 512


def check_rows(w_len: int, g: int) -> None:
    """Raise unless a ``W``-wide window of ``G`` grouped queries fits the
    kernel's row budget (``W * G <= 64`` rows per kv head)."""
    if w_len * g > KERNEL_MAX_ROWS:
        raise ValueError(
            f"the paged decode kernel takes at most {KERNEL_MAX_ROWS} rows "
            f"per kv head (window W * query group G), got W={w_len} x "
            f"G={g} = {w_len * g}")


def _quant_mode(k_pages, k_scale) -> Optional[str]:
    """None (float pages), "int8" or "int4" (packed payload: the scale
    plane holds twice the payload's rows)."""
    if k_scale is None:
        return None
    rows, page_len = k_pages.shape[2], k_scale.shape[2]
    if page_len == rows:
        return "int8"
    if page_len != 2 * rows:
        raise ValueError(
            f"int4 payload rows {rows} do not match scale plane page_len "
            f"{page_len} (expected page_len // 2)")
    return "int4"


def _check(q, k_pages, v_pages, t, table, k_scale, v_scale, anc):
    if q.ndim != 5:
        raise ValueError(f"q must be [S, W, Hkv, G, D], got {tuple(q.shape)}")
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {q.dtype}")
    if k_pages.shape != v_pages.shape or k_pages.ndim != 4:
        raise ValueError("k/v pages must be [N, Hkv, page_len, D] alike")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if k_scale is None:
        if k_pages.dtype != v_pages.dtype or k_pages.dtype not in _DTYPES:
            raise TypeError(f"pages must be float32 or bfloat16, "
                            f"got {k_pages.dtype}/{v_pages.dtype}")
    else:
        if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
            raise TypeError(f"scale planes mark int8/int4 pages, got "
                            f"{k_pages.dtype}/{v_pages.dtype}")
        n, hkv_p = k_pages.shape[:2]
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if (sc.ndim != 3 or sc.shape[:2] != (n, hkv_p)
                    or sc.dtype != torch.float32):
                raise ValueError(f"{name} must be float32 [N, Hkv, "
                                 f"page_len], got {sc.dtype} "
                                 f"{tuple(sc.shape)}")
        if k_scale.shape != v_scale.shape:
            raise ValueError("k_scale and v_scale differ in shape")
        _quant_mode(k_pages, k_scale)
    s, _w, hkv, _g, d = q.shape
    if k_pages.shape[1] != hkv or k_pages.shape[3] != d:
        raise ValueError(f"pages {tuple(k_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if t.shape != (s,) or table.ndim != 2 or table.shape[0] != s:
        raise ValueError(f"t must be [{s}] and table [{s}, P], got "
                         f"{tuple(t.shape)} and {tuple(table.shape)}")
    if anc is not None:
        w = q.shape[1]
        if anc.shape != (s, w, w) or anc.dtype != torch.bool:
            raise ValueError(f"anc must be bool [{s}, {w}, {w}], got "
                             f"{anc.dtype} {tuple(anc.shape)}")
    devs = {x.device for x in (q, k_pages, v_pages, t, table) + (
        () if k_scale is None else (k_scale, v_scale)) + (
        () if anc is None else (anc,))}
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
            q, k_pages, v_pages, t, table, scale=scale, window=window,
            k_scale=k_scale, v_scale=v_scale, anc=anc)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on cuda or cpu "
                         f"tensors, got {q.device}")
    return _launch(q, k_pages, v_pages, t, table, float(scale), window,
                   k_scale, v_scale, anc)


_counters: dict = {}    # device -> the split kernel's arrival counters


def _arrival_counters(device, n: int) -> torch.Tensor:
    """A zeroed int32 workspace of at least ``n`` entries on ``device``:
    one counter per (slot, kv head), by which the last live split learns
    that it merges (it sets the counter back to 0). Kept across calls,
    grown (zeroed) when a launch needs more."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        buf = _counters[device] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                              device=device)
    return buf


def split_plan(rows: int, pages: int, page_len: int, num_sms: int, *,
               window: Optional[int] = None, w_len: int = 1):
    """``(nsplit, pps)``: the flash-decoding split of the kernel's grid
    ``(S, Hkv, nsplit)`` over ``rows`` = S * Hkv (slot, kv head) pairs,
    split ``z`` owning the table's logical pages ``[z * pps, (z + 1) *
    pps)``. Enough splits that the grid fills ``num_sms`` SMs
    ``BLOCKS_PER_SM`` deep over the pages a slot's rows can reach (all
    of them, or the span of a sliding ``window`` of ``w_len`` rows), each
    a whole number of ``CHUNK_POSITIONS`` chunks and at most
    ``MAX_SPLIT_PAGES`` pages. A function of the shapes, the static
    window and the card alone -- never of the positions ``t`` -- so a
    decode step reads nothing back from the card."""
    def cdiv(a, b):
        return -(-a // b)

    pages = max(pages, 1)
    span = pages if window is None else \
        min(pages, cdiv(int(window) + w_len - 1, page_len) + 1)
    cpages = max(1, CHUNK_POSITIONS // page_len)
    want = cdiv(BLOCKS_PER_SM * num_sms, max(rows, 1))
    nsplit = max(1, min(want, cdiv(span, cpages)))
    pps = cdiv(cdiv(span, nsplit), cpages) * cpages
    pps = min(pps, MAX_SPLIT_PAGES)
    return cdiv(pages, pps), pps


def _launch(q, k_pages, v_pages, t, table, scale, window, k_scale,
            v_scale, anc):
    s, w, hkv, g, d = q.shape
    n = k_pages.shape[0]
    mode = _quant_mode(k_pages, k_scale)
    page_len = k_pages.shape[2] if mode is None else k_scale.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"paged kernel supports head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    check_rows(w, g)
    operands = [("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                ("t", t), ("table", table)]
    if mode is not None:
        operands += [("k_scale", k_scale), ("v_scale", v_scale)]
    if anc is not None:
        operands.append(("anc", anc))
    for name, x in operands:
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
    p = table.shape[1]
    nsplit, pps = split_plan(s * hkv, p, page_len,
                             kernels.num_sms(q.device.index),
                             window=window, w_len=w)
    ws = [None, None, None]
    if nsplit > 1:
        ws = [torch.empty((s, hkv, nsplit, w * g, 2), dtype=torch.float32,
                          device=q.device),
              torch.empty((s, hkv, nsplit, w * g, d), dtype=torch.float32,
                          device=q.device),
              _arrival_counters(q.device, s * hkv)]
    ws = [None if x is None else x.data_ptr() for x in ws]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    win = 0 if window is None else int(window)
    name = {None: "paged_decode", "int8": "paged_decode_q8",
            "int4": "paged_decode_q4"}[mode] + ("" if anc is None
                                                else "_anc")
    tree = () if anc is None else (anc.data_ptr(),)
    lib = kernels.library(name)
    fn = getattr(lib, "dkt_" + name)
    if mode is None:
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 t.data_ptr(), table.data_ptr(), *tree, out.data_ptr(),
                 *ws, _DTYPES[k_pages.dtype], s, w, hkv, g, d, page_len, p,
                 n, nsplit, pps, scale, win, stream)
    else:
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 k_scale.data_ptr(), v_scale.data_ptr(), t.data_ptr(),
                 table.data_ptr(), *tree, out.data_ptr(), *ws, s, w, hkv, g,
                 d, page_len, p, n, nsplit, pps, scale, win, stream)
    kernels.check(lib, err, name)
    kernels.count_launch(name)
    return out


def unpack_int4(b):
    """``[..., L/2, D]`` packed bytes -> ``[..., L, D]`` int4-valued int8
    (positions in order along axis -2): the inverse of
    ``models.decoding.pack_int4``, nibble math in int32 as in JAX."""
    b32 = b.to(torch.int32) & 255
    lo = b32 & 15
    lo = lo - 16 * (lo > 7).to(torch.int32)
    hi = (b32 >> 4) & 15
    hi = hi - 16 * (hi > 7).to(torch.int32)
    return torch.cat([lo, hi], dim=-2).to(torch.int8)


def gather_pages(pages, table, *, packed: bool = False):
    """Each slot's pages in logical order as one contiguous ``[S, Hkv,
    P * page_len, D]`` view (a scale plane ``[N, Hkv, page_len]`` gives
    ``[S, Hkv, P * page_len]``; ``packed`` int4 pages are unpacked
    first); sentinel entries clamp to the last physical page (their
    positions are masked by the caller)."""
    n = pages.shape[0]
    pg = pages[table.long().clamp(0, n - 1)]     # [S, P, Hkv, pl, ...]
    if packed:
        pg = unpack_int4(pg)
    s, p, h, pl = pg.shape[:4]
    return pg.transpose(1, 2).reshape((s, h, p * pl) + pg.shape[4:])


def window_valid_mask(t, w_len: int, length: int, window=None,
                      anc=None):
    """``[S, W, length]`` validity of cache positions for the window rows
    (JAX ``_window_valid_mask``, ``models/decoding.py`` :769): ``pos <= t
    + j`` for the window-causal chain; with ``anc`` the committed prefix
    plus the ancestor columns, each row's own position ``t + depth``
    (``depth`` = ancestor count - 1) for the SWA band."""
    pos = torch.arange(length, device=t.device)
    t = t.long()
    if anc is None:
        row_pos = t[:, None] + torch.arange(w_len, device=t.device)
        valid = pos[None, None, :] <= row_pos[:, :, None]
    else:
        rel = pos[None, :] - t[:, None]                          # [S, L]
        within = (rel >= 0) & (rel < w_len)
        cols = rel.clamp(0, w_len - 1)[:, None, :].expand(-1, w_len, -1)
        anc_g = torch.gather(anc, 2, cols)                       # [S, W, L]
        valid = (rel < 0)[:, None, :] | (within[:, None, :] & anc_g)
        row_pos = t[:, None] + anc.sum(dim=2) - 1
    if window is not None:
        valid = valid & (pos[None, None, :] > (row_pos - int(window))
                         [:, :, None])
    return valid


def paged_decode_attention_reference(q, k_pages, v_pages, t, table, *,
                                     scale: float,
                                     window: Optional[int] = None,
                                     k_scale=None, v_scale=None, anc=None):
    """The plain PyTorch version: ``gather_pages`` (unpacking int4) plus
    the masked softmax, with the kernel's masks (``window_valid_mask``;
    positions on sentinel pages are masked like positions past the
    window row) and rounding points (float pages: probabilities rounded to the page dtype before
    the value product; quantized pages: scores times ``k_scale`` after
    the contraction, probabilities times ``v_scale`` before it)."""
    s, w, hkv, g, d = q.shape
    n = k_pages.shape[0]
    mode = _quant_mode(k_pages, k_scale)
    packed = mode == "int4"
    k = gather_pages(k_pages, table, packed=packed)
    v = gather_pages(v_pages, table, packed=packed)
    length = k.shape[2]
    page_len = length // table.shape[1]
    sc = torch.einsum("swhgd,shld->shgwl", q.float(), k.float()) * scale
    if mode is not None:
        sc = sc * gather_pages(k_scale, table)[:, :, None, None, :]
    valid = window_valid_mask(t, w, length, window, anc)        # [S, W, L]
    live = (table.long() < n).repeat_interleave(page_len, dim=1)  # [S, L]
    valid = valid & live[:, None, :]
    sc = sc.masked_fill(~valid[:, None, None], NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    e = torch.exp(sc - m)
    l = e.sum(dim=-1, keepdim=True)
    if mode is None:
        e = e.to(v.dtype).float()
    else:
        e = e * gather_pages(v_scale, table)[:, :, None, None, :]
    o = torch.einsum("shgwl,shld->swhgd", e, v.float())
    return o / l.permute(0, 3, 1, 2, 4)


def paged_decode_split_reference(q, k_pages, v_pages, t, table, *,
                                 scale: float, pps: int,
                                 window: Optional[int] = None,
                                 k_scale=None, v_scale=None, anc=None):
    """The kernel's flash-decoding split in plain PyTorch, float32 (used
    by the tests): split ``z`` takes the logical pages ``[z * pps, (z +
    1) * pps)`` that the window rows can reach and whose table entry is
    not the sentinel, as the Pallas kernel's ``run`` condition picks them
    (masked positions on those pages enter with ``exp(NEG_INF - m)``);
    each split's ``(m, l, acc)`` comes from one masked softmax over its
    positions, and the splits merge in split order through their
    log-sum-exps over the splits with ``l > 0``; a row no split reaches
    is 0. Float pages keep their values (no rounding of ``p``)."""
    s, w, hkv, g, d = q.shape
    n = k_pages.shape[0]
    mode = _quant_mode(k_pages, k_scale)
    packed = mode == "int4"
    k = gather_pages(k_pages, table, packed=packed).float()
    v = gather_pages(v_pages, table, packed=packed).float()
    p = table.shape[1]
    page_len = k.shape[2] // p
    sc = torch.einsum("swhgd,shld->shgwl", q.float(), k) * scale
    if mode is not None:
        sc = sc * gather_pages(k_scale, table)[:, :, None, None, :]
        vs = gather_pages(v_scale, table)[:, :, None, None, :]
    valid = window_valid_mask(t, w, p * page_len, window, anc)  # [S, W, L]
    sc = sc.masked_fill(~valid[:, None, None], NEG_INF)
    # the pages any window row reaches: positions (t - window, t + W - 1]
    start = torch.arange(p, device=q.device) * page_len
    tl = t.long()[:, None]
    run = (start[None] <= tl + w - 1) & (table.long() < n)
    if window is not None:
        run = run & (start[None] + page_len - 1 > tl - int(window))
    nsplit = -(-p // pps)
    ms, ls, accs = [], [], []
    for z in range(nsplit):
        sel = torch.zeros(p, dtype=torch.bool, device=q.device)
        sel[z * pps:(z + 1) * pps] = True
        pos_on = (run & sel[None]).repeat_interleave(page_len, dim=1)
        x = sc.masked_fill(~pos_on[:, None, None, None], float("-inf"))
        m = x.amax(dim=-1, keepdim=True)
        e = torch.exp(x - m.clamp_min(NEG_INF))
        e = torch.where(pos_on[:, None, None, None], e, torch.zeros_like(e))
        ls.append(e.sum(dim=-1, keepdim=True))
        if mode is not None:
            e = e * vs
        accs.append(torch.einsum("shgwl,shld->shgwd", e, v))
        ms.append(torch.where(ls[-1] > 0, m, torch.full_like(m, NEG_INF)))
    m_all, l_all = torch.stack(ms), torch.stack(ls)
    has = l_all > 0
    big = torch.where(has, m_all, torch.full_like(m_all, float("-inf")))
    mx = big.amax(dim=0)
    wts = torch.where(has, torch.exp(m_all - mx.clamp_min(NEG_INF)),
                      torch.zeros_like(m_all))
    acc = sum(wts[z] * accs[z] for z in range(nsplit))
    l_tot = sum(wts[z] * l_all[z] for z in range(nsplit))
    o = acc / torch.where(l_tot == 0, torch.ones_like(l_tot), l_tot)
    return o.permute(0, 3, 1, 2, 4)
