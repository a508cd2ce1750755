"""The serving decode path of the port: prompt prefill (one pass or in
chunks) into a batch-1 staging cache, and one decode step over all
slots of a paged KV pool.

Mirrors the serving subset of ``distkeras_tpu/models/decoding.py``:
``prefill`` :607 / ``_prefill_block`` :344, ``prefill_chunk_step`` :546
/ ``_prefill_block_chunked`` :465 with ``_merge_attention`` :374
(``_attn_lse`` :387 is ``ops.flash_attention.flash_forward`` here, which
returns the lse), ``_cache_write`` :198,
``_cache_write_pages`` :926, ``_paged_attn_readout`` :1033,
``decode_step_slots_paged`` :1096, ``_sample_vec`` :1539,
``_masked_logits_vec`` :1565, ``_fuse_qkv_params`` :1627,
``_project_qkv`` :1662 and ``_serving_params`` :1694.

Functions take the module (for its configuration) and an explicit
parameter tree (``Sequential.param_tree()``, usually pre-cast by
``serving_params``), as the JAX functions do. Caches are lists with one
``{"k", "v"}`` dict per attention layer (``None`` elsewhere) and are
written IN PLACE: a staging cache is ``[B, Hkv, L, Dh]``, a page pool
``[N, Hkv, page_len, Dh]``. Prefill attention runs
``ops.flash_attention.flash_forward`` and the decode readout
``ops.paged_attention.paged_decode_attention``: the CUDA kernels for
tensors on the card, their plain versions for tensors on the CPU.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from distkeras_tpu_torch.models.attention import (MultiHeadAttention,
                                                  PositionalEmbedding,
                                                  TransformerBlock)
from distkeras_tpu_torch.models.core import Sequential, torch_dtype
from distkeras_tpu_torch.models.layers import Dropout
from distkeras_tpu_torch.ops.attention import NEG_INF, apply_rope
from distkeras_tpu_torch.ops.flash_attention import flash_forward
from distkeras_tpu_torch.ops.paged_attention import paged_decode_attention
from distkeras_tpu_torch.utils.tree import tree_map


def _decode_block_of(layer) -> Optional[TransformerBlock]:
    return layer if isinstance(layer, TransformerBlock) else None


def attn_compute_dtype(module: Sequential) -> Optional[torch.dtype]:
    """The attention compute dtype of the first block (one dtype across
    the stack, the LM-family convention), or None."""
    for layer in module.layers:
        block = _decode_block_of(layer)
        if block is not None:
            return torch_dtype(block.attn.dtype)
    return None


def serving_params(params, dtype: torch.dtype):
    """Pre-cast the matrices (ndim >= 2) to the serving dtype once;
    vectors (biases, norm scales) stay float32. The embedding gather and
    the head then read the cast tree too, exactly as in the JAX
    package."""
    return tree_map(
        lambda p: p.detach().to(dtype)
        if p.ndim >= 2 and p.is_floating_point() else p.detach(), params)


def fuse_qkv_params(module: Sequential, params):
    """Replace each block's ``wq``/``wk``/``wv`` with one ``wqkv [d, H +
    2*Hkv, Dh]`` so a step runs one projection matmul instead of three
    (each output column is the same dot product)."""
    fused = list(params)
    for i, layer in enumerate(module.layers):
        if _decode_block_of(layer) is None:
            continue
        p = dict(fused[i])
        pa = dict(p["attn"])
        pa["wqkv"] = torch.cat([pa.pop("wq"), pa.pop("wk"), pa.pop("wv")],
                               dim=1)
        p["attn"] = pa
        fused[i] = p
    return fused


def _project_qkv(attn: MultiHeadAttention, p, xc):
    dt = xc.dtype
    if "wqkv" in p:
        qkv = torch.einsum("bsd,dhe->bshe", xc, p["wqkv"].to(dt))
        h, hkv = attn.num_heads, attn.kv_heads
        return qkv[:, :, :h], qkv[:, :, h:h + hkv], qkv[:, :, h + hkv:]
    q = torch.einsum("bsd,dhe->bshe", xc, p["wq"].to(dt))
    k = torch.einsum("bsd,dhe->bshe", xc, p["wk"].to(dt))
    v = torch.einsum("bsd,dhe->bshe", xc, p["wv"].to(dt))
    return q, k, v


def _attn_out(p, out, dt):
    return torch.einsum("bshe,hed->bsd", out, p["wo"].to(dt))


def init_cache(module: Sequential, batch: int, max_len: int, dtype,
               device, check_len: Optional[int] = None) -> List:
    """Per-layer zeroed ``{"k", "v"}`` buffers ``[batch, Hkv, max_len,
    Dh]`` (a page pool passes pages as the batch and ``page_len`` as the
    length), ``None`` for layers without attention. ``check_len`` is the
    position count the positional table must cover (default
    ``max_len``)."""
    need = max_len if check_len is None else check_len
    cache = []
    for layer in module.layers:
        if isinstance(layer, PositionalEmbedding) and need > layer.max_len:
            raise ValueError(
                f"PositionalEmbedding(max_len={layer.max_len}) is too small "
                f"for a {need}-position decode cache")
        block = _decode_block_of(layer)
        if block is None:
            cache.append(None)
            continue
        shape = (batch, block.attn.kv_heads, max_len, block.attn.head_dim)
        cache.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                      "v": torch.zeros(shape, dtype=dtype, device=device)})
    return cache


def _cache_write(kv, k, v, t: int):
    """Write a ``[B, S, Hkv, Dh]`` k/v slab (as projected) at positions
    ``t .. t+S-1`` of a head-major staging cache, in place."""
    s = k.shape[1]
    kv["k"][:, :, t:t + s] = k.transpose(1, 2).to(kv["k"].dtype)
    kv["v"][:, :, t:t + s] = v.transpose(1, 2).to(kv["v"].dtype)
    return kv


def _mlp_half(block: TransformerBlock, p, x):
    h = block.norm2.apply(p["norm2"], x)
    return x + block.mlp.apply(p["mlp"], h)


def _prefill_block(block: TransformerBlock, p, kv, x, positions):
    """Whole-prompt pass through one block: ONE causal flash pass over
    ``[B, P]``, writing the block's cache entries for every position."""
    attn = block.attn
    dt = torch_dtype(attn.dtype)
    xc = block.norm1.apply(p["norm1"], x).to(dt)
    q, k, v = _project_qkv(attn, p["attn"], xc)
    if attn.use_rope:
        q = apply_rope(q, positions, scale=attn.rope_scale)
        k = apply_rope(k, positions, scale=attn.rope_scale)
    _cache_write(kv, k, v, 0)
    out, _ = flash_forward(q, k, v, scale=q.shape[-1] ** -0.5, causal=True,
                           window=attn.attn_window)
    y = _attn_out(p["attn"], out.to(dt), dt)
    return _mlp_half(block, p, x + y.to(x.dtype))


def _merge_attention(o_a, lse_a, o_b, lse_b):
    """Combine two normalised attention partials over disjoint key sets
    through their log-sum-exps. o: ``[..., S, D]``; lse: ``[..., S]``."""
    m = torch.maximum(lse_a, lse_b)
    wa = torch.exp(lse_a - m)[..., None]
    wb = torch.exp(lse_b - m)[..., None]
    return (o_a.float() * wa + o_b.float() * wb) / (wa + wb)


def _banded_prefix_attn(q, kp, vp, t0: int, lo: int, window: int,
                        scale: float):
    """Chunk queries against the sliding-window prefix band ``[lo, t0)``
    (fewer than ``window`` keys): plain masked attention with its lse.
    q: ``[B, Q, H, D]``; kp/vp: ``[B, H, Lb, D]`` (heads expanded)."""
    qh = q.transpose(1, 2)
    s = torch.einsum("bhqd,bhkd->bhqk", qh.float() * scale, kp.float())
    jpos = lo + torch.arange(s.shape[-1], device=q.device)[None, :]
    gi = t0 + torch.arange(s.shape[-2], device=q.device)[:, None]
    s = s.masked_fill(~(jpos > gi - window), NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", torch.exp(s - lse[..., None]),
                     vp.float())
    return o.transpose(1, 2).to(q.dtype), lse


def _cache_prefix(kv, upto: int, dt, lo: int = 0):
    """Cache positions ``[lo, upto)`` as ``[B, Hkv, upto-lo, D]`` k/v in
    the compute dtype."""
    return (kv["k"][:, :, lo:upto].to(dt), kv["v"][:, :, lo:upto].to(dt))


def _prefill_block_chunked(block: TransformerBlock, p, kv, x, positions,
                           t0: int):
    """One chunk of one block: the chunk's queries attend to the cache
    prefix ``[0, t0)`` (one non-causal flash pass with the GQA group
    folded into the query rows) and to the chunk itself (causal); the
    two partials merge exactly through their log-sum-exps. Sliding
    window models use a windowed diagonal pass plus a masked prefix
    band of the last ``window - 1`` positions."""
    attn = block.attn
    dt = torch_dtype(attn.dtype)
    xc = block.norm1.apply(p["norm1"], x).to(dt)
    q, k, v = _project_qkv(attn, p["attn"], xc)
    if attn.use_rope:
        q = apply_rope(q, positions, scale=attn.rope_scale)
        k = apply_rope(k, positions, scale=attn.rope_scale)
    _cache_write(kv, k, v, t0)
    b, q_len, nh, dh = q.shape
    hkv = attn.kv_heads
    g = nh // hkv
    scale = dh ** -0.5
    window = attn.attn_window
    o_diag, lse_diag = flash_forward(q, k, v, scale=scale, causal=True,
                                     window=window)
    lo = 0 if window is None else max(0, t0 - window + 1)
    if t0 > lo:
        kp, vp = _cache_prefix(kv, t0, dt, lo=lo)
        if window is None:
            # every chunk query is newer than every prefix key: the G
            # query heads sharing one kv head fold into the row axis
            qg = q.reshape(b, q_len, hkv, g, dh).permute(0, 2, 3, 1, 4) \
                  .reshape(b * hkv, 1, g * q_len, dh)
            o_pre, lse_pre = flash_forward(
                qg, kp.reshape(b * hkv, 1, t0, dh),
                vp.reshape(b * hkv, 1, t0, dh),
                scale=scale, causal=False, layout="bhsd")
            o_pre = o_pre.reshape(b, hkv, g, q_len, dh) \
                         .permute(0, 3, 1, 2, 4).reshape(b, q_len, nh, dh)
            lse_pre = lse_pre.reshape(b, nh, q_len)
        else:
            o_pre, lse_pre = _banded_prefix_attn(
                q, kp.repeat_interleave(g, dim=1),
                vp.repeat_interleave(g, dim=1), t0, lo, window, scale)
        out = _merge_attention(
            o_pre.transpose(1, 2), lse_pre,
            o_diag.transpose(1, 2), lse_diag).transpose(1, 2)
    else:
        out = o_diag
    y = _attn_out(p["attn"], out.to(dt), dt)
    return _mlp_half(block, p, x + y.to(x.dtype))


def _last_block(module: Sequential) -> int:
    return max((i for i, layer in enumerate(module.layers)
                if _decode_block_of(layer) is not None), default=-1)


@torch.no_grad()
def prefill_chunk_step(module: Sequential, params, cache, chunk, t0: int,
                       *, final: bool):
    """ONE ``[B, q_len]`` chunk at global start ``t0`` through the stack
    (positions ``[0, t0)`` of ``cache`` must be written). Returns
    ``(last_logits [B, V] if final else None, cache)``; a non-final chunk
    stops after the deepest attention block."""
    last_block = _last_block(module)
    last = len(module.layers) - 1
    q_len = chunk.shape[1]
    x = chunk
    positions = torch.arange(t0, t0 + q_len, device=chunk.device)
    for i, layer in enumerate(module.layers):
        if not final and i > last_block:
            break
        p = params[i]
        block = _decode_block_of(layer)
        if block is not None:
            x = _prefill_block_chunked(block, p, cache[i], x, positions, t0)
        elif isinstance(layer, PositionalEmbedding):
            x = x + p["embeddings"][t0:t0 + q_len][None].to(x.dtype)
        elif isinstance(layer, Dropout):
            pass
        else:
            if i == last and x.ndim == 3:
                x = x[:, -1:]            # head on the final position only
            x = layer.apply(p, x)
    return (x[:, -1] if final else None), cache


@torch.no_grad()
def prefill(module: Sequential, params, cache, prompts):
    """Run the stack once over ``[B, P]`` prompts, filling every
    attention layer's cache at positions ``0..P-1``; returns
    ``(last_logits [B, V], cache)`` (the vocab head runs on the last
    position only)."""
    p_len = prompts.shape[1]
    x = prompts
    positions = torch.arange(p_len, device=prompts.device)
    last = len(module.layers) - 1
    for i, layer in enumerate(module.layers):
        p = params[i]
        block = _decode_block_of(layer)
        if block is not None:
            x = _prefill_block(block, p, cache[i], x, positions)
        elif isinstance(layer, PositionalEmbedding):
            x = x + p["embeddings"][:p_len][None].to(x.dtype)
        elif isinstance(layer, Dropout):
            pass
        else:
            if i == last and x.ndim == 3:
                x = x[:, -1:]
            x = layer.apply(p, x)
    return x[:, -1], cache


# --- paged decode ------------------------------------------------------------


def page_write_index(t, table, page_len: int, n_pages: int):
    """Where each slot's decode write lands: ``(rows, pages, offsets)``
    for the slots whose position ``t`` maps to an allocated page. A
    position past the table (the engine's free-slot sentinel) or a
    sentinel table entry writes nothing: those rows are left out here,
    because an indexed store would refuse (not drop) an out-of-range
    index. Computed once per step and shared by every layer."""
    n_logical = table.shape[1]
    t = t.long()
    lp = torch.div(t, page_len, rounding_mode="floor")
    off = t - lp * page_len
    in_range = (lp >= 0) & (lp < n_logical)
    pp = table.long().gather(1, lp.clamp(0, n_logical - 1)[:, None])[:, 0]
    rows = torch.nonzero(in_range & (pp < n_pages), as_tuple=True)[0]
    return rows, pp[rows], off[rows]


def _cache_write_pages(kv, k, v, index):
    """Write the ``[S, 1, Hkv, D]`` decode k/v through the page tables
    (``index`` from ``page_write_index``), in place."""
    rows, pages, offs = index
    kv["k"][pages, :, offs] = k[rows, 0].to(kv["k"].dtype)
    kv["v"][pages, :, offs] = v[rows, 0].to(kv["v"].dtype)
    return kv


def _paged_attn_readout(attn: MultiHeadAttention, p, q, kv, t, table, dt):
    """The paged readout plus the output projection: queries in float32
    grouped ``[S, W, Hkv, G, D]``, K/V read through the page table."""
    b, w_len, nh, dh = q.shape
    hkv = attn.kv_heads
    qg = q.float().reshape(b, w_len, hkv, nh // hkv, dh)
    o = paged_decode_attention(qg, kv["k"], kv["v"], t, table,
                               scale=dh ** -0.5, window=attn.attn_window)
    out = o.reshape(b, w_len, nh, dh).to(dt)
    return _attn_out(p, out, dt)


def _decode_block_slots_paged(block: TransformerBlock, p, kv, x, t, table,
                              index):
    attn = block.attn
    dt = torch_dtype(attn.dtype)
    xc = block.norm1.apply(p["norm1"], x).to(dt)
    q, k, v = _project_qkv(attn, p["attn"], xc)
    if attn.use_rope:
        q = apply_rope(q, t[:, None], scale=attn.rope_scale)
        k = apply_rope(k, t[:, None], scale=attn.rope_scale)
    _cache_write_pages(kv, k, v, index)
    y = _paged_attn_readout(attn, p["attn"], q, kv, t, table, dt)
    return _mlp_half(block, p, x + y.to(x.dtype))


@torch.no_grad()
def decode_step_slots_paged(module: Sequential, params, cache, tok, t,
                            table, page_len: int):
    """One token per slot through the stack against the paged pool:
    tok ``[S]``, t ``[S]`` int32, table ``[S, P]`` int32; returns
    ``([S, V] logits, cache)``. Slots whose ``t`` is the out-of-range
    sentinel write nothing and give logits the caller discards."""
    x = tok[:, None]
    n_pages = next(kv["k"].shape[0] for kv in cache if kv is not None)
    index = page_write_index(t, table, page_len, n_pages)
    for i, layer in enumerate(module.layers):
        p = params[i]
        block = _decode_block_of(layer)
        if block is not None:
            x = _decode_block_slots_paged(block, p, cache[i], x, t, table,
                                          index)
        elif isinstance(layer, PositionalEmbedding):
            pos = t.long().clamp(0, layer.max_len - 1)
            x = x + p["embeddings"][pos][:, None, :].to(x.dtype)
        elif isinstance(layer, Dropout):
            pass
        else:
            x = layer.apply(p, x)
    return x[:, 0], cache


# --- per-slot sampling ---------------------------------------------------------


def _masked_logits_vec(logits, temperature, top_k, top_p):
    """Temperature-scaled float32 logits with the rank top-k and the
    exclusive-cumsum nucleus cut applied (``NEG_INF`` outside the
    candidate set). Top-k ranks come from a STABLE descending argsort,
    so ties at the k-th logit go to the lowest index."""
    lf = logits.float()
    safe_t = torch.where(temperature > 0.0, temperature,
                         torch.ones_like(temperature))
    lf = lf / safe_t[:, None]
    order = torch.argsort(-lf, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    keep = (top_k[:, None] <= 0) | (ranks < top_k[:, None])
    lf = torch.where(keep, lf, torch.full_like(lf, NEG_INF))
    sorted_logits = torch.flip(torch.sort(lf, dim=-1).values, dims=(-1,))
    probs = torch.softmax(sorted_logits, dim=-1)
    exclusive = torch.cumsum(probs, dim=-1) - probs
    keep_sorted = exclusive < top_p[:, None]
    thresh = torch.where(keep_sorted, sorted_logits,
                         torch.full_like(sorted_logits, float("inf"))) \
        .amin(dim=-1, keepdim=True)
    return torch.where((top_p >= 1.0)[:, None] | (lf >= thresh), lf,
                       torch.full_like(lf, NEG_INF))


def _sample_vec(logits, temperature, top_k, top_p, generators):
    """Per-row sampling: every knob is a ``[B]`` tensor (``temperature
    0`` = greedy, ``top_k <= 0`` = no truncation, ``top_p >= 1`` = no
    nucleus cut) and ``generators[b]`` is row ``b``'s own
    ``torch.Generator`` (``None`` for a greedy row), so a request's draws
    depend only on its own seed. A draw is ``argmax(masked logits +
    Gumbel noise)``, the categorical draw the JAX package makes; the
    noise comes from torch's generator, not JAX's threefry."""
    greedy = torch.argmax(logits, dim=-1)
    lf = _masked_logits_vec(logits, temperature, top_k, top_p)
    sampled = greedy.clone()
    tiny = float(np.finfo(np.float32).tiny)
    for row, gen in enumerate(generators):
        if gen is None:
            continue
        u = torch.rand(lf.shape[-1], generator=gen, device=lf.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
        sampled[row] = torch.argmax(lf[row] + gumbel)
    return torch.where(temperature > 0.0, sampled, greedy)
