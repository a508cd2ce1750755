"""The decode path of the port: prompt prefill (one pass or in chunks)
into a slab cache, the one-token decode step over a slab cache and
``generate()`` on top of it, one decode step over all slots of a paged
KV pool or of a slab pool, and the speculative verify window (linear or
tree) over either.

Mirrors ``distkeras_tpu/models/decoding.py``: ``_decode_block_of`` :53
(unwraps ``Remat``), ``init_cache`` :69 (float, int8 and int4 caches; a
layer holding attention that is no block is refused, :139-147),
``_quantize_kv`` :152, ``_kv_bits`` :168, ``pack_int4`` :174 /
``unpack_int4`` :187, ``prefill`` :607 / ``_prefill_block`` :344,
``prefill_chunk_step`` :546 / ``_prefill_block_chunked`` :465 with
``_merge_attention`` :374 (``_attn_lse`` :387 is
``ops.flash_attention.flash_forward`` here, which returns the lse),
``_cache_write`` :198, ``_cache_prefix`` :449,
``_decode_attn`` :275 (``_decode_scores`` :231 and ``_decode_mix`` :250
are ``ops.decode_attention``'s plain version), ``_decode_block`` :335,
``decode_step`` :641, ``_cache_write_pages`` :926 (with
``slab_write_index`` also the slab pool's ``_cache_write_slots`` :732),
``_slot_attn_readout`` :815, ``decode_step_slots`` :877,
``_paged_attn_readout`` :1033, ``decode_step_slots_paged`` :1096, the
speculative verify window (``_window_positions`` :758,
``_decode_block_slots_window`` :1152, ``_verify_window`` :1201,
``verify_step_slots`` :1249, ``verify_step_slots_paged`` :1276) with
``tree_walk`` :1296 and ``commit_tree_path`` :1366,
``_apply_mlp_decode`` :685 with ``_moe_route_stats`` :704,
``decode_fused_slots`` :1425 (the scan is a Python loop here),
``_sample`` :1503, ``_sample_vec`` :1539, ``_masked_logits_vec`` :1565,
``_per_seq_vec`` :1592, ``_is_per_seq`` :1607, ``_fuse_qkv_params``
:1627, ``_project_qkv`` :1662, ``_serving_params`` :1694 and
``generate`` :1710.

Functions take the module (for its configuration) and an explicit
parameter tree (``Sequential.param_tree()``, usually pre-cast by
``serving_params``), as the JAX functions do. Caches are lists with one
dict per attention layer (``None`` elsewhere) and are written IN PLACE:
a slab or staging cache is ``{"k", "v"}`` ``[B, Hkv, L, Dh]``, a page
pool ``[N, Hkv, page_len, Dh]``: views of the first N pages of planes
one page longer, whose last page (the sink, index N, beyond every page
table) takes the paged writes that land nowhere (``with_sink``), so a
paged write has one shape whatever the tables hold and never reads the
card back. A slab pool (the serving engine's ``kv_layout="slab"``) is
``[S, Hkv, L, Dh]`` rows, views of planes one row longer whose last row
is its sink in the same way. A quantized cache holds int8 payloads
plus ``"k_scale"``/``"v_scale"`` float32 ``[B, Hkv, L]`` planes; an int4
cache also carries the ``"q4": True`` marker (its slab payload holds one
int8 byte per entry; only a page pool packs two per byte). Prefill
attention runs ``ops.flash_attention.flash_forward``, the slab decode
readout of ``generate()`` ``ops.decode_attention.decode_attention`` and
the paged one ``ops.paged_attention.paged_decode_attention``: the CUDA
kernels for tensors on the card, their plain versions for tensors on the
CPU. The slot steps over a slab pool read it through
``_slot_attn_readout`` (plain PyTorch on any device, as JAX's slab
engine keeps its einsum path).

A parameter tree may hold quantized leaves (``ops.quant_matmul`` qdicts:
the engine's ``weight_quant`` tree, or ``generate()``'s
``models.quantize`` tree). Their consumers are ``_project_qkv`` and
``_attn_out`` (JAX :1662 and :801), the MLP, the head and the two
embedding tables: the decode and verify steps (and the head, which runs
on the last position only) call ``ops.quant_matmul.quant_matmul``, the
K5 kernel on the card, the port's counterpart of XLA fusing ``q *
scale`` into each consumer; a prefill chunk dequantizes one leaf at a
time just before its matmul; an embedding gathers byte rows and unpacks
only their nibble half.

MoE blocks (``models.moe.MoE``): ``generate()``, its slab decode steps
and every prefill run the layer's own ``apply`` (its configured
dispatch, as JAX does at :340, :370 and :542); the paged slot steps
(decode and verify, tree verify included) run ``MoE.decode_apply`` (the
drop-free fused dispatch, K6a on the card) unless ``moe_dispatched`` is
False, and with ``moe_stats`` also return the step's expert load and
router entropy over live slots. Under a quantized tree an MoE's stacked
expert leaves (``w1``/``w2``) are dequantized to the layer's compute
dtype one layer at a time, just before the layer runs (``_moe_params``),
as JAX dequantizes them in-graph: no K5 runs over experts.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from distkeras_tpu_torch.models.attention import (MultiHeadAttention,
                                                  PositionalEmbedding,
                                                  TransformerBlock)
from distkeras_tpu_torch.models.blocks import Remat
from distkeras_tpu_torch.models.core import Sequential, torch_dtype
from distkeras_tpu_torch.models.layers import (Dense, Dropout, Embedding,
                                               get_activation)
from distkeras_tpu_torch.models.moe import MoE
from distkeras_tpu_torch.ops import prng
from distkeras_tpu_torch.ops.attention import NEG_INF, apply_rope
from distkeras_tpu_torch.ops.decode_attention import decode_attention
from distkeras_tpu_torch.ops.flash_attention import flash_forward
# unpack_int4 lives with the paged readout that unpacks pages; it is
# re-exported here beside pack_int4, where the JAX package keeps both
from distkeras_tpu_torch.ops.paged_attention import (  # noqa: F401
    gather_pages, paged_decode_attention, unpack_int4, window_valid_mask)
from distkeras_tpu_torch.ops.quant_matmul import (dequant_weight,
                                                  gather_rows, is_qdict,
                                                  quant_matmul)
from distkeras_tpu_torch.utils.tree import tree_map


def _decode_block_of(layer) -> Optional[TransformerBlock]:
    """The ``TransformerBlock`` a decode step runs for ``layer``, or None
    for a position-wise layer. A ``Remat`` wrapper (a training-time
    memory policy) is unwrapped, as JAX does (:53-66)."""
    if isinstance(layer, Remat):
        layer = layer.inner
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


def _qmm(x, w, dt, kernel: bool):
    """``x [..., K] @ w`` in ``dt`` for a quantized leaf ``w`` (its 2-D
    view, ``ops.quant_matmul``): through the K5 wrapper (``kernel``: the
    decode and verify steps and the head), or with the leaf dequantized
    to ``dt`` just before the matmul (prefill chunks: a transient tensor,
    no float tree stays resident)."""
    if kernel:
        return quant_matmul(x, w).to(dt)
    w2 = dequant_weight(w, dt).reshape(x.shape[-1], -1)
    return torch.matmul(x.to(dt), w2)


def _project_qkv(attn: MultiHeadAttention, p, xc, kernel: bool = False):
    dt = xc.dtype
    if is_qdict(p.get("wq")):
        b, s_len, _ = xc.shape

        def proj(w, heads):
            return _qmm(xc, w, dt, kernel).reshape(b, s_len, heads, -1)

        return (proj(p["wq"], attn.num_heads), proj(p["wk"], attn.kv_heads),
                proj(p["wv"], attn.kv_heads))
    if "wqkv" in p:
        qkv = torch.einsum("bsd,dhe->bshe", xc, p["wqkv"].to(dt))
        h, hkv = attn.num_heads, attn.kv_heads
        return qkv[:, :, :h], qkv[:, :, h:h + hkv], qkv[:, :, h + hkv:]
    q = torch.einsum("bsd,dhe->bshe", xc, p["wq"].to(dt))
    k = torch.einsum("bsd,dhe->bshe", xc, p["wk"].to(dt))
    v = torch.einsum("bsd,dhe->bshe", xc, p["wv"].to(dt))
    return q, k, v


def _attn_out(p, out, dt, kernel: bool = False):
    if is_qdict(p["wo"]):
        b, s_len = out.shape[:2]
        return _qmm(out.reshape(b, s_len, -1), p["wo"], dt, kernel)
    return torch.einsum("bshe,hed->bsd", out, p["wo"].to(dt))


def _moe_params(mlp: MoE, p):
    """An MoE's parameters with quantized stacked expert leaves (``w1``
    ``[E, d, h]``, ``w2`` ``[E, h, d]`` qdicts) dequantized to the layer's
    compute dtype, one layer at a time: a transient the caller drops
    after the layer, so the resident tree stays int8/int4 (JAX
    dequantizes them in-graph, ``ops/quant_matmul.py`` :334). A float
    tree passes through."""
    if not any(is_qdict(v) for v in p.values()):
        return p
    dt = torch_dtype(mlp.dtype)
    return {k: dequant_weight(v, dt) if is_qdict(v) else v
            for k, v in p.items()}


def _mlp(mlp, p, x, kernel: bool):
    """``TransformerMLP.apply`` over a float or a quantized tree; an
    ``MoE`` runs its own ``apply`` (its configured dispatch) on its
    dequantized experts."""
    if isinstance(mlp, MoE):
        return mlp.apply(_moe_params(mlp, p), x)
    if not is_qdict(p["w1"]):
        return mlp.apply(p, x)
    dt = torch_dtype(mlp.dtype)
    act = get_activation(mlp.activation)
    h = act(_qmm(x.to(dt), p["w1"], dt, kernel) + p["b1"].to(dt))
    y = _qmm(h, p["w2"], dt, kernel) + p["b2"].to(dt)
    return y.to(x.dtype)


def _apply_layer(layer, p, x):
    """``layer.apply`` for the stack's other layers, with the quantized
    leaves of a quantized tree: the token embedding gathers byte rows
    and unpacks only their nibble half (float32 rows), the head runs K5
    (on the last position's rows only)."""
    if isinstance(layer, Embedding) and is_qdict(p["embeddings"]):
        return gather_rows(p["embeddings"], x)
    if isinstance(layer, Dense) and is_qdict(p["kernel"]):
        dt = torch_dtype(layer.dtype)
        y = _qmm(x.to(dt), p["kernel"], dt, kernel=True)
        if layer.use_bias:
            y = y + p["bias"].to(dt)
        return get_activation(layer.activation)(y)
    return layer.apply(p, x)


def _pos_rows(table, idx):
    """Rows ``idx`` (an index tensor) of a positional table, float or
    quantized."""
    return gather_rows(table, idx) if is_qdict(table) else table[idx]


def cache_kind(dtype) -> Optional[str]:
    """``"int8"`` or ``"int4"`` for a quantized cache dtype (the names,
    or ``torch.int8``), None for a float dtype."""
    if isinstance(dtype, str):
        return dtype if dtype in ("int8", "int4") else None
    return "int8" if dtype == torch.int8 else None


def init_cache(module: Sequential, batch: int, max_len: int, dtype,
               device, check_len: Optional[int] = None) -> List:
    """Per-layer zeroed ``{"k", "v"}`` buffers ``[batch, Hkv, max_len,
    Dh]`` (a page pool passes pages as the batch and ``page_len`` as the
    length), ``None`` for layers without attention. ``dtype="int8"`` /
    ``"int4"`` (or ``torch.int8``) builds a quantized cache: int8
    payloads plus float32 ``k_scale``/``v_scale`` ``[batch, Hkv,
    max_len]`` planes, and for int4 the ``"q4"`` marker. ``check_len``
    is the position count the positional table must cover (default
    ``max_len``)."""
    need = max_len if check_len is None else check_len
    kind = cache_kind(dtype)
    if kind is None and isinstance(dtype, str):
        dtype = torch_dtype(dtype)
    cache = []
    for layer in module.layers:
        if isinstance(layer, PositionalEmbedding) and need > layer.max_len:
            raise ValueError(
                f"PositionalEmbedding(max_len={layer.max_len}) is too small "
                f"for a {need}-position decode cache")
        block = _decode_block_of(layer)
        if block is None:
            if layer.accepts_segment_ids:
                # attention the decode loop cannot cache: run position-wise,
                # each token would attend only to itself
                raise ValueError(
                    f"decode path does not support layer {layer!r}: it "
                    "contains attention but is not a TransformerBlock "
                    "(or Remat-wrapped TransformerBlock)")
            cache.append(None)
            continue
        shape = (batch, block.attn.kv_heads, max_len, block.attn.head_dim)
        if kind is None:
            cache.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                          "v": torch.zeros(shape, dtype=dtype,
                                           device=device)})
            continue
        kv = {key: torch.zeros(shape, dtype=torch.int8, device=device)
              for key in ("k", "v")}
        for key in ("k_scale", "v_scale"):
            kv[key] = torch.zeros(shape[:3], dtype=torch.float32,
                                  device=device)
        if kind == "int4":
            kv["q4"] = True
        cache.append(kv)
    return cache


#: the tensors of a cache dict, payload first (``"q4"`` is a marker and
#: ``"sink"`` a page pool's full planes)
CACHE_PLANES = ("k", "v", "k_scale", "v_scale")


def sink_views(full, n_pages: int):
    """A page pool's cache dict over ``full``, planes of ``n_pages + 1``
    pages: views of each plane's first ``n_pages`` pages (what every
    reader gets), the ``"q4"`` marker, and under ``"sink"`` the full
    planes, which only the paged write touches (a dead entry lands on
    page ``n_pages``, the sink)."""
    kv = {key: full[key][:n_pages] for key in CACHE_PLANES if key in full}
    if "q4" in full:
        kv["q4"] = True
    kv["sink"] = {key: full[key] for key in CACHE_PLANES if key in full}
    return kv


def with_sink(kv):
    """The full planes (the visible pages plus the sink page) behind a
    page-pool cache dict. A dict built without them (by hand, or by
    ``init_cache``) gets them here, once: its planes are copied into
    planes one page longer, and its entries become views of their first
    pages, so the caller's dict keeps its contents and shapes."""
    full = kv.get("sink")
    if full is None:
        full = {key: torch.cat([kv[key], torch.zeros_like(kv[key][:1])])
                for key in CACHE_PLANES if key in kv}
        kv.update(sink_views(dict(full, **({"q4": True} if "q4" in kv
                                             else {})),
                             kv["k"].shape[0]))
    return kv["sink"]


def _quantize_kv(x, bits: int = 8):
    """``[..., Dh]`` float -> (int8 payload, float32 ``[...]`` per-vector
    scale): symmetric, ``scale = max|x| / 127`` (``/ 7`` for ``bits=4``,
    values in [-7, 7], still one int8 byte per entry), rounding half to
    even as ``jnp.round`` does; a zero vector keeps scale 0."""
    qmax = 7.0 if bits == 4 else 127.0
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / qmax
    safe = scale.masked_fill(scale == 0.0, 1.0)
    q = torch.clamp(torch.round(xf / safe[..., None]), -qmax, qmax) \
        .to(torch.int8)
    return q, scale


def _kv_bits(kv) -> int:
    """Quantization bit width of a cache dict: 4 with the ``"q4"`` marker,
    else 8."""
    return 4 if "q4" in kv else 8


def pack_int4(q):
    """Pack an int4-valued int8 tensor to nibbles along dim -2 (the
    position axis of a ``[..., L, D]`` plane): byte row ``r`` holds
    position ``r`` in the low nibble and position ``r + L/2`` in the high
    nibble (``L`` even). Nibble math in int32, as in JAX."""
    n = q.shape[-2]
    lo = q[..., :n // 2, :].to(torch.int32)
    hi = q[..., n // 2:, :].to(torch.int32)
    b = ((hi & 15) << 4) | (lo & 15)
    return (b - 256 * (b > 127).to(torch.int32)).to(torch.int8)


def _cache_write(kv, k, v, t: int):
    """Write a ``[B, S, Hkv, Dh]`` k/v slab (as projected) at positions
    ``t .. t+S-1`` of a head-major cache, in place, quantizing for an
    int8/int4 cache."""
    s = k.shape[1]
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    if "k_scale" in kv:
        bits = _kv_bits(kv)
        for key, skey, x in (("k", "k_scale", kh), ("v", "v_scale", vh)):
            q, sc = _quantize_kv(x, bits)
            kv[key][:, :, t:t + s] = q
            kv[skey][:, :, t:t + s] = sc
        return kv
    kv["k"][:, :, t:t + s] = kh.to(kv["k"].dtype)
    kv["v"][:, :, t:t + s] = vh.to(kv["v"].dtype)
    return kv


def _mlp_half(block: TransformerBlock, p, x, kernel: bool = False):
    h = block.norm2.apply(p["norm2"], x)
    return x + _mlp(block.mlp, p["mlp"], h, kernel)


def _apply_mlp_decode(mlp, p, x, moe_dispatched: bool, routing):
    """The MLP of the slot steps (JAX :685): an MoE takes the
    drop-free fused dispatch (``MoE.decode_apply``) unless
    ``moe_dispatched`` is False (then its own ``apply``, the dense
    baseline); ``routing`` (a list, or None) collects ``(num_experts,
    (topi, full))`` per MoE layer for the expert telemetry."""
    if moe_dispatched and isinstance(mlp, MoE):
        p = _moe_params(mlp, p)
        if routing is None:
            return mlp.decode_apply(p, x)
        out, r = mlp.decode_apply(p, x, return_routing=True)
        routing.append((mlp.num_experts, r))
        return out
    return _mlp(mlp, p, x, kernel=True)


def _moe_route_stats(routing, t, w_len: int, live_len: int):
    """The step's expert telemetry (JAX :704): ``expert_load`` [E]
    (top-k assignments per expert summed over the MoE layers whose
    expert count is the first one's) and ``router_entropy`` (mean nats
    of the full router softmax), both over live slots only (``0 <= t <
    live_len``; the free-slot sentinel routes garbage). Device tensors;
    None when no MoE layer ran."""
    if not routing:
        return None
    live = ((t >= 0) & (t < live_len)).float()                 # [S]
    e0 = routing[0][0]
    load = torch.zeros(e0, device=t.device)
    ent_sum = torch.zeros((), device=t.device)
    n_layers = 0
    for e, (topi, full) in routing:
        if e != e0:
            continue
        oh = torch.nn.functional.one_hot(topi, e0).float().sum(-2)
        load = load + (oh * live[:, None, None]).sum((0, 1))
        pf = full.float()
        ent = -(pf * torch.log(pf + 1e-9)).sum(-1)             # [S, W]
        ent_sum = ent_sum + (ent * live[:, None]).sum()
        n_layers += 1
    n_tok = torch.clamp(live.sum() * w_len * n_layers, min=1.0)
    return {"expert_load": load, "router_entropy": ent_sum / n_tok}


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
    the compute dtype; int8/int4 payloads dequantize here (sliced first),
    so a chunked prefill attends to what later decode steps read."""
    k = kv["k"][:, :, lo:upto]
    v = kv["v"][:, :, lo:upto]
    if "k_scale" in kv:
        k = (k.float() * kv["k_scale"][:, :, lo:upto, None]).to(dt)
        v = (v.float() * kv["v_scale"][:, :, lo:upto, None]).to(dt)
    return k.to(dt), v.to(dt)


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
            x = x + _pos_rows(p["embeddings"], positions)[None].to(x.dtype)
        elif isinstance(layer, Dropout):
            pass
        else:
            if i == last and x.ndim == 3:
                x = x[:, -1:]            # head on the final position only
            x = _apply_layer(layer, p, x)
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
            x = x + _pos_rows(p["embeddings"], positions)[None].to(x.dtype)
        elif isinstance(layer, Dropout):
            pass
        else:
            if i == last and x.ndim == 3:
                x = x[:, -1:]
            x = _apply_layer(layer, p, x)
    return x[:, -1], cache


# --- slab decode (generate) --------------------------------------------------


def _decode_attn(attn: MultiHeadAttention, p, kv, x, t: int):
    """One-token attention against a slab cache at position ``t``: the
    projection, RoPE, the (quantizing) cache write, then
    ``ops.decode_attention`` over the ``[B*Hkv, L, D]`` view of the cache
    with the G query heads of each kv head as its rows (nothing is
    expanded or copied). x: ``[B, 1, d]``."""
    dt = torch_dtype(attn.dtype)
    q, k, v = _project_qkv(attn, p, x.to(dt), kernel=True)
    if attn.use_rope:
        pos = torch.full((1,), t, device=x.device)
        q = apply_rope(q, pos, scale=attn.rope_scale)
        k = apply_rope(k, pos, scale=attn.rope_scale)
    _cache_write(kv, k, v, t)
    b, _, nh, dh = q.shape
    rows = b * attn.kv_heads
    length = kv["k"].shape[2]
    sc = {}
    if "k_scale" in kv:
        sc = {key: kv[key].reshape(rows, length)
              for key in ("k_scale", "v_scale")}
    o = decode_attention(q[:, 0].reshape(rows, nh // attn.kv_heads, dh),
                         kv["k"].reshape(rows, length, dh),
                         kv["v"].reshape(rows, length, dh), t,
                         scale=dh ** -0.5, window=attn.attn_window, **sc)
    y = _attn_out(p, o.reshape(b, 1, nh, dh).to(dt), dt, kernel=True)
    return y.to(x.dtype)


def _decode_block(block: TransformerBlock, p, kv, x, t: int):
    h = block.norm1.apply(p["norm1"], x)
    x = x + _decode_attn(block.attn, p["attn"], kv, h, t).to(x.dtype)
    return _mlp_half(block, p, x, kernel=True)


@torch.no_grad()
def decode_step(module: Sequential, params, cache, tok, t: int):
    """One token per row through the stack against a slab cache: tok
    ``[B]``, ``t`` the position it is written at (a Python int); returns
    ``([B, V] logits, cache)``."""
    x = tok[:, None]
    for i, layer in enumerate(module.layers):
        p = params[i]
        block = _decode_block_of(layer)
        if block is not None:
            x = _decode_block(block, p, cache[i], x, t)
        elif isinstance(layer, PositionalEmbedding):
            pos = torch.full((1,), t, device=x.device)
            x = x + _pos_rows(p["embeddings"], pos)[None].to(x.dtype)
        elif isinstance(layer, Dropout):
            pass
        else:
            x = _apply_layer(layer, p, x)
    return x[:, 0], cache


# --- paged decode and the speculative verify window -------------------------
#
# A speculative verify scores an [S, W] window per slot at positions
# t .. t+W-1 in one pass (W = k+1: the pending input and k drafts), or a
# token TREE of W nodes: node j is written at window column t + j, roped
# and position-embedded at its root-path depth t + depth[j], and seen only
# by its descendants through the [S, W, W] ancestor mask. Positions past
# the accepted ones hold rejected drafts: masked until the stream's own
# later writes replace them, as a slab row's stale tail is.


class PageWrite(NamedTuple):
    """Where a window's writes land: one entry per (slot, window column),
    row-major, at offset ``offs[i]`` of physical page ``pages[i]``; a
    dead entry's page is the sink (``n_pages``, beyond every table) and
    its offset 0. ``halves`` (int4 pools with W > 1): the page vectors
    of the low- and the high-nibble pass, each sending the other half's
    entries to the sink."""
    pages: torch.Tensor
    offs: torch.Tensor
    halves: Optional[tuple] = None


def page_write_index(pos, table, page_len: int, n_pages: int,
                     split_halves: bool = False) -> PageWrite:
    """Where each slot's writes land, for positions ``pos`` ``[S]`` (one
    per slot) or ``[S, W]`` (a window): S * W entries whatever the
    tables hold (JAX's drop-mode scatter), so the write never asks the
    card how many there are. A position on an unallocated logical page
    (a sentinel entry), before 0 or past the table (the engine's
    free-slot sentinel, the commit's dropped depths) is dead: it writes
    the sink page, which no reader sees. Computed once per step and
    shared by every layer. ``split_halves`` adds the int4 split."""
    if pos.ndim == 1:
        pos = pos[:, None]
    n_logical = table.shape[1]
    pos = pos.long()
    lp = torch.div(pos, page_len, rounding_mode="floor")
    off = pos - lp * page_len
    pp = table.long().gather(1, lp.clamp(0, n_logical - 1))      # [S, W]
    live = (lp >= 0) & (lp < n_logical) & (pp < n_pages)
    pages = torch.where(live, pp, n_pages).reshape(-1)
    offs = torch.where(live, off, 0).reshape(-1)
    halves = None
    if split_halves and pos.shape[1] > 1:
        high = offs >= page_len // 2
        halves = (torch.where(high, n_pages, pages),
                  torch.where(high, pages, n_pages))
    return PageWrite(pages, offs, halves)


def _write_int4(plane, pages, offs, q):
    """Merge int4 values ``q`` ``[n, Hkv, D]`` into their nibbles of the
    packed byte rows (positions ``off`` and ``off -+ page_len/2`` share a
    row), keeping the other nibble: a read-modify-write whose live
    entries must not share a byte row."""
    half = plane.shape[2]
    prow = offs % half
    high = (offs >= half)[:, None, None]
    cur = plane[pages, :, prow].to(torch.int32) & 255
    nib = q.to(torch.int32) & 15
    b = torch.where(high, (cur & 0x0F) | (nib << 4), (cur & 0xF0) | nib)
    plane[pages, :, prow] = (b - 256 * (b > 127).to(torch.int32)) \
        .to(torch.int8)


def slab_write_index(pos, n_slots: int, length: int) -> PageWrite:
    """Where each slot's writes land in a slab pool (rows ``[S, Hkv, L,
    D]`` plus a sink row): ``page_write_index`` with one page of ``L``
    positions per slot, page ``s`` for slot ``s``. A position outside
    ``[0, L)`` (the engine's free-slot sentinel ``t >= L``, the commit's
    dropped depths) writes the sink row ``S``, which no reader sees:
    JAX's one-hot write (:732) that misses every position."""
    rows = torch.arange(n_slots, device=pos.device)[:, None]
    return page_write_index(pos, rows, length, n_slots)


def _cache_write_pages(kv, k, v, index: PageWrite):
    """Write ``[S, W, Hkv, D]`` k/v through the page tables (``index``
    from ``page_write_index``, or ``slab_write_index`` for a slab pool:
    JAX's ``_cache_write_slots`` :732), in place, quantizing for an
    int8/int4 pool. Every entry is written: a dead one into the sink page of the
    full planes (``with_sink``), so a live page sees only its live
    writes. An int4 page packs two positions half a page apart into one
    byte row: two window columns may share it, so the read-modify-write
    runs once per nibble half (``index.halves``), which is the
    column-by-column result of JAX's writer."""
    full = with_sink(kv)
    pages, offs = index.pages, index.offs
    kh = k.reshape((-1,) + tuple(k.shape[2:]))           # [S*W, Hkv, D]
    vh = v.reshape((-1,) + tuple(v.shape[2:]))
    if "k_scale" not in kv:
        full["k"][pages, :, offs] = kh.to(full["k"].dtype)
        full["v"][pages, :, offs] = vh.to(full["v"].dtype)
        return kv
    bits = _kv_bits(kv)
    for key, skey, x in (("k", "k_scale", kh), ("v", "v_scale", vh)):
        q, sc = _quantize_kv(x, bits)
        full[skey][pages, :, offs] = sc
        # a slab's int4 plane holds one byte per entry, as its scale plane
        # holds one scale: only a page pool packs two positions a byte
        if bits == 8 or full[key].shape[2] == full[skey].shape[2]:
            full[key][pages, :, offs] = q
        elif index.halves is None:
            _write_int4(full[key], pages, offs, q)
        else:
            for half_pages in index.halves:
                _write_int4(full[key], half_pages, offs, q)
    return kv


def _window_positions(t, w_len: int, tree=None):
    """Per window query cache positions (JAX :758): ``t + j`` for the
    causal chain, ``t + depth[j]`` for a token tree (siblings share a
    position while writing distinct window columns)."""
    if tree is None:
        return t.long()[:, None] + torch.arange(w_len, device=t.device)
    return t.long()[:, None] + tree["depth"].long()


def _gather_pages(kv, table):
    """Each slot's pages of a pool cache dict in logical order (JAX
    :986): ``[S, Hkv, P * page_len, D]`` k/v (int4 pages unpacked) and
    ``[S, Hkv, P * page_len]`` scale planes. Sentinel entries clamp to the
    last physical page: garbage the validity mask never admits."""
    packed = "q4" in kv
    out = {key: gather_pages(kv[key], table, packed=packed)
           for key in ("k", "v")}
    for key in ("k_scale", "v_scale"):
        if key in kv:
            out[key] = gather_pages(kv[key], table)
    return out


def _slot_attn_readout(attn: MultiHeadAttention, p, q, view, t, dt,
                       anc=None):
    """The masked per-slot attention of the window queries ``q`` ``[S, W,
    H, D]`` against a logically contiguous ``[S, Hkv, L, D]`` view (JAX
    :815), plus the output projection: a slab pool's rows, or a page
    gather in logical order (``decode_kernel="off"``), so the two are
    bitwise equal wherever the views hold equal values. Scores and
    values in the cache's dtype with float32 sums (an int8/int4 view's
    scales applied to the scores and folded into the probabilities); no
    attention kernel runs, on any device."""
    b, w_len, nh, dh = q.shape
    hkv = attn.kv_heads
    qg = (q.float() * dh ** -0.5).reshape(b, w_len, hkv, nh // hkv, dh)
    length = view["k"].shape[2]
    if "k_scale" in view:
        s = torch.einsum("bqhgd,bhkd->bhgqk", qg, view["k"].float()) \
            * view["k_scale"][:, :, None, None, :]
    else:
        cdt = view["k"].dtype
        s = torch.einsum("bqhgd,bhkd->bhgqk", qg.to(cdt).float(),
                         view["k"].float())
    valid = window_valid_mask(t, w_len, length, attn.attn_window, anc)
    s = s.masked_fill(~valid[:, None, None], NEG_INF)
    w = torch.softmax(s, dim=-1)
    if "v_scale" in view:
        w = w * view["v_scale"][:, :, None, None, :]
    else:
        w = w.to(view["v"].dtype).float()
    o = torch.einsum("bhgqk,bhkd->bqhgd", w, view["v"].float())
    out = o.to(dt).reshape(b, w_len, nh, dh)
    return _attn_out(p, out, dt, kernel=True)


def _paged_attn_readout(attn: MultiHeadAttention, p, q, kv, t, table, dt,
                        anc=None, kernel: bool = True):
    """The paged readout plus the output projection: queries in float32
    grouped ``[S, W, Hkv, G, D]``, K/V read through the page table (with
    the scale planes of an int8/int4 pool), the tree ancestor mask
    ``anc`` when given. ``kernel`` False reads the pages through the
    gather readout, ``_slot_attn_readout`` over ``_gather_pages`` (the
    engine's ``decode_kernel="off"``)."""
    if not kernel:
        return _slot_attn_readout(attn, p, q, _gather_pages(kv, table), t,
                                  dt, anc)
    b, w_len, nh, dh = q.shape
    hkv = attn.kv_heads
    qg = q.float().reshape(b, w_len, hkv, nh // hkv, dh)
    sc = {}
    if "k_scale" in kv:
        sc = {"k_scale": kv["k_scale"], "v_scale": kv["v_scale"]}
    o = paged_decode_attention(qg, kv["k"], kv["v"], t, table,
                               scale=dh ** -0.5, window=attn.attn_window,
                               anc=anc, **sc)
    out = o.reshape(b, w_len, nh, dh).to(dt)
    return _attn_out(p, out, dt, kernel=True)


def _decode_block_slots_window(block: TransformerBlock, p, kv, x, t, table,
                               index, tree=None, kv_out=None,
                               moe_dispatched: bool = True, routing=None,
                               paged_kernel: bool = True):
    """One block over an ``[S, W, d]`` window at per-slot positions
    (JAX :1152): project, rope at ``_window_positions``, write all W
    positions through ``index`` (the page tables, or a slab pool's rows
    when ``table`` is None), then the readout (the tree mask with
    ``tree``; a slab's is ``_slot_attn_readout`` over its rows) and
    ``_apply_mlp_decode``. The roped window k/v go to ``kv_out`` (the
    caller's list) for ``commit_tree_path``."""
    attn = block.attn
    dt = torch_dtype(attn.dtype)
    xc = block.norm1.apply(p["norm1"], x).to(dt)
    q, k, v = _project_qkv(attn, p["attn"], xc, kernel=True)
    if attn.use_rope:
        pos = _window_positions(t, q.shape[1], tree)
        q = apply_rope(q, pos, scale=attn.rope_scale)
        k = apply_rope(k, pos, scale=attn.rope_scale)
    if kv_out is not None:
        kv_out.append((k, v))
    _cache_write_pages(kv, k, v, index)
    anc = None if tree is None else tree["anc"]
    if table is None:
        y = _slot_attn_readout(attn, p["attn"], q, kv, t, dt, anc)
    else:
        y = _paged_attn_readout(attn, p["attn"], q, kv, t, table, dt,
                                anc=anc, kernel=paged_kernel)
    x = x + y.to(x.dtype)
    h = block.norm2.apply(p["norm2"], x)
    return x + _apply_mlp_decode(block.mlp, p["mlp"], h, moe_dispatched,
                                 routing)


def _verify_window(module: Sequential, params, cache, toks, t, table,
                   page_len: int, tree=None, moe_dispatched: bool = True,
                   moe_stats=None, paged_kernel: bool = True):
    """``[S, W]`` window tokens through the stack against the paged pool
    (or with ``table`` None a slab pool) at per-slot positions (JAX
    :1201); returns ``([S, W, V] logits,
    cache)``, plus with ``tree`` (``{"depth": [S, W], "anc": [S, W,
    W]}``) the per-layer roped window k/v (None for other layers), plus
    with ``moe_stats`` (the live-position bound) the ``_moe_route_stats``
    of the step. MoE blocks see the window as ONE slot-token batch
    (capacity ``S * W``: drop-free). ``paged_kernel`` False reads the
    pages through the gather readout instead of the paged kernel
    (JAX's ``paged_kernel=False``; the TPU tiling gate is not carried
    over)."""
    x = toks
    w_len = toks.shape[1]
    kv0 = next(kv for kv in cache if kv is not None)
    pos = t.long()[:, None] + torch.arange(w_len, device=t.device)
    if table is None:
        index = slab_write_index(pos, *_slab_dims(kv0))
    else:
        index = page_write_index(pos, table, page_len, kv0["k"].shape[0],
                                 split_halves="q4" in kv0)
    kv_win = [] if tree is not None else None
    routing = [] if moe_stats is not None else None
    for i, layer in enumerate(module.layers):
        p = params[i]
        block = _decode_block_of(layer)
        if block is not None:
            x = _decode_block_slots_window(block, p, cache[i], x, t, table,
                                           index, tree, kv_win,
                                           moe_dispatched, routing,
                                           paged_kernel)
        elif isinstance(layer, PositionalEmbedding):
            pos = _window_positions(t, w_len, tree).clamp(
                0, layer.max_len - 1)
            x = x + _pos_rows(p["embeddings"], pos).to(x.dtype)
        elif isinstance(layer, Dropout):
            pass
        else:
            x = _apply_layer(layer, p, x)
    out = (x, cache)
    if tree is not None:
        it = iter(kv_win)
        out += ([next(it) if _decode_block_of(layer) is not None else None
                 for layer in module.layers],)
    if moe_stats is not None:
        out += (_moe_route_stats(routing, t, w_len, int(moe_stats)),)
    return out


def _slab_dims(kv):
    """``(slots, positions)`` of a slab pool's cache dict."""
    return kv["k"].shape[0], kv["k"].shape[2]


@torch.no_grad()
def decode_step_slots(module: Sequential, params, cache, tok, t, *,
                      moe_dispatched: bool = True, moe_stats=None):
    """One token per slot through the stack against a slab pool (JAX
    :877): tok ``[S]``, t ``[S]`` int32 per-slot positions; returns
    ``([S, V] logits, cache)``, plus the step's ``_moe_route_stats``
    with ``moe_stats``. A slot whose ``t`` is out of the rows' range
    (the engine's free-slot sentinel ``max_len``) writes the sink row
    and gives logits the caller discards. The readout is
    ``_slot_attn_readout``: no attention kernel runs, as JAX's slab
    engine always takes its einsum path."""
    out = _verify_window(module, params, cache, tok[:, None], t, None, 0,
                         moe_dispatched=moe_dispatched,
                         moe_stats=moe_stats)
    return (out[0][:, 0],) + out[1:]


@torch.no_grad()
def verify_step_slots(module: Sequential, params, cache, toks, t, *,
                      tree=None, moe_dispatched: bool = True,
                      moe_stats=None):
    """Batched speculative verify against a slab pool (JAX :1249): the
    slab mirror of ``verify_step_slots_paged``, with the same window,
    tree and MoE contract; every write lands (a window position past
    the row goes to the sink row)."""
    return _verify_window(module, params, cache, toks, t, None, 0,
                          tree=tree, moe_dispatched=moe_dispatched,
                          moe_stats=moe_stats)


@torch.no_grad()
def decode_step_slots_paged(module: Sequential, params, cache, tok, t,
                            table, page_len: int, *,
                            moe_dispatched: bool = True, moe_stats=None,
                            paged_kernel: bool = True):
    """One token per slot through the stack against the paged pool:
    tok ``[S]``, t ``[S]`` int32, table ``[S, P]`` int32; returns
    ``([S, V] logits, cache)``, plus the step's ``_moe_route_stats``
    with ``moe_stats``. Slots whose ``t`` is the out-of-range sentinel
    write nothing and give logits the caller discards. MoE blocks run
    ``MoE.decode_apply`` (``moe_dispatched``) or their own ``apply``;
    ``paged_kernel`` False is the gather readout."""
    out = _verify_window(module, params, cache, tok[:, None], t, table,
                         page_len, moe_dispatched=moe_dispatched,
                         moe_stats=moe_stats, paged_kernel=paged_kernel)
    return (out[0][:, 0],) + out[1:]


@torch.no_grad()
def verify_step_slots_paged(module: Sequential, params, cache, toks, t,
                            table, page_len: int, *, tree=None,
                            moe_dispatched: bool = True, moe_stats=None,
                            paged_kernel: bool = True):
    """Batched speculative verify against the paged pool (JAX :1276):
    toks ``[S, W]`` (column 0 the slot's pending input, then its drafts
    or tree nodes), t ``[S]`` window starts. ``logits[:, j]`` is the
    target's next-token distribution after window position j. Writes
    past allocated pages drop. With ``tree`` the return gains the
    per-layer window k/v for ``commit_tree_path``; a chain-shaped tree
    (``depth[j] = j``, lower-triangular ``anc``) reproduces the plain
    window bit for bit. ``moe_dispatched``/``moe_stats``/``paged_kernel``
    as in ``decode_step_slots_paged`` (the stats come last)."""
    return _verify_window(module, params, cache, toks, t, table, page_len,
                          tree=tree, moe_dispatched=moe_dispatched,
                          moe_stats=moe_stats, paged_kernel=paged_kernel)


@torch.no_grad()
def decode_fused_slots(module: Sequential, params, cache, tok, t, stop,
                       num_steps: int, table, page_len: int, *,
                       temperature=None, top_k=None, top_p=None,
                       keys=None, sampler=None,
                       moe_dispatched: bool = True, moe_stats=None,
                       paged_kernel: bool = True,
                       on_logits: Optional[Callable] = None):
    """``num_steps`` consecutive ``decode_step_slots_paged`` steps as one
    unit (JAX :1425; its ``lax.scan`` is a Python loop here): each
    step's token feeds the next on the device, the host reads nothing
    in between. tok ``[S]`` int64, t ``[S]`` int32, ``stop`` ``[S]``
    int64 per-slot stop tokens (-1: never). Greedy when ``temperature``
    is None; otherwise ``temperature``/``top_k``/``top_p`` are ``[S]``
    tensors and ``keys`` the ``[S, 2]`` per-slot PRNG keys, split once
    per step (the second half draws, the first carries) through
    ``sampler`` (``_sample_vec`` by default, or
    ``ops.sampling.sample_tokens``), as the single-step loop does, so a
    sampled stream is byte-identical to K single steps. ``generate()``'s
    stop rule per slot: once a row emits its stop token, the rest of its
    window repeats it. ``on_logits(logits)`` sees each step's ``[S, V]``
    logits. ``paged_kernel`` as in ``decode_step_slots_paged``; with
    ``table`` None the steps are ``decode_step_slots`` over a slab pool
    (JAX's ``table=None``). Returns
    ``(toks [S, num_steps], cache, keys, stats)``: ``keys`` the carried
    keys (None when greedy), ``stats`` the LAST step's
    ``_moe_route_stats`` with ``moe_stats``, else None.

    Step j writes position ``t + j`` of every slot: the caller has
    allocated every page a slot will consume; a write past them lands
    in the sink, and a row's writes after its stop are stale tail that
    no later read admits."""
    sample = _sample_vec if sampler is None else sampler
    cur, tcur = tok, t
    done = torch.zeros(tok.shape, dtype=torch.bool, device=tok.device)
    cols, stats = [], None
    for j in range(int(num_steps)):
        last = j == num_steps - 1
        kw = dict(moe_dispatched=moe_dispatched,
                  moe_stats=moe_stats if last else None)
        if table is None:
            out = decode_step_slots(module, params, cache, cur, tcur, **kw)
        else:
            out = decode_step_slots_paged(
                module, params, cache, cur, tcur, table, page_len,
                paged_kernel=paged_kernel, **kw)
        logits = out[0]
        if on_logits is not None:
            on_logits(logits)
        if temperature is None:
            nxt = torch.argmax(logits, dim=-1)
        else:
            pair = prng.split(keys)                       # [S, 2, 2]
            keys = pair[:, 0]
            nxt = sample(logits, temperature, top_k, top_p, pair[:, 1])
        nxt = torch.where(done, stop, nxt)
        done = done | ((nxt == stop) & (stop >= 0))
        cols.append(nxt)
        cur, tcur = nxt, tcur + 1
        if last and moe_stats is not None:
            stats = out[-1]
    return torch.stack(cols, dim=1), cache, keys, stats


def tree_walk(logits, toks, parents, *, temperature=None, top_k=None,
              top_p=None, keys=None):
    """Acceptance over a verified token tree (JAX :1296): from the root,
    draw the target's choice ``x`` at the current node (argmax, or one
    ``_sample_vec`` draw), emit it, descend into the lowest-index child
    whose token is ``x``, or stop. ``logits`` ``[S, W, V]``; ``toks``,
    ``parents`` ``[S, W]`` numpy (unused nodes have parent -1).

    Sampled (``temperature``/``top_k``/``top_p`` ``[S]`` tensors,
    ``keys`` the ``[S, 2]`` per-slot PRNG keys): each step splits every
    slot's key, draws with the second half and carries the first where
    the row still walks, exactly one split per emitted token, as plain
    decode splits, so a sampled speculative stream equals the plain one.
    The walk runs on the host (one fetch of the candidates per step, or
    of all argmaxes when greedy).

    Returns ``(emitted [S, W], n_emit [S], path [S, W], new_keys)``:
    numpy ``emitted[s, :n_emit[s]]`` the tokens (-1 after), ``path[s,
    d]`` the accepted node at depth d, and the post-walk keys on the
    keys' device (None when greedy)."""
    s_n, w_len, _ = logits.shape
    toks = np.asarray(toks)
    parents = np.asarray(parents)
    rows = np.arange(s_n)
    cur = np.zeros(s_n, np.int64)
    walking = np.ones(s_n, bool)
    n_emit = np.zeros(s_n, np.int64)
    emitted = np.full((s_n, w_len), -1, np.int64)
    path = np.zeros((s_n, w_len), np.int64)
    greedy = temperature is None
    if greedy:
        cand = torch.argmax(logits, dim=-1).cpu().numpy()       # [S, W]
    row_idx = torch.arange(s_n, device=logits.device)
    for step in range(w_len):
        path[:, step] = cur
        if not walking.any():
            continue
        if greedy:
            x = cand[rows, cur]
        else:
            pair = prng.split(keys)                       # [S, 2, 2]
            lg = logits[row_idx, torch.from_numpy(cur).to(logits.device)]
            x = _sample_vec(lg, temperature, top_k, top_p, pair[:, 1]) \
                .cpu().numpy()
            # the key advances only where the row emits
            keys = torch.where(torch.from_numpy(walking).to(keys.device)
                               [:, None], pair[:, 0], keys)
        emitted[walking, step] = x[walking]
        n_emit += walking
        is_child = (parents == cur[:, None]) & (toks == x[:, None]) \
            & walking[:, None]
        has = is_child.any(axis=1)
        walking &= has
        cur = np.where(walking, np.argmax(is_child, axis=1), cur)
    return emitted, n_emit, path, None if greedy else keys


@torch.no_grad()
def commit_tree_path(cache, kv_win, path, t, n_emit, table=None,
                     page_len: int = 0):
    """Write the accepted root path's K/V at its contiguous final
    positions ``t .. t+n_emit-1`` (JAX :1366): the verify wrote node j at
    window column ``t + j``; the node accepted at depth d belongs at ``t +
    d`` and was roped there. Depths at or past ``n_emit`` write nothing.
    A chain-shaped path rewrites identical bytes. ``table`` None commits
    into a slab pool's rows."""
    dev = t.device
    path = torch.as_tensor(np.asarray(path), device=dev).long()
    n_emit = torch.as_tensor(np.asarray(n_emit), device=dev).long()
    w_len = path.shape[1]
    depth = torch.arange(w_len, device=dev)
    # a dropped depth goes to position -1: before every page, never
    # wrapping whatever the integer width
    pos = torch.where(depth[None, :] < n_emit[:, None],
                      t.long()[:, None] + depth[None, :],
                      torch.full_like(path, -1))
    kv0 = next(kv for kv in cache if kv is not None)
    if table is None:
        index = slab_write_index(pos, *_slab_dims(kv0))
    else:
        index = page_write_index(pos, table, page_len, kv0["k"].shape[0],
                                 split_halves="q4" in kv0)
    sel = path[:, :, None, None]
    for kv, kvw in zip(cache, kv_win):
        if kvw is None:
            continue
        k, v = kvw
        kc = torch.gather(k, 1, sel.expand(-1, -1, *k.shape[2:]))
        vc = torch.gather(v, 1, sel.expand(-1, -1, *v.shape[2:]))
        _cache_write_pages(kv, kc, vc, index)
    return cache


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


def _sample_vec(logits, temperature, top_k, top_p, keys):
    """Per-row sampling (JAX :1539): every knob is a ``[B]`` tensor
    (``temperature 0`` = greedy, ``top_k <= 0`` = no truncation, ``top_p
    >= 1`` = no nucleus cut); ``keys`` is a ``[B, 2]`` batch of per-row
    keys (the engine: a request's draws depend only on its own key,
    JAX's ``vmap(categorical)``) or one key (``generate()``: one field
    over the whole ``[B, V]``). A draw is ``argmax(masked logits +
    Gumbel field)``, JAX's categorical; the field is one K7 launch on
    the card."""
    greedy = torch.argmax(logits, dim=-1)
    lf = _masked_logits_vec(logits, temperature, top_k, top_p)
    field = prng.gumbel(keys, lf.shape if keys.ndim == 1 else lf.shape[1:])
    sampled = torch.argmax(lf + field, dim=-1)
    return torch.where(temperature > 0.0, sampled, greedy)


# --- generate() ---------------------------------------------------------------


def _sample(logits, temperature: float, top_k: Optional[int], rng,
            top_p: Optional[float] = None):
    """Scalar-knob sampling (JAX ``_sample``): argmax at temperature 0;
    otherwise temperature-scaled float32 logits, top-k by INDEX (a
    stable descending sort, so ties at the k-th logit go to the lowest
    index as ``lax.top_k`` orders them), then the nucleus cut (a token
    survives iff the probability mass strictly above it is ``< top_p``),
    then ``categorical(rng, logits)``: one key's Gumbel field over the
    whole ``[B, V]``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    lf = logits.float() / temperature
    if top_k is not None:
        idx = torch.argsort(-lf, dim=-1, stable=True)[..., :int(top_k)]
        keep = torch.zeros_like(lf, dtype=torch.bool).scatter_(-1, idx, True)
        lf = torch.where(keep, lf, torch.full_like(lf, NEG_INF))
    if top_p is not None:
        sorted_logits = torch.flip(torch.sort(lf, dim=-1).values, dims=(-1,))
        probs = torch.softmax(sorted_logits, dim=-1)
        exclusive = torch.cumsum(probs, dim=-1) - probs
        thresh = torch.where(exclusive < top_p, sorted_logits,
                             torch.full_like(sorted_logits, float("inf"))) \
            .amin(dim=-1, keepdim=True)
        lf = torch.where(lf >= thresh, lf, torch.full_like(lf, NEG_INF))
    return prng.categorical(rng, lf)


def _per_seq_vec(value, b: int, dtype, none_sentinel, name: str):
    """A scalar-or-``[B]`` sampling knob as a ``[B]`` numpy vector
    (``None`` -> the disabled sentinel; scalars broadcast)."""
    if value is None:
        value = none_sentinel
    arr = np.asarray(value, dtype)
    if arr.ndim == 0:
        return np.full((b,), arr, dtype)
    if arr.shape != (b,):
        raise ValueError(
            f"per-sequence {name} must have shape ({b},) to match the "
            f"prompt batch, got {arr.shape}")
    return arr


def _is_per_seq(value) -> bool:
    """True when a sampling knob was passed as a per-sequence array
    (list/tuple or an array with a batch dim) rather than a scalar."""
    if value is None or isinstance(value, (int, float)):
        return False
    if isinstance(value, (list, tuple)):
        return True
    return getattr(value, "ndim", 0) >= 1


def _weight_quant_kind(weights_dtype) -> Optional[str]:
    """``"int8"``/``"int4"`` for a quantized ``weights_dtype`` (an int8
    dtype means ``"int8"``, as in JAX), else None."""
    if isinstance(weights_dtype, str):
        return weights_dtype if weights_dtype in ("int8", "int4") else None
    if weights_dtype in (torch.int8, np.int8):
        return "int8"
    return None


def _generate_params(model, weights_dtype, compute_dt):
    """The parameter tree ``generate()`` runs: the model's own
    (``weights_dtype=None``), its matrices cast to a float dtype once
    with q/k/v fused into ``wqkv``, or (``"int8"``/``"int4"``) the
    ``models.quantize`` tree as qdicts. Trees are cached on the model
    per dtype and rebuilt when any parameter changed (a new tensor, or
    an in-place update that bumped its version counter)."""
    if weights_dtype == "auto":
        weights_dtype = compute_dt if (compute_dt is not None and
                                       compute_dt != torch.float32) else None
    if weights_dtype is None:
        return model.params
    key = _weight_quant_kind(weights_dtype)
    if key is None:
        key = weights_dtype if isinstance(weights_dtype, torch.dtype) else \
            torch_dtype(weights_dtype if isinstance(weights_dtype, str)
                        else np.dtype(weights_dtype).name)
        if not key.is_floating_point:
            raise ValueError(
                f"weights_dtype {key} unsupported: use a float dtype, "
                "'int8'/'int4' (weight-only quantized serving), 'auto' or "
                "None")
    sig = tuple((id(p), p._version) for p in model.module.parameters())
    cache_all = getattr(model, "_serving_params_cache", None)
    if cache_all is None:
        cache_all = model._serving_params_cache = {}
    for stale in [k for k, (s, _) in cache_all.items() if s != sig]:
        del cache_all[stale]
    entry = cache_all.get(key)
    if entry is None:
        with torch.no_grad():
            if isinstance(key, str):
                from distkeras_tpu_torch.models.quantize import \
                    quantize_params_qdicts
                tree = quantize_params_qdicts(model.params,
                                              4 if key == "int4" else 8)
            else:
                tree = fuse_qkv_params(model.module,
                                       serving_params(model.params, key))
        entry = cache_all[key] = (sig, tree)
    return entry[1]


@torch.inference_mode()
def generate(model, prompts, max_new_tokens: int,
             temperature=0.0, top_k=None, top_p=None, seed: int = 0,
             cache_dtype=None, stop_token=None, weights_dtype="auto",
             as_numpy: bool = True, prefill_chunk: Optional[int] = None):
    """Autoregressive continuation over a slab KV cache (JAX
    ``generate`` :1710): ``[B, P]`` int prompts -> ``[B, P +
    max_new_tokens]`` tokens.

    One prefill (``prefill_chunk``: in chunks of that many positions)
    writes the ``[B, Hkv, P + max_new_tokens, Dh]`` cache, then one
    ``decode_step`` per new token, a Python loop of eager steps. On the
    card each step's attention is the K2 decode kernel (the int8 variant
    for an int8/int4 cache), at every cache length.

    ``temperature=0`` is greedy; otherwise softmax sampling truncated by
    ``top_k`` (index-exact) and/or ``top_p`` (nucleus). The four knobs
    ``temperature``/``top_k``/``top_p``/``stop_token`` also take
    per-sequence ``[B]`` arrays (sentinels: temperature 0 greedy, top_k 0
    none, top_p 1.0 none, stop_token -1 never). Draws follow JAX's key
    chain: ``rng = PRNGKey(seed)``, then before every token ``rng, sub =
    split(rng)`` and one categorical draw over the whole ``[B, V]`` from
    ``sub`` (``ops.prng``, K7 on the card), so a seed gives JAX's
    tokens. Once a row emits ``stop_token`` every later position is that
    token.

    ``cache_dtype`` None means the attention compute dtype; ``"int8"`` /
    ``"int4"`` quantize the cache per token and head. ``weights_dtype``
    ``"auto"`` casts matrices to a non-float32 compute dtype once (cached
    on the model, q/k/v fused), None runs the model's own weights, a
    float dtype forces one; ``"int8"``/``"int4"`` (or an int8 dtype)
    quantize the matrices once (``models.quantize``, cached on the
    model): the decode steps' projections, MLP and head run the K5
    quantized matmul, the prefill dequantizes one leaf at a time.
    Returns numpy (``as_numpy``) or a tensor on the model's device."""
    module = model.module
    if not isinstance(module, Sequential):
        raise TypeError("generate() expects a Sequential LM "
                        f"(got {type(module).__name__})")
    prompts_np = prompts.cpu().numpy() if torch.is_tensor(prompts) \
        else np.asarray(prompts)
    if prompts_np.ndim != 2:
        raise ValueError(f"prompts must be [B, P], got {prompts_np.shape}")
    max_new_tokens = int(max_new_tokens)
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, "
                         f"got {max_new_tokens}")
    per_seq = any(_is_per_seq(v)
                  for v in (temperature, top_k, top_p, stop_token))
    if not per_seq and top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if prefill_chunk is not None:
        prefill_chunk = int(prefill_chunk)
        if prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}")
    dev = model.device
    if max_new_tokens == 0:
        return prompts_np if as_numpy else torch.as_tensor(
            prompts_np, device=dev)
    b, p_len = prompts_np.shape
    total = p_len + max_new_tokens
    samp = None
    if per_seq:
        samp = {"temperature": _per_seq_vec(temperature, b, np.float32, 0.0,
                                            "temperature"),
                "top_k": _per_seq_vec(top_k, b, np.int64, 0, "top_k"),
                "top_p": _per_seq_vec(top_p, b, np.float32, 1.0, "top_p"),
                "stop": _per_seq_vec(stop_token, b, np.int64, -1,
                                     "stop_token")}
        if ((samp["top_p"] <= 0.0) | (samp["top_p"] > 1.0)).any():
            raise ValueError(
                f"top_p entries must be in (0, 1], got {samp['top_p']}")
    for layer in module.layers:
        if isinstance(layer, PositionalEmbedding) and total > layer.max_len:
            raise ValueError(
                f"PositionalEmbedding(max_len={layer.max_len}) is too "
                f"small for prompt {p_len} + {max_new_tokens} new tokens "
                f"= {total} positions")
    compute_dt = attn_compute_dtype(module)
    if cache_dtype is None:
        cache_dtype = compute_dt if compute_dt is not None else torch.float32
    params = _generate_params(model, weights_dtype, compute_dt)
    cache = init_cache(module, b, total, cache_dtype, dev, check_len=total)
    rng = prng.key(seed, device=dev)

    if per_seq:
        knobs = {key: torch.from_numpy(samp[key]).to(dev)
                 for key in ("temperature", "top_k", "top_p")}
        sampled = bool((samp["temperature"] > 0.0).any())
        stop_v = torch.from_numpy(samp["stop"]).to(dev)

        def draw(logits, sub):
            return _sample_vec(logits, knobs["temperature"], knobs["top_k"],
                               knobs["top_p"], sub)

        def stopped(nxt):
            return (nxt == stop_v) & (stop_v >= 0)
    else:
        stop_v = None if stop_token is None else torch.full(
            (b,), int(stop_token), dtype=torch.long, device=dev)
        sampled = float(temperature) != 0.0

        def draw(logits, sub):
            return _sample(logits, float(temperature), top_k, sub, top_p)

        def stopped(nxt):
            if stop_v is None:
                return torch.zeros_like(nxt, dtype=torch.bool)
            return nxt == stop_v

    def sample_next(logits):
        """``rng, sub = split(rng)``, then the draw; an all-greedy batch
        takes the argmax, whose tokens no key changes."""
        nonlocal rng
        if not sampled:
            return torch.argmax(logits, dim=-1)
        pair = prng.split(rng)
        rng = pair[0]
        return draw(logits, pair[1])

    tokens = torch.zeros((b, total), dtype=torch.long, device=dev)
    tokens[:, :p_len] = torch.from_numpy(prompts_np.astype(np.int64)).to(dev)
    if prefill_chunk is not None and p_len > prefill_chunk:
        for t0 in range(0, p_len, prefill_chunk):
            q_len = min(prefill_chunk, p_len - t0)
            last_logits, cache = prefill_chunk_step(
                module, params, cache, tokens[:, t0:t0 + q_len], t0,
                final=t0 + q_len >= p_len)
    else:
        last_logits, cache = prefill(module, params, cache,
                                     tokens[:, :p_len])
    first = sample_next(last_logits)
    done = stopped(first)
    tokens[:, p_len] = first
    for t in range(p_len, total - 1):
        logits, cache = decode_step(module, params, cache, tokens[:, t], t)
        nxt = sample_next(logits)
        if stop_v is not None:
            nxt = torch.where(done, stop_v, nxt)
            done = done | stopped(nxt)
        tokens[:, t + 1] = nxt
    if not as_numpy:
        return tokens
    out = tokens.cpu().numpy()
    if np.issubdtype(prompts_np.dtype, np.integer):
        out = out.astype(prompts_np.dtype)
    return out
