"""Weight-only int8 / int4 quantized matmul: the quantized-weight format
of the serving engine, its plain PyTorch version and the wrapper of the
hand-written CUDA kernel (``csrc/quant_matmul.cu``, K5).

Replaces ``distkeras_tpu/ops/quant_matmul.py`` ``quant_matmul`` (:263,
the ``pl.pallas_call`` at :282, body ``_kernel`` :212) and ports the
rest of that module: ``is_qdict`` :95, ``pack_rows`` :135 /
``unpack_rows`` :146, ``quantize_weight`` :157, ``dequant_weight`` :190,
``quant_error`` :198, ``_resolve_2d`` :224, ``reference_matmul`` :249,
``quantize_params_tree`` :313 with ``_ATTN_REDUCE`` :310,
``dequant_params_tree`` :334 and ``tree_quant_errors`` :356.

Quantized-weight format (one dict per weight leaf, the original leaf
shape preserved):

* int8: ``{"q": int8 (the weight's shape), "scale": float32}``;
* int4: values on the [-7, 7] grid; with an even leading axis the rows
  are nibble-packed along axis 0 as ``{"q4": int8 [s0 // 2, ...],
  "scale"}``: byte row r holds logical row r in the low nibble and row
  ``r + s0 // 2`` in the high one (the half-split of the int4 KV
  pages); an odd leading axis keeps one byte per entry under ``"q"``.

``scale`` is per output channel and broadcasts against the trailing
axes of the unpacked ``q`` (wq ``[d, h, e]`` carries ``[h, e]``, wo
``[h, e, d]`` carries ``[d]``), so ``q * scale`` needs no metadata.

``quant_matmul(x, wq)`` contracts ``x [..., K]`` against the 2-D view of
the weight. Both layouts resolve from shapes alone: ``q.shape[0] == K``
is the projection layout (``[d, h, e]`` seen as ``[d, h*e]``), else the
leading axes flatten to K (wo ``[h, e, d]`` seen as ``[h*e, d]``). The
axis-0 nibble packing commutes with both flattenings, so byte row r of
the 2-D view pairs logical rows r and r + K/2 in either layout.

The wrapper launches K5 for a tensor on the card and takes the plain
version (``reference_matmul``) for a tensor on the CPU; nothing falls
back. The TPU gates (``fused_supported``, ``choose_block_n``,
``MAX_BLOCK_N``, K % 128, the %8 row pad) are not carried over: the
kernel takes every K and N.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from distkeras_tpu_torch import kernels

#: output columns one block owns
BLOCK_N = 128
#: weight byte rows one shared-memory stage holds (a K split is a
#: multiple of it)
STAGE_ROWS = 64
#: K splits of one column tile: one thread-block cluster
MAX_SPLIT = 8
#: blocks the plan aims for, per SM (K splits and 16-row tiles)
BLOCKS_PER_SM = 1.5
#: activation rows one CUDA-core block holds per launch tile
M_TILES = (1, 2, 4, 8)
#: bf16 activations from this many rows on take the tensor cores
TC_MIN_ROWS = 5
#: the most 16-row tiles a tensor-core block holds
TC_MAX_TILES = 5


def is_qdict(p) -> bool:
    """Whether a parameter-tree node is one quantized weight leaf."""
    return (isinstance(p, dict) and "scale" in p
            and ("q" in p or "q4" in p))


# --- quantize / dequantize ---------------------------------------------------


def pack_rows(q: torch.Tensor) -> torch.Tensor:
    """Nibble-pack int4-valued int8 rows along axis 0 (even length):
    byte row r = logical row r (low nibble) | row r + s0/2 << 4. Nibble
    math in int32, as in JAX."""
    s0 = q.shape[0]
    lo = q[: s0 // 2].to(torch.int32) & 15
    hi = q[s0 // 2:].to(torch.int32) & 15
    b = (hi << 4) | lo
    return (b - 256 * (b > 127).to(torch.int32)).to(torch.int8)


def unpack_rows(b: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_rows`: ``[s0/2, ...]`` bytes -> ``[s0,
    ...]`` int8 values in [-7, 7], low-nibble rows first."""
    b32 = b.to(torch.int32) & 255
    lo = b32 & 15
    lo = lo - 16 * (lo > 7).to(torch.int32)
    hi = (b32 >> 4) & 15
    hi = hi - 16 * (hi > 7).to(torch.int32)
    return torch.cat([lo, hi], dim=0).to(torch.int8)


def quantize_weight(w, bits: int = 8,
                    reduce_axes: Optional[Tuple[int, ...]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Symmetric per-channel quantization of one weight (a tensor or a
    numpy array), computed in float32 on the weight's device.

    ``reduce_axes`` are the contraction axes the scale absorbs (default:
    all but the last); the scale keeps the other trailing axes.
    ``bits=4`` packs along axis 0 when its length is even. Bitwise the
    JAX package's bytes and scales: absmax / qmax in float32, a zero
    channel's scale 1, round half to even, clip."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    w = torch.as_tensor(w).detach().float()
    if w.ndim < 2:
        raise ValueError(f"need a matrix-shaped weight, got "
                         f"{tuple(w.shape)}")
    if reduce_axes is None:
        reduce_axes = tuple(range(w.ndim - 1))
    reduce_axes = tuple(sorted(a % w.ndim for a in reduce_axes))
    if reduce_axes != tuple(range(len(reduce_axes))):
        raise ValueError(
            f"reduce_axes must be a leading prefix, got {reduce_axes}")
    qmax = 7.0 if bits == 4 else 127.0
    absmax = w.abs().amax(dim=reduce_axes, keepdim=True)
    scale = absmax / qmax
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / scale), -qmax, qmax).to(torch.int8)
    scale = scale.reshape(w.shape[len(reduce_axes):]).contiguous()
    if bits == 4 and q.shape[0] % 2 == 0:
        return {"q4": pack_rows(q), "scale": scale}
    return {"q": q, "scale": scale}


def dequant_weight(wq: Dict, dtype=torch.float32) -> torch.Tensor:
    """``q * scale`` in float32, back in the original weight shape, cast
    to ``dtype``."""
    q = unpack_rows(wq["q4"]) if "q4" in wq else wq["q"]
    return (q.float() * wq["scale"]).to(dtype)


def gather_rows(wq: Dict, idx) -> torch.Tensor:
    """Rows ``idx`` (any integer index tensor) of a quantized table
    ``[rows, d]``, dequantized to float32 ``[..., d]``: the byte rows are
    gathered first and only their nibble half unpacked (a packed table
    holds row r and r + rows/2 in one byte row), so the table is never
    dequantized whole."""
    idx = torch.as_tensor(idx).long()
    if "q4" in wq:
        half = wq["q4"].shape[0]
        b = wq["q4"][idx % half].to(torch.int32) & 255
        nib = torch.where((idx >= half)[..., None], b >> 4, b & 15)
        q = nib - 16 * (nib > 7).to(torch.int32)
    else:
        q = wq["q"][idx]
    return q.float() * wq["scale"]


def quant_error(w, wq) -> Dict[str, float]:
    """Per-leaf reconstruction error of one quantized weight:
    ``max_abs_err`` and ``rel_rms``, in float32 numpy on the host as the
    JAX package computes them, so a leaf on the card gets no float copy
    there."""
    w = torch.as_tensor(w).detach().cpu().float().numpy()
    deq = dequant_weight({k: v.detach().cpu() for k, v in wq.items()})
    err = deq.numpy().reshape(w.shape) - w
    denom = float(np.sqrt(np.mean(w ** 2))) or 1.0
    return {"max_abs_err": float(np.abs(err).max()),
            "rel_rms": float(np.sqrt(np.mean(err ** 2)) / denom)}


# --- the matmul --------------------------------------------------------------


def _resolve_2d(x_k: int, wq: Dict):
    """Resolve the weight dict against a contraction length: ``(q2d,
    scale1d, int4, n)`` with ``q2d`` the ``[K or K/2, N]`` byte view.
    The projection layout (``q.shape[0] == K``) wins; otherwise the
    output-projection layout (leading axes flatten to K)."""
    int4 = "q4" in wq
    q = wq["q4"] if int4 else wq["q"]
    mult = 2 if int4 else 1
    if q.shape[0] * mult == x_k:
        q2d = q.reshape(q.shape[0], -1)
    elif int(np.prod(q.shape[:-1])) * mult == x_k:
        q2d = q.reshape(-1, q.shape[-1])
    else:
        raise ValueError(
            f"quantized weight {tuple(q.shape)} (packed={int4}) does not "
            f"contract with K={x_k}")
    n = q2d.shape[1]
    scale = wq["scale"].reshape(-1)
    if scale.shape[0] != n:
        raise ValueError(
            f"scale {tuple(wq['scale'].shape)} does not flatten to the "
            f"{n} output channels of {tuple(q.shape)}")
    return q2d, scale, int4, n


def reference_matmul(x, wq) -> torch.Tensor:
    """The plain version of K5: the integer values as float32 contracted
    with ``x`` in float32, THEN the per-channel scale (constant along K,
    so it commutes out of the sum). float32 result; the caller casts."""
    lead, k = tuple(x.shape[:-1]), x.shape[-1]
    q2d, scale, int4, n = _resolve_2d(k, wq)
    if int4:
        q2d = unpack_rows(q2d)
    out = torch.matmul(x.reshape(-1, k).float(), q2d.float()) * scale
    return out.reshape(lead + (n,))


def quant_matmul(x, wq) -> torch.Tensor:
    """``x [..., K] @ dequant(wq) -> [..., N]`` float32: K5 for a tensor
    on the card (the weight bytes are all it reads of the weight), the
    plain version for a tensor on the CPU."""
    if x.device.type == "cpu":
        return reference_matmul(x, wq)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cuda or cpu tensors, got "
                         f"{x.device}")
    return _launch(x, wq)


def split_plan(m: int, k_rows: int, n: int, num_sms: int, *,
               tensor_cores: bool):
    """``(route, tile, ksplit, kchunk)`` for ``m`` activation rows
    against ``k_rows`` weight byte rows (K, or K/2 packed) and ``n``
    columns on a card of ``num_sms`` SMs. Route 1 (``tensor_cores``: bf16
    activations of at least ``TC_MIN_ROWS`` rows) holds ``tile`` 16-row
    tiles a block, as many as keep ``BLOCKS_PER_SM`` blocks an SM (fewer
    re-reads of the weight); route 0 ``tile`` rows of ``M_TILES``. The
    weight's byte rows are cut into ``ksplit`` (at most ``MAX_SPLIT``)
    chunks of ``kchunk`` (a multiple of ``STAGE_ROWS``), enough for
    ``BLOCKS_PER_SM`` blocks an SM. A function of the shapes and the
    card alone, so the same inputs give the same bits."""
    def cdiv(a, b):
        return -(-a // b)

    cols = cdiv(n, BLOCK_N)
    target = int(np.ceil(BLOCKS_PER_SM * num_sms))
    if tensor_cores and m >= TC_MIN_ROWS:
        route = 1
        tile = next((t for t in range(min(TC_MAX_TILES, cdiv(m, 16)), 0, -1)
                     if cols * cdiv(m, 16 * t) >= target), 1)
        rows = 16 * tile
    else:
        route = 0
        tile = next((t for t in M_TILES if t >= m), M_TILES[-1])
        rows = tile
    blocks = cols * cdiv(m, rows)
    ksplit = max(1, min(cdiv(target, blocks), MAX_SPLIT,
                        cdiv(k_rows, STAGE_ROWS)))
    kchunk = cdiv(cdiv(k_rows, ksplit), STAGE_ROWS) * STAGE_ROWS
    return route, tile, cdiv(k_rows, kchunk), kchunk


def split_matmul_reference(x, wq, ksplit: int, kchunk: int) -> torch.Tensor:
    """The K split of K5 in plain PyTorch (what the kernel sums, in the
    order it sums it; used by the tests): each chunk of ``kchunk`` byte
    rows (both of a packed byte row's logical rows) contracted in
    float32, the chunks' partials added in split order, then scaled."""
    lead, k = tuple(x.shape[:-1]), x.shape[-1]
    q2d, scale, int4, n = _resolve_2d(k, wq)
    xf = x.reshape(-1, k).float()
    half = k // 2
    total = torch.zeros((xf.shape[0], n), dtype=torch.float32,
                        device=x.device)
    for y in range(ksplit):
        r0, r1 = y * kchunk, min(q2d.shape[0], (y + 1) * kchunk)
        if int4:
            qq = unpack_rows(q2d[r0:r1])
            rows = torch.cat([torch.arange(r0, r1),
                              torch.arange(r0, r1) + half]).to(x.device)
        else:
            qq = q2d[r0:r1]
            rows = torch.arange(r0, r1, device=x.device)
        total = total + torch.matmul(xf[:, rows], qq.float())
    return (total * scale).reshape(lead + (n,))


def _launch(x, wq):
    lead, k = tuple(x.shape[:-1]), x.shape[-1]
    q2d, scale, int4, n = _resolve_2d(k, wq)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if q2d.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"weight bytes must be int8 and scales float32, got "
                        f"{q2d.dtype} and {scale.dtype}")
    if int4 and k % 2:
        raise ValueError(f"a packed weight needs an even K, got {k}")
    devs = {x.device, q2d.device, scale.device}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")
    x2 = x.reshape(-1, k).contiguous()
    q2d = q2d.contiguous()
    scale = scale.contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out.reshape(lead + (n,))
    bf16 = x2.dtype == torch.bfloat16
    route, tile, ksplit, kchunk = split_plan(
        m, q2d.shape[0], n, kernels.num_sms(x.device.index),
        tensor_cores=bf16)
    name = "quant_matmul_q4" if int4 else "quant_matmul_q8"
    lib = kernels.library(name)
    fn = lib.dkt_quant_matmul_q4 if int4 else lib.dkt_quant_matmul_q8
    err = fn(x2.data_ptr(), int(bf16), q2d.data_ptr(), scale.data_ptr(),
             out.data_ptr(), m, k, n, route, tile, ksplit, kchunk,
             torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(lib, err, name)
    kernels.count_launch(name)
    return out.reshape(lead + (n,))


# --- parameter trees (the serving engine's weight side) ----------------------

#: scale reduction axes per attention leaf (the contraction axes of the
#: decode matmuls): wq/wk/wv ``[d, h, e]`` contract d; wo ``[h, e, d]``
#: contracts (h, e). Every other leaf uses the all-but-last default.
_ATTN_REDUCE = {"wq": (0,), "wk": (0,), "wv": (0,), "wo": (0, 1)}


def quantize_params_tree(params, bits: int = 8):
    """Quantize every ``models.quantize.QUANTIZABLE_NAMES`` leaf of a
    parameter tree into the qdict format (original shapes preserved, on
    the leaf's device); other leaves pass through detached. The serving
    engine's ``weight_quant`` initializer."""
    from distkeras_tpu_torch.models.quantize import _is_quantizable

    def walk(p, name=""):
        if isinstance(p, dict):
            return {k: walk(v, k) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return [walk(v, name) for v in p]
        if _is_quantizable(p, name):
            return quantize_weight(p, bits,
                                   reduce_axes=_ATTN_REDUCE.get(name))
        return p.detach() if torch.is_tensor(p) else p

    with torch.no_grad():
        return walk(params)


def dequant_params_tree(params, dtype=torch.float32):
    """A float tree from a quantized one: every qdict dequantized to
    ``dtype`` (whole leaves at once; the serving paths instead
    dequantize one leaf at a time, just before its matmul)."""
    def walk(p):
        if isinstance(p, dict):
            if is_qdict(p):
                return dequant_weight(p, dtype)
            return {k: walk(v) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return [walk(v) for v in p]
        return p

    return walk(params)


def tree_quant_errors(params, qtree) -> Dict[str, Dict[str, float]]:
    """Path-keyed :func:`quant_error` over every quantized leaf of
    ``qtree`` against the float tree: the engine's
    ``weight_quant_error``."""
    out = {}

    def walk(p, q, path):
        if is_qdict(q):
            out["/".join(path)] = quant_error(p, q)
        elif isinstance(q, dict):
            for k in q:
                walk(p[k], q[k], path + [str(k)])
        elif isinstance(q, (list, tuple)):
            for i, v in enumerate(q):
                walk(p[i], v, path + [str(i)])

    with torch.no_grad():
        walk(params, qtree, [])
    return out
