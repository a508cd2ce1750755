"""One-step decode attention over the slab KV cache: the hand-written
CUDA kernel (``csrc/decode_attention.cu``) and its plain PyTorch
version.

Replaces ``distkeras_tpu/ops/decode_attention.py`` ``decode_attention``
(:157, the ``pl.pallas_call`` at :233, body ``_kernel`` :92): the
attention of one new query position per (batch row, kv head) against
that row's head-major cache, GQA native (the ``G`` query heads sharing a
kv head are the rows of one tile; K/V are never expanded), positions
``> t`` masked, an optional sliding ``window``, and int8 caches with
per-token float32 scale planes (int4 slab caches store one int8 byte per
entry and take the int8 path).

Shapes: q ``[BH, G, D]`` (float32 or bfloat16); k/v ``[BH, L, D]``
float32, bfloat16 or int8 (a view of the ``[B, Hkv, L, D]`` cache; any
row and position strides, the head dim contiguous); ``k_scale`` /
``v_scale`` ``[BH, L]`` float32 for int8; ``t`` a Python int, the
position just written. Returns ``[BH, G, D]`` float32.

Rounding points. The plain version follows the JAX package's CPU path
(``models/decoding.py`` ``_decode_attn`` :321 with ``_decode_scores``
:231 and ``_decode_mix`` :250), the path ``generate()`` takes off the
TPU, so the port's greedy ``generate()`` stays token-identical to it:
``q * scale`` in float32, then cast to the cache dtype for a float cache
(int8 contracts in float32); scores in float32; ``k_scale`` applied
after the D contraction; a whole-row softmax; probabilities cast to the
cache dtype (float) or multiplied by ``v_scale`` (int8) before the
value contraction. The kernel shares every one of those points except
the last for float caches: it rounds the unnormalised online-softmax
probabilities (``exp(s - m)`` against the running max) to the cache
dtype, where the plain version rounds the normalised ones; and it sums
in another order. ``chip_smoke.py`` and ``tests/test_torch_cuda.py``
hold it to the plain version within a stated tolerance.

The TPU gates (``MIN_KERNEL_LEN``, ``choose_block``, ``block_of``, the
``bh_block`` divisor, the %8 row pad) are not carried over: the kernel
takes any cache length and runs at every length.
"""

from __future__ import annotations

from typing import Optional

import torch

from distkeras_tpu_torch import kernels
from distkeras_tpu_torch.ops.attention import NEG_INF

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is instantiated for
KERNEL_HEAD_DIMS = (32, 64, 128)
#: query rows (GQA group size) one block holds
KERNEL_MAX_GROUP = 64
#: positions the kernel stages per step; a split covers whole tiles
TILE = 64
#: blocks per SM the split aims for (the card keeps several resident)
BLOCKS_PER_SM = 4


def _check(q, k, v, t, k_scale, v_scale):
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3:
        raise ValueError(f"q must be [BH, G, D] and k/v [BH, L, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape != v.shape or k.dtype != v.dtype:
        raise ValueError("k and v must have one shape and dtype")
    bh, _g, d = q.shape
    if k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on rows or head_dim")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if k_scale is None:
        if k.dtype not in _DTYPES:
            raise TypeError(f"a float cache must be float32 or bfloat16, "
                            f"got {k.dtype}")
    else:
        if k.dtype != torch.int8:
            raise TypeError(f"scale planes mark an int8 cache, got {k.dtype}")
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if s.shape != k.shape[:2] or s.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 {tuple(k.shape[:2])}"
                                 f", got {s.dtype} {tuple(s.shape)}")
    if not 0 <= int(t) < k.shape[1]:
        raise ValueError(f"t={t} outside the cache length {k.shape[1]}")
    devs = {x.device for x in (q, k, v) + (
        () if k_scale is None else (k_scale, v_scale))}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")


def valid_range(t: int, window: Optional[int]):
    """The cache positions ``[lo, t]`` the query attends."""
    t = int(t)
    lo = 0 if window is None else max(0, t - int(window) + 1)
    return lo, t


def decode_attention(q, k, v, t: int, *, scale: Optional[float] = None,
                     window: Optional[int] = None, k_scale=None,
                     v_scale=None):
    """One-step cache attention; returns ``[BH, G, D]`` float32."""
    _check(q, k, v, t, k_scale, v_scale)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, t, scale=scale,
                                          window=window, k_scale=k_scale,
                                          v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    return _launch(q, k, v, int(t), float(scale), window, k_scale, v_scale)


def split_plan(rows: int, n_valid: int, num_sms: int):
    """How the valid positions are cut across blocks (flash-decoding):
    ``(splits, chunk)`` with ``chunk`` a multiple of ``TILE``. Enough
    splits that ``rows * splits`` fills the card ``BLOCKS_PER_SM`` deep,
    but none shorter than one tile."""
    def cdiv(a, b):
        return -(-a // b)

    want = max(1, cdiv(BLOCKS_PER_SM * num_sms, max(rows, 1)))
    splits = max(1, min(cdiv(n_valid, TILE), want))
    chunk = cdiv(cdiv(n_valid, splits), TILE) * TILE
    return cdiv(n_valid, chunk), chunk


def _launch(q, k, v, t, scale, window, k_scale, v_scale):
    bh, g, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"decode kernel supports head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if g > KERNEL_MAX_GROUP:
        raise ValueError(f"decode kernel takes at most {KERNEL_MAX_GROUP} "
                         f"query heads per kv head, got {g}")
    esize = k.element_size()
    for name, x in (("k", k), ("v", v)):
        if x.stride(2) != 1:
            raise ValueError(f"{name} must be contiguous along head_dim")
        if (x.data_ptr() % 16 or (x.stride(0) * esize) % 16
                or (x.stride(1) * esize) % 16):
            raise ValueError(f"{name} rows must start on 16-byte boundaries "
                             "(the kernel reads them 16 bytes at a time)")
    if k.stride() != v.stride():
        raise ValueError("k and v must share their strides")
    quant = k_scale is not None
    if quant and k_scale.stride() != v_scale.stride():
        raise ValueError("k_scale and v_scale must share their strides")
    qf = q.float().contiguous()
    out = torch.empty((bh, g, d), dtype=torch.float32, device=q.device)
    if bh == 0:
        return out
    lo, hi = valid_range(t, window)
    splits, chunk = split_plan(bh, hi - lo + 1, kernels.num_sms(q.device.index))
    part_acc = torch.empty((splits, bh, g, d), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((2, splits, bh, g), dtype=torch.float32,
                          device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    name = "decode_attention_q8" if quant else "decode_attention"
    lib = kernels.library(name)
    if quant:
        err = lib.dkt_decode_attention_q8(
            qf.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
            part_ml.data_ptr(), bh, g, d, k.stride(0), k.stride(1),
            k_scale.stride(0), k_scale.stride(1), lo, hi, chunk, splits,
            scale, stream)
    else:
        err = lib.dkt_decode_attention(
            qf.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            part_acc.data_ptr(), part_ml.data_ptr(), _DTYPES[k.dtype], bh, g,
            d, k.stride(0), k.stride(1), lo, hi, chunk, splits, scale,
            stream)
    kernels.check(lib, err, name)
    kernels.count_launch(name)
    return out


def decode_attention_reference(q, k, v, t: int, *, scale: float,
                               window: Optional[int] = None, k_scale=None,
                               v_scale=None):
    """The plain PyTorch version, with the rounding points of the JAX
    package's CPU decode path (see the module docstring)."""
    qs = q.float() * scale
    if k_scale is None:
        qs = qs.to(k.dtype).float()
    s = torch.einsum("bgd,bld->bgl", qs, k.float())
    if k_scale is not None:
        s = s * k_scale[:, None, :]
    lo, hi = valid_range(t, window)
    pos = torch.arange(k.shape[1], device=q.device)
    s = s.masked_fill(~((pos >= lo) & (pos <= hi)), NEG_INF)
    w = torch.softmax(s, dim=-1)
    if v_scale is not None:
        w = w * v_scale[:, None, :]
    else:
        w = w.to(v.dtype).float()
    return torch.einsum("bgl,bld->bgd", w, v.float())
