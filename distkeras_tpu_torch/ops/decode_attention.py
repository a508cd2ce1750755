"""One-step decode attention over the slab KV cache: the hand-written
CUDA kernel (``csrc/decode_attention.cuh``) and its plain PyTorch
version.

Replaces ``distkeras_tpu/ops/decode_attention.py`` ``decode_attention``
(:157, the ``pl.pallas_call`` at :233, body ``_kernel`` :92): the
attention of one new query position per (batch row, kv head) against
that row's head-major cache, GQA native (the ``G`` query heads sharing a
kv head share each staged chunk; K/V are never expanded), positions
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

On a CUDA tensor a call is one CUDA launch. The kernel reads q in its
own dtype and strides; ``split_plan`` cuts each row's positions into
splits from the shapes, the static window and the SM count (never from
``t``); the last live split of a row to finish merges the splits'
partials; the arrival counters and the partials live in a workspace
kept per device (``_workspace``). ``decode_split_reference`` models the
split and the merge in plain PyTorch for the tests.

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
KERNEL_HEAD_DIMS = (8, 12, 16, 32, 64, 128)
#: query rows (GQA group size) one block holds
KERNEL_MAX_GROUP = 64
#: positions a split is a whole number of by default (a multiple of every
#: dtype's chunk)
CHUNK_POSITIONS = 128
#: blocks per SM the split aims for (splits past a short context idle)
BLOCKS_PER_SM = 8
#: the most live splits of one row the plan aims for (the last to arrive
#: merges them all, their (m, l) staged in its shared memory)
MAX_LIVE_SPLITS = 32


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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def chunk_positions(head_dim: int, itemsize: int) -> int:
    """The positions the kernel stages at a time for a cache of this head
    dim and element size: about 8 KB of K (rows padded to whole 8-dim
    pieces), 32 to 128 positions (the kernel's ``Geo::CK``)."""
    return min(128, max(32, 8192 // (_cdiv(head_dim, 8) * 8 * itemsize)))


def copy_bytes(row_bytes: int) -> int:
    """The bytes of one ``cp.async`` the kernel stages a cache row with
    (its ``Geo::CB``): 16 where the row is whole 16-byte pieces, else 8 or
    4 (bf16 at head dim 12, int8 at 8 and 12)."""
    return 16 if row_bytes % 16 == 0 else 8 if row_bytes % 8 == 0 else 4


def split_plan(rows: int, length: int, num_sms: int, *,
               window: Optional[int] = None, unit: int = CHUNK_POSITIONS):
    """``(nsplit, chunk)``: the flash-decoding split of the kernel's grid
    ``(rows, nsplit)``, split ``z`` owning the cache positions ``[z *
    chunk, (z + 1) * chunk)``, ``chunk`` a multiple of ``unit`` (the
    launcher passes its cache's ``chunk_positions``). Enough splits that
    the live ones fill
    ``num_sms`` SMs ``BLOCKS_PER_SM`` deep over the positions a row can
    reach (the whole cache, or a sliding ``window``'s span: ``window``
    positions in whole chunks plus one chunk for its misalignment), at
    most ``MAX_LIVE_SPLITS`` of them (one more where a window straddles
    a chunk boundary). A function of the shapes, the
    static window and the card alone -- never of the position ``t`` --
    so the grid stays the same as the context grows; each split clips
    its range to the live positions on the device."""
    length = max(int(length), 1)
    span = length if window is None else min(
        length, _cdiv(int(window), unit) * unit + unit)
    units = _cdiv(span, unit)
    want = min(_cdiv(BLOCKS_PER_SM * num_sms, max(rows, 1)),
               MAX_LIVE_SPLITS)
    chunk = _cdiv(units, max(1, min(want, units))) * unit
    return _cdiv(length, chunk), chunk


def live_splits(nsplit: int, chunk: int, window: Optional[int]) -> int:
    """The most splits of a row that can be live at once: every split,
    or those a ``window`` of positions can touch (the size of the
    partials workspace a row needs)."""
    if window is None:
        return nsplit
    return min(nsplit, _cdiv(max(int(window) - 1, 0), chunk) + 1)


_workspaces: dict = {}   # device -> (arrival counters, partials)


def _workspace(device, rows: int, floats: int):
    """The kernel's workspaces on ``device``, kept across calls and grown
    when a launch needs more: a zeroed int32 counter per row, by which
    the last live split of a row learns that it merges (it sets the
    counter back to 0), and ``floats`` float32 entries for the splits'
    partial ``(m, l)`` and ``acc``. Calls on one stream run one after
    another, so they share both."""
    cnt, part = _workspaces.get(device, (None, None))
    if cnt is None or cnt.numel() < rows:
        cnt = torch.zeros(max(rows, 1024), dtype=torch.int32, device=device)
    if part is None or part.numel() < floats:
        part = torch.empty(max(floats, 1 << 16), dtype=torch.float32,
                           device=device)
    _workspaces[device] = (cnt, part)
    return cnt, part


def _launch(q, k, v, t, scale, window, k_scale, v_scale):
    bh, g, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"decode kernel supports head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if g > KERNEL_MAX_GROUP:
        raise ValueError(f"decode kernel takes at most {KERNEL_MAX_GROUP} "
                         f"query heads per kv head, got {g}")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be a positive number of positions, "
                         f"got {window}")
    esize = k.element_size()
    cb = copy_bytes(d * esize)
    for name, x in (("k", k), ("v", v)):
        if x.stride(2) != 1:
            raise ValueError(f"{name} must be contiguous along head_dim")
        if (x.data_ptr() % cb or (x.stride(0) * esize) % cb
                or (x.stride(1) * esize) % cb):
            raise ValueError(f"{name} rows must start on {cb}-byte "
                             f"boundaries (the kernel reads them {cb} bytes "
                             "at a time)")
    if k.stride() != v.stride():
        raise ValueError("k and v must share their strides")
    quant = k_scale is not None
    if quant and k_scale.stride() != v_scale.stride():
        raise ValueError("k_scale and v_scale must share their strides")
    if q.stride(2) != 1:
        q = q.contiguous()
    out = torch.empty((bh, g, d), dtype=torch.float32, device=q.device)
    if bh == 0:
        return out
    nsplit, chunk = split_plan(bh, k.shape[1],
                               kernels.num_sms(q.device.index), window=window,
                               unit=chunk_positions(d, esize))
    live = live_splits(nsplit, chunk, window)
    n_ml = _cdiv(bh * live * g * 2, 4) * 4     # acc on a 16-byte boundary
    cnt, part = _workspace(q.device, bh,
                           0 if live == 1 else n_ml + bh * live * g * d)
    ws = (part.data_ptr(), part.data_ptr() + 4 * n_ml, cnt.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    win = 0 if window is None else int(window)
    tail = (int(t), win, chunk, nsplit, live, scale, stream)
    name = "decode_attention_q8" if quant else "decode_attention"
    lib = kernels.library(name)
    if quant:
        err = lib.dkt_decode_attention_q8(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), out.data_ptr(), *ws, _DTYPES[q.dtype], bh, g,
            d, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            k_scale.stride(0), k_scale.stride(1), *tail)
    else:
        err = lib.dkt_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *ws,
            _DTYPES[q.dtype], _DTYPES[k.dtype], bh, g, d, q.stride(0),
            q.stride(1), k.stride(0), k.stride(1), *tail)
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


def decode_split_reference(q, k, v, t: int, *, scale: float, chunk: int,
                           window: Optional[int] = None, k_scale=None,
                           v_scale=None):
    """The kernel's flash-decoding split in plain PyTorch, float32 (used
    by the tests): split ``z`` takes the cache positions ``[z * chunk,
    (z + 1) * chunk)`` clipped to ``[lo, t]``, and a split left with
    none takes no part; each live split's ``(m, l, acc)`` comes from one
    softmax over its positions (``l`` summing the unscaled
    probabilities, ``acc`` taking them times ``v_scale`` for an int8
    cache), and the splits merge in split order through their
    log-sum-exps over the splits with ``l > 0``. ``q * scale`` is rounded
    to a float cache's dtype as the kernel rounds it; the probabilities
    keep their values."""
    qs = q.float() * scale
    if k_scale is None:
        qs = qs.to(k.dtype).float()
    s = torch.einsum("bgd,bld->bgl", qs, k.float())
    if k_scale is not None:
        s = s * k_scale[:, None, :]
    lo, hi = valid_range(t, window)
    ms, ls, accs = [], [], []
    for z in range(_cdiv(k.shape[1], chunk)):
        a, b = max(lo, z * chunk), min(hi + 1, (z + 1) * chunk)
        if a >= b:
            continue
        x = s[:, :, a:b]
        m = x.amax(dim=-1, keepdim=True)
        e = torch.exp(x - m)
        ls.append(e.sum(dim=-1, keepdim=True))
        if v_scale is not None:
            e = e * v_scale[:, None, a:b]
        accs.append(torch.einsum("bgl,bld->bgd", e, v[:, a:b].float()))
        ms.append(m)
    m_all, l_all = torch.stack(ms), torch.stack(ls)
    has = l_all > 0
    big = torch.where(has, m_all, torch.full_like(m_all, float("-inf")))
    mx = big.amax(dim=0)
    wts = torch.where(has, torch.exp(m_all - mx.clamp_min(NEG_INF)),
                      torch.zeros_like(m_all))
    acc = sum(wts[z] * accs[z] for z in range(len(accs)))
    l_tot = sum(wts[z] * l_all[z] for z in range(len(accs)))
    return acc / torch.where(l_tot == 0, torch.ones_like(l_tot), l_tot)
