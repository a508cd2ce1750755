"""Fused sampling epilogue for the serving decode step: the wrapper of
the hand-written CUDA kernel (``csrc/sampling.cu``, K4) and its plain
PyTorch version.

Replaces ``distkeras_tpu/ops/sampling.py`` ``sample_epilogue`` (:146, the
``pl.pallas_call`` at :180, body ``_kernel`` :98) and ports
``gumbel_noise`` :89 and ``sample_tokens`` :200. The unfused sampler
(``models.decoding._sample_vec``) walks the ``[S, V]`` logits several
times (two rank argsorts, a sort, a softmax and a cumsum); the kernel
takes the raw logits (float32, bfloat16 or float16), the knobs and a
Gumbel field and emits the int64 token ids in one launch: the
temperature scale is inside it, and the descending sort the TPU kernel
consumed is replaced by radix descents over the values' bits (the k-th
value by counts, the nucleus threshold by the mass strictly above a
value), so no ``torch.sort`` runs on the card.

Exactness contract:

* a categorical draw is ``argmax(lf + gumbel)``: :func:`gumbel_noise`
  is the field ``decoding._sample_vec`` adds, per row the threefry
  ``gumbel(key, (V,))`` of the row's key (``ops.prng``: one K7 launch
  over ``[S, V]`` on the card), as JAX's ``gumbel_noise`` (:89) feeds
  the Pallas epilogue;
* the plain version is the unfused sampler's own mask program
  (``decoding._masked_logits_vec``), then ``argmax(lf + g)`` and the
  greedy override, so on the CPU fused and unfused streams are
  byte-identical by construction;
* the kernel mirrors the masks exactly (the same IEEE division, rank
  top-k with lowest-index ties, the nucleus cut's threshold as the
  smallest value whose mass above stays under ``top_p`` of the total,
  first-index argmaxes). Its nucleus mass is an exact fixed-point sum
  where the plain version takes a float32 ``torch.cumsum``, so at a row
  whose cumulative mass lies within float32 rounding of ``top_p`` the
  nucleus may keep one token more or fewer; :func:`boundary_partings`
  is the check that admits such a row, and only such a row.

The TPU gates (``fused_supported``, vocab % 128, the %8 row pad) are
not carried over: the kernel takes any vocab.
"""

from __future__ import annotations

import numpy as np
import torch

from distkeras_tpu_torch import kernels
from distkeras_tpu_torch.ops import prng
from distkeras_tpu_torch.ops.attention import NEG_INF as _NEG_INF


def gumbel_noise(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """``[S, vocab]`` float32 Gumbel field of ``[S, 2]`` per-row keys:
    row ``s`` is ``gumbel(keys[s], (vocab,))``, the noise
    ``vmap(categorical)`` draws (JAX :89). One K7 launch on the card."""
    return prng.gumbel(keys, (vocab,))


def sample_epilogue_reference(logits, temperature, top_k, top_p, gumbel):
    """The plain version: the unfused sampler's masks, the Gumbel argmax
    and the greedy override."""
    from distkeras_tpu_torch.models.decoding import _masked_logits_vec
    lf = _masked_logits_vec(logits, temperature, top_k, top_p)
    sampled = torch.argmax(lf + gumbel, dim=-1)
    return torch.where(temperature > 0.0, sampled,
                       torch.argmax(logits, dim=-1))


def sample_epilogue(logits, temperature, top_k, top_p, gumbel):
    """Token ids ``[S]`` (int64) for one decode step: temperature scale,
    rank top-k (``<= 0`` off), nucleus cut (``>= 1`` off), Gumbel draw,
    greedy override (``temperature <= 0``). ``gumbel`` ``[S, V]`` comes
    from :func:`gumbel_noise`. K4 for tensors on the card, the plain
    version for tensors on the CPU."""
    if logits.ndim != 2 or gumbel.shape != logits.shape:
        raise ValueError(f"logits and gumbel must be one [S, V] shape, got "
                         f"{tuple(logits.shape)} and {tuple(gumbel.shape)}")
    s = logits.shape[0]
    for name, a in (("temperature", temperature), ("top_k", top_k),
                    ("top_p", top_p)):
        if tuple(a.shape) != (s,):
            raise ValueError(f"{name} must be [{s}], got {tuple(a.shape)}")
    if logits.device.type == "cpu":
        return sample_epilogue_reference(logits, temperature, top_k, top_p,
                                         gumbel)
    if logits.device.type != "cuda":
        raise ValueError(f"sample_epilogue runs on cuda or cpu tensors, got "
                         f"{logits.device}")
    return launch_kernel(logits, temperature, top_k, top_p, gumbel)


def _scaled(logits, temperature):
    """Temperature-scaled float32 logits, as the plain version scales
    them (a greedy row divides by 1)."""
    safe_t = torch.where(temperature > 0.0, temperature,
                         torch.ones_like(temperature))
    return logits.float() / safe_t[:, None].float()


#: the kernel's logits dtypes (its C ABI's codes); another dtype is cast
#: to float32 first
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def launch_kernel(logits, temperature, top_k, top_p, gumbel):
    """One K4 launch on the raw ``[S, V]`` logits (rows may be strided);
    returns ``[S]`` int64 token ids. Knobs already float32 / int64 and a
    contiguous float32 field are passed as they are, so the call is one
    CUDA kernel and allocates only its output."""
    s, v = logits.shape
    if gumbel.shape != logits.shape:
        raise ValueError(f"logits and gumbel must share one [S, V] shape, "
                         f"got {tuple(logits.shape)} and "
                         f"{tuple(gumbel.shape)}")
    if any(tuple(a.shape) != (s,) for a in (temperature, top_k, top_p)):
        raise ValueError(f"temperature, top_k and top_p must be [{s}]")
    devs = {x.device for x in (logits, temperature, top_k, top_p, gumbel)}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")
    if logits.dtype not in _DTYPES:
        logits = logits.float()
    if v > 1 and logits.stride(1) != 1:
        logits = logits.contiguous()
    temp = temperature.float().contiguous()
    kk = top_k.long().contiguous()
    pp = top_p.float().contiguous()
    g = gumbel.float().contiguous()
    out = torch.empty(s, dtype=torch.int64, device=logits.device)
    if s == 0:
        return out
    lib = kernels.library("sample_epilogue")
    err = lib.dkt_sample_epilogue(
        logits.data_ptr(), _DTYPES[logits.dtype], logits.stride(0),
        g.data_ptr(), temp.data_ptr(), kk.data_ptr(), pp.data_ptr(),
        out.data_ptr(), s, v,
        torch.cuda.current_stream(logits.device).cuda_stream)
    kernels.check(lib, err, "sample_epilogue")
    kernels.count_launch("sample_epilogue")
    return out


def sample_tokens(logits, temperature, top_k, top_p, keys):
    """Drop-in for ``decoding._sample_vec`` with per-row keys (JAX :200):
    the Gumbel field from :func:`gumbel_noise`, then the fused epilogue.
    The serving engine's ``fused_sampling=True`` sampler."""
    g = gumbel_noise(keys, logits.shape[-1])
    return sample_epilogue(logits, temperature, top_k, top_p, g)


#: at most this many rows of one run (a batch of draws, an engine run) may
#: part from the plain version at the nucleus boundary: a float32 flip
#: needs ``excl`` within a few ulps of ``top_p``, which random rows
#: almost never give
MAX_BOUNDARY_PARTINGS = 2


def boundary_partings(out, ref, logits, temperature, top_k, top_p):
    """The rows where the kernel's tokens ``out`` part from the plain
    version's ``ref`` on the same inputs, as ``(row, margin, tol)``.

    Each such row must be a nucleus-boundary row, or AssertionError is
    raised. At the plain version's cut (``n`` sorted entries kept, from
    its own float32 exclusive cumsum), another summation order may keep
    one entry more or one fewer, and nothing else:

    * one more: the kernel's token is the first dropped sorted entry
      ``n`` (by value, so ties count as it), and the float64 ``excl[n]``
      lies within ``tol`` of ``top_p``;
    * one fewer: the plain token is the last kept entry ``n - 1`` and
      the float64 ``excl[n - 1]`` lies within ``tol`` of ``top_p``.

    (The float64 value may lie on either side of ``top_p``: the plain
    version's own float32 sum may be the one that rounded across.)

    ``tol`` is four times the row's own float32 rounding there: the
    largest ``|excl32 - excl64|`` over the entries up to the cut plus
    one float32 ulp of ``top_p``. Greedy rows and rows without a nucleus
    cut may not part at all."""
    out, ref = out.cpu(), ref.cpu()
    parted = torch.nonzero(out != ref).flatten().tolist()
    if not parted:
        return []
    # the plain version's own mask program, on its device
    rows = torch.tensor(parted, device=logits.device)
    temp, kk, pp = (a[rows] for a in (temperature, top_k, top_p))
    lf = _scaled(logits[rows], temp)
    order = torch.argsort(-lf, dim=-1, stable=True)
    keep = (kk[:, None] <= 0) | (torch.argsort(order, dim=-1, stable=True)
                                 < kk[:, None])
    masked = torch.where(keep, lf, torch.full_like(lf, _NEG_INF))
    srt = torch.sort(masked, dim=-1, descending=True).values
    p32 = torch.softmax(srt, dim=-1)
    excl32 = torch.cumsum(p32, dim=-1) - p32
    p64 = torch.softmax(srt.double(), dim=-1)
    excl64 = torch.cumsum(p64, dim=-1) - p64
    lf, srt, excl32, excl64, temp, kk, pp = (
        a.cpu() for a in (lf, srt, excl32, excl64, temp, kk, pp))
    v = lf.shape[-1]
    kcount = torch.where(kk <= 0, torch.full_like(kk, v), kk.clamp(1, v))
    found = []
    for j, row in enumerate(parted):
        p = float(pp[j])
        if not (float(temp[j]) > 0.0 and p < 1.0):
            raise AssertionError(
                f"sample_epilogue parts from its plain version at row {row}, "
                f"which has no nucleus cut (temperature {float(temp[j])}, "
                f"top_p {p})")
        kept = excl32[j] < p
        n = int(kept.int().argmin()) if not bool(kept.all()) else v
        hi = min(n + 1, v)
        tol = 4.0 * (float((excl32[j, :hi].double() - excl64[j, :hi])
                           .abs().max())
                     + float(np.spacing(np.float32(p))))
        tok_out = float(lf[j, int(out[row])])
        tok_ref = float(lf[j, int(ref[row])])
        sides = []
        if n < int(kcount[j]) and tok_out == float(srt[j, n]):
            sides.append(abs(float(excl64[j, n]) - p))
        if n >= 1 and tok_ref == float(srt[j, n - 1]):
            sides.append(abs(p - float(excl64[j, n - 1])))
        margin = min(sides, default=float("inf"))
        if not margin <= tol:
            raise AssertionError(
                f"sample_epilogue parts from its plain version away from "
                f"the nucleus boundary at row {row}: tokens "
                f"{int(out[row])} (kernel) and {int(ref[row])} (plain), "
                f"margin {margin:.3e} at the plain cut of {n} entries, "
                f"tolerance {tol:.3e}")
        found.append((row, margin, tol))
    return found
