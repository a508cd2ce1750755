"""JAX's threefry2x32 PRNG: the port's own copy of what it needs from
``jax.random`` (``jax._src.prng`` and ``jax._src.random``), so that the
same seeds draw the same bits as the JAX package.

A key is an ``[..., 2]`` int64 tensor holding two uint32 words (JAX's
raw ``threefry2x32`` key, ``[hi, lo]``); int64 because torch's uint32
lacks most arithmetic, so every add below is masked to 32 bits. Keys
live on any device; a draw comes out on its key's device.

What is ported, with JAX's defaults (impl ``threefry2x32``,
``jax_threefry_partitionable=True``, 32-bit mode):

* ``key(seed)`` is ``PRNGKey(seed)``: the seed is taken modulo 2^32 (in
  32-bit mode JAX narrows it before ``threefry_seed`` splits it, so the
  high word is 0);
* :func:`threefry2x32`: 20 rounds (rotations 13 15 26 6 / 17 29 16 24,
  the key schedule with the parity word ``0x1BD11BDA``);
* the partitionable counters: a draw of ``shape`` hashes the 64-bit
  flat index of each element over the WHOLE shape (``iota_2x32_shape``,
  high word first), so one key over ``[B, V]`` draws what JAX draws,
  not B draws over ``[V]``; a batch of keys ``[R, 2]`` draws ``[R,
  *shape]``, each row over its own counters (``vmap``);
* :func:`random_bits` is ``bits1 ^ bits2`` (narrower widths keep the
  low bits); :func:`split` stacks the two words;
* :func:`uniform` shifts the bits into a float's mantissa,
  ``(bits >> (nbits - nmant)) | bits(1.0)``, minus 1, scaled (for
  float32 and float16 by one fused multiply-add, as XLA contracts ``f *
  (maxval - minval) + minval``; bfloat16 rounds after each op), then
  ``max(minval, .)``; bfloat16 (7 mantissa bits) draws 8-bit words;
* :func:`gumbel` (mode ``"low"``) is ``-log(-log(uniform(minval=tiny)))``,
  :func:`categorical` the argmax of logits plus a Gumbel field,
  :func:`bernoulli` ``uniform < p``, :func:`normal`
  ``sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1))``.

Keys, splits, bits, uniforms and Bernoulli masks are bitwise JAX's.
``log`` and ``erfinv`` are not bitwise between XLA, torch on the CPU and
CUDA's ``logf``: the Gumbel and normal fields agree within a few float32
ulps (``tests/test_torch_prng.py`` states the bounds), and categorical
draws equal JAX's wherever no two scores lie within that of each other.

On the card every draw is one launch of the K7 kernel
(``csrc/prng.cu``): the threefry hash of every counter with the
epilogue chosen by an argument (the two words of a split, raw bits, a
float32 uniform, a float32 Gumbel field). The torch code here is its
plain version: a CPU key takes it, a CUDA key the kernel, and nothing
falls back either way. K7 replaces no Pallas kernel: in JAX, XLA fuses
the threefry rounds into the consumer; written out in PyTorch the hash
is a chain of about a hundred elementwise launches per draw.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from distkeras_tpu_torch import kernels

MASK = 0xFFFFFFFF
#: the key schedule's parity constant
_PARITY = 0x1BD11BDA
#: rotation amounts of the even and odd groups of four rounds
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

#: K7's epilogues (its C ABI's mode codes)
SPLIT, BITS, UNIFORM, GUMBEL = 0, 1, 2, 3

Shape = Union[int, Sequence[int]]


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: ``[0, seed mod 2^32]`` as int64."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def as_key(rng, device=None) -> torch.Tensor:
    """A key given as a JAX key, a numpy array or a tensor of two uint32
    words, as the port's int64 ``[..., 2]`` tensor on ``device``."""
    if torch.is_tensor(rng):
        out = rng.to(torch.int64)
    else:
        out = torch.from_numpy(np.asarray(rng).astype(np.int64))
    if out.shape[-1:] != (2,):
        raise ValueError(f"a key has two words, got shape {tuple(out.shape)}")
    return (out & MASK).to(device) if device is not None else out & MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x1,
    x2)`` under the key ``(k1, k2)``: int64 tensors of uint32 words,
    broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & MASK
    x1 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


#: (bits, mantissa bits, integer view) of the float dtypes a draw takes
_FLOATS = {torch.float32: (32, 23, torch.int32),
           torch.bfloat16: (16, 7, torch.int16),
           torch.float16: (16, 10, torch.int16)}
#: the bits of 1.0 in each of them
_ONE_BITS = {torch.float32: 0x3F800000, torch.bfloat16: 0x3F80,
             torch.float16: 0x3C00}


def _uniform_from_bits(bits, dtype, minval: float, maxval: float):
    """``jax.random.uniform``'s epilogue on its random words."""
    nbits, nmant, int_t = _FLOATS[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    fbits = (bits >> (rng_bits - nmant)) | _ONE_BITS[dtype]
    floats = fbits.to(int_t).view(dtype) - 1.0
    lo = torch.tensor(minval, dtype=dtype, device=bits.device)
    hi = torch.tensor(maxval, dtype=dtype, device=bits.device)
    if dtype == torch.bfloat16:
        # XLA rounds a bfloat16 multiply and add one at a time
        return torch.maximum(lo, floats * (hi - lo) + lo)
    # for float32 and float16 XLA contracts floats * span + lo into one
    # fused multiply-add: in float64 the product and the sum are exact
    # for these operands, so one rounding to dtype gives the FMA's result
    fused = (floats.double() * (hi - lo).double() + lo.double()).to(dtype)
    return torch.maximum(lo, fused)


def _words(keys: torch.Tensor, n: int):
    """The hash of ``[R, 2]`` keys over the counters ``0 .. n-1`` of each
    row: the two ``[R, n]`` words."""
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    return threefry2x32(keys[:, :1], keys[:, 1:], idx >> 32, idx & MASK)


def draw_reference(keys: torch.Tensor, n: int, mode: int,
                   minval: float = 0.0, maxval: float = 1.0):
    """K7's plain version, on any device: ``[R, 2]`` keys over the
    counters ``0 .. n-1`` of each row, with the epilogue ``mode``:
    ``[R, n, 2]`` int64 words (``SPLIT``), ``[R, n]`` int64 ``bits1 ^
    bits2`` (``BITS``), ``[R, n]`` float32 uniforms in ``[minval,
    maxval)`` (``UNIFORM``) or a float32 Gumbel field (``GUMBEL``,
    ``minval`` the float32 ``tiny`` and ``maxval`` 1)."""
    w1, w2 = _words(keys.to(torch.int64), n)
    if mode == SPLIT:
        return torch.stack([w1, w2], dim=-1)
    bits = w1 ^ w2
    if mode == BITS:
        return bits
    u = _uniform_from_bits(bits, torch.float32, minval, maxval)
    return u if mode == UNIFORM else -torch.log(-torch.log(u))


def _launch(keys: torch.Tensor, n: int, mode: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """One K7 launch, ``draw_reference``'s contract on the card."""
    r = keys.shape[0]
    k = keys.to(torch.int64).contiguous()
    if mode == SPLIT:
        out = torch.empty((r, n, 2), dtype=torch.int64, device=k.device)
    elif mode == BITS:
        out = torch.empty((r, n), dtype=torch.int64, device=k.device)
    else:
        out = torch.empty((r, n), dtype=torch.float32, device=k.device)
    if r * n == 0:
        return out
    lib = kernels.library("prng")
    err = lib.dkt_prng(k.data_ptr(), r, n, mode, float(minval),
                       float(maxval), out.data_ptr(),
                       torch.cuda.current_stream(k.device).cuda_stream)
    kernels.check(lib, err, "prng")
    kernels.count_launch("prng")
    return out


def draw(rng: torch.Tensor, shape: Shape, mode: int, minval: float = 0.0,
         maxval: float = 1.0) -> torch.Tensor:
    """``[*batch, 2]`` keys over the counters of ``shape`` with the
    epilogue ``mode`` (``draw_reference``), shaped ``[*batch, *shape]``
    (``SPLIT``: ``[*batch, *shape, 2]``): one K7 launch for keys on the
    card, the plain version for keys on the CPU."""
    shape = _shape(shape)
    batch = rng.shape[:-1]
    keys = rng.reshape(-1, 2)
    n = math.prod(shape)
    minval, maxval = _f32(minval), _f32(maxval)
    if keys.device.type == "cuda":
        out = _launch(keys, n, mode, minval, maxval)
    elif keys.device.type == "cpu":
        out = draw_reference(keys, n, mode, minval, maxval)
    else:
        raise ValueError(f"keys must be on cuda or cpu, got {keys.device}")
    return out.reshape(*batch, *shape, *out.shape[2:])


def _f32(x: float) -> float:
    return float(np.float32(x))


def split(rng: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[..., 2]`` keys -> ``[..., num, 2]``."""
    return draw(rng, (num,), SPLIT)


def random_bits(rng: torch.Tensor, shape: Shape, width: int = 32):
    """``width``-bit random words (int64) of ``[*batch, *shape]`` for
    ``[*batch, 2]`` keys: ``bits1 ^ bits2``, the low ``width`` bits."""
    if width not in (8, 16, 32):
        raise ValueError(f"width must be 8, 16 or 32, got {width}")
    bits = draw(rng, shape, BITS)
    return bits & ((1 << width) - 1) if width < 32 else bits


def uniform(rng: torch.Tensor, shape: Shape, dtype=torch.float32,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform``: floats in ``[minval, maxval)`` of
    ``[*batch, *shape]``. A float32 draw is one K7 launch on the card;
    other dtypes take K7's bits and finish here."""
    if dtype not in _FLOATS:
        raise ValueError(f"uniform draws {sorted(map(str, _FLOATS))}, "
                         f"got {dtype}")
    if dtype == torch.float32:
        return draw(rng, shape, UNIFORM, minval, maxval)
    nmant = _FLOATS[dtype][1]
    bits = random_bits(rng, shape, 8 if nmant < 8 else 16)
    return _uniform_from_bits(bits, dtype, minval, maxval)


def gumbel(rng: torch.Tensor, shape: Shape,
           dtype=torch.float32) -> torch.Tensor:
    """``jax.random.gumbel`` (mode ``"low"``): ``-log(-log(u))`` with
    ``u = uniform(minval=tiny, maxval=1)``. A float32 field is one K7
    launch on the card."""
    tiny = float(torch.finfo(dtype).tiny)
    if dtype == torch.float32:
        return draw(rng, shape, GUMBEL, tiny, 1.0)
    u = uniform(rng, shape, dtype, tiny, 1.0)
    return -torch.log(-torch.log(u))


def bernoulli(rng: torch.Tensor, p: float, shape: Shape) -> torch.Tensor:
    """``jax.random.bernoulli(rng, p, shape)`` (mode ``"low"``, a float
    ``p``): ``uniform(float32) < p``."""
    return uniform(rng, shape, torch.float32) < torch.tensor(
        p, dtype=torch.float32, device=rng.device)


def normal(rng: torch.Tensor, shape: Shape,
           dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal``: ``sqrt(2) * erfinv(u)`` with ``u`` uniform
    in ``[nextafter(-1, 0), 1)`` of ``dtype``."""
    lo = float(torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                               torch.tensor(0.0, dtype=dtype)))
    u = uniform(rng, shape, dtype, lo, 1.0)
    return torch.erfinv(u) * torch.tensor(math.sqrt(2.0), dtype=dtype,
                                          device=rng.device)


#: how far a Gumbel field may lie from another implementation's
#: (JAX's on the CPU, K7 against its plain version), in float32 ulps of
#: ``max(|value|, 1)`` (:func:`ulps`): two ``log`` implementations round
#: differently, and the outer log of a value near 1 magnifies the inner
#: one's error (measured: 2 against XLA on the CPU)
GUMBEL_ULPS = 4
#: the same for a normal field: ``erfinv`` near +-1 is steep (measured:
#: 91 against XLA on the CPU, in the tails)
NORMAL_ULPS = 128


def ulps(a, b) -> torch.Tensor:
    """``|a - b|`` in float32 ulps of ``max(|b|, 1)``: a relative measure
    away from zero that stays finite for a value near zero."""
    a = torch.as_tensor(a).double()
    b = torch.as_tensor(b).double()
    top = b.abs().clamp_min(1.0).float()
    scale = torch.nextafter(top, torch.full_like(top, float("inf")))
    return (a - b).abs() / (scale.double() - top.double())


def categorical(rng: torch.Tensor, logits: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical(rng, logits, axis)`` for one key: the
    argmax of ``logits`` plus a Gumbel field over the whole of
    ``logits``' shape, in its dtype."""
    g = gumbel(rng, tuple(logits.shape), logits.dtype)
    return torch.argmax(g + logits, dim=axis)
