"""Ring attention: exact sequence-parallel attention over a mesh axis.

Replaces ``distkeras_tpu/ops/ring_attention.py`` (``_merge_block`` :45,
``_check_block`` :91, ``_ring_forward`` :104, the custom VJP's rules
:170 and :184, ``ring_attention`` :270). Each rank of the axis holds a
sequence shard ``[B, S_l, H, D]`` of q, k and v; the K/V shards travel
around the ring (``parallel.collectives.shift_start``: the next hop's
receive is posted before this hop's compute) while each rank merges its
queries' attention over every shard it sees.

Forward (``_Ring``, a ``torch.autograd.Function``). Hop ``t`` of rank
``i`` holds the shard of rank ``src = (i - t) mod n`` and runs ONE
``flash_forward`` on it (K1f on the card, its plain version on the
CPU): causal on the diagonal hop (``src == i``), full for a shard
before this rank's, and no launch at all for a later shard under
``causal`` (JAX computes every block and masks it with ``NEG_INF``;
skipping gives the same result, so rank ``i`` launches ``i + 1``
forward kernels a call under ``causal`` and ``n`` without). The hops'
``(out, lse)`` pairs merge by log-sum-exp in float32; a row with no
admitted key in a hop (packed ids, see below) comes back from the
kernel with an lse at ``NEG_INF`` (exactly ``NEG_INF`` and a zero row
from the tensor-core kernel, ``NEG_INF + log(S_l)`` and the values'
mean from the CUDA-core kernel and the plain version) and gets zero
weight. Each hop's ``out`` is rounded to q's dtype by the kernel before
the merge; the merge and the final ``lse`` are float32.

Backward: a second ring pass (JAX's design, :11-20). The forward saves
only ``q, k, v, out, lse`` and the ids, which do not grow with the ring.
Each hop runs ``flash_backward`` (K1dq and K1dkv) with the MERGED
``lse`` and ``delta = rowsum(dout * out)`` (float32), so every hop's
probabilities are the global ones; ``dq`` accumulates at home in
float32, and float32 ``dk``/``dv`` accumulators travel with their K/V,
arriving home after ``n`` shifts, then cast to k's and v's dtypes (JAX
:262-263).

``segment_ids`` is this rank's ``[B, S_l]`` shard of packed-sequence
ids; a k-side copy travels with K/V in both passes and reaches the
kernels as ``kv_segment_ids``. ``block_size`` is validated as JAX's
``_check_block`` does; it changes no result here: the kernels' tiles
already bound the score memory to a tile, which is what JAX's inner
blocking buys. ``use_custom_vjp=False`` is the test oracle: autograd
through JAX's forward loop written in plain PyTorch (``_merge_block``,
``block_size`` blocking) with the differentiable ``ppermute``, whose
gradient is the inverse shift (O(ring) residuals).

Call it inside ``shard_map`` (or ``with mesh:``) over a mesh whose
``axis_name`` axis shards the sequence.
"""

from __future__ import annotations

from typing import Optional

import torch

from distkeras_tpu_torch.ops.attention import NEG_INF
from distkeras_tpu_torch.ops.flash_attention import (attention_delta,
                                                     flash_backward,
                                                     flash_forward)
from distkeras_tpu_torch.parallel import collectives as C

#: an lse at or below this marks a row with no admitted key in a hop
EMPTY_LSE = 0.5 * NEG_INF


def _check_block(block_size, s_local):
    if block_size is not None:
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if block_size < s_local and s_local % block_size:
            raise ValueError(
                f"block_size {block_size} must divide the local shard "
                f"length {s_local}")
    if block_size is not None and block_size < s_local:
        return block_size, s_local // block_size
    return s_local, 1


def _hops(axis_name, causal):
    """``(n, [(t, launched, diagonal)])`` of this rank's ring: hop ``t``
    holds the shard of index ``(i - t) mod n``."""
    n, i = C.axis_size(axis_name), C.axis_index(axis_name)
    srcs = [(i - t) % n for t in range(n)]
    return n, [(t, not (causal and src > i), src == i)
               for t, src in enumerate(srcs)]


def _shift(tensors, axis_name, t, n):
    """Post the shift of the hop's K/V (and k-side ids) unless it is the
    last hop."""
    if t == n - 1:
        return None
    return C.shift_start([x for x in tensors if x is not None], axis_name)


def _received(pending, seg):
    got = pending.wait()
    return got[0], got[1], (got[2] if seg is not None else None)


def merge(acc, acc_lse, out, lse):
    """Merge a hop's ``(out [B, S, H, D], lse [B, H, S])`` into the
    float32 running pair; a row the hop admitted no key for keeps its
    running values (zero weight)."""
    of = out.float()
    if acc is None:
        return of, lse
    empty = lse <= EMPTY_LSE
    m = torch.maximum(acc_lse, lse)
    new = m + torch.log(torch.exp(acc_lse - m) + torch.exp(lse - m))
    new = torch.where(empty, acc_lse, new)
    w_acc = torch.exp(acc_lse - new)
    w_hop = torch.where(empty, torch.zeros_like(lse), torch.exp(lse - new))
    acc = acc * w_acc.transpose(1, 2)[..., None] \
        + of * w_hop.transpose(1, 2)[..., None]
    return acc, new


def _ring_forward(q, k, v, seg, scale, causal, axis_name):
    n, hops = _hops(axis_name, causal)
    kc, vc, sc = k, v, seg
    acc = lse = None
    for t, launched, diagonal in hops:
        pending = _shift((kc, vc, sc), axis_name, t, n)
        if launched:
            o, l = flash_forward(q, kc, vc, scale=scale,
                                 causal=causal and diagonal,
                                 segment_ids=seg, kv_segment_ids=sc)
            acc, lse = merge(acc, lse, o, l)
        if pending is not None:
            kc, vc, sc = _received(pending, seg)
    return acc.to(q.dtype), lse


def _ring_backward(q, k, v, out, lse, seg, dout, scale, causal, axis_name):
    n, hops = _hops(axis_name, causal)
    delta = attention_delta(out, dout)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    kc, vc, sc = k, v, seg
    for t, launched, diagonal in hops:
        pending = _shift((kc, vc, sc), axis_name, t, n)
        if launched:
            gq, gk, gv = flash_backward(
                q, kc, vc, out, lse, dout, delta, scale=scale,
                causal=causal and diagonal, segment_ids=seg,
                kv_segment_ids=sc)
            dq += gq.float()
            dk += gk.float()
            dv += gv.float()
        # the accumulators follow their K/V: n shifts bring them home
        dk, dv = C.shift_start([dk, dv], axis_name).wait()
        if pending is not None:
            kc, vc, sc = _received(pending, seg)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Ring(torch.autograd.Function):
    """The ring with its second-pass backward (JAX's ``custom_vjp``);
    saved: ``q, k, v, out, lse`` and the ids, O(local shard)."""

    @staticmethod
    def forward(ctx, q, k, v, seg, scale, causal, axis_name):
        out, lse = _ring_forward(q, k, v, seg, scale, causal, axis_name)
        ctx.save_for_backward(q, k, v, out, lse, seg)
        ctx.config = (scale, causal, axis_name)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, seg = ctx.saved_tensors
        scale, causal, axis_name = ctx.config
        dq, dk, dv = _ring_backward(q, k, v, out, lse, seg,
                                    dout.contiguous(), scale, causal,
                                    axis_name)
        return dq, dk, dv, None, None, None, None


def _merge_block(m, l, acc, qf, ks, vs, q_pos, k_pos, causal,
                 q_seg=None, k_seg=None):
    """One online-softmax merge of a K/V block into the ``(m, l, acc)``
    carry (JAX :45): ``qf`` ``[B, Sl, H, D]`` pre-scaled float32,
    ``m``/``l`` ``[B, H, Sl, 1]``, ``acc`` ``[B, Sl, H, D]``."""
    s = torch.einsum("bqhd,bkhd->bhqk", qf, ks.float())
    if causal:
        valid = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(valid[None, None], s, torch.full_like(s, NEG_INF))
    if q_seg is not None:
        same = q_seg[:, :, None] == k_seg[:, None, :]
        s = torch.where(same[:, None], s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha.transpose(1, 2) + torch.einsum(
        "bhqk,bkhd->bqhd", p, vs.float())
    return m_new, l_new, acc_new


def _ring_autodiff(q, k, v, seg, scale, causal, block_size, axis_name):
    """JAX's ``_ring_forward`` in plain PyTorch, differentiated by
    autograd through the shifts (the oracle)."""
    n, i = C.axis_size(axis_name), C.axis_index(axis_name)
    b, s_local, h, d = q.shape
    if k.shape[2] != h:
        g = h // k.shape[2]
        k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    perm = [(j, (j + 1) % n) for j in range(n)]
    qf = q.float() * scale
    q_pos = i * s_local + torch.arange(s_local, device=q.device) \
        if causal else None
    block, nblk = _check_block(block_size, s_local)
    m = torch.full((b, h, s_local, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, s_local, 1), device=q.device)
    acc = torch.zeros((b, s_local, h, d), device=q.device)
    kc, vc, sc = k, v, seg
    for t in range(n):
        pos0 = ((i - t) % n) * s_local if causal else None
        for kb in range(nblk):
            lo, hi = kb * block, (kb + 1) * block
            k_pos = None if pos0 is None else \
                pos0 + torch.arange(lo, hi, device=q.device)
            m, l, acc = _merge_block(
                m, l, acc, qf, kc[:, lo:hi], vc[:, lo:hi], q_pos, k_pos,
                causal, seg, None if sc is None else sc[:, lo:hi])
        if t < n - 1:
            kc = C.ppermute(kc, axis_name, perm)
            vc = C.ppermute(vc, axis_name, perm)
            if sc is not None:
                sc = C.ppermute(sc, axis_name, perm)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe.transpose(1, 2)).to(q.dtype)


def ring_attention(q, k, v, *, axis_name: str, causal: bool = False,
                   scale: Optional[float] = None,
                   block_size: Optional[int] = None,
                   use_custom_vjp: bool = True,
                   segment_ids=None) -> torch.Tensor:
    """BSHD sequence-sharded attention: q ``[B, S_l, H, D]``, k/v ``[B,
    S_l, Hkv, D]`` local shards (``H`` a multiple of ``Hkv``), out like
    q. ``segment_ids``: the local ``[B, S_l]`` shard of packed-sequence
    ids (attention restricted to equal ids across shards).
    ``block_size`` must divide ``S_l`` (validated; see the module
    docstring). ``use_custom_vjp=False``: autograd through the plain
    loop (the oracle of the tests)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if segment_ids is not None:
        segment_ids = torch.as_tensor(segment_ids, device=q.device)
        if tuple(segment_ids.shape) != tuple(q.shape[:2]):
            raise ValueError(
                f"segment_ids must be the local [B, S_local] shard "
                f"{tuple(q.shape[:2])}, got {tuple(segment_ids.shape)}")
        segment_ids = segment_ids.to(torch.int32).contiguous()
    _check_block(block_size, q.shape[1])
    if not use_custom_vjp:
        return _ring_autodiff(q, k, v, segment_ids, float(scale),
                              bool(causal), block_size, axis_name)
    return _Ring.apply(q, k, v, segment_ids, float(scale), bool(causal),
                       axis_name)
