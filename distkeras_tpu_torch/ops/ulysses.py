"""Ulysses attention: all-to-all sequence parallelism.

Replaces ``distkeras_tpu/ops/ulysses.py`` (``_seq_to_heads`` :36,
``_heads_to_seq`` :48, ``ulysses_attention`` :54). Two all-to-alls
along the mesh axis move the sequence-sharded ``[B, S/N, H, D]`` to
head-sharded ``[B, S, H/N, D]`` and back, so each rank computes exact
attention over the whole sequence for ``H/N`` heads with a one-device
kernel: ``impl="xla"`` the plain ``ops.attention.dot_product_attention``,
``impl="flash"`` the differentiable ``flash_attention`` (K1f, K1dq and
K1dkv on the card). The heads must divide over the axis. Segment ids
(the local ``[B, S/N]`` shard) are all-gathered to ``[B, S]`` for the
inner kernel's own masking. The all-to-alls are differentiable, so the
gradient takes the same two hops back (``parallel.collectives``).

Call it inside ``shard_map`` (or ``with mesh:``) over a mesh whose
``axis_name`` axis shards the sequence.
"""

from __future__ import annotations

from typing import Optional

import torch

from distkeras_tpu_torch.ops.attention import dot_product_attention
from distkeras_tpu_torch.ops.flash_attention import flash_attention
from distkeras_tpu_torch.parallel import collectives as C


def _seq_to_heads(x, axis_name):
    """``[B, S/N, H, D]`` sequence-sharded -> ``[B, S, H/N, D]``
    head-sharded: rank order is sequence order."""
    return C.all_to_all(x, axis_name, split_axis=2, concat_axis=1,
                        tiled=True)


def _heads_to_seq(x, axis_name):
    """``[B, S, H/N, D]`` head-sharded -> ``[B, S/N, H, D]``."""
    return C.all_to_all(x, axis_name, split_axis=1, concat_axis=2,
                        tiled=True)


def ulysses_attention(q, k, v, *, axis_name: str, causal: bool = False,
                      scale: Optional[float] = None, impl: str = "xla",
                      segment_ids=None) -> torch.Tensor:
    """BSHD sequence-sharded exact attention through the head scatter:
    q/k/v local shards ``[B, S/N, H, D]`` with ``H % N == 0``; returns the
    local ``[B, S/N, H, D]`` output. JAX's Pallas tile sizes
    (``block_q``/``block_k``) have no counterpart: the flash kernels pick
    their own tiles."""
    n = C.axis_size(axis_name)
    h = q.shape[2]
    if h % n != 0:
        raise ValueError(
            f"ulysses_attention needs num_heads ({h}) divisible by the "
            f"'{axis_name}' axis size ({n}); use attn_impl='ring' when "
            "heads don't split evenly")
    if impl not in ("xla", "flash"):
        raise ValueError(f"impl must be 'xla' or 'flash', got {impl!r}")
    seg_full = None
    if segment_ids is not None:
        segment_ids = torch.as_tensor(segment_ids, device=q.device)
        if tuple(segment_ids.shape) != tuple(q.shape[:2]):
            raise ValueError(
                f"segment_ids must be the local [B, S_local] shard "
                f"{tuple(q.shape[:2])}, got {tuple(segment_ids.shape)}")
        seg_full = C.all_gather(segment_ids.to(torch.int32), axis_name,
                                axis=1, tiled=True)

    qg, kg, vg = (_seq_to_heads(x, axis_name) for x in (q, k, v))
    if impl == "flash":
        out = flash_attention(qg, kg, vg, causal=causal, scale=scale,
                              segment_ids=seg_full)
    else:
        out = dot_product_attention(qg, kg, vg, causal=causal, scale=scale,
                                    segment_ids=seg_full)
    return _heads_to_seq(out, axis_name)
