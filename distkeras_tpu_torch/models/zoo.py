"""Model zoo of the port: the decoder-only transformer LM the port serves
and trains (mirrors ``distkeras_tpu/models/zoo.py`` ``transformer_lm``
:153), with dense or mixture-of-experts MLP blocks, optionally each
wrapped in ``blocks.Remat``."""

from __future__ import annotations

from typing import Optional

from distkeras_tpu_torch.models.attention import (LayerNorm,
                                                  PositionalEmbedding,
                                                  RMSNorm, TransformerBlock)
from distkeras_tpu_torch.models.blocks import Remat
from distkeras_tpu_torch.models.core import Sequential
from distkeras_tpu_torch.models.layers import Dense, Embedding
from distkeras_tpu_torch.models.moe import MoE


def transformer_lm(vocab_size: int, d_model: int = 512, num_heads: int = 8,
                   num_layers: int = 6, mlp_ratio: int = 4,
                   max_len: Optional[int] = None, use_rope: bool = True,
                   norm: str = "rmsnorm", dtype: str = "float32",
                   attn_impl: str = "auto",
                   seq_axis_name: Optional[str] = None,
                   num_kv_heads: Optional[int] = None,
                   rope_scale: float = 1.0,
                   attn_window: Optional[int] = None,
                   moe_every: int = 0, num_experts: int = 0,
                   moe_expert_axis: Optional[str] = None,
                   moe_aux_loss_weight: float = 0.0,
                   moe_dispatch: str = "dense",
                   moe_capacity_factor: float = 1.25,
                   moe_expert_unroll: bool = False,
                   remat: Optional[str] = None) -> Sequential:
    """Decoder-only causal transformer LM: tokens ``[B, S]`` in, logits
    ``[B, S, vocab]`` out. ``num_kv_heads < num_heads`` builds a
    grouped-query model; ``attn_window`` a sliding-window one.
    ``moe_every=k`` (with ``num_experts``) swaps every k-th block's MLP
    for a ``models.moe.MoE`` of hidden size ``mlp_ratio * d_model``
    (``moe_dispatch``, ``moe_capacity_factor``, ``moe_aux_loss_weight``
    and ``moe_expert_unroll`` configure it, as in JAX
    ``zoo.py:204-211``); ``moe_expert_axis`` (expert parallelism) raises
    naming its ROADMAP item. ``attn_impl`` is ``"auto"``/``"flash"``
    (the flash kernels) or ``"xla"`` (plain attention); the
    sequence-parallel ones and ``seq_axis_name`` raise naming their
    ROADMAP item. ``remat`` wraps every block in ``blocks.Remat`` with
    that policy (``"nothing"``, ``"dots"``, ``"dots_no_batch"``)."""
    layers = [Embedding(vocab_size, d_model)]
    if not use_rope:
        if max_len is None:
            raise ValueError("max_len required when use_rope=False")
        layers.append(PositionalEmbedding(max_len))
    for i in range(num_layers):
        mlp_layer = None
        if moe_every and num_experts and (i + 1) % moe_every == 0:
            mlp_layer = MoE(num_experts, mlp_ratio * d_model, dtype=dtype,
                            expert_axis_name=moe_expert_axis,
                            aux_loss_weight=moe_aux_loss_weight,
                            dispatch=moe_dispatch,
                            capacity_factor=moe_capacity_factor,
                            expert_unroll=moe_expert_unroll)
        block = TransformerBlock(
            num_heads, mlp_ratio=mlp_ratio, causal=True, use_rope=use_rope,
            norm=norm, dtype=dtype, attn_impl=attn_impl,
            seq_axis_name=seq_axis_name, num_kv_heads=num_kv_heads,
            rope_scale=rope_scale, attn_window=attn_window,
            mlp_layer=mlp_layer)
        layers.append(block if remat is None else Remat(block, policy=remat))
    layers.append(RMSNorm() if norm == "rmsnorm" else LayerNorm())
    layers.append(Dense(vocab_size, use_bias=False, dtype=dtype))
    return Sequential(layers)
