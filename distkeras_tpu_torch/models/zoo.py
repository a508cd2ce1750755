"""Model zoo of the port: the decoder-only transformer LM this slice
serves (mirrors ``distkeras_tpu/models/zoo.py`` ``transformer_lm``
:153, dense MLP)."""

from __future__ import annotations

from typing import Optional

from distkeras_tpu_torch.models.attention import (LayerNorm,
                                                  PositionalEmbedding,
                                                  RMSNorm, TransformerBlock)
from distkeras_tpu_torch.models.core import Sequential
from distkeras_tpu_torch.models.layers import Dense, Embedding


def transformer_lm(vocab_size: int, d_model: int = 512, num_heads: int = 8,
                   num_layers: int = 6, mlp_ratio: int = 4,
                   max_len: Optional[int] = None, use_rope: bool = True,
                   norm: str = "rmsnorm", dtype: str = "float32",
                   num_kv_heads: Optional[int] = None,
                   rope_scale: float = 1.0,
                   attn_window: Optional[int] = None,
                   moe_every: int = 0, num_experts: int = 0) -> Sequential:
    """Decoder-only causal transformer LM: tokens ``[B, S]`` in, logits
    ``[B, S, vocab]`` out. ``num_kv_heads < num_heads`` builds a
    grouped-query model; ``attn_window`` a sliding-window one."""
    if moe_every or num_experts:
        raise NotImplementedError(
            "MoE blocks are not ported yet: ROADMAP, kernel queue items "
            "K6a-K6c (MoE serving)")
    layers = [Embedding(vocab_size, d_model)]
    if not use_rope:
        if max_len is None:
            raise ValueError("max_len required when use_rope=False")
        layers.append(PositionalEmbedding(max_len))
    for _ in range(num_layers):
        layers.append(TransformerBlock(
            num_heads, mlp_ratio=mlp_ratio, causal=True, use_rope=use_rope,
            norm=norm, dtype=dtype, num_kv_heads=num_kv_heads,
            rope_scale=rope_scale, attn_window=attn_window))
    layers.append(RMSNorm() if norm == "rmsnorm" else LayerNorm())
    layers.append(Dense(vocab_size, use_bias=False, dtype=dtype))
    return Sequential(layers)
