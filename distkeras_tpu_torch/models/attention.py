"""Transformer layers: norms, positional embeddings, multi-head attention
(grouped queries, RoPE, sliding window), the MLP and the pre-norm block.

Mirrors ``distkeras_tpu/models/attention.py`` (:37-486), each layer
registered under its JAX name with JAX's ``get_config`` (a block's
``mlp_layer`` travels as a layer spec), with the same parameter names
and layouts: ``wq [d, H, Dh]``, ``wk``/``wv [d, Hkv,
Dh]``, ``wo [H, Dh, d]``, MLP ``w1 [d, r*d]``/``w2 [r*d, d]``. Norms
compute in float32 and cast back to the input dtype; projections run
in the layer's compute dtype. The full-sequence attention goes through
the differentiable ``ops.flash_attention.flash_attention`` (the CUDA
forward and backward kernels on the card, their plain versions on the
CPU) for ``attn_impl`` ``"auto"`` or ``"flash"``, and through the plain
``ops.attention.dot_product_attention`` for ``"xla"``. Both attention
layers accept packed-sequence ``segment_ids`` ``[B, S]``
(``accepts_segment_ids``): attention is restricted to equal ids; RoPE
positions stay absolute over the packed row, as in JAX :269-275; the
MLP half ignores the ids.

Sequence parallelism (JAX ``_attention_compute`` :130-177): with
``attn_impl="ring"`` (``ops.ring_attention``, ``ring_block_size`` its
``block_size``), ``"ulysses"`` or ``"ulysses_flash"``
(``ops.ulysses``, plain or flash inner attention) and
``seq_axis_name``, a layer called inside ``shard_map`` over a mesh
whose ``seq_axis_name`` axis shards the sequence holds one shard ``[B,
S_l, d]``: RoPE and ``PositionalEmbedding`` use GLOBAL positions,
``axis_index * S_l`` onwards (JAX :274, :78-108), grouped K/V heads are
repeated to the query heads for Ulysses (JAX ``_expand_kv``; the ring
shifts the ``Hkv``-head shards), and the ids are the local shard. A
bad combination raises what JAX raises: a window with a
sequence-parallel implementation, or one without ``seq_axis_name``, at
the call.

Tensor parallelism (the SPMD trainer, ``parallel.sharding``): given the
rank's block of its heads (``wq``/``wo`` split over the placement's
tensor-parallel axis) or of its hidden units (``w1``/``b1``/``w2``), the
attention and the MLP compute those between Megatron's
``replicate_in`` at the input and one ``reduce_out`` after ``wo`` or
``w2`` (``b2`` is added after the sum); grouped K/V heads the axis does
not divide stay whole and each rank takes its query heads' groups.
"""

from __future__ import annotations

from typing import Optional

import torch

from distkeras_tpu_torch.models.core import (Layer, layer_from_spec,
                                             layer_spec, register_layer,
                                             torch_dtype)
from distkeras_tpu_torch.models.layers import (dropout, get_activation,
                                               init_weights)
from distkeras_tpu_torch.ops import prng
from distkeras_tpu_torch.ops.attention import (apply_rope,
                                               dot_product_attention)
from distkeras_tpu_torch.ops.flash_attention import flash_attention

#: attention implementations of one device, and the sequence-parallel
#: ones (JAX ``_attention_compute`` :130), which run over a mesh axis
ATTN_IMPLS = ("auto", "flash", "xla")
SEQ_PARALLEL_IMPLS = ("ring", "ulysses", "ulysses_flash")


def check_attn_impl(attn_impl: str):
    """An unknown implementation name raises ``ValueError``."""
    if attn_impl not in ATTN_IMPLS + SEQ_PARALLEL_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r}; known: "
                         f"{ATTN_IMPLS + SEQ_PARALLEL_IMPLS}")


def _axis_bound(axis_name) -> bool:
    """True inside ``shard_map``/``with mesh:`` over a mesh with the axis;
    outside, the input holds the FULL sequence (JAX :98-106)."""
    from distkeras_tpu_torch.parallel.mesh import current_mesh
    mesh = current_mesh()
    return mesh is not None and axis_name in mesh.shape


def _attention_compute(q, k, v, *, causal, impl, axis_name=None,
                       ring_block_size=None, window=None,
                       segment_ids=None):
    """Dispatch on the implementation (JAX :130-177); q/k/v are BSHD,
    k/v with the query heads for ``"xla"`` and Ulysses, grouped for the
    flash and ring implementations. ``segment_ids`` flow to every
    implementation (the local shard for the sequence-parallel ones)."""
    if impl in ("auto", "flash"):
        return flash_attention(q, k, v, causal=causal, window=window,
                               segment_ids=segment_ids)
    if window is not None and impl in SEQ_PARALLEL_IMPLS:
        raise ValueError(
            f"attn_window is not supported with attn_impl={impl!r} "
            "(sequence-parallel paths have no windowed variant yet)")
    if impl == "ring":
        if not axis_name:
            raise ValueError(
                "attn_impl='ring' requires seq_axis_name (the mesh axis the "
                "sequence is sharded over, e.g. 'sp' from parallel.mesh); "
                "without it RoPE positions and causal masks would silently "
                "use shard-local coordinates")
        from distkeras_tpu_torch.ops.ring_attention import ring_attention
        return ring_attention(q, k, v, axis_name=axis_name, causal=causal,
                              block_size=ring_block_size,
                              segment_ids=segment_ids)
    if impl in ("ulysses", "ulysses_flash"):
        if not axis_name:
            raise ValueError(
                "attn_impl='ulysses' requires seq_axis_name (the mesh axis "
                "the sequence is sharded over); without it RoPE positions "
                "and causal masks would silently use shard-local "
                "coordinates")
        from distkeras_tpu_torch.ops.ulysses import ulysses_attention
        return ulysses_attention(
            q, k, v, axis_name=axis_name, causal=causal,
            impl="flash" if impl == "ulysses_flash" else "xla",
            segment_ids=segment_ids)
    return dot_product_attention(q, k, v, causal=causal, window=window,
                                 segment_ids=segment_ids)


@register_layer
class LayerNorm(Layer):
    def __init__(self, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = float(epsilon)

    def build(self, input_shape, rng):
        self.add_param("scale", torch.ones(input_shape[-1],
                                           device=rng.device))
        self.add_param("offset", torch.zeros(input_shape[-1],
                                             device=rng.device))
        return tuple(input_shape)

    def apply(self, p, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        return (y * p["scale"] + p["offset"]).to(x.dtype)

    def get_config(self):
        return {"epsilon": self.epsilon}


@register_layer
class RMSNorm(Layer):
    def __init__(self, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = float(epsilon)

    def build(self, input_shape, rng):
        self.add_param("scale", torch.ones(input_shape[-1],
                                           device=rng.device))
        return tuple(input_shape)

    def apply(self, p, x):
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True)
                             + self.epsilon)
        return (y * p["scale"]).to(x.dtype)

    def get_config(self):
        return {"epsilon": self.epsilon}


@register_layer
class PositionalEmbedding(Layer):
    """Learned absolute positions added to a ``[B, S, d]`` input. With
    ``seq_axis_name``, inside a mesh that binds that axis the input is
    one sequence shard, and the layer takes the GLOBAL positions ``idx *
    S`` onwards (JAX :78-108); outside one it holds the whole
    sequence."""

    def __init__(self, max_len: int, seq_axis_name: Optional[str] = None):
        super().__init__()
        self.max_len = int(max_len)
        self.seq_axis_name = seq_axis_name

    def build(self, input_shape, rng):
        self.add_param("embeddings", init_weights(
            "uniform_scaling", rng, (self.max_len, input_shape[-1])))
        return tuple(input_shape)

    def apply(self, p, x):
        s = x.shape[1]
        start = 0
        if self.seq_axis_name and _axis_bound(self.seq_axis_name):
            from distkeras_tpu_torch.parallel import collectives
            global_len = s * collectives.axis_size(self.seq_axis_name)
            if global_len > self.max_len:
                raise ValueError(
                    f"PositionalEmbedding(max_len={self.max_len}) is too "
                    f"small for global sequence length {global_len} "
                    f"({s} per shard over axis '{self.seq_axis_name}')")
            start = collectives.axis_index(self.seq_axis_name) * s
        elif s > self.max_len:
            raise ValueError(f"PositionalEmbedding(max_len={self.max_len}) "
                             f"is too small for {s} positions")
        emb = p["embeddings"][start:start + s]
        return x + emb[None].to(x.dtype)

    def get_config(self):
        return {"max_len": self.max_len,
                "seq_axis_name": self.seq_axis_name}


@register_layer
class MultiHeadAttention(Layer):
    """Multi-head self-attention over ``[B, S, d_model]``;
    ``num_kv_heads < num_heads`` is grouped-query attention."""

    accepts_segment_ids = True

    def __init__(self, num_heads: int, head_dim: Optional[int] = None,
                 causal: bool = True, use_rope: bool = True,
                 dtype: str = "float32", attn_impl: str = "auto",
                 seq_axis_name: Optional[str] = None,
                 kernel_init: str = "glorot_uniform",
                 ring_block_size: Optional[int] = None,
                 num_kv_heads: Optional[int] = None,
                 rope_scale: float = 1.0,
                 attn_window: Optional[int] = None):
        super().__init__()
        check_attn_impl(attn_impl)
        self.attn_impl = attn_impl
        self.seq_axis_name = seq_axis_name
        #: the ring's ``block_size`` (validated there; changes no result)
        self.ring_block_size = ring_block_size
        self.rope_scale = float(rope_scale)
        self.attn_window = (int(attn_window) if attn_window is not None
                            else None)
        if self.attn_window is not None and not causal:
            raise ValueError("attn_window requires causal=True")
        self.num_heads = int(num_heads)
        self.num_kv_heads = (int(num_kv_heads) if num_kv_heads is not None
                             else None)
        kv = self.kv_heads
        if kv < 1 or self.num_heads % kv:
            raise ValueError(
                f"num_kv_heads must be a positive divisor of num_heads "
                f"{self.num_heads}, got {kv}")
        self.head_dim = head_dim if head_dim is None else int(head_dim)
        #: the head_dim argument (``build`` resolves None to d_model / H)
        self._head_dim_arg = self.head_dim
        self.causal = bool(causal)
        self.use_rope = bool(use_rope)
        self.dtype = dtype
        self.kernel_init = kernel_init

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    def build(self, input_shape, rng):
        d_model = input_shape[-1]
        if self.head_dim is None:
            self.head_dim = d_model // self.num_heads
        h, dh, hkv = self.num_heads, self.head_dim, self.kv_heads
        ks = prng.split(rng, 4)

        # drawn as the logical 2-D matrices, then reshaped (the fan rule
        # of a 3-D tensor would shrink the scale)
        def w2d(k, m, n):
            return init_weights(self.kernel_init, k, (m, n))

        self.add_param("wq", w2d(ks[0], d_model, h * dh)
                       .reshape(d_model, h, dh))
        self.add_param("wk", w2d(ks[1], d_model, hkv * dh)
                       .reshape(d_model, hkv, dh))
        self.add_param("wv", w2d(ks[2], d_model, hkv * dh)
                       .reshape(d_model, hkv, dh))
        self.add_param("wo", w2d(ks[3], h * dh, d_model)
                       .reshape(h, dh, d_model))
        return tuple(input_shape)

    def apply(self, p, x, segment_ids=None):
        dt = torch_dtype(self.dtype)
        impl = self.attn_impl
        from distkeras_tpu_torch.parallel.sharding import \
            tensor_parallel_axis
        tp = tensor_parallel_axis(p["wq"].shape[1], self.num_heads, "heads")
        wk, wv = p["wk"], p["wv"]
        if tp is not None:
            # Megatron's column->row split: this rank's heads of q/k/v and
            # of wo's input; the branch input's gradient sums the ranks'
            from distkeras_tpu_torch.parallel.collectives import (
                axis_index, replicate_in)
            x = replicate_in(x, tp)
            if wk.shape[1] == self.kv_heads:
                # grouped K/V heads the axis does not divide stay whole:
                # each rank expands them to its own query heads
                hl = p["wq"].shape[1]
                g = self.num_heads // self.kv_heads
                heads = torch.arange(axis_index(tp) * hl,
                                     (axis_index(tp) + 1) * hl,
                                     device=wk.device) // g
                wk = replicate_in(wk, tp).index_select(1, heads)
                wv = replicate_in(wv, tp).index_select(1, heads)
        xc = x.to(dt)
        positions = None
        if self.use_rope and impl in SEQ_PARALLEL_IMPLS \
                and self.seq_axis_name:
            # global positions of this sequence shard (JAX :274)
            from distkeras_tpu_torch.parallel import collectives
            s = x.shape[1]
            positions = collectives.axis_index(self.seq_axis_name) * s \
                + torch.arange(s, device=x.device)
        q = torch.einsum("bsd,dhe->bshe", xc, p["wq"].to(dt))
        k = torch.einsum("bsd,dhe->bshe", xc, wk.to(dt))
        v = torch.einsum("bsd,dhe->bshe", xc, wv.to(dt))
        if self.use_rope:
            q = apply_rope(q, positions, scale=self.rope_scale)
            k = apply_rope(k, positions, scale=self.rope_scale)
        g = q.shape[2] // k.shape[2]
        if g > 1 and impl in ("xla", "ulysses", "ulysses_flash"):
            # one K/V head per query head (JAX ``_expand_kv``): Ulysses'
            # all-to-all splits heads; the flash kernels, and the ring's
            # hops over them, read a group's shared head directly
            k = k.repeat_interleave(g, dim=2)
            v = v.repeat_interleave(g, dim=2)
        out = _attention_compute(q, k, v, causal=self.causal, impl=impl,
                                 axis_name=self.seq_axis_name,
                                 ring_block_size=self.ring_block_size,
                                 window=self.attn_window,
                                 segment_ids=segment_ids)
        y = torch.einsum("bshe,hed->bsd", out, p["wo"].to(dt))
        if tp is not None:
            from distkeras_tpu_torch.parallel.collectives import reduce_out
            y = reduce_out(y, tp)
        return y.to(x.dtype)

    def get_config(self):
        return {"num_heads": self.num_heads, "head_dim": self._head_dim_arg,
                "causal": self.causal, "use_rope": self.use_rope,
                "dtype": self.dtype, "attn_impl": self.attn_impl,
                "seq_axis_name": self.seq_axis_name,
                "kernel_init": self.kernel_init,
                "ring_block_size": self.ring_block_size,
                "num_kv_heads": self.num_kv_heads,
                "rope_scale": self.rope_scale,
                "attn_window": self.attn_window}


@register_layer
class TransformerMLP(Layer):
    """Position-wise MLP: ``act(x @ w1 + b1) @ w2 + b2``."""

    def __init__(self, hidden_dim: int, activation: str = "gelu",
                 dtype: str = "float32",
                 kernel_init: str = "glorot_uniform"):
        super().__init__()
        self.hidden_dim = int(hidden_dim)
        self.activation = activation
        self.dtype = dtype
        self.kernel_init = kernel_init

    def build(self, input_shape, rng):
        d = input_shape[-1]
        k1, k2 = prng.split(rng)
        self.add_param("w1", init_weights(self.kernel_init, k1,
                                          (d, self.hidden_dim)))
        self.add_param("b1", torch.zeros(self.hidden_dim, device=rng.device))
        self.add_param("w2", init_weights(self.kernel_init, k2,
                                          (self.hidden_dim, d)))
        self.add_param("b2", torch.zeros(d, device=rng.device))
        return tuple(input_shape)

    def apply(self, p, x):
        dt = torch_dtype(self.dtype)
        act = get_activation(self.activation)
        from distkeras_tpu_torch.parallel.sharding import \
            tensor_parallel_axis
        tp = tensor_parallel_axis(p["w1"].shape[-1], self.hidden_dim,
                                  "hidden units")
        xin = x
        if tp is not None:
            from distkeras_tpu_torch.parallel.collectives import replicate_in
            xin = replicate_in(x, tp)
        h = act(xin.to(dt) @ p["w1"].to(dt) + p["b1"].to(dt))
        y = h @ p["w2"].to(dt)
        if tp is not None:
            # the row split: each rank's hidden units' part of the sum
            from distkeras_tpu_torch.parallel.collectives import reduce_out
            y = reduce_out(y, tp)
        y = y + p["b2"].to(dt)
        return y.to(x.dtype)

    def get_config(self):
        return {"hidden_dim": self.hidden_dim, "activation": self.activation,
                "dtype": self.dtype, "kernel_init": self.kernel_init}


@register_layer
class TransformerBlock(Layer):
    """Pre-norm residual block: ``x + attn(norm(x))``, then
    ``x + mlp(norm(x))``. ``mlp_layer`` (e.g. a ``models.moe.MoE``)
    replaces the ``TransformerMLP`` the block would build.
    ``dropout_rate > 0`` drops out both residual branches in training
    when ``apply`` gets an ``rng`` (JAX :447-466)."""

    accepts_segment_ids = True

    def __init__(self, num_heads: int, mlp_ratio: int = 4,
                 head_dim: Optional[int] = None, causal: bool = True,
                 use_rope: bool = True, activation: str = "gelu",
                 norm: str = "rmsnorm", dtype: str = "float32",
                 attn_impl: str = "auto",
                 seq_axis_name: Optional[str] = None,
                 mlp_layer: Optional[Layer] = None,
                 dropout_rate: float = 0.0,
                 ring_block_size: Optional[int] = None,
                 num_kv_heads: Optional[int] = None,
                 rope_scale: float = 1.0,
                 attn_window: Optional[int] = None):
        super().__init__()
        self.dropout_rate = float(dropout_rate)
        self.mlp_ratio = int(mlp_ratio)
        self.activation = activation
        self.dtype = dtype
        # the arguments as JAX's block keeps them, for ``get_config``
        self._config = {"num_heads": int(num_heads), "head_dim": head_dim,
                        "causal": causal, "use_rope": use_rope,
                        "norm": norm, "attn_impl": attn_impl,
                        "seq_axis_name": seq_axis_name,
                        "ring_block_size": ring_block_size,
                        "num_kv_heads": num_kv_heads,
                        "rope_scale": float(rope_scale),
                        "attn_window": attn_window}
        norm_cls = RMSNorm if norm == "rmsnorm" else LayerNorm
        self.norm1 = norm_cls()
        self.attn = MultiHeadAttention(
            num_heads, head_dim=head_dim, causal=causal, use_rope=use_rope,
            dtype=dtype, attn_impl=attn_impl, seq_axis_name=seq_axis_name,
            ring_block_size=ring_block_size, num_kv_heads=num_kv_heads,
            rope_scale=rope_scale, attn_window=attn_window)
        self.norm2 = norm_cls()
        self._mlp_override = mlp_layer is not None
        # sized at build from d_model unless given
        self.mlp = mlp_layer

    @property
    def uses_rng(self) -> bool:
        return self.dropout_rate > 0.0

    def build(self, input_shape, rng):
        d_model = input_shape[-1]
        if not self._mlp_override:
            self.mlp = TransformerMLP(self.mlp_ratio * d_model,
                                      activation=self.activation,
                                      dtype=self.dtype)
        ks = prng.split(rng, 4)
        for layer, k in zip((self.norm1, self.attn, self.norm2, self.mlp),
                            ks):
            layer.build(tuple(input_shape), k)
        return tuple(input_shape)

    def apply(self, p, x, segment_ids=None, rng=None):
        # one key per consumer, as JAX splits them (the mlp's is unused)
        drop = self.training and rng is not None and self.dropout_rate > 0
        if drop:
            k_drop1, _, k_drop2 = prng.split(rng, 3)
        a = self.attn.apply(p["attn"], self.norm1.apply(p["norm1"], x),
                            segment_ids=segment_ids)
        if drop:
            a = dropout(a, self.dropout_rate, k_drop1)
        x = x + a
        m = self.mlp.apply(p["mlp"], self.norm2.apply(p["norm2"], x))
        if drop:
            m = dropout(m, self.dropout_rate, k_drop2)
        return x + m

    def sub_layers(self):
        """The sub-layers by subtree key (``models.core.trainable_mask``
        recurses through them, as JAX :460)."""
        return {"norm1": self.norm1, "attn": self.attn,
                "norm2": self.norm2, "mlp": self.mlp}

    def get_config(self):
        c = self._config
        cfg = {"num_heads": c["num_heads"], "mlp_ratio": self.mlp_ratio,
               "head_dim": c["head_dim"], "causal": c["causal"],
               "use_rope": c["use_rope"], "activation": self.activation,
               "norm": c["norm"], "dtype": self.dtype,
               "attn_impl": c["attn_impl"],
               "seq_axis_name": c["seq_axis_name"],
               "dropout_rate": self.dropout_rate,
               "ring_block_size": c["ring_block_size"],
               "num_kv_heads": c["num_kv_heads"],
               "rope_scale": c["rope_scale"],
               "attn_window": c["attn_window"]}
        if self._mlp_override:
            cfg["mlp_layer"] = layer_spec(self.mlp)
        return cfg

    @classmethod
    def from_config(cls, config):
        config = dict(config)
        spec = config.pop("mlp_layer", None)
        if spec is not None:
            config["mlp_layer"] = layer_from_spec(spec)
        return cls(**config)
