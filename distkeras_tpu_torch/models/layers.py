"""Dense, embedding and dropout layers, activations and initializers.

Mirrors the parts of ``distkeras_tpu/models/layers.py`` that
``zoo.transformer_lm`` uses. ``"gelu"`` is ``jax.nn.gelu``'s default,
the tanh approximation (:40). Matrices are stored float32 and cast to
the layer's compute dtype when applied; activations flow in the compute
dtype (the JAX package's mixed-precision policy).
Initializers and dropout draw from JAX's threefry keys (``ops.prng``),
so a key gives the JAX package's weights and masks.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from distkeras_tpu_torch.models.core import Layer, torch_dtype
from distkeras_tpu_torch.ops import prng
from distkeras_tpu_torch.ops import prng

ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "softplus": F.softplus,
}


def get_activation(name):
    if callable(name):
        return name
    if name is None:
        return ACTIVATIONS["linear"]
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"Unknown activation {name!r}; known: {sorted(ACTIVATIONS)}")


def _fans(shape):
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def init_weights(name: str, rng: torch.Tensor, shape):
    """The Keras-named initializers (JAX :74-97), float32 on ``rng``'s
    device from the threefry key ``rng``: JAX's families, scales and
    draws (the uniform families bitwise ``jax.random.uniform``'s, the
    normal ones within the ulps of ``erfinv``)."""
    shape = tuple(int(s) for s in shape)
    fan_in, fan_out = _fans(shape)

    def uniform(limit):
        return prng.uniform(rng, shape, torch.float32, -limit, limit)

    def normal(std):
        return prng.normal(rng, shape) * torch.tensor(
            std, dtype=torch.float32, device=rng.device)

    if name == "zeros":
        return torch.zeros(shape, device=rng.device)
    if name == "ones":
        return torch.ones(shape, device=rng.device)
    if name == "glorot_uniform":
        return uniform(math.sqrt(6.0 / (fan_in + fan_out)))
    if name == "glorot_normal":
        return normal(math.sqrt(2.0 / (fan_in + fan_out)))
    if name == "he_normal":
        return normal(math.sqrt(2.0 / fan_in))
    if name == "he_uniform":
        return uniform(math.sqrt(6.0 / fan_in))
    if name == "lecun_normal":
        return normal(math.sqrt(1.0 / fan_in))
    if name == "uniform_scaling":
        return uniform(0.05)
    raise ValueError(f"Unknown initializer {name!r}")


def dropout(x, rate: float, rng):
    """Inverted dropout (JAX ``Dropout.apply`` :166-172): keep each entry
    with probability ``1 - rate`` by ``bernoulli(rng, keep, x.shape)``
    and scale the kept ones by ``1 / keep``."""
    keep = 1.0 - rate
    mask = prng.bernoulli(rng, keep, tuple(x.shape))
    return torch.where(mask, x / keep, 0.0)


class Dense(Layer):
    """Fully connected layer: ``kernel [in, units]`` (+ ``bias``)."""

    def __init__(self, units: int, activation=None, use_bias: bool = True,
                 kernel_init: str = "glorot_uniform",
                 dtype: str = "float32"):
        super().__init__()
        self.units = int(units)
        get_activation(activation)
        self.activation = activation
        self.use_bias = bool(use_bias)
        self.kernel_init = kernel_init
        self.dtype = dtype

    def build(self, input_shape, rng):
        self.add_param("kernel", init_weights(
            self.kernel_init, rng, (input_shape[-1], self.units)))
        if self.use_bias:
            self.add_param("bias", torch.zeros(self.units,
                                               device=rng.device))
        return tuple(input_shape[:-1]) + (self.units,)

    def apply(self, p, x):
        dt = torch_dtype(self.dtype)
        y = torch.matmul(x.to(dt), p["kernel"].to(dt))
        if self.use_bias:
            y = y + p["bias"].to(dt)
        return get_activation(self.activation)(y)


class Dropout(Layer):
    """Inverted dropout; the identity when not training or ``rng`` is
    None (JAX :160-175)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    @property
    def uses_rng(self) -> bool:
        return self.rate > 0.0

    def apply(self, p, x, rng=None):
        if not self.training or rng is None or self.rate <= 0.0:
            return x
        return dropout(x, self.rate, rng)


class Embedding(Layer):
    """Token ids ``[B, S]`` -> rows of ``embeddings [vocab, dim]`` (in the
    table's dtype)."""

    def __init__(self, vocab_size: int, dim: int,
                 embeddings_init: str = "uniform_scaling"):
        super().__init__()
        self.vocab_size = int(vocab_size)
        self.dim = int(dim)
        self.embeddings_init = embeddings_init

    def build(self, input_shape, rng):
        self.add_param("embeddings", init_weights(
            self.embeddings_init, rng, (self.vocab_size, self.dim)))
        return tuple(input_shape) + (self.dim,)

    def apply(self, p, x):
        return F.embedding(x.long(), p["embeddings"])
