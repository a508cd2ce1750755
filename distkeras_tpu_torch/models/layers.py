"""Dense, embedding and dropout layers, activations and initializers.

Mirrors the parts of ``distkeras_tpu/models/layers.py`` that
``zoo.transformer_lm`` uses. ``"gelu"`` is ``jax.nn.gelu``'s default,
the tanh approximation (:40). Matrices are stored float32 and cast to
the layer's compute dtype when applied; activations flow in the compute
dtype (the JAX package's mixed-precision policy).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from distkeras_tpu_torch.models.core import Layer, torch_dtype

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


def init_weights(name: str, generator: torch.Generator, shape):
    """The Keras-named initializers the LM uses, drawn float32 on the CPU
    from ``generator`` (the JAX package's families and scales; the random
    streams differ, so tests carry weights across with ``models.bridge``)."""
    shape = tuple(int(s) for s in shape)
    fan_in, fan_out = _fans(shape)

    def uniform(limit):
        return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * limit

    if name == "zeros":
        return torch.zeros(shape)
    if name == "ones":
        return torch.ones(shape)
    if name == "glorot_uniform":
        return uniform(math.sqrt(6.0 / (fan_in + fan_out)))
    if name == "uniform_scaling":
        return uniform(0.05)
    raise ValueError(f"Unknown initializer {name!r}")


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

    def build(self, input_shape, generator):
        self.add_param("kernel", init_weights(
            self.kernel_init, generator, (input_shape[-1], self.units)))
        if self.use_bias:
            self.add_param("bias", torch.zeros(self.units))
        return tuple(input_shape[:-1]) + (self.units,)

    def apply(self, p, x):
        dt = torch_dtype(self.dtype)
        y = torch.matmul(x.to(dt), p["kernel"].to(dt))
        if self.use_bias:
            y = y + p["bias"].to(dt)
        return get_activation(self.activation)(y)


class Dropout(Layer):
    """Inverted dropout: the identity at inference. Training with a
    non-zero rate needs the JAX package's random bits and waits for the
    PRNG port."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def apply(self, p, x):
        if self.training and self.rate > 0.0:
            raise NotImplementedError(
                "training through Dropout(rate > 0) is not ported yet: "
                "ROADMAP, Queue 1 item 'PRNG and sampled paths'")
        return x


class Embedding(Layer):
    """Token ids ``[B, S]`` -> rows of ``embeddings [vocab, dim]`` (in the
    table's dtype)."""

    def __init__(self, vocab_size: int, dim: int,
                 embeddings_init: str = "uniform_scaling"):
        super().__init__()
        self.vocab_size = int(vocab_size)
        self.dim = int(dim)
        self.embeddings_init = embeddings_init

    def build(self, input_shape, generator):
        self.add_param("embeddings", init_weights(
            self.embeddings_init, generator, (self.vocab_size, self.dim)))
        return tuple(input_shape) + (self.dim,)

    def apply(self, p, x):
        return F.embedding(x.long(), p["embeddings"])
