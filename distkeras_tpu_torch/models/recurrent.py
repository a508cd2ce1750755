"""Recurrent layers of the port: ``LSTM``, ``GRU`` and ``Bidirectional``
(mirrors ``distkeras_tpu/models/recurrent.py``: ``LSTM`` :26, ``GRU``
:94, ``Bidirectional`` :147), over inputs ``[batch, time, features]``.

Parameters under JAX's names and layouts, split from the key as JAX's
``init`` splits it (so a seed gives JAX's weights): LSTM ``wx [F, 4U]``,
``wh [U, 4U]``, ``b [4U]`` in gate order i, f, g, o with the forget
bias at 1; GRU ``wx [F, 3U]``, ``wh [U, 3U]``, ``b [3U]`` in gate order
r, z, n, where ``r`` scales the n block of ``h @ wh`` (not h, :131-133).

The input projection is one ``[B*T, kU]`` product (:64-66); the time
loop is a plain Python loop of ``torch.matmul`` and the elementwise
gates in the compute dtype, with the carry in that dtype, as JAX's
``lax.scan`` body. JAX computes all of it with plain XLA (no Pallas
kernel), and so does the port with PyTorch: not ``nn.LSTM``/``nn.GRU``
or cuDNN's RNN, whose GRU gates differ, which carry two biases and
whose bf16 carry does not round as JAX's does. ``reverse=True`` walks
time backwards and keeps each output at its input's position
(``lax.scan(reverse=True)``); with ``return_sequences=False`` the
result is the carry after the last step taken (t = 0 when reversed).
"""

from __future__ import annotations

import torch

from distkeras_tpu_torch.models.core import (Layer, layer_from_spec,
                                             layer_spec, register_layer,
                                             torch_dtype)
from distkeras_tpu_torch.models.layers import init_weights
from distkeras_tpu_torch.ops import prng


class _Recurrent(Layer):
    """Shared skeleton of ``LSTM`` and ``GRU``: ``gates`` gate blocks of
    ``units`` columns, the projection, the time loop and the config."""

    gates: int

    def __init__(self, units: int, return_sequences: bool = False,
                 reverse: bool = False, kernel_init: str = "glorot_uniform",
                 dtype: str = "float32"):
        super().__init__()
        self.units = int(units)
        self.return_sequences = bool(return_sequences)
        self.reverse = bool(reverse)
        self.kernel_init = kernel_init
        self.dtype = dtype

    def _bias(self, device) -> torch.Tensor:
        return torch.zeros(self.gates * self.units, device=device)

    def build(self, input_shape, rng):
        t, f = input_shape
        k1, k2 = prng.split(rng)
        gu = self.gates * self.units
        self.add_param("wx", init_weights(self.kernel_init, k1, (f, gu)))
        self.add_param("wh", init_weights("glorot_uniform", k2,
                                          (self.units, gu)))
        self.add_param("b", self._bias(rng.device))
        return (t, self.units) if self.return_sequences else (self.units,)

    def _init_carry(self, h0):
        return h0

    def _step(self, carry, xp, wh):
        """One time step: ``(new carry, h)``."""
        raise NotImplementedError

    def apply(self, p, x):
        dt = torch_dtype(self.dtype)
        wx, wh, b = p["wx"].to(dt), p["wh"].to(dt), p["b"].to(dt)
        xproj = torch.matmul(x.to(dt), wx) + b          # [B, T, kU]
        steps = range(x.shape[1])
        if self.reverse:
            steps = reversed(steps)
        carry = self._init_carry(xproj.new_zeros(x.shape[0], self.units))
        hs = [None] * x.shape[1]
        h = carry
        for t in steps:
            carry, h = self._step(carry, xproj[:, t], wh)
            hs[t] = h
        return torch.stack(hs, dim=1) if self.return_sequences else h

    def get_config(self):
        return {"units": self.units,
                "return_sequences": self.return_sequences,
                "reverse": self.reverse, "kernel_init": self.kernel_init,
                "dtype": self.dtype}


@register_layer
class LSTM(_Recurrent):
    """LSTM: gates i, f, g, o; ``c = f * c + i * g``, ``h = o *
    tanh(c)`` (JAX :69-77)."""

    gates = 4

    def _bias(self, device):
        u = self.units
        b = torch.zeros(4 * u, device=device)
        b[u:2 * u] = 1.0
        return b

    def _init_carry(self, h0):
        return (h0, h0)

    def _step(self, carry, xp, wh):
        h, c = carry
        i, f, g, o = (xp + torch.matmul(h, wh)).chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c = f * c + i * torch.tanh(g)
        h = o * torch.tanh(c)
        return (h, c), h


@register_layer
class GRU(_Recurrent):
    """GRU: gates r, z, n; ``n = tanh(x_n + r * (h @ wh)_n)``, ``h = (1 -
    z) * n + z * h`` (JAX :129-135)."""

    gates = 3

    def _step(self, h, xp, wh):
        u = self.units
        hp = torch.matmul(h, wh)
        r = torch.sigmoid(xp[:, :u] + hp[:, :u])
        z = torch.sigmoid(xp[:, u:2 * u] + hp[:, u:2 * u])
        n = torch.tanh(xp[:, 2 * u:] + r * hp[:, 2 * u:])
        h = (1 - z) * n + z * h
        return h, h


@register_layer
class Bidirectional(Layer):
    """A forward and a backward (``reverse=True``) copy of an LSTM/GRU,
    concatenated on the last axis (JAX :147). The forward copy is built
    with the first half of the key's split and the backward one with the
    second (:164-167); the parameter and state trees are ``{"forward",
    "backward"}``. The config is ``{"layer_spec": spec of the forward
    layer}`` (:183-187)."""

    def __init__(self, layer: Layer = None, **layer_config):
        super().__init__()
        if layer is None:       # from_config: the forward layer's spec
            layer = layer_from_spec(layer_config.pop("layer_spec"))
        # ``forward`` and ``backward`` are nn.Module methods: the copies
        # are held as ``fwd``/``bwd`` and named in the trees as JAX's
        self.fwd = layer
        self.bwd = type(layer).from_config(dict(layer.get_config(),
                                                reverse=True))

    def build(self, input_shape, rng):
        k1, k2 = prng.split(rng)
        of = self.fwd.build(input_shape, k1)
        ob = self.bwd.build(input_shape, k2)
        return tuple(of[:-1]) + (of[-1] + ob[-1],)

    def param_tree(self):
        return {"forward": self.fwd.param_tree(),
                "backward": self.bwd.param_tree()}

    def state_tree(self):
        return {"forward": self.fwd.state_tree(),
                "backward": self.bwd.state_tree()}

    def apply(self, p, x):
        return torch.cat([self.fwd.apply(p["forward"], x),
                          self.bwd.apply(p["backward"], x)], dim=-1)

    def sub_layers(self):
        """The two copies by subtree key (JAX :172)."""
        return {"forward": self.fwd, "backward": self.bwd}

    def get_config(self):
        return {"layer_spec": layer_spec(self.fwd)}
