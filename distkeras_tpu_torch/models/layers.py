"""Standard layers of the port: dense, embedding, dropout, activation,
reshaping, convolution (plain, 1-d, depthwise, separable, transposed),
upsampling, pooling and normalization layers, activations and
initializers. Every class is registered under its JAX name and its
``get_config`` is the JAX layer's (``models.core.layer_spec``).

Mirrors ``distkeras_tpu/models/layers.py``. ``"gelu"`` is
``jax.nn.gelu``'s default, the tanh approximation (:40). Weights are
stored float32 and cast to the layer's compute dtype when applied;
activations flow in the compute dtype (the JAX package's mixed-precision
policy), and the normalizations compute in float32 and cast back.
Initializers and dropout draw from JAX's threefry keys (``ops.prng``),
so a key gives the JAX package's weights and masks.

The image layers keep JAX's layout at their interface: inputs NHWC (NWC
for ``Conv1D``), kernels HWIO (WIO). A convolution runs on the NCHW view
``x.permute(0, 3, 1, 2)`` of the NHWC tensor, which is a channels-last
tensor to PyTorch (no copy), and permutes its output back, so
``Flatten`` reads H, W, C in JAX's order. The convolutions and pools are
PyTorch's (cuDNN on the card): JAX computes them with plain XLA
(``lax.conv_general_dilated``, ``lax.conv_transpose``,
``lax.reduce_window``), not with a Pallas kernel. ``"SAME"`` padding is XLA's, which is asymmetric where the
window overhangs by an odd amount (``same_pads``); it is applied with
``F.pad`` (zeros for a convolution or an average, ``-inf`` for a max).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from distkeras_tpu_torch.models.core import (Layer, register_layer,
                                             torch_dtype)
from distkeras_tpu_torch.ops import prng
from distkeras_tpu_torch.ops.normalization import bn_train_apply

#: the data-parallel half of the family's ROADMAP item, named in errors
SYNC_BN_ITEM = ("ROADMAP, Queue 1 item 10 (cross-replica BatchNorm, "
                "axis_name=, needs a mesh of cards)")

ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": torch.relu,
    "relu6": F.relu6,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "log_softmax": lambda x: torch.log_softmax(x, dim=-1),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "elu": F.elu,
    "leaky_relu": F.leaky_relu,
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


@register_layer
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

    def get_config(self):
        return {"units": self.units, "activation": self.activation,
                "use_bias": self.use_bias, "kernel_init": self.kernel_init,
                "dtype": self.dtype}


@register_layer
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

    def get_config(self):
        return {"rate": self.rate}


@register_layer
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

    def get_config(self):
        return {"vocab_size": self.vocab_size, "dim": self.dim,
                "embeddings_init": self.embeddings_init}


@register_layer
class Activation(Layer):
    """An activation by name (JAX :148)."""

    def __init__(self, activation: str):
        super().__init__()
        get_activation(activation)  # fail at construction
        self.activation = activation

    def apply(self, p, x):
        return get_activation(self.activation)(x)

    def get_config(self):
        return {"activation": self.activation}


@register_layer
class Flatten(Layer):
    """``[B, ...] -> [B, prod(...)]`` in JAX's (row-major NHWC) order
    (JAX :179)."""

    def build(self, input_shape, rng):
        return (math.prod(input_shape),)

    def apply(self, p, x):
        return x.reshape(x.shape[0], -1)


@register_layer
class Reshape(Layer):
    """``[B, ...] -> [B, *target_shape]`` (JAX :188)."""

    def __init__(self, target_shape: Sequence[int]):
        super().__init__()
        self.target_shape = tuple(int(d) for d in target_shape)

    def build(self, input_shape, rng):
        return self.target_shape

    def apply(self, p, x):
        return x.reshape((x.shape[0],) + self.target_shape)

    def get_config(self):
        return {"target_shape": list(self.target_shape)}


# ---------------------------------------------------------------------------
# convolution / pooling (channels last)
# ---------------------------------------------------------------------------

def _pair(v) -> Tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(e)
                                                             for e in v)


def same_pads(sizes, window, strides):
    """XLA's ``"SAME"`` padding, ``(low, high)`` per spatial dimension:
    ``out = ceil(n / s)``, ``total = max((out - 1) * s + k - n, 0)``,
    ``low = total // 2`` (the extra element, if any, goes high)."""
    pads = []
    for n, k, s in zip(sizes, window, strides):
        out = -(-int(n) // s)
        total = max((out - 1) * s + k - int(n), 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _out_sizes(sizes, window, strides, padding: str):
    """Spatial output sizes of a window op (XLA's rule per padding)."""
    if padding == "SAME":
        return tuple(-(-int(n) // s) for n, s in zip(sizes, strides))
    return tuple((int(n) - k) // s + 1
                 for n, k, s in zip(sizes, window, strides))


def _pad_spatial(x: torch.Tensor, pads, value: float) -> torch.Tensor:
    """Pad the trailing spatial dimensions of channels-first ``x`` by
    ``pads`` (``(low, high)`` per dimension, leading first)."""
    flat = [e for lo_hi in reversed(pads) for e in lo_hi]
    if not any(flat):
        return x
    return F.pad(x, flat, value=value)


def _check_padding(padding: str) -> str:
    padding = padding.upper()
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    return padding


class _ConvND(Layer):
    """Shared N-d convolution (JAX :210): channels-last input, kernel
    ``[*window, in, filters]`` under ``kernel``, optional ``bias``. The
    input and kernel are cast to the compute dtype, the bias added there
    after the convolution, then the activation. Subclasses change the
    kernel's shape, the output width and the convolution itself
    (``_kernel_shape``, ``_out_channels``, ``_out_spatial``, ``_conv``),
    as JAX's hooks do."""

    _rank: int

    def __init__(self, filters: int, kernel_size, strides=1, padding="SAME",
                 activation=None, use_bias: bool = True,
                 kernel_init: str = "he_normal", dtype: str = "float32"):
        super().__init__()
        get_activation(activation)  # fail at construction
        self.filters = int(filters)
        self.kernel_size = self._spatial(kernel_size)
        self.strides = self._spatial(strides)
        self.padding = _check_padding(padding)
        self.activation = activation
        self.use_bias = bool(use_bias)
        self.kernel_init = kernel_init
        self.dtype = dtype

    def _spatial(self, v) -> tuple:
        """A bare int broadcasts to the layer's spatial rank; a sequence
        must match it (JAX :237)."""
        n = self._rank
        if isinstance(v, (tuple, list)):
            if len(v) != n:
                raise ValueError(f"{type(self).__name__} expects {n} "
                                 f"spatial dim(s), got {v}")
            return tuple(int(e) for e in v)
        return (int(v),) * n

    # -- subclass hooks ------------------------------------------------------
    def _kernel_shape(self, c: int) -> tuple:
        return self.kernel_size + (c, self.filters)

    def _out_channels(self, c: int) -> int:
        return self.filters

    def _out_spatial(self, sizes) -> tuple:
        return _out_sizes(sizes, self.kernel_size, self.strides,
                          self.padding)

    def _conv(self, xc, w):
        """The convolution of the channels-first ``xc`` by ``w`` ``[out,
        in / groups, *window]`` (XLA's SAME pads first); the groups follow
        from the kernel's in axis (``feature_group_count``)."""
        if self.padding == "SAME":
            xc = _pad_spatial(xc, same_pads(xc.shape[2:], self.kernel_size,
                                            self.strides), 0.0)
        conv = F.conv1d if self._rank == 1 else F.conv2d
        return conv(xc, w, stride=self.strides,
                    groups=xc.shape[1] // w.shape[1])

    # -- shared body ---------------------------------------------------------
    def build(self, input_shape, rng):
        c = input_shape[-1]
        self.add_param("kernel", init_weights(self.kernel_init, rng,
                                              self._kernel_shape(c)))
        if self.use_bias:
            self.add_param("bias", torch.zeros(self._out_channels(c),
                                               device=rng.device))
        return self._out_spatial(input_shape[:-1]) + (self._out_channels(c),)

    def apply(self, p, x):
        dt = torch_dtype(self.dtype)
        r = self._rank
        xc = x.to(dt).movedim(-1, 1)         # the channels-first view
        # [*window, in, out] -> [out, in, *window]
        w = p["kernel"].to(dt).permute(r + 1, r, *range(r))
        y = self._conv(xc, w).movedim(1, -1)
        if self.use_bias:
            y = y + p["bias"].to(dt)
        return get_activation(self.activation)(y)

    def get_config(self):
        ks, st = self.kernel_size, self.strides
        return {"filters": self.filters,
                "kernel_size": list(ks) if len(ks) > 1 else ks[0],
                "strides": list(st) if len(st) > 1 else st[0],
                "padding": self.padding,
                "activation": self.activation, "use_bias": self.use_bias,
                "kernel_init": self.kernel_init, "dtype": self.dtype}


@register_layer
class Conv2D(_ConvND):
    """2-d convolution over ``[B, H, W, C]``, kernel HWIO (JAX :287)."""
    _rank = 2


@register_layer
class Conv1D(_ConvND):
    """1-d convolution over ``[B, W, C]``, kernel WIO (JAX :294)."""
    _rank = 1


@register_layer
class DepthwiseConv2D(_ConvND):
    """Depthwise 2-d convolution (JAX :300): each input channel is
    convolved with its own ``depth_multiplier`` filters. The HWIO kernel
    is ``[kh, kw, 1, C * m]`` and runs with ``groups=C`` (JAX's
    ``feature_group_count``): output channel ``c * m + j`` is the j-th
    filter of input channel c in both packages."""

    _rank = 2

    def __init__(self, kernel_size, strides=1, padding: str = "SAME",
                 depth_multiplier: int = 1, activation=None,
                 use_bias: bool = True, kernel_init: str = "he_normal",
                 dtype: str = "float32"):
        super().__init__(filters=0, kernel_size=kernel_size,
                         strides=strides, padding=padding,
                         activation=activation, use_bias=use_bias,
                         kernel_init=kernel_init, dtype=dtype)
        self.depth_multiplier = int(depth_multiplier)

    def _kernel_shape(self, c):
        return self.kernel_size + (1, c * self.depth_multiplier)

    def _out_channels(self, c):
        return c * self.depth_multiplier

    def get_config(self):
        cfg = super().get_config()
        cfg.pop("filters")
        cfg["depth_multiplier"] = self.depth_multiplier
        return cfg


@register_layer
class SeparableConv2D(Layer):
    """Depthwise-separable convolution (JAX :341): a ``DepthwiseConv2D``
    with no bias and no activation, then a 1x1 ``Conv2D`` that carries
    the activation and the bias. Parameters ``{"depthwise",
    "pointwise"}``; the key splits in two for them, as JAX's."""

    def __init__(self, filters: int, kernel_size, strides=1,
                 padding: str = "SAME", depth_multiplier: int = 1,
                 activation=None, use_bias: bool = True,
                 kernel_init: str = "he_normal", dtype: str = "float32"):
        super().__init__()
        self.filters = int(filters)
        self.depth_multiplier = int(depth_multiplier)
        self.activation = activation
        self.use_bias = bool(use_bias)
        self.kernel_init = kernel_init
        self.dtype = dtype
        self.depthwise = DepthwiseConv2D(
            kernel_size, strides=strides, padding=padding,
            depth_multiplier=depth_multiplier, use_bias=False,
            kernel_init=kernel_init, dtype=dtype)
        self.pointwise = Conv2D(filters, 1, activation=activation,
                                use_bias=use_bias, kernel_init=kernel_init,
                                dtype=dtype)

    def build(self, input_shape, rng):
        k1, k2 = prng.split(rng)
        shape = self.depthwise.build(input_shape, k1)
        return self.pointwise.build(shape, k2)

    def apply(self, p, x):
        return self.pointwise.apply(p["pointwise"],
                                    self.depthwise.apply(p["depthwise"], x))

    def sub_layers(self):
        """The two convolutions by subtree key (JAX :371)."""
        return {"depthwise": self.depthwise, "pointwise": self.pointwise}

    def get_config(self):
        cfg = _ConvND.get_config(self.depthwise)
        cfg.pop("filters")
        cfg.update(filters=self.filters,
                   depth_multiplier=self.depth_multiplier,
                   activation=self.activation, use_bias=self.use_bias)
        return cfg


def conv_transpose_pads(k: int, s: int, padding: str):
    """``lax.conv_transpose``'s ``(low, high)`` padding of the
    stride-dilated input for one spatial dimension
    (``jax._src.lax.convolution._conv_transpose_padding``): SAME gives
    ``n * s`` outputs, VALID ``n * s + max(k - s, 0)``."""
    if padding == "SAME":
        total = k + s - 2
        low = k - 1 if s > k - 1 else -(-total // 2)
    else:
        total = k + s - 2 + max(k - s, 0)
        low = k - 1
    return low, total - low


@register_layer
class Conv2DTranspose(_ConvND):
    """Transposed 2-d convolution (JAX :392), as ``lax.conv_transpose``
    computes it with its default ``transpose_kernel=False``: the input
    dilated by the strides (``s - 1`` zeros between neighbours), padded
    by ``conv_transpose_pads`` and convolved at stride 1 with the HWIO
    kernel AS GIVEN (``[kh, kw, in, filters]``). This is not
    ``F.conv_transpose2d``, which is the gradient of a convolution: it
    flips the kernel spatially and swaps its in and out axes."""

    _rank = 2

    def _out_spatial(self, sizes):
        return tuple((int(n) - 1) * s + 1 + sum(conv_transpose_pads(
            k, s, self.padding)) - k + 1
            for n, k, s in zip(sizes, self.kernel_size, self.strides))

    def _conv(self, xc, w):
        b, c, h, wd = xc.shape
        sh, sw = self.strides
        if (sh, sw) != (1, 1):
            dil = xc.new_zeros((b, c, (h - 1) * sh + 1, (wd - 1) * sw + 1))
            dil[:, :, ::sh, ::sw] = xc
            xc = dil
        pads = [conv_transpose_pads(k, s, self.padding)
                for k, s in zip(self.kernel_size, self.strides)]
        return F.conv2d(_pad_spatial(xc, pads, 0.0), w)


@register_layer
class UpSampling2D(Layer):
    """Nearest-neighbour upsampling ``[B, H, W, C] -> [B, rH, rW, C]``
    (JAX :404, ``jnp.repeat`` on each spatial axis); no parameters."""

    def __init__(self, size=2):
        super().__init__()
        if isinstance(size, (tuple, list)) and len(size) != 2:
            raise ValueError(
                f"UpSampling2D expects 2 spatial factors, got {size}")
        self.size = _pair(size)

    def build(self, input_shape, rng):
        h, w, c = input_shape
        return (h * self.size[0], w * self.size[1], c)

    def apply(self, p, x):
        return x.repeat_interleave(self.size[0], dim=1) \
            .repeat_interleave(self.size[1], dim=2)

    def get_config(self):
        return {"size": list(self.size)}


class _Pool2D(Layer):
    """Shared 2-d pooling over ``[B, H, W, C]`` (JAX :430)."""

    def __init__(self, pool_size=2, strides=None, padding="VALID"):
        super().__init__()
        self.pool_size = _pair(pool_size)
        self.strides = (_pair(strides) if strides is not None
                        else self.pool_size)
        self.padding = _check_padding(padding)

    def _pads(self, xc):
        if self.padding == "VALID":
            return [(0, 0), (0, 0)]
        return same_pads(xc.shape[2:], self.pool_size, self.strides)

    def build(self, input_shape, rng):
        return _out_sizes(input_shape[:2], self.pool_size, self.strides,
                          self.padding) + (input_shape[-1],)

    def apply(self, p, x):
        return self._reduce(x.movedim(-1, 1)).movedim(1, -1)

    def get_config(self):
        return {"pool_size": list(self.pool_size),
                "strides": list(self.strides), "padding": self.padding}


@register_layer
class MaxPooling2D(_Pool2D):
    """Window maximum; ``"SAME"`` pads with ``-inf`` (JAX :451)."""

    def _reduce(self, xc):
        xc = _pad_spatial(xc, self._pads(xc), float("-inf"))
        return F.max_pool2d(xc, self.pool_size, self.strides)


@register_layer
class AveragePooling2D(_Pool2D):
    """Window mean over the REAL elements of each window: the window sum
    divided by the count of unpadded elements it covers (JAX :459
    reduces a window of ones)."""

    def _reduce(self, xc):
        pads = self._pads(xc)
        summed = F.avg_pool2d(_pad_spatial(xc, pads, 0.0), self.pool_size,
                              self.strides, divisor_override=1)
        ones = xc.new_ones((1, 1) + tuple(xc.shape[2:]))
        count = F.avg_pool2d(_pad_spatial(ones, pads, 0.0), self.pool_size,
                             self.strides, divisor_override=1)
        return summed / count


@register_layer
class GlobalAveragePooling2D(Layer):
    """Mean over H and W of ``[B, H, W, C]`` (JAX :471)."""

    def build(self, input_shape, rng):
        return (input_shape[-1],)

    def apply(self, p, x):
        return x.mean(dim=(1, 2))


@register_layer
class GlobalAveragePooling1D(Layer):
    """Mean over the sequence axis of ``[B, S, D]`` (JAX :480)."""

    def build(self, input_shape, rng):
        return (input_shape[-1],)

    def apply(self, p, x):
        return x.mean(dim=1)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

@register_layer
class BatchNorm(Layer):
    """Batch normalization over the last axis (JAX :495): params
    ``scale``/``offset``, state ``mean``/``var`` (float32 buffers).

    Training (``self.training``): normalize by the batch's float32
    moments, ``var = E[x^2] - E[x]^2`` (biased), through
    ``ops.normalization.bn_train_apply`` (JAX's two-reduction backward),
    and write ``m * running + (1 - m) * batch`` into the state tensors
    given (in place, no gradient). ``virtual_batch_size`` (ghost BN):
    each group of that many rows normalizes by its own moments (plain
    autograd, as JAX's :534-549), and the running statistics move by the
    groups' mean. Eval: normalize by the running statistics. This is not
    ``F.batch_norm``: torch's running variance is unbiased and its
    momentum is ``1 - m``. ``axis_name`` (cross-replica moments) raises.
    """

    has_state = True

    def __init__(self, momentum: float = 0.99, epsilon: float = 1e-3,
                 axis_name: Optional[str] = None,
                 virtual_batch_size: Optional[int] = None):
        super().__init__()
        if axis_name is not None:
            raise NotImplementedError(
                f"BatchNorm(axis_name=) is not ported yet: {SYNC_BN_ITEM}")
        self.momentum = float(momentum)
        self.epsilon = float(epsilon)
        self.virtual_batch_size = (None if virtual_batch_size is None
                                   else int(virtual_batch_size))

    def build(self, input_shape, rng):
        dim, dev = input_shape[-1], rng.device
        self.add_param("scale", torch.ones(dim, device=dev))
        self.add_param("offset", torch.zeros(dim, device=dev))
        self.add_state("mean", torch.zeros(dim, device=dev))
        self.add_state("var", torch.ones(dim, device=dev))
        return tuple(input_shape)

    @torch.no_grad()
    def _update(self, s, mean, var) -> None:
        m = self.momentum
        s["mean"].copy_(m * s["mean"] + (1 - m) * mean)
        s["var"].copy_(m * s["var"] + (1 - m) * var)

    def apply(self, p, x, state=None):
        s = self.state_tree() if state is None else state
        xf = x.float()  # the statistics in float32 for bf16 activations
        eps = self.epsilon
        if self.training and self.virtual_batch_size is not None:
            v = self.virtual_batch_size
            if x.shape[0] % v:
                raise ValueError(f"batch size {x.shape[0]} not divisible "
                                 f"by virtual_batch_size {v}")
            g = x.shape[0] // v
            xg = xf.reshape((g, v) + tuple(x.shape[1:]))
            gaxes = tuple(range(1, xg.dim() - 1))
            mean_g = xg.mean(dim=gaxes)                        # [g, C]
            var_g = xg.square().mean(dim=gaxes) - mean_g.square()
            sh = (g,) + (1,) * (xg.dim() - 2) + (-1,)
            inv = torch.rsqrt(var_g.reshape(sh) + eps) * p["scale"]
            y = (xg - mean_g.reshape(sh)) * inv + p["offset"]
            self._update(s, mean_g.detach().mean(0), var_g.detach().mean(0))
            return y.reshape(x.shape).to(x.dtype)
        if self.training:
            axes = tuple(range(x.dim() - 1))
            with torch.no_grad():
                mean = xf.mean(dim=axes)
                var = xf.square().mean(dim=axes) - mean.square()
            self._update(s, mean, var)
            return bn_train_apply(x, p["scale"], p["offset"], mean, var,
                                  eps, axes)
        inv = torch.rsqrt(s["var"] + eps) * p["scale"]
        return ((xf - s["mean"]) * inv + p["offset"]).to(x.dtype)

    def get_config(self):
        return {"momentum": self.momentum, "epsilon": self.epsilon,
                "axis_name": None,
                "virtual_batch_size": self.virtual_batch_size}


@register_layer
class GroupNorm(Layer):
    """Group normalization over the channel axis (JAX :584): float32
    moments per (sample, group) over the spatial positions and the
    group's channels; no state, the same in training and eval."""

    def __init__(self, groups: int = 32, epsilon: float = 1e-5):
        super().__init__()
        self.groups = int(groups)
        self.epsilon = float(epsilon)

    def build(self, input_shape, rng):
        dim = input_shape[-1]
        if dim % self.groups:
            raise ValueError(
                f"channels {dim} not divisible by groups {self.groups}")
        self.add_param("scale", torch.ones(dim, device=rng.device))
        self.add_param("offset", torch.zeros(dim, device=rng.device))
        return tuple(input_shape)

    def apply(self, p, x):
        g = self.groups
        xf = x.float()
        xg = xf.reshape(tuple(x.shape[:-1]) + (g, x.shape[-1] // g))
        axes = tuple(range(1, x.dim() - 1)) + (x.dim(),)
        mean = xg.mean(dim=axes, keepdim=True)
        var = (xg - mean).square().mean(dim=axes, keepdim=True)
        y = ((xg - mean) * torch.rsqrt(var + self.epsilon)).reshape(x.shape)
        return (y * p["scale"] + p["offset"]).to(x.dtype)

    def get_config(self):
        return {"groups": self.groups, "epsilon": self.epsilon}
