"""Container layers of the port (mirrors ``distkeras_tpu/models/
blocks.py``): ``Residual`` (:23), the ResNet block skeleton,
``WideAndDeep`` (:94), the BASELINE config 4 model as one layer, and
``Remat`` (:147-210), the rematerialization wrapper.

Each is registered under its JAX name with JAX's ``get_config``; the
inner layers travel as layer specs (``Remat(inner_spec=)``,
``Residual(main_spec=, shortcut_spec=)``) and are rebuilt from them.

``Residual`` and ``WideAndDeep`` lay out their parameter and state trees
as JAX's (``{"main", "shortcut"}``, ``{"wide", "deep"}``; an identity
shortcut holds ``{}``) and split their key as JAX's ``init`` does, so a
seed gives JAX's weights.

``Remat(inner, policy=)`` recomputes ``inner``'s activations during the
backward pass instead of keeping them, through
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: peak
activation memory drops from one block's worth per wrapped block to
about one, at the cost of a second forward. Its parameter tree is the
inner layer's own (no ``inner`` key), as JAX's ``Remat.init`` returns the
inner params, so ``from_jax_params`` and ``to_jax_params`` carry a remat
model unchanged. ``segment_ids`` pass through to an inner layer that
accepts them. The recompute runs in the mode of the original forward
(the trainer restores eval mode before the backward) and leaves no
auxiliary loss behind (an MoE's balance term was collected from the
original forward). A stateful inner layer (BatchNorm) writes its
running statistics in the original forward only: the recompute gets
copies of the state tensors, so a ``Remat`` step leaves the state
bitwise equal to the bare step's (in training mode the forward does not
read the running statistics, so the copies change no output).

Policies (JAX ``jax.checkpoint_policies``): ``None`` or ``"nothing"``
saves nothing; ``"dots"`` saves every matmul output (``mm``, ``bmm``,
``addmm``, ``baddbmm``) and ``"dots_no_batch"`` only ``mm``/``addmm``,
through ``torch.utils.checkpoint.create_selective_checkpoint_contexts``.
A CUDA kernel launched through ctypes writes into tensors the dispatch
level cannot see, so under every policy the flash attention forward
runs again in the recompute (a 12-layer model launches ``flash_fwd`` 24
times a step, not 12). The recompute reruns the same operations on the
same values, so a wrapped block's loss and gradients equal the bare
block's bitwise.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from distkeras_tpu_torch.models.core import (Layer, Sequential,
                                             layer_from_spec, layer_spec,
                                             register_layer)
from distkeras_tpu_torch.models.layers import Dense, get_activation
from distkeras_tpu_torch.ops import prng
from distkeras_tpu_torch.utils.tree import tree_map

_aten = torch.ops.aten
#: the operations each selective policy saves (JAX ``checkpoint_dots``
#: and ``dots_with_no_batch_dims_saveable``)
_SAVED_OPS = {
    "dots": [_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
             _aten.baddbmm.default],
    "dots_no_batch": [_aten.mm.default, _aten.addmm.default],
}


@register_layer
class Remat(Layer):
    """Recompute ``inner`` in the backward pass (``jax.checkpoint``)."""

    POLICIES = ("nothing", "dots", "dots_no_batch")

    def __init__(self, inner: Layer = None, inner_spec=None,
                 policy: Optional[str] = None):
        super().__init__()
        if inner is None:
            inner = layer_from_spec(inner_spec)
        if inner is None:
            raise ValueError("Remat needs an inner layer")
        if policy is not None and policy not in self.POLICIES:
            raise ValueError(f"unknown remat policy {policy!r}; "
                             f"known: {self.POLICIES}")
        self.inner = inner
        self.policy = policy

    @property
    def accepts_segment_ids(self) -> bool:
        return self.inner.accepts_segment_ids

    @property
    def uses_rng(self) -> bool:
        return self.inner.uses_rng

    def build(self, input_shape, rng):
        return self.inner.build(input_shape, rng)

    def param_tree(self):
        return self.inner.param_tree()

    def state_tree(self):
        return self.inner.state_tree()

    def _context_fn(self):
        ops = _SAVED_OPS.get(self.policy)
        if ops is None:
            return None
        return functools.partial(create_selective_checkpoint_contexts, ops)

    def apply(self, p, x, segment_ids=None, rng=None, state=None):
        kw = {}
        if segment_ids is not None and self.accepts_segment_ids:
            kw["segment_ids"] = segment_ids
        if rng is not None and self.uses_rng:
            kw["rng"] = rng       # the recompute draws the same masks
        if self.has_state:
            kw["state"] = state
        if not torch.is_grad_enabled():      # nothing to save
            return self.inner.apply(p, x, **kw)
        training, calls = self.training, []

        def f(p, x, kw):
            if not calls:                    # the original forward
                calls.append(True)
                return self.inner.apply(p, x, **kw)
            if "state" in kw:                # written once, not twice
                own = kw["state"]
                kw = dict(kw, state=tree_map(
                    torch.clone, self.inner.state_tree() if own is None
                    else own))
            layers = [m for m in self.inner.modules() if isinstance(m, Layer)]
            aux = [m._aux_loss for m in layers]
            modes = [m.training for m in layers]
            self.inner.train(training)
            try:
                return self.inner.apply(p, x, **kw)
            finally:
                for m, a, t in zip(layers, aux, modes):
                    m._aux_loss, m.training = a, t

        ckpt_kw = {}
        context_fn = self._context_fn()
        if context_fn is not None:
            ckpt_kw["context_fn"] = context_fn
        return checkpoint(f, p, x, kw, use_reentrant=False, **ckpt_kw)

    def get_config(self):
        return {"inner_spec": layer_spec(self.inner), "policy": self.policy}


@register_layer
class Residual(Layer):
    """``y = act(main(x) + shortcut(x))``, the ResNet block skeleton
    (JAX :23). ``shortcut=None`` is the identity (the shapes must
    match). The key splits in two for ``init`` (main, shortcut) and in
    three for a training ``apply`` that draws, as JAX's."""

    def __init__(self, main: Layer = None, shortcut: Optional[Layer] = None,
                 activation: Optional[str] = "relu", main_spec=None,
                 shortcut_spec=None):
        super().__init__()
        main = main if main is not None else layer_from_spec(main_spec)
        if shortcut is None:
            shortcut = layer_from_spec(shortcut_spec)
        if main is None:
            raise ValueError("Residual needs a main branch")
        get_activation(activation)
        self.main = main
        self.shortcut = shortcut
        self.activation = activation

    def _branches(self):
        return [l for l in (self.main, self.shortcut) if l is not None]

    @property
    def accepts_segment_ids(self) -> bool:
        return any(l.accepts_segment_ids for l in self._branches())

    @property
    def uses_rng(self) -> bool:
        return any(l.uses_rng for l in self._branches())

    def build(self, input_shape, rng):
        k1, k2 = prng.split(rng)
        out_main = self.main.build(input_shape, k1)
        out_short = (self.shortcut.build(input_shape, k2)
                     if self.shortcut is not None else tuple(input_shape))
        if tuple(out_main) != tuple(out_short):
            raise ValueError(
                f"Residual branch shapes differ: main {tuple(out_main)} vs "
                f"shortcut {tuple(out_short)}")
        return tuple(out_main)

    def param_tree(self):
        return {"main": self.main.param_tree(),
                "shortcut": ({} if self.shortcut is None
                             else self.shortcut.param_tree())}

    def state_tree(self):
        return {"main": self.main.state_tree(),
                "shortcut": ({} if self.shortcut is None
                             else self.shortcut.state_tree())}

    def apply(self, p, x, segment_ids=None, rng=None, state=None):
        keys = [None, None]
        if rng is not None and self.uses_rng:
            r = prng.split(rng, 3)
            keys = [r[1], r[2]]

        def branch(layer, name, key):
            kw = {}
            if segment_ids is not None and layer.accepts_segment_ids:
                kw["segment_ids"] = segment_ids
            if key is not None and layer.uses_rng:
                kw["rng"] = key
            if layer.has_state:
                kw["state"] = None if state is None else state[name]
            return layer.apply(p[name], x, **kw)

        y = branch(self.main, "main", keys[0])
        sc = (x if self.shortcut is None
              else branch(self.shortcut, "shortcut", keys[1]))
        return get_activation(self.activation)(y + sc)

    def get_config(self):
        return {"main_spec": layer_spec(self.main),
                "shortcut_spec": layer_spec(self.shortcut),
                "activation": self.activation}


@register_layer
class WideAndDeep(Layer):
    """Wide & Deep (Cheng et al. 2016) as one layer (JAX :94): the input
    row is ``[wide (wide_dim) | deep (rest)]`` and the logits are
    ``Dense(wide) + MLP(deep)``."""

    def __init__(self, wide_dim: int, deep_hidden=(256, 128),
                 num_classes: int = 2, activation: str = "relu",
                 dtype: str = "float32"):
        super().__init__()
        self.wide_dim = int(wide_dim)
        self.deep_hidden = tuple(int(h) for h in deep_hidden)
        self.num_classes = int(num_classes)
        self.activation = activation
        self.dtype = dtype
        self.wide = Dense(self.num_classes, use_bias=True, dtype=dtype)
        self.deep = Sequential(
            [Dense(h, activation=activation, dtype=dtype)
             for h in self.deep_hidden] + [Dense(self.num_classes,
                                                 dtype=dtype)])

    @property
    def uses_rng(self) -> bool:
        return self.deep.uses_rng

    def build(self, input_shape, rng):
        total = input_shape[-1]
        if total <= self.wide_dim:
            raise ValueError(
                f"input dim {total} must exceed wide_dim {self.wide_dim}")
        k1, k2 = prng.split(rng)
        self.wide.build((self.wide_dim,), k1)
        self.deep.build((total - self.wide_dim,), k2)
        return (self.num_classes,)

    def param_tree(self):
        return {"wide": self.wide.param_tree(),
                "deep": self.deep.param_tree()}

    def state_tree(self):
        return {"wide": self.wide.state_tree(),
                "deep": self.deep.state_tree()}

    def apply(self, p, x, rng=None):
        xw, xd = x[..., :self.wide_dim], x[..., self.wide_dim:]
        kw = {"rng": rng} if rng is not None and self.uses_rng else {}
        return (self.wide.apply(p["wide"], xw)
                + self.deep.apply(p["deep"], xd, **kw))

    def get_config(self):
        return {"wide_dim": self.wide_dim,
                "deep_hidden": list(self.deep_hidden),
                "num_classes": self.num_classes,
                "activation": self.activation, "dtype": self.dtype}
