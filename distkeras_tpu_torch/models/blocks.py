"""Container layers of the port: ``Remat``, the rematerialization
wrapper (mirrors ``distkeras_tpu/models/blocks.py`` ``Remat`` :147-210).

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
original forward).

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

from distkeras_tpu_torch.models.core import Layer

_aten = torch.ops.aten
#: the operations each selective policy saves (JAX ``checkpoint_dots``
#: and ``dots_with_no_batch_dims_saveable``)
_SAVED_OPS = {
    "dots": [_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
             _aten.baddbmm.default],
    "dots_no_batch": [_aten.mm.default, _aten.addmm.default],
}


class Remat(Layer):
    """Recompute ``inner`` in the backward pass (``jax.checkpoint``)."""

    POLICIES = ("nothing", "dots", "dots_no_batch")

    def __init__(self, inner: Layer = None, inner_spec=None,
                 policy: Optional[str] = None):
        super().__init__()
        if inner_spec is not None:
            raise NotImplementedError(
                "Remat(inner_spec=): layer specs (model serialization) are "
                "not ported yet: ROADMAP, Queue 1 item 9")
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

    def _context_fn(self):
        ops = _SAVED_OPS.get(self.policy)
        if ops is None:
            return None
        return functools.partial(create_selective_checkpoint_contexts, ops)

    def apply(self, p, x, segment_ids=None, rng=None):
        kw = {}
        if segment_ids is not None and self.accepts_segment_ids:
            kw["segment_ids"] = segment_ids
        if rng is not None and self.uses_rng:
            kw["rng"] = rng       # the recompute draws the same masks
        if not torch.is_grad_enabled():      # nothing to save
            return self.inner.apply(p, x, **kw)
        training, calls = self.training, []

        def f(p, x, kw):
            if not calls:                    # the original forward
                calls.append(True)
                return self.inner.apply(p, x, **kw)
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
