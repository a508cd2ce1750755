"""Weight bridge between the JAX package's ``Model.params`` /
``Model.state`` trees (numpy arrays) and the port's modules, both ways:
``from_jax_params`` loads a JAX tree into a port model,
``qtree_from_jax`` carries a JAX tree with quantized leaves across as
tensors (int8 ``q``/``q4`` bytes and float32 scales as they are),
``to_jax_params`` exports a port model's weights in the JAX tree layout
(so a model trained here can be loaded into the JAX package, and the
tests compare trained weights leaf by leaf).

The port keeps the JAX parameter names and layouts, so the bridge is a
copy: every key of the port's ``param_tree()`` must be present with the
same shape, and nothing else may be. The LM layers carry no state; a
state tree with any array in it is refused rather than dropped, except
a JAX MoE layer's training-only balance-loss scalar (``AUX_LOSS_KEY``).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from distkeras_tpu_torch.compat import resolve_device
from distkeras_tpu_torch.models.core import Model
from distkeras_tpu_torch.utils.tree import tree_map

#: the JAX package's state key of the MoE balance loss
#: (``distkeras_tpu/models/core.py`` ``AUX_LOSS_KEY``)
AUX_LOSS_KEY = "__aux_loss__"


def _flatten(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _flatten(sub, f"{prefix}/{key}")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _flatten(sub, f"{prefix}[{i}]")
    elif tree is not None:
        yield prefix, tree


@torch.no_grad()
def from_jax_params(model: Model, params, state=None) -> Model:
    """Copy ``params`` (one dict per layer, numpy leaves) into ``model``;
    returns the model. Raises on a missing, extra or mis-shaped key."""
    ours: Dict[str, torch.Tensor] = dict(_flatten(model.params))
    theirs = {k: np.asarray(v) for k, v in _flatten(params)}
    missing = sorted(set(ours) - set(theirs))
    extra = sorted(set(theirs) - set(ours))
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing {missing}, "
                         f"unexpected {extra} (a quantized tree crosses "
                         "with qtree_from_jax)")
    for key, dst in ours.items():
        src = theirs[key]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{key}: shape {tuple(src.shape)} does not "
                             f"match the port's {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(np.array(src, copy=True)).to(dst.dtype))
    if state is not None:
        # a JAX MoE layer built with a balance-loss weight carries its
        # training-only aux-loss scalar in the state: nothing to load
        leaves = [k for k, _ in _flatten(state)
                  if not k.endswith("/" + AUX_LOSS_KEY)]
        if leaves:
            raise ValueError(f"the port's layers carry no state, got "
                             f"{leaves}")
    return model


def qtree_from_jax(tree, device=None):
    """A JAX parameter tree that may hold quantized leaves (the
    ``ops.quant_matmul`` qdicts ``{"q" | "q4", "scale"}``, or float
    arrays) as the port's tree of tensors on ``device`` (default: the
    CUDA card, as every entry point; ``device="cpu"`` for the CPU): the
    same bytes and scales, so both packages can be fed one quantized tree
    (a port engine's ``_params``, ``quant_matmul``, a decode step)."""
    dev = resolve_device(device)

    def leaf(tree):
        if isinstance(tree, dict):
            return {k: leaf(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [leaf(v) for v in tree]
        if tree is None:
            return None
        return torch.from_numpy(np.array(tree, copy=True)).to(dev)

    return leaf(tree)


def to_jax_params(model: Model):
    """The model's parameters as the JAX package's tree: one dict per
    layer of the ``Sequential``, float32 numpy leaves under the JAX
    names and layouts (the inverse of ``from_jax_params``)."""
    return tree_map(
        lambda x: x.detach().to("cpu", torch.float32).numpy().copy(),
        model.params)
