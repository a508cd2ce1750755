"""Weight-only int8 / int4 quantization for inference: the format of
``generate(weights_dtype="int8"/"int4")`` and ``QuantizedModel``.

Mirrors ``distkeras_tpu/models/quantize.py``: ``_quantize_leaf`` :39,
``QUANTIZABLE_NAMES`` / ``_is_quantizable`` :65/:69, ``quantize_params``
/ ``dequantize_params`` :75/:95, ``QuantizedModel`` :109,
``quantize_model`` / ``dequantize_model`` :147/:154. Symmetric
per-output-channel quantization with the scale over the LAST axis;
``bits=4`` uses the [-7, 7] grid and still stores one int8 byte per
entry (the serving engine's ``ops.quant_matmul`` format is the one that
packs nibbles). Small leaves (biases, norm scales) stay float32.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Tuple

import numpy as np
import torch

from distkeras_tpu_torch.models.core import Model
from distkeras_tpu_torch.utils.tree import tree_leaves, tree_map

#: the leaves that take int8: the matmul kernels and the embedding
#: tables; everything else stays float32
QUANTIZABLE_NAMES = frozenset(
    {"kernel", "embeddings", "w1", "w2", "wq", "wk", "wv", "wo"})


def _quantize_leaf(w, bits: int = 8) -> Dict[str, torch.Tensor]:
    """Symmetric per-last-axis-channel quantization, ``w ~ q * scale``,
    in float32 on the leaf's device (bitwise the JAX package's)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    w = torch.as_tensor(w).detach().float()
    qmax = 7.0 if bits == 4 else 127.0
    absmax = w.abs().amax(dim=tuple(range(w.ndim - 1)), keepdim=True)
    scale = absmax / qmax
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / scale), -qmax, qmax).to(torch.int8)
    return {"q": q, "scale": scale.reshape(-1)}


def _dequantize_leaf(q, scale, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def _is_quantizable(leaf, name: str) -> bool:
    return (name in QUANTIZABLE_NAMES and torch.is_tensor(leaf)
            and leaf.ndim >= 2 and leaf.is_floating_point())


def _named_map(fn, tree, name=""):
    """``fn(leaf, name)`` over a parameter tree, ``name`` the dict key a
    leaf sits under (a list entry inherits its parent's)."""
    if isinstance(tree, dict):
        return {k: _named_map(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_named_map(fn, v, name) for v in tree]
    return fn(tree, name)


def quantize_params(params, bits: int = 8) -> Tuple[Any, Any]:
    """Parameter tree -> (same-structure tree of int8 ``q`` /
    passthrough leaves, matching tree of float32 ``scale`` / None
    leaves)."""
    def quant(leaf, name):
        if _is_quantizable(leaf, name):
            d = _quantize_leaf(leaf, bits)
            return (d["q"], d["scale"])
        return (leaf.detach() if torch.is_tensor(leaf) else leaf, None)

    with torch.no_grad():
        pairs = _named_map(quant, params)
    return _pick(pairs, 0), _pick(pairs, 1)


def _pick(tree, i: int):
    """Entry ``i`` of every ``(q, scale)`` pair of a tree."""
    if isinstance(tree, tuple):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return [_pick(v, i) for v in tree]


def dequantize_params(qtree, scales):
    """Inverse of :func:`quantize_params` (float32 leaves)."""
    return tree_map(lambda q, s: q if s is None else _dequantize_leaf(q, s),
                    qtree, scales)


def quantize_params_qdicts(params, bits: int = 8):
    """:func:`quantize_params` as one tree of ``ops.quant_matmul`` qdicts
    (``{"q", "scale"}``, one byte per entry even for int4), the tree
    ``generate(weights_dtype="int8"/"int4")`` runs. wq/wk/wv's ``[e]``
    scale is broadcast to ``[h, e]`` so that it flattens to the ``h*e``
    output channels of the projection (the same values)."""
    qtree, scales = quantize_params(params, bits)

    def join(q, s, name=""):
        if isinstance(q, dict):
            return {k: join(q[k], s[k], k) for k in q}
        if isinstance(q, list):
            return [join(a, b, name) for a, b in zip(q, s)]
        if s is None:
            return q
        if name in ("wq", "wk", "wv"):
            s = s.expand(q.shape[1:]).contiguous()
        return {"q": q, "scale": s}

    return join(qtree, scales)


class QuantizedModel:
    """Inference handle over int8 weights: ``predict`` runs the forward
    pass on the weights dequantized for that call (the int8 bytes are
    what the handle keeps)."""

    def __init__(self, module, qparams, scales, input_shape, output_shape,
                 device):
        self.module = module
        self.qparams = qparams
        self.scales = scales
        self.input_shape = tuple(input_shape)
        self.output_shape = tuple(output_shape)
        self.device = device

    @torch.no_grad()
    def predict(self, x) -> np.ndarray:
        params = dequantize_params(self.qparams, self.scales)
        y = self.module.apply(params,
                              torch.as_tensor(np.asarray(x)).to(self.device))
        if y.is_floating_point():
            y = y.float()
        return y.cpu().numpy()

    def num_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in tree_leaves(self.qparams)) + \
            sum(t.numel() * t.element_size()
                for t in tree_leaves(self.scales) if t is not None)


def quantize_model(model: Model) -> QuantizedModel:
    """Post-training weight-only int8 quantization of a Model."""
    qparams, scales = quantize_params(model.params)
    return QuantizedModel(model.module, qparams, scales, model.input_shape,
                          model.output_shape, model.device)


def dequantize_model(qmodel: QuantizedModel) -> Model:
    """Back to a full-precision Model (float32 weights, a copy of the
    module)."""
    module = copy.deepcopy(qmodel.module)
    with torch.no_grad():
        params = dequantize_params(qmodel.qparams, qmodel.scales)
        for dst, src in zip(tree_leaves(module.param_tree()),
                            tree_leaves(params)):
            dst.copy_(src)
    return Model(module, qmodel.input_shape, qmodel.output_shape,
                 qmodel.device)
