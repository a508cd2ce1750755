"""Model files in the JAX package's format: architecture JSON plus the
weight arrays (mirrors ``distkeras_tpu/models/serialization.py``, the
port of dist-keras's ``serialize_keras_model`` /
``deserialize_keras_model``, which ship a model to the Spark executors
as architecture JSON and a weight list).

A payload is ``{"format", "class", "config", "input_shape", "params",
"state"}`` with ``FORMAT_VERSION = "distkeras_tpu.model.v1"``; the
weights are flat ``{leaf_key: numpy array}`` maps, a leaf's key its
path through the JAX tree (``0/kernel``, ``3/main/0/kernel``; list
indices and dict keys joined by ``/``). ``save_model`` writes
``<path>.json`` (format, class, config, input shape and, for a quantized
file, ``"quantized": true``) and ``<path>.npz`` (``params:<key>``,
``state:<key>`` and, for a quantized file, the float32 per-channel
scales ``scale:params:<key>`` beside the int8 codes). The JAX package
reads what the port writes and the port reads what the JAX package
writes, the legacy ``<key>:scale`` entries of old quantized files
included (JAX :147-163).

Loading rebuilds the module from the registry (``models.core.
layer_from_spec``), sizes it on the ``meta`` device (what JAX's
``jax.eval_shape`` does in ``_abstract_template``, :72: nothing is
drawn only to be overwritten), then allocates it on the caller's device
(default: the CUDA card) and copies every leaf in; a leaf whose shape
differs raises (JAX :52-55), a missing one raises ``KeyError``, and
entries that no leaf of the model names are ignored, as in JAX (a JAX
MoE layer's training-only balance-loss scalar, ``__aux_loss__``, is one:
the port publishes that term instead of keeping it as state). A port
file carries that scalar (zero) for every MoE layer with a balance-loss
weight, so the JAX package finds the state leaf it expects.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from distkeras_tpu_torch.compat import resolve_device
from distkeras_tpu_torch.models.bridge import AUX_LOSS_KEY
from distkeras_tpu_torch.models.core import LAYER_REGISTRY, Model
from distkeras_tpu_torch.models.quantize import (QuantizedModel,
                                                 _dequantize_leaf,
                                                 _is_quantizable,
                                                 _quantize_leaf)

FORMAT_VERSION = "distkeras_tpu.model.v1"


def leaf_key(path) -> str:
    """The flat key of a leaf at ``path`` (dict keys and list indices,
    outermost first): JAX's ``leaf_key`` formula, ``a/b/0/c``."""
    return "/".join(str(p) for p in path)


def _walk(tree, path=()) -> Iterator[Tuple[tuple, Any]]:
    """``(path, leaf)`` pairs of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    elif tree is not None:
        yield path, tree


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {leaf_key(path): _host(leaf) for path, leaf in _walk(tree)}


def _aux_loss_leaves(model: Model) -> Dict[str, np.ndarray]:
    """The zero ``__aux_loss__`` state leaf the JAX tree holds for each
    MoE layer with a balance-loss weight, keyed beside that layer's
    parameters (found by the identity of its ``gate``)."""
    from distkeras_tpu_torch.models.moe import MoE
    where = {id(leaf): path for path, leaf in _walk(model.params)}
    out = {}
    for m in model.module.modules():
        if isinstance(m, MoE) and m.aux_loss_weight:
            prefix = where[id(m.gate)][:-1]
            out[leaf_key(prefix + (AUX_LOSS_KEY,))] = np.zeros(
                (), np.float32)
    return out


def serialize_model(model: Model) -> Dict[str, Any]:
    """Model -> plain dict (the architecture config and numpy weights),
    JAX's ``serialize_model``."""
    state = _flatten(model.state)
    state.update(_aux_loss_leaves(model))
    return {
        "format": FORMAT_VERSION,
        "class": model.module.name,
        "config": model.module.get_config(),
        "input_shape": list(model.input_shape),
        "params": _flatten(model.params),
        "state": state,
    }


def _abstract_template(payload: Dict[str, Any], device) -> Model:
    """The model of an architecture dict, sized on the ``meta`` device
    and then allocated, uninitialized, on ``device``."""
    if payload.get("format") != FORMAT_VERSION:
        raise ValueError(f"Unknown model format: {payload.get('format')!r}")
    module = LAYER_REGISTRY[payload["class"]].from_config(payload["config"])
    model = Model.build(module, tuple(payload["input_shape"]),
                        device="meta")
    model.module.to_empty(device=device)
    model.device = device
    return model


@torch.no_grad()
def _load_tree(tree, flat: Dict[str, np.ndarray]) -> None:
    """Copy ``flat[leaf_key]`` into every leaf of ``tree``."""
    for path, leaf in _walk(tree):
        key = leaf_key(path)
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"weight {key!r} shape {arr.shape} != expected "
                             f"{tuple(leaf.shape)}")
        leaf.copy_(torch.from_numpy(np.array(arr, copy=True)).to(leaf.dtype))


def deserialize_model(payload: Dict[str, Any], device=None) -> Model:
    """Plain dict -> Model on ``device`` (default: the CUDA card): the
    module from the registry, the weights and state from the payload."""
    model = _abstract_template(payload, resolve_device(device))
    _load_tree(model.params, payload["params"])
    _load_tree(model.state, payload["state"])
    return model


def save_model(model: Model, path: str, quantize: bool = False) -> None:
    """Write ``<path>.json`` and ``<path>.npz``. ``quantize=True`` stores
    the matrix weights (``models.quantize.QUANTIZABLE_NAMES``) as int8
    codes and float32 per-channel scales (``scale:params:<key>``), the
    codes and scales bitwise the JAX package's for the same weights."""
    payload = serialize_model(model)
    arch = {k: payload[k] for k in ("format", "class", "config",
                                    "input_shape")}
    if quantize:
        arch["quantized"] = True
        arrays = {}
        for keys, leaf in _walk(model.params):
            k = "params:" + leaf_key(keys)
            if _is_quantizable(leaf, str(keys[-1])):
                d = _quantize_leaf(leaf)
                arrays[k] = _host(d["q"])
                arrays["scale:" + k] = _host(d["scale"])
            else:
                arrays[k] = _host(leaf)
    else:
        arrays = {f"params:{k}": v for k, v in payload["params"].items()}
    with open(path + ".json", "w") as f:
        json.dump(arch, f, indent=2)
    arrays.update({f"state:{k}": v for k, v in payload["state"].items()})
    np.savez(path + ".npz", **arrays)


def load_model(path: str, keep_quantized: bool = False, device=None):
    """A ``Model`` on ``device`` (default: the CUDA card; float32
    weights), or, for a quantized file with ``keep_quantized=True``, a
    ``models.quantize.QuantizedModel`` built from the stored int8 codes
    and float32 scales verbatim."""
    dev = resolve_device(device)
    with open(path + ".json") as f:
        arch = json.load(f)
    with np.load(path + ".npz") as npz:
        arrays = {k: npz[k] for k in npz.files}
    state = {k[len("state:"):]: v for k, v in arrays.items()
             if k.startswith("state:")}
    if not arch.pop("quantized", False):
        if keep_quantized:
            raise ValueError(
                f"{path} was not saved with quantize=True; load it normally "
                "and call models.quantize.quantize_model()")
        params = {k[len("params:"):]: v for k, v in arrays.items()
                  if k.startswith("params:")}
        return deserialize_model({**arch, "params": params, "state": state},
                                 dev)

    def scale_key(k):
        """The scale entry of param entry ``k``: ``scale:<k>``, or the
        legacy ``<k>:scale``; None for a float leaf."""
        if "scale:" + k in arrays:
            return "scale:" + k
        legacy = k + ":scale"
        return legacy if legacy in arrays else None

    def is_scale_entry(k):
        return k.startswith("scale:") or (
            k.endswith(":scale") and k[:-len(":scale")] in arrays)

    if not keep_quantized:
        params = {}
        for k, v in arrays.items():
            if not k.startswith("params:") or is_scale_entry(k):
                continue
            sk = scale_key(k)
            params[k[len("params:"):]] = (
                v if sk is None else _dequantize_leaf(
                    torch.from_numpy(v), torch.from_numpy(arrays[sk]))
                .numpy())
        return deserialize_model({**arch, "params": params, "state": state},
                                 dev)
    model = _abstract_template(arch, dev)
    _load_tree(model.state, state)

    def leaf(path, t):
        key = "params:" + leaf_key(path)
        arr = arrays[key]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"weight {key!r} shape {arr.shape} != expected "
                             f"{tuple(t.shape)}")
        sk = scale_key(key)
        if sk is None:
            return torch.from_numpy(arr).to(dev, t.dtype), None
        return (torch.from_numpy(arr).to(dev),               # int8 verbatim
                torch.from_numpy(arrays[sk]).to(dev))

    qparams, scales = _unzip(model.params, leaf)
    return QuantizedModel(model.module, qparams, scales, model.input_shape,
                          model.output_shape, dev)


def _unzip(tree, fn, path=()):
    """Two trees shaped like ``tree`` from ``fn(path, leaf) -> (a, b)``."""
    if isinstance(tree, dict):
        pairs = {k: _unzip(v, fn, path + (k,)) for k, v in tree.items()}
        return ({k: a for k, (a, _) in pairs.items()},
                {k: b for k, (_, b) in pairs.items()})
    if isinstance(tree, (list, tuple)):
        pairs = [_unzip(v, fn, path + (i,)) for i, v in enumerate(tree)]
        return [a for a, _ in pairs], [b for _, b in pairs]
    return fn(path, tree)
