"""Core model substrate of the port: the ``Layer`` base (an
``nn.Module``), the ``Sequential`` container and the ``Model`` handle.

Mirrors ``distkeras_tpu/models/core.py`` (``Layer`` :83, ``Sequential``
:124, ``Model`` :196). A layer creates its parameters in
``build(input_shape, rng)`` once its input width is known, under the
JAX package's names and layouts and from its threefry key ``rng``
(``ops.prng``: a container splits it as JAX's ``init`` does), so the
same key gives JAX's weights and ``param_tree()`` has the same
structure as the JAX ``Model.params`` (one dict per layer of a
``Sequential``) and the weight bridge is a copy. ``apply(p, x)`` is the
layer's function of an explicit parameter tree, which lets the serving
path run a pre-cast copy of the weights; ``forward(x)`` applies the
layer's own parameters. Parameters are float32 master weights that
require grad; each layer casts them to its compute dtype inside
``apply``, so autograd returns float32 gradients on the float32 leaves
(what JAX's ``value_and_grad`` returns). A layer may publish an
auxiliary training loss during a training-mode forward
(``publish_aux_loss``, e.g. the MoE balance loss); ``collect_aux_losses``
sums and clears them: the counterpart of JAX's ``AUX_LOSS_KEY`` state
entry and ``collect_aux_losses`` (:33-50). Model state (JAX :83-195,
BatchNorm's running statistics): a stateful layer registers it as
float32 buffers under JAX's names (``add_state``); ``state_tree()``
mirrors ``param_tree()`` with the structure of the JAX ``Model.state``
(one dict per layer of a ``Sequential``, ``{}`` for a stateless one).
``apply`` takes the state subtree as ``state=`` (default: the layer's own
buffers), and a training-mode forward writes the new statistics into the
tensors it was given, in place, under ``no_grad``: so a trainer's carry,
or a stacked worker's view of its ``[W, ...]`` rows, advances as JAX's
returned state does. Packed sequences: ``Sequential.apply(p, x, segment_ids=)``
forwards ``[B, S]`` ids only to the layers that declare
``accepts_segment_ids`` (JAX :151-186). Randomness in training:
``Sequential.apply(p, x, rng=)`` splits ``rng`` once per layer (JAX
:172-176) and hands each sub-key to the layers that draw (``uses_rng``:
a ``Dropout`` or ``TransformerBlock`` with a rate, a ``Remat`` or a
nested stack holding one); a stack none of whose layers draws splits
nothing, which changes no result. ``Model.apply`` (inference)
runs under ``torch.no_grad``; ``Model.predict`` and ``Model.evaluate``
are JAX's host-side inference (:237-359); ``get_weights``/``set_weights``
the Keras-style flat list of params, then state, in JAX's leaf order
(dict keys sorted, :379-405); ``Model.fit`` trains in place through
``parallel.trainers.SingleTrainer``; ``Model.generate`` continues
prompts through ``models.decoding.generate``.

Layer specs (JAX :28-80, :107-118, :188-194): every layer class is
registered under its JAX class name (``register_layer``,
``LAYER_REGISTRY``), ``get_config()`` returns the JAX layer's dict of
constructor arguments (the same keys and values, so the same JSON),
``from_config`` rebuilds the layer, and ``layer_spec``/``layer_from_spec``
are the ``{"class", "config"}`` encoding that containers and
``models.serialization`` use. ``Model.save``/``Model.load`` write and
read the JAX package's model files (JAX :361-372).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from distkeras_tpu_torch.compat import resolve_device
from distkeras_tpu_torch.ops import prng

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

#: layer class name -> class: what ``layer_from_spec`` rebuilds from
LAYER_REGISTRY: Dict[str, type] = {}


def register_layer(cls: type) -> type:
    """Class decorator adding a layer class to ``LAYER_REGISTRY`` under
    its (JAX) class name."""
    LAYER_REGISTRY[cls.__name__] = cls
    return cls


def layer_spec(layer):
    """Layer -> ``{"class": name, "config": get_config()}`` (None passes
    through): the encoding every container and model file uses."""
    if layer is None:
        return None
    return {"class": layer.name, "config": layer.get_config()}


def layer_from_spec(spec):
    """``{"class", "config"}`` spec -> a new layer (None passes
    through)."""
    if spec is None:
        return None
    if not isinstance(spec, dict) or set(spec) != {"class", "config"}:
        raise ValueError(f"not a layer spec (a dict with exactly the keys "
                         f"'class' and 'config'): {spec!r}")
    try:
        cls = LAYER_REGISTRY[spec["class"]]
    except KeyError:
        raise ValueError(f"unknown layer class {spec['class']!r} in a layer "
                         f"spec; known: {sorted(LAYER_REGISTRY)}") from None
    return cls.from_config(spec["config"])


def user_float(y: torch.Tensor) -> torch.Tensor:
    """JAX's output dtype policy (:53): a bf16/f16 output goes back to the
    host as float32; other dtypes pass through."""
    if y.is_floating_point() and y.dtype != torch.float32:
        return y.float()
    return y


def sorted_leaves(tree) -> List:
    """The leaves of a tree in ``jax.tree_util.tree_leaves`` order: dict
    keys sorted, list entries in order."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for sub in tree for l in sorted_leaves(sub)]
    return [] if tree is None else [tree]


@contextlib.contextmanager
def eval_mode(module: nn.Module):
    """Run the block with ``module`` in inference mode (JAX's
    ``training=False``), restoring every sub-module's mode after it."""
    modes = [(m, m.training) for m in module.modules()]
    module.eval()
    try:
        yield module
    finally:
        for m, t in modes:
            m.training = t


def torch_dtype(name) -> torch.dtype:
    """A compute dtype given by name (the JAX package's spelling) or as a
    ``torch.dtype``."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_DTYPES)}")


class Layer(nn.Module):
    """Base layer. Subclasses implement ``build`` (create parameters with
    ``add_param``, return the output shape without the batch axis) and
    ``apply`` (the layer as a function of a parameter tree)."""

    #: the auxiliary loss the last forward published (``publish_aux_loss``)
    _aux_loss: Optional[torch.Tensor] = None
    #: packed-sequence capability: ``apply`` takes ``segment_ids=`` (the
    #: attention layers, and containers holding one)
    accepts_segment_ids = False
    #: this layer's ``apply`` takes ``rng=`` (a threefry key) and draws
    #: from it when training (a dropout rate > 0)
    uses_rng = False
    #: Keras-style freezing (JAX :98): set False before training and the
    #: layer's parameters and state (its whole subtree) take no updates;
    #: a training-time attribute, not part of the config
    trainable = True

    @property
    def has_state(self) -> bool:
        """This layer keeps model state, or holds a layer that does, and
        its ``apply`` takes ``state=`` (a stateful layer sets it True)."""
        return any(isinstance(m, Layer) and m.has_state
                   for m in self.children())

    def build(self, input_shape: Tuple[int, ...],
              rng: torch.Tensor) -> Tuple[int, ...]:
        return tuple(input_shape)

    def add_param(self, name: str, value: torch.Tensor) -> None:
        self.register_parameter(name, nn.Parameter(value))

    def add_state(self, name: str, value: torch.Tensor) -> None:
        """Register model state (a running statistic) as a buffer."""
        self.register_buffer(name, value)

    def param_tree(self) -> Dict:
        """``{name: tensor}`` for this layer's own parameters plus
        ``{child: child.param_tree()}`` for its sub-layers."""
        tree = {name: p for name, p in self.named_parameters(recurse=False)}
        for name, child in self.named_children():
            if isinstance(child, Layer):
                sub = child.param_tree()
                if sub:
                    tree[name] = sub
        return tree

    def state_tree(self) -> Dict:
        """``param_tree()``'s counterpart over the state buffers: the
        layer's part of the JAX ``Model.state``."""
        tree = {name: b for name, b in self.named_buffers(recurse=False)}
        for name, child in self.named_children():
            if isinstance(child, Layer):
                sub = child.state_tree()
                if sub:
                    tree[name] = sub
        return tree

    def apply(self, p, x):
        return x

    def get_config(self) -> Dict:
        """The constructor arguments as the JAX layer's ``get_config``
        returns them (JSON-able)."""
        return {}

    @classmethod
    def from_config(cls, config: Dict) -> "Layer":
        return cls(**config)

    @property
    def name(self) -> str:
        return type(self).__name__

    def forward(self, x, segment_ids=None):
        if segment_ids is None:
            return self.apply(self.param_tree(), x)
        if not self.accepts_segment_ids:
            raise ValueError(f"{type(self).__name__} does not accept "
                             "segment_ids")
        return self.apply(self.param_tree(), x, segment_ids=segment_ids)

    def publish_aux_loss(self, value: Optional[torch.Tensor]) -> None:
        """Set (or, with None, clear) this layer's auxiliary loss: what
        ``collect_aux_losses`` adds to the training objective. Each
        forward replaces the last one's, so no stale term survives."""
        self._aux_loss = value


def trainable_mask(module: Layer, tree):
    """A tree of Python bools shaped like ``tree`` (the parameter or the
    state tree of ``module``): True where updates may flow, or None when
    nothing is frozen (JAX :445). A layer with ``trainable = False``
    freezes its whole subtree; ``Sequential`` recurses per layer, and a
    container with ``sub_layers() -> {subtree key: layer}`` recurses
    through it, so freezing only a block's attention works. Any other
    layer is atomic: only its own flag counts."""
    from distkeras_tpu_torch.utils.tree import tree_leaves, tree_map

    def walk(layer, sub, enabled):
        enabled = enabled and getattr(layer, "trainable", True)
        if isinstance(layer, Sequential):
            return [walk(l, p, enabled) for l, p in zip(layer.layers, sub)]
        subs = getattr(layer, "sub_layers", None)
        if callable(subs) and isinstance(sub, dict):
            named = subs()
            return {key: (walk(named[key], child, enabled) if key in named
                          else tree_map(lambda _: enabled, child))
                    for key, child in sub.items()}
        return tree_map(lambda _: enabled, sub)

    mask = walk(module, tree, True)
    if all(tree_leaves(mask)):
        return None
    return mask


def collect_aux_losses(module: nn.Module):
    """The sum of every auxiliary loss the layers of ``module`` published
    since the last collection, clearing them (0.0 when none did)."""
    total = 0.0
    for m in module.modules():
        if isinstance(m, Layer) and m._aux_loss is not None:
            total = total + m._aux_loss
            m._aux_loss = None
    return total


@register_layer
class Sequential(Layer):
    """Ordered stack of layers; its parameter tree is a list with one
    entry per layer."""

    def __init__(self, layers: Optional[Sequence[Layer]] = None):
        super().__init__()
        self.layers = nn.ModuleList(list(layers) if layers else [])

    def build(self, input_shape, rng):
        shape = tuple(input_shape)
        for layer in self.layers:
            rng, sub = prng.split(rng)
            shape = layer.build(shape, sub)
        return shape

    def param_tree(self) -> List[Dict]:
        return [layer.param_tree() for layer in self.layers]

    def state_tree(self) -> List[Dict]:
        return [layer.state_tree() for layer in self.layers]

    @property
    def accepts_segment_ids(self) -> bool:
        return any(layer.accepts_segment_ids for layer in self.layers)

    @property
    def uses_rng(self) -> bool:
        return any(layer.uses_rng for layer in self.layers)

    @property
    def has_state(self) -> bool:
        return any(layer.has_state for layer in self.layers)

    def apply(self, p, x, segment_ids=None, rng=None, state=None):
        """``segment_ids`` ``[B, S]`` go to the layers that accept them
        (attention masking); the others are position-wise, and the loss
        masks padded positions. Ids passed to a stack where no layer
        accepts them raise rather than run unmasked. ``rng`` (training):
        one split per layer, the sub-key to the layers that draw.
        ``state`` (one entry per layer, or None for the layers' own
        buffers) goes to the stateful layers."""
        if segment_ids is not None and not self.accepts_segment_ids:
            raise ValueError(
                "segment_ids passed, but no layer in this Sequential "
                "accepts them (packed-sequence masking needs a "
                "TransformerBlock-family layer)")
        if not self.uses_rng:
            rng = None
        for i, (layer, lp) in enumerate(zip(self.layers, p)):
            kw = {}
            if rng is not None:
                rng, sub = prng.split(rng)
                if layer.uses_rng:
                    kw["rng"] = sub
            if segment_ids is not None and layer.accepts_segment_ids:
                kw["segment_ids"] = segment_ids
            if layer.has_state:
                kw["state"] = None if state is None else state[i]
            x = layer.apply(lp, x, **kw)
        return x

    def get_config(self):
        return {"layers": [layer_spec(layer) for layer in self.layers]}

    @classmethod
    def from_config(cls, config):
        return cls([layer_from_spec(spec) for spec in config["layers"]])


class Model:
    """A built model: the module, its input/output shapes and the device
    its parameters live on."""

    def __init__(self, module: Layer, input_shape, output_shape,
                 device: torch.device):
        self.module = module
        self.input_shape = tuple(input_shape)
        self.output_shape = tuple(output_shape)
        self.device = device

    @classmethod
    def build(cls, module: Layer, input_shape: Tuple[int, ...],
              rng=None, *, seed: int = 0, device=None) -> "Model":
        """Create the parameters on ``device`` (default: the CUDA card;
        raises when there is none unless ``device="cpu"``) from the
        threefry key ``rng`` (a JAX key, or two uint32 words) or, by
        default, ``PRNGKey(seed)``: JAX's ``Model.build`` draws
        (``ops.prng``; K7 on the card, bitwise its plain version for the
        uniform families), so a seed gives the same weights on every
        device."""
        dev = resolve_device(device)
        key = (prng.key(seed, dev) if rng is None
               else prng.as_key(rng, dev))
        out_shape = module.build(tuple(input_shape), key)
        module.to(dev)
        module.eval()
        return cls(module, input_shape, out_shape, dev)

    @property
    def params(self):
        return self.module.param_tree()

    @property
    def state(self):
        """The model state tree (BatchNorm's running statistics): the
        module's own buffers, shaped as the JAX ``Model.state``."""
        return self.module.state_tree()

    @torch.no_grad()
    def apply(self, x) -> torch.Tensor:
        """Forward pass over a batch (tokens ``[B, S]`` for an LM)."""
        return self.module(torch.as_tensor(x).to(self.device))

    @torch.no_grad()
    def predict(self, x, batch_size: Optional[int] = None) -> np.ndarray:
        """Host-side inference (JAX :237): the eval-mode forward over
        ``x`` with the running statistics, as float32 (``user_float``).
        With ``batch_size`` the rows go in batches of that size and the
        last one is zero-padded to it, so every call has one shape."""
        from distkeras_tpu_torch.data.dataset import coerce_column
        if not torch.is_tensor(x):   # JAX's dtypes: float32 or integers
            x = torch.from_numpy(coerce_column(x))
        x = x.to(self.device)
        params = self.params

        def fwd(b):
            with eval_mode(self.module):
                return user_float(self.module.apply(params, b)) \
                    .cpu().numpy()

        if batch_size is None:
            return fwd(x)
        n, outs = x.shape[0], []
        for i in range(0, n, batch_size):
            xb = x[i:i + batch_size]
            pad = batch_size - xb.shape[0]
            if pad:
                xb = torch.cat([xb, xb.new_zeros((pad,) + xb.shape[1:])])
            yb = fwd(xb)
            outs.append(yb[:batch_size - pad] if pad else yb)
        return np.concatenate(outs, axis=0)

    def evaluate(self, x, y=None, *, loss="mean_squared_error",
                 metrics=("accuracy",), batch_size: int = 1024,
                 features_col: str = "features", label_col: str = "label"):
        """Keras-style ``model.evaluate`` (JAX :307): ``{"loss": ...,
        metric: ...}`` over the whole of a ``Dataset`` or of arrays
        ``x``, ``y``, from a batched ``predict``; a ``ShardedDataset``
        one shard at a time."""
        from distkeras_tpu_torch.data.dataset import Dataset, coerce_column
        from distkeras_tpu_torch.data.sharded import ShardedDataset
        from distkeras_tpu_torch.ops.losses import get_loss
        from distkeras_tpu_torch.ops.metrics import get_metric, metric_name

        if isinstance(x, ShardedDataset):
            # shard by shard, weighted by shard size: exact only for
            # row-decomposable metrics, so a pooled one (macro
            # precision/recall/f1, auc) is refused
            decomposable = {"accuracy", "top_5_accuracy", "mse"}
            bad = [metric_name(m) for m in (metrics or ())
                   if metric_name(m) not in decomposable]
            if bad:
                raise ValueError(
                    f"metrics {bad} are not decomposable across shards "
                    "(a size-weighted mean of per-shard macro scores is "
                    "not the pooled score); evaluate them on an in-memory "
                    "Dataset, or use decomposable metrics "
                    f"({sorted(decomposable)}) here")
            totals, n_total = {}, 0
            for i in range(x.num_shards):
                shard = x.load_shard(i)
                res = self.evaluate(shard, loss=loss, metrics=metrics,
                                    batch_size=batch_size,
                                    features_col=features_col,
                                    label_col=label_col)
                n = len(shard)
                n_total += n
                for k, v in res.items():
                    totals[k] = totals.get(k, 0.0) + n * v
            return {k: v / n_total for k, v in totals.items()}
        if isinstance(x, Dataset):
            X, yv = x.arrays(features_col, label_col)
            if yv is None:
                raise ValueError(
                    f"evaluate(dataset): label column {label_col!r} not in "
                    f"dataset (columns: {x.columns})")
        else:
            if y is None:
                raise ValueError("evaluate(x, y): y is required")
            X, yv = coerce_column(x), coerce_column(y)
        preds = torch.from_numpy(self.predict(X, batch_size=batch_size))
        yt = torch.from_numpy(yv)
        res = {"loss": float(get_loss(loss)(yt, preds))}
        for m in (metrics or ()):
            res[metric_name(m)] = float(get_metric(m)(yt, preds))
        return res

    def get_weights(self) -> List[np.ndarray]:
        """Keras-style flat weight list (JAX :379): the params, then the
        state, as host numpy arrays in ``jax.tree_util.tree_leaves``
        order, so a JAX model's ``get_weights()`` loads here."""
        return [w.detach().cpu().numpy().copy()
                for w in sorted_leaves((self.params, self.state))]

    @torch.no_grad()
    def set_weights(self, weights: Sequence[np.ndarray]) -> None:
        """The inverse of :meth:`get_weights`: shapes must match leaf for
        leaf; the values are copied into the model's tensors."""
        leaves = sorted_leaves((self.params, self.state))
        if len(weights) != len(leaves):
            raise ValueError(
                f"set_weights got {len(weights)} arrays, model has "
                f"{len(leaves)} weight tensors (params + state)")
        for i, (leaf, w) in enumerate(zip(leaves, weights)):
            w = torch.from_numpy(np.array(w))
            if tuple(w.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"set_weights: tensor {i} has shape {tuple(w.shape)}, "
                    f"expected {tuple(leaf.shape)}")
            leaf.copy_(w)

    def save(self, path: str, quantize: bool = False) -> None:
        """Keras-style ``model.save`` (JAX :361): ``<path>.json`` and
        ``<path>.npz`` in the JAX package's format
        (``models.serialization.save_model``)."""
        from distkeras_tpu_torch.models.serialization import save_model
        save_model(self, path, quantize=quantize)

    @staticmethod
    def load(path: str, keep_quantized: bool = False, *, device=None):
        """Keras-style loader (JAX :367,
        ``models.serialization.load_model``) onto ``device`` (default:
        the CUDA card)."""
        from distkeras_tpu_torch.models.serialization import load_model
        return load_model(path, keep_quantized=keep_quantized,
                          device=device)

    def generate(self, prompts, max_new_tokens: int, **kwargs):
        """Keras-style convenience over ``models.decoding.generate``
        (``distkeras_tpu`` ``Model.generate`` :373): KV-cache
        autoregressive continuation of ``[B, P]`` prompts."""
        from distkeras_tpu_torch.models.decoding import generate
        return generate(self, prompts, max_new_tokens, **kwargs)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.module.parameters())

    def summary(self) -> str:
        """Keras-style per-layer table (JAX :411): each layer of a
        ``Sequential`` with its parameter count, then the total. Printed
        and returned."""
        if isinstance(self.module, Sequential):
            rows = [(type(layer).__name__,
                     sum(p.numel() for p in layer.parameters()))
                    for layer in self.module.layers]
        else:
            rows = [(type(self.module).__name__, self.num_params())]
        name_w = min(72, max([len(r[0]) for r in rows] + [10]))
        lines = [f"Model: in={self.input_shape} out={self.output_shape}",
                 "-" * (name_w + 14)]
        lines += [f"{name:<{name_w}}  {n:>12,}" for name, n in rows]
        lines.append("-" * (name_w + 14))
        lines.append(f"{'total':<{name_w}}  {self.num_params():>12,}")
        out = "\n".join(lines)
        print(out)
        return out

    def to(self, device) -> "Model":
        """Move the parameters to another device (in place)."""
        self.device = resolve_device(device)
        self.module.to(self.device)
        return self

    def fit(self, x, y=None, *, optimizer="sgd",
            loss="mean_squared_error", batch_size: int = 32,
            epochs: int = 1, metrics=None, validation_data=None,
            validation_split: float = 0.0, seed: int = 0,
            **trainer_kwargs):
        """Keras-style ``model.fit`` (``distkeras_tpu`` ``Model.fit``
        :260): a thin wrapper over ``SingleTrainer``. ``x`` is a
        ``data.Dataset`` (default feature/label columns) or a feature
        array with labels ``y``, or a ``ShardedDataset``. Trains IN PLACE
        on the model's device and returns the ``History``.
        ``validation_split`` holds out the LAST fraction of the
        (unshuffled) in-memory data, as Keras does. The trainer's other
        options (``callbacks``, ``class_weight``, checkpoints, ...) pass
        through ``trainer_kwargs``."""
        from distkeras_tpu_torch.data.dataset import Dataset
        from distkeras_tpu_torch.data.sharded import ShardedDataset
        from distkeras_tpu_torch.parallel.trainers import SingleTrainer

        if isinstance(x, (Dataset, ShardedDataset)):
            ds = x
        else:
            if y is None:
                raise ValueError("fit(x, y): y is required for array input")
            ds = Dataset({"features": np.asarray(x), "label": np.asarray(y)})
        if validation_split:
            if validation_data is not None:
                raise ValueError(
                    "pass validation_split OR validation_data, not both")
            if not 0.0 < validation_split < 1.0:
                raise ValueError(f"validation_split must be in (0, 1), got "
                                 f"{validation_split}")
            if isinstance(ds, ShardedDataset):
                raise ValueError(
                    "validation_split needs in-memory data; hold out "
                    "shards yourself for a ShardedDataset")
            ds, validation_data = ds.split(1.0 - validation_split)
        trainer = SingleTrainer(
            self, worker_optimizer=optimizer, loss=loss,
            batch_size=batch_size, num_epoch=epochs, metrics=metrics,
            validation_data=validation_data, seed=seed, **trainer_kwargs)
        trainer.train(ds)
        return trainer.get_history()
