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
entry and ``collect_aux_losses`` (:33-50), since the port's layers carry
no state. Packed sequences: ``Sequential.apply(p, x, segment_ids=)``
forwards ``[B, S]`` ids only to the layers that declare
``accepts_segment_ids`` (JAX :151-186). Randomness in training:
``Sequential.apply(p, x, rng=)`` splits ``rng`` once per layer (JAX
:172-176) and hands each sub-key to the layers that draw (``uses_rng``:
a ``Dropout`` or ``TransformerBlock`` with a rate, a ``Remat`` or a
nested stack holding one); a stack none of whose layers draws splits
nothing, which changes no result. ``Model.apply`` (inference)
runs under ``torch.no_grad``; ``Model.fit`` trains in place through
``parallel.trainers.SingleTrainer``; ``Model.generate`` continues
prompts through ``models.decoding.generate``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from distkeras_tpu_torch.compat import resolve_device
from distkeras_tpu_torch.ops import prng

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


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

    def build(self, input_shape: Tuple[int, ...],
              rng: torch.Tensor) -> Tuple[int, ...]:
        return tuple(input_shape)

    def add_param(self, name: str, value: torch.Tensor) -> None:
        self.register_parameter(name, nn.Parameter(value))

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

    def apply(self, p, x):
        return x

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


def collect_aux_losses(module: nn.Module):
    """The sum of every auxiliary loss the layers of ``module`` published
    since the last collection, clearing them (0.0 when none did)."""
    total = 0.0
    for m in module.modules():
        if isinstance(m, Layer) and m._aux_loss is not None:
            total = total + m._aux_loss
            m._aux_loss = None
    return total


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

    @property
    def accepts_segment_ids(self) -> bool:
        return any(layer.accepts_segment_ids for layer in self.layers)

    @property
    def uses_rng(self) -> bool:
        return any(layer.uses_rng for layer in self.layers)

    def apply(self, p, x, segment_ids=None, rng=None):
        """``segment_ids`` ``[B, S]`` go to the layers that accept them
        (attention masking); the others are position-wise, and the loss
        masks padded positions. Ids passed to a stack where no layer
        accepts them raise rather than run unmasked. ``rng`` (training):
        one split per layer, the sub-key to the layers that draw."""
        if segment_ids is not None and not self.accepts_segment_ids:
            raise ValueError(
                "segment_ids passed, but no layer in this Sequential "
                "accepts them (packed-sequence masking needs a "
                "TransformerBlock-family layer)")
        if not self.uses_rng:
            rng = None
        for layer, lp in zip(self.layers, p):
            kw = {}
            if rng is not None:
                rng, sub = prng.split(rng)
                if layer.uses_rng:
                    kw["rng"] = sub
            if segment_ids is not None and layer.accepts_segment_ids:
                kw["segment_ids"] = segment_ids
            x = layer.apply(lp, x, **kw)
        return x


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

    @torch.no_grad()
    def apply(self, x) -> torch.Tensor:
        """Forward pass over a batch (tokens ``[B, S]`` for an LM)."""
        return self.module(torch.as_tensor(x).to(self.device))

    def generate(self, prompts, max_new_tokens: int, **kwargs):
        """Keras-style convenience over ``models.decoding.generate``
        (``distkeras_tpu`` ``Model.generate`` :373): KV-cache
        autoregressive continuation of ``[B, P]`` prompts."""
        from distkeras_tpu_torch.models.decoding import generate
        return generate(self, prompts, max_new_tokens, **kwargs)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.module.parameters())

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
        array with labels ``y``. Trains IN PLACE on the model's device and
        returns the ``History``. ``validation_split`` holds out the LAST
        fraction of the (unshuffled) data, as Keras does."""
        from distkeras_tpu_torch.data.dataset import Dataset
        from distkeras_tpu_torch.parallel.trainers import SingleTrainer

        if isinstance(x, Dataset):
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
            ds, validation_data = ds.split(1.0 - validation_split)
        trainer = SingleTrainer(
            self, worker_optimizer=optimizer, loss=loss,
            batch_size=batch_size, num_epoch=epochs, metrics=metrics,
            validation_data=validation_data, seed=seed, **trainer_kwargs)
        trainer.train(ds)
        return trainer.get_history()
