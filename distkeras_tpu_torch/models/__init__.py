"""Models of the port: the layer substrate with model state, the
standard, image and normalization layers (``layers``), the transformer
layers, the ``Residual``/``WideAndDeep``/``Remat`` containers
(``blocks``), the zoo (the BASELINE vision and tabular models and the
LM), the weight bridge to and from the JAX package, weight-only
quantization (``quantize``) and the serving decode path
(``decoding``)."""

from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.models.blocks import Remat, Residual, WideAndDeep
from distkeras_tpu_torch.models.bridge import (from_jax_params, qtree_from_jax,
                                              to_jax_params, to_jax_state)
from distkeras_tpu_torch.models.core import (Layer, Model, Sequential,
                                             collect_aux_losses)
from distkeras_tpu_torch.models.layers import (
    Activation, AveragePooling2D, BatchNorm, Conv1D, Conv2D, Dense, Dropout,
    Embedding, Flatten, GlobalAveragePooling1D, GlobalAveragePooling2D,
    GroupNorm, MaxPooling2D, Reshape)

__all__ = ["Activation", "AveragePooling2D", "BatchNorm", "Conv1D", "Conv2D",
           "Dense", "Dropout", "Embedding", "Flatten",
           "GlobalAveragePooling1D", "GlobalAveragePooling2D", "GroupNorm",
           "Layer", "MaxPooling2D", "Model", "Remat", "Reshape", "Residual",
           "Sequential", "WideAndDeep", "collect_aux_losses",
           "from_jax_params", "qtree_from_jax", "to_jax_params",
           "to_jax_state", "zoo"]
