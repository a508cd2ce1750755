"""Models of the port: the layer substrate with model state, the
standard, image and normalization layers (``layers``), the transformer
layers, the ``Residual``/``WideAndDeep``/``Remat`` containers
(``blocks``), the recurrent layers (``recurrent``), the zoo (the five
BASELINE models, ViT, MobileNet and the LM), the layer registry and
model files in the JAX package's format (``serialization``), the weight
bridge to and from the JAX package, weight-only
quantization (``quantize``) and the serving decode path
(``decoding``)."""

from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.models.blocks import Remat, Residual, WideAndDeep
from distkeras_tpu_torch.models.bridge import (from_jax_params, qtree_from_jax,
                                              to_jax_params, to_jax_state)
from distkeras_tpu_torch.models.core import (LAYER_REGISTRY, Layer, Model,
                                             Sequential, collect_aux_losses,
                                             layer_from_spec, layer_spec,
                                             register_layer)
from distkeras_tpu_torch.models.layers import (
    Activation, AveragePooling2D, BatchNorm, Conv1D, Conv2D, Conv2DTranspose,
    Dense, DepthwiseConv2D, Dropout, Embedding, Flatten,
    GlobalAveragePooling1D, GlobalAveragePooling2D, GroupNorm, MaxPooling2D,
    Reshape, SeparableConv2D, UpSampling2D)
from distkeras_tpu_torch.models.recurrent import GRU, LSTM, Bidirectional
from distkeras_tpu_torch.models.serialization import (load_model,
                                                      save_model)

__all__ = ["Activation", "AveragePooling2D", "BatchNorm", "Bidirectional",
           "Conv1D", "Conv2D", "Conv2DTranspose", "Dense", "DepthwiseConv2D",
           "Dropout", "Embedding", "Flatten", "GRU",
           "GlobalAveragePooling1D", "GlobalAveragePooling2D", "GroupNorm",
           "LAYER_REGISTRY", "LSTM", "Layer", "MaxPooling2D", "Model",
           "Remat", "Reshape", "Residual", "SeparableConv2D", "Sequential",
           "UpSampling2D", "WideAndDeep", "collect_aux_losses",
           "from_jax_params", "layer_from_spec", "layer_spec", "load_model",
           "qtree_from_jax", "register_layer", "save_model", "to_jax_params",
           "to_jax_state", "zoo"]
