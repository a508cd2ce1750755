"""Models of the port: the layer substrate, the transformer layers, the
``Remat`` wrapper (``blocks``), the LM zoo entry, the weight bridge to
and from the JAX package, weight-only quantization (``quantize``) and
the serving decode path (``decoding``)."""

from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.models.bridge import (from_jax_params, qtree_from_jax,
                                              to_jax_params)
from distkeras_tpu_torch.models.core import (Layer, Model, Sequential,
                                             collect_aux_losses)

__all__ = ["Layer", "Model", "Sequential", "collect_aux_losses",
           "from_jax_params", "qtree_from_jax", "to_jax_params", "zoo"]
