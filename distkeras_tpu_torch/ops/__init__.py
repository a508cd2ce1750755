"""Operators of the port: attention building blocks and the wrappers
of the hand-written CUDA kernels (``flash_attention``,
``decode_attention``, ``paged_attention``, ``quant_matmul``,
``sampling``; ``moe_kernels``, imported as its module, holds the MoE
expert up-projection, and ``prng``, JAX's threefry keys and draws with
the K7 kernel); losses, optimizers,
learning-rate schedules and metrics for training (``losses``,
``optimizers``, ``schedules``, ``metrics``)."""

from distkeras_tpu_torch.ops.attention import (NEG_INF, apply_rope,
                                               dot_product_attention,
                                               rope_frequencies)
from distkeras_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_reference)
from distkeras_tpu_torch.ops.flash_attention import (
    flash_attention, flash_backward, flash_backward_reference, flash_forward,
    flash_forward_reference)
from distkeras_tpu_torch.ops.losses import (fused_linear_cross_entropy,
                                            with_class_weight,
                                            with_label_smoothing)
from distkeras_tpu_torch.ops.paged_attention import (
    gather_pages, paged_decode_attention, paged_decode_attention_reference)
from distkeras_tpu_torch.ops.quant_matmul import (quant_matmul,
                                                  reference_matmul)
from distkeras_tpu_torch.ops.sampling import (sample_epilogue,
                                              sample_epilogue_reference,
                                              sample_tokens)

__all__ = ["NEG_INF", "apply_rope", "dot_product_attention",
           "rope_frequencies", "decode_attention",
           "decode_attention_reference", "flash_attention", "flash_backward",
           "flash_backward_reference", "flash_forward",
           "flash_forward_reference", "fused_linear_cross_entropy",
           "gather_pages", "paged_decode_attention",
           "paged_decode_attention_reference", "quant_matmul",
           "reference_matmul", "sample_epilogue",
           "sample_epilogue_reference", "sample_tokens",
           "with_class_weight", "with_label_smoothing"]
