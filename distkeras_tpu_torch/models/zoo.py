"""Model zoo of the port (mirrors ``distkeras_tpu/models/zoo.py``): the
BASELINE evaluation models and the decoder-only transformer LM.

  1. ``mlp`` (:30)           the MNIST MLP (config 1, ``SingleTrainer``)
  2. ``lenet5`` (:44)        LeNet-5 (config 2, ADAG on CIFAR-10)
  3. ``resnet50`` (:119)     ResNet-v1.5-50 (config 3, AEASGD on ImageNet,
                             the north-star model), ``resnet`` the family,
                             ``resnet18_thin`` the few-block test size
  4. ``wide_and_deep`` (:146) Wide & Deep (config 4, DOWNPOUR on Criteo)
  5. ``bilstm_classifier`` (:135) the BiLSTM classifier (config 5,
                             batched ``Predictor`` inference)

and ``transformer_lm`` (:153), with dense or mixture-of-experts MLP
blocks, optionally each wrapped in ``blocks.Remat``; ``vit`` (:227), the
Vision Transformer, whose attention is the flash kernels without the
causal mask; ``mobilenet`` (:262), MobileNet-v1 over depthwise
convolutions. Build a spec with ``Model.build(spec, input_shape)``;
images are NHWC.
"""

from __future__ import annotations

from typing import Optional, Sequence

from distkeras_tpu_torch.models.attention import (LayerNorm,
                                                  PositionalEmbedding,
                                                  RMSNorm, TransformerBlock)
from distkeras_tpu_torch.models.blocks import Remat, Residual, WideAndDeep
from distkeras_tpu_torch.models.core import Sequential
from distkeras_tpu_torch.models.layers import (
    Activation, BatchNorm, Conv2D, Dense, DepthwiseConv2D, Dropout, Embedding,
    Flatten, GlobalAveragePooling1D, GlobalAveragePooling2D, GroupNorm,
    MaxPooling2D, Reshape)
from distkeras_tpu_torch.models.moe import MoE
from distkeras_tpu_torch.models.recurrent import LSTM, Bidirectional


def mlp(hidden: Sequence[int] = (512, 256), num_classes: int = 10,
        activation: str = "relu", dropout: float = 0.0,
        dtype: str = "float32") -> Sequential:
    """MNIST-style MLP (BASELINE config 1)."""
    layers = []
    for h in hidden:
        layers.append(Dense(h, activation=activation, dtype=dtype))
        if dropout > 0:
            layers.append(Dropout(dropout))
    layers.append(Dense(num_classes, dtype=dtype))
    return Sequential(layers)


def lenet5(num_classes: int = 10, dtype: str = "float32") -> Sequential:
    """LeNet-5 (BASELINE config 2: ADAG on CIFAR-10): NHWC, tanh
    activations as in the original."""
    return Sequential([
        Conv2D(6, 5, padding="SAME", activation="tanh", dtype=dtype),
        MaxPooling2D(2),
        Conv2D(16, 5, padding="VALID", activation="tanh", dtype=dtype),
        MaxPooling2D(2),
        Flatten(),
        Dense(120, activation="tanh", dtype=dtype),
        Dense(84, activation="tanh", dtype=dtype),
        Dense(num_classes, dtype=dtype),
    ])


def _resnet_norm(norm: str, bn_axis_name: Optional[str],
                 norm_groups: int = 32):
    """Norm factory of the resnet family: ``"batch"`` (BatchNorm) or
    ``"group"`` (GroupNorm of ``norm_groups``)."""
    if norm == "batch":
        return lambda: BatchNorm(axis_name=bn_axis_name)
    if norm == "group":
        return lambda: GroupNorm(groups=norm_groups)
    raise ValueError(f"norm must be 'batch' or 'group', got {norm!r}")


def _bottleneck(filters: int, stride: int, project: bool, dtype: str,
                bn_axis_name: Optional[str], norm: str = "batch",
                norm_groups: int = 32) -> Residual:
    """ResNet-v1.5 bottleneck: 1x1 -> 3x3 (stride) -> 1x1 (4f), a norm
    after each conv, relu after the residual add."""
    bn = _resnet_norm(norm, bn_axis_name, norm_groups)
    main = Sequential([
        Conv2D(filters, 1, use_bias=False, dtype=dtype), bn(),
        Activation("relu"),
        Conv2D(filters, 3, strides=stride, use_bias=False, dtype=dtype),
        bn(), Activation("relu"),
        Conv2D(4 * filters, 1, use_bias=False, dtype=dtype), bn(),
    ])
    shortcut = None
    if project:
        shortcut = Sequential([
            Conv2D(4 * filters, 1, strides=stride, use_bias=False,
                   dtype=dtype), bn(),
        ])
    return Residual(main, shortcut, activation="relu")


def resnet(stage_sizes: Sequence[int], num_classes: int = 1000,
           width: int = 64, dtype: str = "float32",
           bn_axis_name: Optional[str] = None, norm: str = "batch",
           norm_groups: int = 32) -> Sequential:
    """ResNet-v1.5 over bottleneck blocks (NHWC): a 7x7/2 stem, a 3x3/2
    SAME max pool, the stages, global average pooling and the head."""
    layers = [
        Conv2D(width, 7, strides=2, use_bias=False, dtype=dtype),
        _resnet_norm(norm, bn_axis_name, norm_groups)(), Activation("relu"),
        MaxPooling2D(3, strides=2, padding="SAME"),
    ]
    filters = width
    for stage, blocks in enumerate(stage_sizes):
        for block in range(blocks):
            stride = 2 if (stage > 0 and block == 0) else 1
            layers.append(_bottleneck(filters, stride, block == 0, dtype,
                                      bn_axis_name, norm, norm_groups))
        filters *= 2
    layers += [GlobalAveragePooling2D(), Dense(num_classes, dtype=dtype)]
    return Sequential(layers)


def resnet50(num_classes: int = 1000, dtype: str = "float32",
             bn_axis_name: Optional[str] = None,
             norm: str = "batch") -> Sequential:
    """ResNet-50 (BASELINE config 3, the north-star model): 25,557,032
    parameters at 1000 classes."""
    return resnet([3, 4, 6, 3], num_classes, 64, dtype, bn_axis_name, norm)


def resnet18_thin(num_classes: int = 10, width: int = 8,
                  dtype: str = "float32") -> Sequential:
    """A two-block thin ResNet of the same family, for tests."""
    return resnet([1, 1], num_classes, width, dtype)


def bilstm_classifier(units: int = 64, num_classes: int = 2,
                      dtype: str = "float32") -> Sequential:
    """BiLSTM sequence classifier (BASELINE config 5: batched
    ``Predictor`` inference): two bidirectional LSTMs (the first returns
    its sequence) and the head."""
    return Sequential([
        Bidirectional(LSTM(units, return_sequences=True, dtype=dtype)),
        Bidirectional(LSTM(units, dtype=dtype)),
        Dense(num_classes, dtype=dtype),
    ])


def wide_and_deep(wide_dim: int, deep_hidden: Sequence[int] = (256, 128),
                  num_classes: int = 2, dtype: str = "float32") -> Sequential:
    """Wide & Deep for Criteo-style CTR (BASELINE config 4)."""
    return Sequential([WideAndDeep(wide_dim, deep_hidden, num_classes,
                                   dtype=dtype)])


def transformer_lm(vocab_size: int, d_model: int = 512, num_heads: int = 8,
                   num_layers: int = 6, mlp_ratio: int = 4,
                   max_len: Optional[int] = None, use_rope: bool = True,
                   norm: str = "rmsnorm", dtype: str = "float32",
                   attn_impl: str = "auto",
                   seq_axis_name: Optional[str] = None,
                   num_kv_heads: Optional[int] = None,
                   rope_scale: float = 1.0,
                   attn_window: Optional[int] = None,
                   moe_every: int = 0, num_experts: int = 0,
                   moe_expert_axis: Optional[str] = None,
                   moe_aux_loss_weight: float = 0.0,
                   moe_dispatch: str = "dense",
                   moe_capacity_factor: float = 1.25,
                   moe_expert_unroll: bool = False,
                   remat: Optional[str] = None) -> Sequential:
    """Decoder-only causal transformer LM: tokens ``[B, S]`` in, logits
    ``[B, S, vocab]`` out. ``num_kv_heads < num_heads`` builds a
    grouped-query model; ``attn_window`` a sliding-window one.
    ``moe_every=k`` (with ``num_experts``) swaps every k-th block's MLP
    for a ``models.moe.MoE`` of hidden size ``mlp_ratio * d_model``
    (``moe_dispatch``, ``moe_capacity_factor``, ``moe_aux_loss_weight``
    and ``moe_expert_unroll`` configure it, as in JAX
    ``zoo.py:204-211``); ``moe_expert_axis`` (expert parallelism) raises
    naming its ROADMAP item. ``attn_impl`` is ``"auto"``/``"flash"``
    (the flash kernels), ``"xla"`` (plain attention) or a
    sequence-parallel one (``"ring"``, ``"ulysses"``,
    ``"ulysses_flash"``) over the mesh axis ``seq_axis_name``, which the
    positional embedding also takes (JAX :200-201). ``remat`` wraps
    every block in ``blocks.Remat`` with that policy (``"nothing"``,
    ``"dots"``, ``"dots_no_batch"``)."""
    layers = [Embedding(vocab_size, d_model)]
    if not use_rope:
        if max_len is None:
            raise ValueError("max_len required when use_rope=False")
        layers.append(PositionalEmbedding(max_len,
                                          seq_axis_name=seq_axis_name))
    for i in range(num_layers):
        mlp_layer = None
        if moe_every and num_experts and (i + 1) % moe_every == 0:
            mlp_layer = MoE(num_experts, mlp_ratio * d_model, dtype=dtype,
                            expert_axis_name=moe_expert_axis,
                            aux_loss_weight=moe_aux_loss_weight,
                            dispatch=moe_dispatch,
                            capacity_factor=moe_capacity_factor,
                            expert_unroll=moe_expert_unroll)
        block = TransformerBlock(
            num_heads, mlp_ratio=mlp_ratio, causal=True, use_rope=use_rope,
            norm=norm, dtype=dtype, attn_impl=attn_impl,
            seq_axis_name=seq_axis_name, num_kv_heads=num_kv_heads,
            rope_scale=rope_scale, attn_window=attn_window,
            mlp_layer=mlp_layer)
        layers.append(block if remat is None else Remat(block, policy=remat))
    layers.append(RMSNorm() if norm == "rmsnorm" else LayerNorm())
    layers.append(Dense(vocab_size, use_bias=False, dtype=dtype))
    return Sequential(layers)


def vit(image_size: int = 224, patch_size: int = 16, d_model: int = 384,
        num_heads: int = 6, num_layers: int = 12, mlp_ratio: int = 4,
        num_classes: int = 1000, dtype: str = "float32",
        dropout_rate: float = 0.0) -> Sequential:
    """Vision Transformer (the defaults are ViT-S/16): one strided
    ``Conv2D`` patchify, the patches as a sequence with learned
    positions, pre-norm LayerNorm blocks with no causal mask and no RoPE
    (``dropout_rate`` on both residual branches in training), a final
    LayerNorm, mean pooling over the patches and the head."""
    if image_size % patch_size:
        raise ValueError(f"image_size {image_size} not divisible by "
                         f"patch_size {patch_size}")
    n_patches = (image_size // patch_size) ** 2
    layers = [Conv2D(d_model, patch_size, strides=patch_size,
                     padding="VALID", dtype=dtype),
              Reshape((n_patches, d_model)),
              PositionalEmbedding(n_patches)]
    for _ in range(num_layers):
        layers.append(TransformerBlock(
            num_heads, mlp_ratio=mlp_ratio, causal=False, use_rope=False,
            norm="layernorm", dtype=dtype, dropout_rate=dropout_rate))
    layers += [LayerNorm(), GlobalAveragePooling1D(),
               Dense(num_classes, dtype=dtype)]
    return Sequential(layers)


def mobilenet(num_classes: int = 1000, width_mult: float = 1.0,
              dtype: str = "float32",
              bn_axis_name: Optional[str] = None) -> Sequential:
    """MobileNet-v1 (NHWC): a 3x3/2 stem, 13 depthwise-separable blocks
    (a 3x3 ``DepthwiseConv2D``, BN, relu, a 1x1 ``Conv2D``, BN, relu),
    global average pooling and the head; ``width_mult`` scales every
    channel count (at least 8). ``bn_axis_name`` raises naming its
    ROADMAP item (``layers.SYNC_BN_ITEM``)."""
    def ch(c):
        return max(8, int(c * width_mult))

    def bn():
        return BatchNorm(axis_name=bn_axis_name)

    layers = [Conv2D(ch(32), 3, strides=2, use_bias=False, dtype=dtype),
              bn(), Activation("relu")]
    # (pointwise out-channels, stride) per separable block
    plan = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
            (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
            (1024, 1)]
    for out_c, stride in plan:
        layers += [
            DepthwiseConv2D(3, strides=stride, use_bias=False, dtype=dtype),
            bn(), Activation("relu"),
            Conv2D(ch(out_c), 1, use_bias=False, dtype=dtype),
            bn(), Activation("relu"),
        ]
    layers += [GlobalAveragePooling2D(), Dense(num_classes, dtype=dtype)]
    return Sequential(layers)
