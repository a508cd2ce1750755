"""Data plane of the port: the in-memory columnar ``Dataset``, its
out-of-core counterpart ``ShardedDataset``, the adapters
(``from_iterable``, ``from_torch``), the feature transformers and the
host data library (``native``), as JAX's ``data/__init__.py`` exports
them. ``data.real`` loads real digit data."""

from distkeras_tpu_torch.data.dataset import Dataset, coerce_column
from distkeras_tpu_torch.data.adapters import from_iterable, from_torch
from distkeras_tpu_torch.data.sharded import ShardedDataset
from distkeras_tpu_torch.data.transformers import (
    DenseTransformer, HashingTransformer, LabelIndexTransformer,
    MinMaxTransformer, OneHotTransformer, ReshapeTransformer,
    StandardScaleTransformer, StringIndexerTransformer, Transformer,
    VectorAssemblerTransformer)
from distkeras_tpu_torch.data import native

__all__ = ["Dataset", "DenseTransformer", "HashingTransformer",
           "LabelIndexTransformer", "MinMaxTransformer",
           "OneHotTransformer", "ReshapeTransformer", "ShardedDataset",
           "StandardScaleTransformer", "StringIndexerTransformer",
           "Transformer", "VectorAssemblerTransformer", "coerce_column",
           "from_iterable", "from_torch", "native"]
