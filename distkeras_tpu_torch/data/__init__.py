"""Data plane of the port: the in-memory columnar ``Dataset`` and its
out-of-core counterpart, ``ShardedDataset``."""

from distkeras_tpu_torch.data.dataset import Dataset, coerce_column
from distkeras_tpu_torch.data.sharded import ShardedDataset

__all__ = ["Dataset", "ShardedDataset", "coerce_column"]
