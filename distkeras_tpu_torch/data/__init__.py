"""Data plane of the port: the in-memory columnar ``Dataset``."""

from distkeras_tpu_torch.data.dataset import Dataset, coerce_column

__all__ = ["Dataset", "coerce_column"]
