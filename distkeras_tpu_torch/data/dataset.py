"""Columnar dataset: named numpy columns of equal length (a copy of the
in-memory part of ``distkeras_tpu/data/dataset.py``, numpy only).
Batches are slices of contiguous columns shaped ``[batch, ...]``.
``ShardedDataset`` (out-of-core shards) waits for a later slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def coerce_column(X) -> np.ndarray:
    """Contiguous host array: integer columns (token ids, class labels)
    keep exact integers; everything else becomes float32."""
    X = np.asarray(X)
    if np.issubdtype(X.dtype, np.integer):
        return np.ascontiguousarray(X)
    return np.ascontiguousarray(X, dtype=np.float32)


class Dataset:
    """Immutable columnar dataset: named numpy columns of equal length."""

    def __init__(self, columns: Dict[str, np.ndarray]):
        if not columns:
            raise ValueError("Dataset needs at least one column")
        lengths = {k: len(v) for k, v in columns.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"Column length mismatch: {lengths}")
        self._columns = {k: np.asarray(v) for k, v in columns.items()}

    @classmethod
    def from_arrays(cls, features, labels=None, features_col: str = "features",
                    label_col: str = "label") -> "Dataset":
        cols = {features_col: np.asarray(features)}
        if labels is not None:
            cols[label_col] = np.asarray(labels)
        return cls(cols)

    @property
    def columns(self) -> List[str]:
        return list(self._columns)

    def __len__(self) -> int:
        return len(next(iter(self._columns.values())))

    def __getitem__(self, col: str) -> np.ndarray:
        try:
            return self._columns[col]
        except KeyError:
            raise KeyError(f"No column {col!r}; available: {self.columns}")

    def __contains__(self, col: str) -> bool:
        return col in self._columns

    def __repr__(self):
        spec = ", ".join(f"{k}:{v.dtype}{list(v.shape[1:])}"
                         for k, v in self._columns.items())
        return f"Dataset(rows={len(self)}, {spec})"

    def shuffle(self, seed: int = 0) -> "Dataset":
        """One permutation from ``seed`` applied to every column."""
        perm = np.random.RandomState(seed).permutation(len(self))
        return Dataset({k: v[perm] for k, v in self._columns.items()})

    def take(self, n: int) -> "Dataset":
        return Dataset({k: v[:n] for k, v in self._columns.items()})

    def skip(self, n: int) -> "Dataset":
        return Dataset({k: v[n:] for k, v in self._columns.items()})

    def split(self, fraction: float) -> Tuple["Dataset", "Dataset"]:
        n = int(len(self) * fraction)
        return self.take(n), self.skip(n)

    def arrays(self, features_col: str = "features",
               label_col: Optional[str] = "label"):
        X = coerce_column(self[features_col])
        if label_col is None or label_col not in self:
            return X, None
        return X, coerce_column(self[label_col])
