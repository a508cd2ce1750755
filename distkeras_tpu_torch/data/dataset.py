"""Columnar dataset: named numpy columns of equal length (the port's copy
of ``distkeras_tpu/data/dataset.py``, numpy only). Batches are slices of
contiguous columns shaped ``[batch, ...]``; the CSV parse, the shuffle
and ``filter`` go through the host library (``data.native``) as JAX's
do. Out-of-core shards of datasets are ``data.sharded.ShardedDataset``.
"""

from __future__ import annotations

from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

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

    @classmethod
    def from_records(cls, records: Sequence[Dict]) -> "Dataset":
        """List-of-dicts (row) input -> columnar storage."""
        if not records:
            raise ValueError("empty records")
        keys = records[0].keys()
        return cls({k: np.asarray([r[k] for r in records]) for k in keys})

    @classmethod
    def from_csv(cls, path, *, label_col_index: Optional[int] = None,
                 sep: str = ",", skip_header: bool = False,
                 features_col: str = "features",
                 label_col: str = "label") -> "Dataset":
        """Numeric CSV through ``native.read_csv`` (JAX :64): tabs
        separate fields whatever ``sep`` is, a trailing separator adds no
        field, an empty file is ``(0, 0)``. With ``label_col_index``
        that column becomes the integer labels and the rest the features
        matrix."""
        from distkeras_tpu_torch.data import native
        data = native.read_csv(path, sep=sep, skip_header=skip_header)
        if label_col_index is None:
            return cls({features_col: data})
        y = data[:, label_col_index].astype(np.int64)
        X = np.ascontiguousarray(
            np.delete(data, label_col_index, axis=1), dtype=np.float32)
        return cls({features_col: X, label_col: y})

    @classmethod
    def from_pandas(cls, df) -> "Dataset":
        """pandas DataFrame -> Dataset: one column per frame column
        (object/string columns stay numpy object arrays for the
        StringIndexer/Hashing transformers)."""
        return cls({str(c): np.asarray(df[c].to_numpy())
                    for c in df.columns})

    @classmethod
    def from_parquet(cls, path, columns: Optional[Sequence[str]] = None
                     ) -> "Dataset":
        """Parquet through pyarrow (imported here, as JAX's does).
        List-valued columns become 2-D feature matrices."""
        import pyarrow.parquet as pq

        table = pq.read_table(path, columns=list(columns) if columns
                              else None)
        out = {}
        for name in table.column_names:
            col = table.column(name)
            arr = col.to_numpy(zero_copy_only=False)
            if arr.dtype == object and len(arr) and isinstance(
                    arr[0], np.ndarray):
                arr = np.stack(arr)  # fixed-size list column -> matrix
            out[name] = arr
        return cls(out)

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

    def select(self, cols: Sequence[str]) -> "Dataset":
        return Dataset({c: self[c] for c in cols})

    def with_column(self, name: str, values: np.ndarray) -> "Dataset":
        """A dataset with the column ``name`` added (or replaced)."""
        cols = dict(self._columns)
        cols[name] = np.asarray(values)
        return Dataset(cols)

    def drop(self, name: str) -> "Dataset":
        cols = {k: v for k, v in self._columns.items() if k != name}
        return Dataset(cols)

    def shuffle(self, seed: int = 0) -> "Dataset":
        """One permutation from ``seed`` applied to every column (the
        multithreaded native gather on large columns)."""
        from distkeras_tpu_torch.data import native
        perm = np.random.RandomState(seed).permutation(len(self))
        return Dataset({k: native.gather(v, perm)
                        for k, v in self._columns.items()})

    def filter(self, mask) -> "Dataset":
        """Row subset by a boolean mask: a length-N bool array or a
        callable ``Dataset -> bool array``
        (``ds.filter(lambda d: d["label"] == 1)``)."""
        if callable(mask):
            mask = mask(self)
        mask = np.asarray(mask)
        if mask.dtype != np.bool_ or mask.shape != (len(self),):
            raise ValueError(
                f"filter mask must be bool[{len(self)}], got "
                f"{mask.dtype}{list(mask.shape)}")
        from distkeras_tpu_torch.data import native
        idx = np.flatnonzero(mask)  # multithreaded gather, as shuffle does
        return Dataset({k: native.gather(v, idx)
                        for k, v in self._columns.items()})

    def take(self, n: int) -> "Dataset":
        return Dataset({k: v[:n] for k, v in self._columns.items()})

    def skip(self, n: int) -> "Dataset":
        return Dataset({k: v[n:] for k, v in self._columns.items()})

    def split(self, fraction: float) -> Tuple["Dataset", "Dataset"]:
        n = int(len(self) * fraction)
        return self.take(n), self.skip(n)

    def map_column(self, col: str, fn: Callable[[np.ndarray], np.ndarray],
                   output_col: Optional[str] = None) -> "Dataset":
        """Vectorized column map: ``fn`` sees the whole column at once."""
        return self.with_column(output_col or col, fn(self[col]))

    def concat(self, other: "Dataset") -> "Dataset":
        if set(self.columns) != set(other.columns):
            raise ValueError("column sets differ")
        return Dataset({k: np.concatenate([self[k], other[k]])
                        for k in self.columns})

    def arrays(self, features_col: str = "features",
               label_col: Optional[str] = "label"):
        X = coerce_column(self[features_col])
        if label_col is None or label_col not in self:
            return X, None
        return X, coerce_column(self[label_col])

    def batches(self, batch_size: int, features_col: str = "features",
                label_col: Optional[str] = "label",
                drop_remainder: bool = True
                ) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
        """Contiguous columnar minibatches ``(xb, yb)``."""
        X, y = self.arrays(features_col, label_col)
        n = len(X)
        end = (n // batch_size) * batch_size if drop_remainder else n
        for i in range(0, end, batch_size):
            xb = X[i:i + batch_size]
            yb = y[i:i + batch_size] if y is not None else None
            yield xb, yb
