"""Feature and label transformers: one vectorized numpy op over a whole
column each (the port's copy of ``distkeras_tpu/data/transformers.py``:
``OneHot`` :30, ``LabelIndex`` :55, ``MinMax`` :79, ``Reshape`` :115,
``Dense`` :134, ``StandardScale`` :161, ``Hashing`` :195,
``StringIndexer`` :262, ``VectorAssembler`` :326). They stay on the
host, as JAX's do; ``OneHot`` and ``MinMax`` run through the host
library (``data.native``). Every transformer is a ``Dataset ->
Dataset`` map (``transform(dataset)``, or the transformer called).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from distkeras_tpu_torch.data.dataset import Dataset


class Transformer:
    """Base: pure ``Dataset -> Dataset`` map (reference:
    ``transformers.py :: Transformer.transform(df)``)."""

    def transform(self, dataset: Dataset) -> Dataset:
        raise NotImplementedError

    def __call__(self, dataset: Dataset) -> Dataset:
        return self.transform(dataset)


class OneHotTransformer(Transformer):
    """Integer label column -> one-hot float vector column.

    Reference parity: ``transformers.py :: OneHotTransformer`` /
    ``utils.to_dense_vector``.
    """

    def __init__(self, output_dim: int, input_col: str = "label",
                 output_col: str = "label_encoded"):
        self.output_dim = int(output_dim)
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, dataset: Dataset) -> Dataset:
        from distkeras_tpu_torch.data import native
        labels = dataset[self.input_col].astype(np.int64).reshape(-1)
        if labels.size and (labels.min() < 0 or
                            labels.max() >= self.output_dim):
            raise ValueError(
                f"labels out of range [0, {self.output_dim}): "
                f"min={labels.min()}, max={labels.max()}")
        return dataset.with_column(
            self.output_col, native.one_hot(labels, self.output_dim))


class LabelIndexTransformer(Transformer):
    """Probability/score vector column -> argmax class index column.

    Reference parity: ``transformers.py :: LabelIndexTransformer`` (the step
    between ``ModelPredictor`` output and ``AccuracyEvaluator`` in every
    example pipeline).
    """

    def __init__(self, output_dim: Optional[int] = None,
                 input_col: str = "prediction",
                 output_col: str = "predicted_index"):
        self.output_dim = output_dim  # kept for API parity; argmax needs none
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, dataset: Dataset) -> Dataset:
        preds = np.asarray(dataset[self.input_col])
        if preds.ndim == 1 or preds.shape[-1] == 1:
            idx = (preds.reshape(len(preds), -1)[:, 0] >= 0.5).astype(np.int64)
        else:
            idx = np.argmax(preds, axis=-1).astype(np.int64)
        return dataset.with_column(self.output_col, idx)


class MinMaxTransformer(Transformer):
    """Rescale a numeric column into ``[o_min, o_max]``.

    Reference parity: ``transformers.py :: MinMaxTransformer`` (used to scale
    pixel values in the MNIST workflow). Ranges may be given (``i_min`` /
    ``i_max``) as in the reference, or inferred from the data.
    """

    def __init__(self, o_min: float = 0.0, o_max: float = 1.0,
                 i_min: Optional[float] = None, i_max: Optional[float] = None,
                 input_col: str = "features",
                 output_col: str = "features_normalized"):
        self.o_min, self.o_max = float(o_min), float(o_max)
        self.i_min, self.i_max = i_min, i_max
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, dataset: Dataset) -> Dataset:
        from distkeras_tpu_torch.data import native
        x = dataset[self.input_col].astype(np.float32)
        x2d = np.ascontiguousarray(x.reshape(len(x), -1))
        if self.i_min is None or self.i_max is None:
            mins, maxs = native.minmax_fit(x2d)
        i_min = np.float32(self.i_min if self.i_min is not None
                           else mins.min())
        i_max = np.float32(self.i_max if self.i_max is not None
                           else maxs.max())
        # global-scalar range (reference semantics): broadcast the scalar
        # over the per-column native rescale kernel
        d = x2d.shape[1]
        out = native.minmax_scale(
            x2d, np.full((d,), i_min, np.float32),
            np.full((d,), i_max, np.float32), self.o_min, self.o_max)
        return dataset.with_column(self.output_col, out.reshape(x.shape))


class ReshapeTransformer(Transformer):
    """Reshape each row of a column (flat pixel vector -> image tensor).

    Reference parity: ``transformers.py :: ReshapeTransformer`` (MNIST 784
    -> 28x28x1 before the CNN examples).
    """

    def __init__(self, input_col: str, output_col: str,
                 shape: Sequence[int]):
        self.input_col = input_col
        self.output_col = output_col
        self.shape = tuple(int(d) for d in shape)

    def transform(self, dataset: Dataset) -> Dataset:
        x = dataset[self.input_col]
        return dataset.with_column(self.output_col,
                                   x.reshape((len(x),) + self.shape))


class DenseTransformer(Transformer):
    """Ensure a column is a dense, contiguous float array.

    Reference parity: ``transformers.py :: DenseTransformer`` (Spark sparse
    vector -> dense vector). Accepts scipy-style sparse matrices or object
    arrays of per-row sparse/list values.
    """

    def __init__(self, input_col: str = "features",
                 output_col: str = "features_dense"):
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, dataset: Dataset) -> Dataset:
        x = dataset[self.input_col]
        if hasattr(x, "toarray"):  # scipy sparse matrix column
            dense = np.asarray(x.toarray(), dtype=np.float32)
        elif x.dtype == object:
            dense = np.stack([
                np.asarray(r.toarray()).reshape(-1)
                if hasattr(r, "toarray") else np.asarray(r, dtype=np.float32)
                for r in x]).astype(np.float32)
        else:
            dense = np.ascontiguousarray(x, dtype=np.float32)
        return dataset.with_column(self.output_col, dense)


class StandardScaleTransformer(Transformer):
    """Zero-mean/unit-variance scaling (capability add beyond the reference's
    MinMax; common preprocessing for the physics examples).

    Spark's StandardScaler is an Estimator: ``fit(train)`` freezes the
    training split's mean/std, and every later call applies THOSE stats —
    so eval data never leaks its own statistics into the transform.
    Unfitted use keeps the old per-dataset behavior."""

    def __init__(self, input_col: str = "features",
                 output_col: str = "features_scaled", epsilon: float = 1e-8):
        self.input_col = input_col
        self.output_col = output_col
        self.epsilon = float(epsilon)
        self.mean_ = None
        self.std_ = None

    def fit(self, dataset: Dataset) -> "StandardScaleTransformer":
        x = dataset[self.input_col].astype(np.float32)
        self.mean_ = x.mean(axis=0, keepdims=True)
        self.std_ = x.std(axis=0, keepdims=True)
        return self

    def transform(self, dataset: Dataset) -> Dataset:
        x = dataset[self.input_col].astype(np.float32)
        if self.mean_ is not None:
            mean, std = self.mean_, self.std_
        else:
            mean = x.mean(axis=0, keepdims=True)
            std = x.std(axis=0, keepdims=True)
        return dataset.with_column(self.output_col,
                                   (x - mean) / (std + self.epsilon))


class HashingTransformer(Transformer):
    """Categorical column(s) -> multi-hot hashed indicator vector.

    The hashing trick for Criteo-style high-cardinality categoricals
    (BASELINE config 4's wide features): each (column, value) pair maps to
    ``crc32(f"{col}={value}") % num_buckets`` — a STABLE hash (unlike
    Python's salted ``hash``), so train- and serve-time encodings agree
    across processes. Works on string or integer columns; the output is a
    float32 ``[n, num_buckets]`` multi-hot matrix suitable as the wide half
    of ``models.blocks.WideAndDeep``.
    """

    def __init__(self, num_buckets: int, input_cols: Sequence[str],
                 output_col: str = "features_hashed"):
        if num_buckets < 1:
            raise ValueError(f"num_buckets must be >= 1, got {num_buckets}")
        self.num_buckets = int(num_buckets)
        self.input_cols = list(input_cols)
        self.output_col = output_col

    def transform(self, dataset: Dataset) -> Dataset:
        import zlib

        n = len(dataset)
        out = np.zeros((n, self.num_buckets), np.float32)
        rows = np.arange(n)
        for col in self.input_cols:
            values = np.asarray(dataset[col])
            prefix = f"{col}=".encode()

            def _hash(v):
                # array-valued rows hash their canonical bytes — str() of an
                # ndarray elides the middle of wide rows ("[0. ... 0.]"), so
                # distinct rows would collide and buckets would depend on
                # numpy print options. Widen to f64/i64 first so the bucket
                # depends on VALUES, not on the column's storage width
                # (train-f32 vs serve-f64 must agree — the class contract).
                if isinstance(v, np.ndarray):
                    if v.dtype.kind == "f":
                        v = v.astype(np.float64)
                    elif v.dtype.kind in "iub":
                        v = v.astype(np.int64)
                    data = np.ascontiguousarray(v).tobytes()
                else:
                    data = str(v).encode()
                return zlib.crc32(prefix + data) % self.num_buckets

            # hash each DISTINCT value once; categorical columns repeat
            # heavily, so this turns O(n) crc32 calls into O(n_unique).
            # Multi-dim columns dedupe whole rows (axis=0); unsortable
            # mixed-type object columns can't go through np.unique at all,
            # so they fall back to the plain per-row loop.
            try:
                uniq, inverse = np.unique(
                    values, return_inverse=True,
                    axis=0 if values.ndim > 1 else None)
            except TypeError:
                buckets = np.fromiter((_hash(v) for v in values),
                                      dtype=np.int64, count=n)
            else:
                uh = np.fromiter((_hash(v) for v in uniq),
                                 dtype=np.int64, count=len(uniq))
                buckets = uh[inverse.reshape(-1)]
            out[rows, buckets] = 1.0
        return dataset.with_column(self.output_col, out)


class StringIndexerTransformer(Transformer):
    """String/categorical column -> integer index column.

    Reference parity: the examples' Spark-ML ``StringIndexer`` stage
    (SURVEY §2.2 — the MNIST/ATLAS workflows run StringIndexer before
    training). Spark semantics kept: indices are assigned by DESCENDING
    frequency (ties broken lexically), so index 0 is the most common
    value. Fit on the training data via ``fit`` (or lazily on first
    transform), then reuse on serve data; unseen values raise by default
    (``handle_invalid="error"``) or get index ``len(labels_)``
    (``"keep"``) — two of Spark's three modes (``"skip"``, which DROPS
    rows, is deliberately unsupported: silent row loss).
    """

    def __init__(self, input_col: str, output_col: Optional[str] = None,
                 handle_invalid: str = "error"):
        if handle_invalid not in ("error", "keep"):
            raise ValueError(
                f"handle_invalid must be 'error' or 'keep', "
                f"got {handle_invalid!r}")
        self.input_col = input_col
        self.output_col = output_col or f"{input_col}_index"
        self.handle_invalid = handle_invalid
        self.labels_ = None  # fitted vocabulary, most-frequent first

    def fit(self, dataset: Dataset) -> "StringIndexerTransformer":
        values = np.asarray(dataset[self.input_col])
        if values.ndim != 1:
            raise ValueError(
                f"StringIndexer expects a 1-D categorical column; "
                f"{self.input_col!r} has shape {values.shape} (index each "
                "sub-column separately)")
        uniq, counts = np.unique(values, return_counts=True)
        # descending count, ascending value on ties (np.unique pre-sorts
        # values, and stable argsort on -counts preserves that order)
        order = np.argsort(-counts, kind="stable")
        self.labels_ = uniq[order]
        self._index = {v: i for i, v in enumerate(self.labels_)}
        return self

    def transform(self, dataset: Dataset) -> Dataset:
        if self.labels_ is None:
            self.fit(dataset)
        values = np.asarray(dataset[self.input_col])
        if values.ndim != 1:
            raise ValueError(
                f"StringIndexer expects a 1-D categorical column; "
                f"{self.input_col!r} has shape {values.shape}")
        unseen = len(self.labels_)
        # map each DISTINCT value once (categoricals repeat heavily), then
        # spread via the inverse — same O(n_unique) pattern as Hashing
        uniq, inverse = np.unique(values, return_inverse=True)
        lut = np.fromiter((self._index.get(v, unseen) for v in uniq),
                          dtype=np.int64, count=len(uniq))
        out = lut[inverse.reshape(-1)]
        if self.handle_invalid == "error" and (out == unseen).any():
            bad = sorted({str(v) for v in values[out == unseen]})[:5]
            raise ValueError(
                f"StringIndexer({self.input_col!r}) saw unseen values "
                f"{bad}; fit on data covering them or use "
                "handle_invalid='keep'")
        return dataset.with_column(self.output_col, out)


class VectorAssemblerTransformer(Transformer):
    """Concatenate feature columns into one flat feature matrix.

    Reference parity: the examples' Spark-ML ``VectorAssembler`` stage
    (SURVEY §2.2) — the step that builds the ``features_col`` every
    trainer consumes. Scalars become width-1 columns; multi-dim columns
    are flattened per row; all inputs are cast to float32.
    """

    def __init__(self, input_cols: Sequence[str],
                 output_col: str = "features"):
        if not input_cols:
            raise ValueError("VectorAssembler needs at least one input_col")
        self.input_cols = list(input_cols)
        self.output_col = output_col

    def transform(self, dataset: Dataset) -> Dataset:
        n = len(dataset)
        parts = []
        for col in self.input_cols:
            v = np.asarray(dataset[col], dtype=np.float32)
            parts.append(v.reshape(n, -1))
        return dataset.with_column(self.output_col,
                                   np.concatenate(parts, axis=1))
