"""Dataset adapters: the columnar ``Dataset`` from other sources (the
port's copy of ``distkeras_tpu/data/adapters.py``: ``from_iterable``
:35, ``from_torch`` :77, ``_looks_batched``).

  * ``from_iterable``: any iterable of ``(features, label)`` tuples,
    ``{col: value}`` dicts or bare feature rows;
  * ``from_torch``: a ``torch.utils.data.Dataset`` or ``DataLoader``
    (batched, ``batch_size=None`` or ``batch_sampler=``). Tensors are
    copied to host numpy columns, from the card too.

Every adapter materializes contiguous columns: the trainers stack whole
epochs ``[steps, batch, ...]``, not per-row iterators. Unbounded
streams go through ``inference.StreamingPredictor``.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional

import numpy as np

from distkeras_tpu_torch.data.dataset import Dataset


def _to_numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):      # torch tensor, on any device
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def from_iterable(rows: Iterable[Any], features_col: str = "features",
                  label_col: str = "label") -> Dataset:
    """Iterable of rows -> columnar Dataset. Row forms (must be uniform):

      * TUPLE ``(features, label)`` — a labeled example;
      * ``{col: value}`` dict — arbitrary named columns
        (``Dataset.from_records`` semantics);
      * anything else (ndarray, list, torch tensor, scalar) — one feature
        row. A 2-element LIST is a 2-feature row, not a pair — only tuples
        are treated as (features, label), so feature vectors are never
        silently split into a bogus label column.
    """
    feats, labels, records = [], [], []
    for row in rows:
        if isinstance(row, dict):
            records.append({k: _to_numpy(v) for k, v in row.items()})
        elif isinstance(row, tuple):
            if len(row) != 2:
                raise ValueError(
                    f"tuple rows must be (features, label) pairs, got a "
                    f"{len(row)}-tuple")
            feats.append(_to_numpy(row[0]))
            labels.append(_to_numpy(row[1]))
        else:
            feats.append(_to_numpy(row))
        if records and (feats or labels):
            raise ValueError(
                "mixed dict and non-dict rows — use one row form for the "
                "whole iterable")
    if records:
        return Dataset.from_records(records)
    if not feats:
        raise ValueError("empty iterable")
    cols = {features_col: np.stack(feats)}
    if labels:
        if len(labels) != len(feats):
            raise ValueError(
                "mixed (features, label) pairs and bare feature rows")
        cols[label_col] = np.stack(labels)
    return Dataset(cols)


def from_torch(source, features_col: str = "features",
               label_col: str = "label",
               limit: Optional[int] = None) -> Dataset:
    """``torch.utils.data.Dataset`` / ``DataLoader`` -> columnar Dataset.

    DataLoader batches are concatenated back into flat columns (so the
    loader's own batch size is irrelevant — trainers re-batch). ``limit``
    caps the number of EXAMPLES taken (useful for huge map-style datasets).
    """
    feats, labels, n = [], [], 0
    batched = _looks_batched(source)

    def push(f, l=None):
        nonlocal n
        f = _to_numpy(f)
        if batched:
            feats.append(f)
            n += len(f)
        else:
            feats.append(f[None])
            n += 1
        if l is not None:
            l = _to_numpy(l)
            labels.append(l if batched else l[None])

    for item in source:
        if isinstance(item, (tuple, list)) and len(item) == 2:
            push(item[0], item[1])
        else:
            push(item)
        if limit is not None and n >= limit:
            break

    if not feats:
        raise ValueError("empty torch source")
    cols = {features_col: np.concatenate(feats)[:limit]}
    if labels:
        cols[label_col] = np.concatenate(labels)[:limit]
    return Dataset(cols)


def _looks_batched(source) -> bool:
    """DataLoaders yield batches — unless constructed with
    ``batch_size=None`` (sample mode); map-style Datasets yield rows.
    The check is on ``batch_sampler``: PyTorch creates one for any batched
    loader (including explicit ``batch_sampler=...``, whose ``.batch_size``
    attribute is None) and leaves it None only in sample mode."""
    if any(c.__name__ == "DataLoader" for c in type(source).__mro__):
        return getattr(source, "batch_sampler", None) is not None
    return False
