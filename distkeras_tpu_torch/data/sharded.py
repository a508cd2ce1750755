"""Out-of-core datasets: a sequence of ``Dataset`` shards loaded one at
a time (mirrors ``distkeras_tpu/data/sharded.py``).

The trainers run their epoch over one shard while the next is loaded and
stacked on a background thread (``utils.prefetch``), so host memory
holds about two shards whatever the total. Shuffling is a per-epoch
shard order plus a row permutation within each shard, from JAX's
formulas (``shard_order``: ``RandomState(seed + 7919 * (epoch + 1))``),
so both packages visit the same batches.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from distkeras_tpu_torch.data.dataset import Dataset


class ShardedDataset:
    """A lazily loaded sequence of ``Dataset`` shards. ``sources``
    entries may be a ``Dataset``, a path (``.npz`` with one array per
    column, or ``.csv``) or a zero-argument callable returning a
    ``Dataset``."""

    def __init__(self, sources: Sequence[Union[Dataset, str, Callable]],
                 csv_kwargs: Optional[dict] = None):
        if not sources:
            raise ValueError("ShardedDataset needs at least one shard")
        self.sources = list(sources)
        self.csv_kwargs = dict(csv_kwargs or {})

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_files(cls, paths: Sequence[str], **csv_kwargs):
        """npz/csv shard files (e.g. ``sorted(glob.glob("train-*.npz"))``)."""
        missing = [p for p in paths if not os.path.exists(p)]
        if missing:
            raise FileNotFoundError(f"shard files not found: {missing[:3]}")
        return cls(list(paths), csv_kwargs=csv_kwargs)

    @classmethod
    def from_datasets(cls, datasets: Sequence[Dataset]):
        return cls(list(datasets))

    @classmethod
    def write(cls, dataset: Dataset, directory: str, num_shards: int,
              prefix: str = "shard") -> "ShardedDataset":
        """Split an in-memory ``Dataset`` into ``num_shards`` npz files
        under ``directory`` (JAX's names and split points) and return the
        ShardedDataset over them."""
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        n = len(dataset)
        if n < num_shards:
            raise ValueError(
                f"cannot split {n} rows into {num_shards} shards")
        os.makedirs(directory, exist_ok=True)
        bounds = np.linspace(0, n, num_shards + 1).astype(int)
        paths = []
        for i in range(num_shards):
            sl = slice(bounds[i], bounds[i + 1])
            path = os.path.join(directory,
                                f"{prefix}-{i:05d}-of-{num_shards:05d}.npz")
            np.savez(path, **{c: dataset[c][sl] for c in dataset.columns})
            paths.append(path)
        return cls.from_files(paths)

    # -- access -------------------------------------------------------------
    @property
    def num_shards(self) -> int:
        return len(self.sources)

    def load_shard(self, i: int) -> Dataset:
        src = self.sources[i]
        if isinstance(src, Dataset):
            return src
        if callable(src):
            out = src()
            if not isinstance(out, Dataset):
                raise TypeError(
                    f"shard loader {i} returned {type(out).__name__}, "
                    "expected Dataset")
            return out
        path = str(src)
        if path.endswith(".npz"):
            with np.load(path) as z:
                return Dataset({k: z[k] for k in z.files})
        if path.endswith(".csv"):
            return Dataset.from_csv(path, **self.csv_kwargs)
        raise ValueError(
            f"unrecognized shard source {path!r} (expected .npz, .csv, "
            "Dataset, or callable)")

    def shard_order(self, epoch: int, seed: int,
                    shuffle: bool) -> List[int]:
        """The epoch's deterministic shard visit order (JAX :113)."""
        if not shuffle or self.num_shards == 1:
            return list(range(self.num_shards))
        rs = np.random.RandomState(seed + 7919 * (epoch + 1))
        return list(rs.permutation(self.num_shards))

    def epoch_items(self, start_epoch: int, num_epoch: int, seed: int,
                    shuffle: bool) -> List[tuple]:
        """The flat ``(epoch, shard_idx, is_epoch_last)`` visit sequence
        of epochs ``[start_epoch, num_epoch)``: one prefetch stream
        iterates it across epoch boundaries (JAX :121)."""
        items = []
        for e in range(start_epoch, num_epoch):
            order = self.shard_order(e, seed, shuffle)
            items += [(e, si, i == len(order) - 1)
                      for i, si in enumerate(order)]
        return items

    # deliberately no __len__: shards load lazily, so there is no cheap
    # global length (and ``if sds:`` stays true)

    def __repr__(self):
        return f"ShardedDataset(num_shards={self.num_shards})"
