"""Real digit data for convergence checks (the port's copy of
``distkeras_tpu/data/real.py``: ``RealDataset``, ``load_real_digits``
:50). Sources, in this order:

  1. a local MNIST npz (``DKT_MNIST_NPZ``, or ``data/mnist.npz`` under
     the repo root) with ``x_train, y_train, x_test, y_test`` in the
     Keras layout;
  2. the UCI handwritten digits bundled with scikit-learn (1,797 real
     8x8 scans);
  3. a deterministic synthetic set, named ``"synthetic"`` so that a
     check can tell (``is_real`` is False).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np


class RealDataset(NamedTuple):
    x_train: np.ndarray  # [N, d] float32 in [0, 1]
    y_train: np.ndarray  # [N] int64
    x_test: np.ndarray
    y_test: np.ndarray
    name: str            # "mnist" | "sklearn-digits" | "synthetic"
    num_classes: int

    @property
    def is_real(self) -> bool:
        return self.name != "synthetic"


def _local_mnist_path() -> str:
    env = os.environ.get("DKT_MNIST_NPZ")
    if env:
        return env
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo_root, "data", "mnist.npz")


def load_real_digits(test_fraction: float = 0.2,
                     seed: int = 0) -> RealDataset:
    """Best available REAL digit-classification data (see module doc)."""
    path = _local_mnist_path()
    if os.path.exists(path):
        with np.load(path) as d:
            xtr = (d["x_train"].reshape(len(d["x_train"]), -1)
                   / 255.0).astype(np.float32)
            xte = (d["x_test"].reshape(len(d["x_test"]), -1)
                   / 255.0).astype(np.float32)
            return RealDataset(xtr, d["y_train"].astype(np.int64),
                               xte, d["y_test"].astype(np.int64),
                               "mnist", 10)
    try:
        from sklearn.datasets import load_digits
    except ImportError:
        rs = np.random.RandomState(seed)
        X = rs.rand(2000, 64).astype(np.float32)
        y = (X.sum(axis=1) * 10 / 64).astype(np.int64) % 10
        n = int(len(X) * (1 - test_fraction))
        return RealDataset(X[:n], y[:n], X[n:], y[n:], "synthetic", 10)

    d = load_digits()
    rs = np.random.RandomState(seed)
    perm = rs.permutation(len(d.data))
    X = (d.data[perm] / 16.0).astype(np.float32)
    y = d.target[perm].astype(np.int64)
    n = int(len(X) * (1 - test_fraction))
    return RealDataset(X[:n], y[:n], X[n:], y[n:], "sklearn-digits", 10)
