"""Training history and wall-clock bookkeeping (a copy of
``distkeras_tpu/utils/history.py`` with no JAX in it): a plain dict of
numpy arrays per epoch, filled from one device-to-host read per epoch.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from distkeras_tpu_torch.utils.profiling import wall


class History:
    """Per-run training record: loss per step, epoch boundaries,
    wall-clock timings."""

    def __init__(self):
        self.epochs: List[Dict[str, np.ndarray]] = []
        self._start: Optional[float] = None
        self._stop: Optional[float] = None

    # -- wall clock -------------------------------------------------------
    def record_training_start(self) -> None:
        self._start = wall()

    def record_training_stop(self) -> None:
        self._stop = wall()

    def get_training_time(self) -> float:
        if self._start is None:
            return 0.0
        end = self._stop if self._stop is not None else wall()
        return end - self._start

    # -- metrics ----------------------------------------------------------
    def append_epoch(self, **metrics: np.ndarray) -> None:
        self.epochs.append({k: np.asarray(v) for k, v in metrics.items()})

    def losses(self) -> np.ndarray:
        """All per-step losses, concatenated across epochs."""
        if not self.epochs:
            return np.array([])
        return np.concatenate([e["loss"] for e in self.epochs], axis=0)

    def metric(self, name: str) -> np.ndarray:
        """Per-step values of a named training metric, concatenated across
        epochs."""
        if not self.epochs:
            return np.array([])
        missing = [i for i, e in enumerate(self.epochs) if name not in e]
        if missing:
            raise KeyError(
                f"metric {name!r} not recorded (have: "
                f"{self.metric_names()})")
        return np.concatenate([e[name] for e in self.epochs], axis=0)

    def metric_names(self) -> List[str]:
        """Recorded training metrics (loss is tracked by ``losses()``)."""
        if not self.epochs:
            return []
        return sorted(k for k in self.epochs[0] if k != "loss")

    def final_loss(self) -> float:
        losses = self.losses()
        if losses.size == 0:
            return float("nan")
        tail = losses[-max(1, len(losses) // 10):]
        return float(np.mean(tail))

    def steps_per_second(self) -> float:
        t = self.get_training_time()
        n = sum(len(e["loss"]) for e in self.epochs)
        return n / t if t > 0 else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "training_time": self.get_training_time(),
            "num_epochs": len(self.epochs),
            "num_steps": int(sum(len(e["loss"]) for e in self.epochs)),
            "final_loss": self.final_loss(),
            "steps_per_second": self.steps_per_second(),
        }
