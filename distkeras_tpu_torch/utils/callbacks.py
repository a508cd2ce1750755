"""Keras-style training callbacks at epoch granularity (mirrors
``distkeras_tpu/utils/callbacks.py``).

The port's trainers run an epoch as a loop of steps whose losses stay on
the device until the epoch ends, so callbacks run once an epoch, after
that one device-to-host read: a per-step host callback would sync the
device every step. The contract is JAX's:

* ``logs`` handed to ``on_epoch_end`` holds Python floats: ``loss`` (the
  epoch mean), each configured metric's epoch mean, and the ``val_*``
  entries when the trainer has ``validation_data``;
* a callback reads the weights through ``trainer.get_weights() ->
  (params, state)`` (host numpy trees) and replaces the ones the trainer
  returns with ``trainer.set_weights(params, state)``;
* ``trainer.stop_training = True`` ends training after the current epoch
  (the distributed trainers stop every worker: the center is shared).
"""

from __future__ import annotations

import csv
import math
import os
import warnings
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from distkeras_tpu_torch.utils.tree import tree_map


class Callback:
    """Base class: subclasses override any of the hooks."""

    trainer = None

    def set_trainer(self, trainer) -> None:
        self.trainer = trainer

    def on_train_begin(self, logs: Optional[Dict] = None) -> None:
        pass

    def on_epoch_end(self, epoch: int, logs: Optional[Dict] = None) -> None:
        pass

    def on_train_end(self, logs: Optional[Dict] = None) -> None:
        pass


class CallbackList:
    """The dispatcher the trainers drive (not user-facing)."""

    def __init__(self, callbacks: Sequence[Callback], trainer):
        self.callbacks = list(callbacks)
        self.trainer = trainer
        self._ended = False
        for cb in self.callbacks:
            if not isinstance(cb, Callback):
                raise TypeError(
                    f"callbacks must be utils.callbacks.Callback instances, "
                    f"got {type(cb).__name__}")
            cb.set_trainer(trainer)

    def train_begin(self) -> None:
        for cb in self.callbacks:
            cb.on_train_begin({})

    def epoch_end(self, epoch: int, logs: Dict) -> None:
        for cb in self.callbacks:
            cb.on_epoch_end(epoch, dict(logs))

    def train_end(self, logs: Optional[Dict] = None) -> None:
        """Idempotent (the trainers call it from ``finally``, so open log
        files close on the exception path too). Afterwards the trainer's
        weight accessors are cleared: a ``get_weights()`` after
        ``train()`` fails loudly."""
        if self._ended:
            return
        self._ended = True
        first_err = None
        for cb in self.callbacks:   # one failing hook must not leak the rest
            try:
                cb.on_train_end(dict(logs or {}))
            except BaseException as e:  # lint: allow-swallow — re-raised
                if first_err is None:
                    first_err = e
        self.trainer._weights_fn = None
        if first_err is not None:
            raise first_err


def _monitor_value(logs: Dict, monitor: str) -> Optional[float]:
    if monitor in logs:
        return float(logs[monitor])
    return None


def _improved(value: float, best: float, mode: str, min_delta: float) -> bool:
    if mode == "min":
        return value < best - min_delta
    return value > best + min_delta


def _infer_mode(monitor: str, mode: str) -> str:
    if mode in ("min", "max"):
        return mode
    if mode != "auto":
        raise ValueError(f"mode must be 'auto', 'min' or 'max', got {mode!r}")
    # accuracy-like monitors go up; losses and errors go down
    up = ("acc", "accuracy", "auc", "precision", "recall", "f1", "top")
    name = monitor.rsplit("val_", 1)[-1]
    return "max" if any(k in name for k in up) else "min"


class EarlyStopping(Callback):
    """Stop when ``monitor`` has not improved for ``patience`` epochs.
    ``restore_best_weights`` hands the best epoch's weights (host
    copies, one device-to-host read an improving epoch) back to the
    trainer at the end of training."""

    def __init__(self, monitor: str = "val_loss", min_delta: float = 0.0,
                 patience: int = 0, mode: str = "auto",
                 restore_best_weights: bool = False, verbose: bool = False):
        self.monitor = monitor
        self.min_delta = abs(float(min_delta))
        self.patience = int(patience)
        self.mode = _infer_mode(monitor, mode)
        self.restore_best_weights = bool(restore_best_weights)
        self.verbose = bool(verbose)

    def on_train_begin(self, logs=None):
        self.best = math.inf if self.mode == "min" else -math.inf
        self.wait = 0
        self.best_epoch = -1
        self.best_weights = None
        self.stopped_epoch = -1

    def on_epoch_end(self, epoch, logs=None):
        value = _monitor_value(logs or {}, self.monitor)
        if value is None:
            raise KeyError(
                f"EarlyStopping monitor {self.monitor!r} not in epoch logs "
                f"{sorted((logs or {}))}; configure the trainer's metrics/"
                "validation_data to produce it")
        if _improved(value, self.best, self.mode, self.min_delta):
            self.best, self.best_epoch, self.wait = value, epoch, 0
            if self.restore_best_weights:
                self.best_weights = self.trainer.get_weights()
        else:
            self.wait += 1
            if self.wait >= self.patience:  # Keras: patience bad epochs
                self.stopped_epoch = epoch
                self.trainer.stop_training = True

    def on_train_end(self, logs=None):
        if self.restore_best_weights and self.best_weights is not None:
            self.trainer.set_weights(*self.best_weights)
        if self.verbose and self.stopped_epoch >= 0:
            print(f"EarlyStopping: stopped at epoch {self.stopped_epoch} "
                  f"(best {self.monitor}={self.best:.6g} "
                  f"@ epoch {self.best_epoch})")


class ModelCheckpoint(Callback):
    """Save the model to ``filepath`` each epoch (or only on
    improvement). ``filepath`` may hold ``{epoch}`` and any logs key,
    e.g. ``"ckpt-{epoch:03d}-{val_loss:.3f}.dkt"``. The files are the
    JAX package's model files (``models.serialization.save_model``),
    which ``load_model`` of either package reads. (The trainers'
    ``checkpoint_dir`` is another thing: raw training state for a
    resume.)"""

    def __init__(self, filepath: str, monitor: str = "val_loss",
                 save_best_only: bool = False, mode: str = "auto",
                 verbose: bool = False):
        self.filepath = str(filepath)
        self.monitor = monitor
        self.save_best_only = bool(save_best_only)
        self.mode = _infer_mode(monitor, mode)
        self.verbose = bool(verbose)

    def on_train_begin(self, logs=None):
        self.best = math.inf if self.mode == "min" else -math.inf

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        if self.save_best_only:
            value = _monitor_value(logs, self.monitor)
            if value is None:
                raise KeyError(
                    f"ModelCheckpoint monitor {self.monitor!r} not in epoch "
                    f"logs {sorted(logs)}")
            if not _improved(value, self.best, self.mode, 0.0):
                return
            self.best = value
        model = self.trainer.snapshot_model()
        path = self.filepath.format(epoch=epoch, **logs)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        from distkeras_tpu_torch.models.serialization import save_model
        save_model(model, path)
        if self.verbose:
            print(f"ModelCheckpoint: wrote {path}")


class CSVLogger(Callback):
    """Append one row an epoch (``epoch`` and the sorted logs keys) to a
    CSV file."""

    def __init__(self, filename: str, append: bool = False):
        self.filename = str(filename)
        self.append = bool(append)
        self._file = None
        self._writer = None

    def on_train_begin(self, logs=None):
        d = os.path.dirname(self.filename)
        if d:
            os.makedirs(d, exist_ok=True)
        # appending to a file with content: its header is already there
        self._has_header = (self.append and os.path.exists(self.filename)
                            and os.path.getsize(self.filename) > 0)
        self._file = open(self.filename, "a" if self.append else "w",
                          newline="")
        self._writer = None  # the header's keys are the first epoch's

    def on_epoch_end(self, epoch, logs=None):
        if self._file is None:
            return
        logs = logs or {}
        if self._writer is None:
            self._keys = sorted(logs)
            self._writer = csv.writer(self._file)
            if not self._has_header:
                self._writer.writerow(["epoch"] + self._keys)
        self._writer.writerow(
            [epoch] + [logs.get(k, "") for k in self._keys])
        self._file.flush()

    def on_train_end(self, logs=None):
        if self._file is not None:
            self._file.close()
            self._file = None


class TensorBoardLogger(Callback):
    """Per-epoch scalars as TensorBoard event files, written through
    ``torch.utils.tensorboard`` (JAX writes them with ``tf.summary``).
    Without the ``tensorboard`` package it warns and writes nothing, as
    JAX's does without TensorFlow."""

    def __init__(self, log_dir: str):
        self.log_dir = str(log_dir)
        self._writer = None

    def on_train_begin(self, logs=None):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            warnings.warn("TensorBoardLogger: tensorboard not available; "
                          "no event files will be written", stacklevel=2)
            return
        self._writer = SummaryWriter(self.log_dir)

    def on_epoch_end(self, epoch, logs=None):
        if self._writer is None:
            return
        for key, value in sorted((logs or {}).items()):
            try:
                self._writer.add_scalar(key, float(value), epoch)
            except (TypeError, ValueError):
                continue  # non-scalar log entries are skipped
        self._writer.flush()

    def on_train_end(self, logs=None):
        if self._writer is not None:
            self._writer.close()
            self._writer = None


class TerminateOnNaN(Callback):
    """Stop training as soon as the epoch loss is NaN or infinite."""

    def on_epoch_end(self, epoch, logs=None):
        loss = (logs or {}).get("loss")
        if loss is not None and not np.isfinite(loss):
            print(f"TerminateOnNaN: non-finite loss {loss} at epoch {epoch}")
            self.trainer.stop_training = True


class EMAWeights(Callback):
    """An exponential moving average of the weights across EPOCHS,
    installed on the trained model at the end (``install=False`` only
    exposes it on ``.ema_weights``). With E epochs an epoch decay of
    ``decay`` acts like a per-step decay of ``decay ** (1 /
    steps_per_epoch)``."""

    def __init__(self, decay: float = 0.9, install: bool = True):
        if not 0.0 < decay < 1.0:
            raise ValueError(f"decay must be in (0, 1), got {decay}")
        self.decay = float(decay)
        self.install = bool(install)

    def on_train_begin(self, logs=None):
        self.ema_weights = None
        if self.install:
            clash = [cb for cb in self.trainer.callbacks
                     if isinstance(cb, EarlyStopping)
                     and cb.restore_best_weights]
            if clash:
                raise ValueError(
                    "EMAWeights(install=True) and EarlyStopping("
                    "restore_best_weights=True) both replace the final "
                    "weights — whichever runs last silently wins. Pick "
                    "one, or use EMAWeights(install=False) and read "
                    ".ema_weights yourself")

    def on_epoch_end(self, epoch, logs=None):
        params, state = self.trainer.get_weights()
        if self.ema_weights is None:
            self.ema_weights = (params, state)
            return
        d = self.decay

        def mix(a, b):
            a = np.asarray(a)
            if not np.issubdtype(a.dtype, np.floating):
                return b  # counters track the live value
            return (d * a + (1 - d) * np.asarray(b)).astype(a.dtype)

        ep, es = self.ema_weights
        self.ema_weights = (tree_map(mix, ep, params),
                            tree_map(mix, es, state))

    def on_train_end(self, logs=None):
        if self.install and self.ema_weights is not None:
            self.trainer.set_weights(*self.ema_weights)


class LambdaCallback(Callback):
    """Ad-hoc hooks: ``LambdaCallback(on_epoch_end=lambda e, logs: ...)``."""

    def __init__(self,
                 on_train_begin: Optional[Callable] = None,
                 on_epoch_end: Optional[Callable] = None,
                 on_train_end: Optional[Callable] = None):
        self._begin = on_train_begin
        self._epoch = on_epoch_end
        self._end = on_train_end

    def on_train_begin(self, logs=None):
        if self._begin:
            self._begin(logs)

    def on_epoch_end(self, epoch, logs=None):
        if self._epoch:
            self._epoch(epoch, logs)

    def on_train_end(self, logs=None):
        if self._end:
            self._end(logs)
