"""Trainers of the port: the ``Trainer`` base and ``SingleTrainer``.

Mirrors ``distkeras_tpu/parallel/trainers.py``: the constructor
(:107-212) for the options this slice supports and
``SingleTrainer.train`` (:524-672). The constructor keeps the
reference's ergonomics (``(model, worker_optimizer, loss, batch_size,
num_epoch, features_col, label_col, ...)``) and ``train(dataset)``
returns the model, trained IN PLACE on the model's device (the CUDA
card, or the CPU for a model built with ``device="cpu"``).

The epoch shuffle is exactly the JAX package's
``np.random.RandomState(seed + 1000 * epoch).permutation(n)``, so both
see the same batches. The options that wait for a later slice raise
``NotImplementedError`` naming the ROADMAP item: ``checkpoint_dir``,
``resume``, ``checkpoint_async``, ``callbacks``, ``profile_dir``,
``class_weight``, ``fused_vocab_head``, ``telemetry`` and
``ShardedDataset`` input. The distributed family and
``EnsembleTrainer`` are later slices too.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from distkeras_tpu_torch.compat import resolve_device
from distkeras_tpu_torch.data.dataset import Dataset, coerce_column
from distkeras_tpu_torch.ops import prng
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.ops.metrics import get_metric, metric_name
from distkeras_tpu_torch.ops.optimizers import (Optimizer,
                                                clip_by_global_norm,
                                                get_optimizer)
from distkeras_tpu_torch.parallel.worker import (LATER, TrainCarry,
                                                 make_train_step, run_epoch,
                                                 stack_batches)
from distkeras_tpu_torch.utils.history import History


class Trainer:
    """Base trainer: the master model, loss/optimizer spec and history."""

    def __init__(self, keras_model,
                 worker_optimizer: Union[str, Optimizer] = "sgd",
                 loss: Union[str, Callable] = "categorical_crossentropy",
                 metrics: Optional[List[str]] = None,
                 features_col: str = "features", label_col: str = "label",
                 batch_size: int = 32, num_epoch: int = 1,
                 learning_rate: Optional[float] = None, seed: int = 0,
                 shuffle_each_epoch: bool = True,
                 optimizer_kwargs: Optional[dict] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1, resume: bool = False,
                 checkpoint_async: bool = False,
                 profile_dir: Optional[str] = None,
                 grad_accum_steps: int = 1,
                 validation_data=None,
                 callbacks: Optional[Sequence] = None,
                 clip_grad_norm: Optional[float] = None,
                 class_weight: Optional[dict] = None,
                 fused_vocab_head: bool = False,
                 telemetry=None):
        later = {"checkpoint_dir": checkpoint_dir is not None,
                 "resume": bool(resume),
                 "checkpoint_async": bool(checkpoint_async),
                 "profile_dir": profile_dir is not None,
                 "callbacks": bool(callbacks),
                 "class_weight": class_weight is not None,
                 "fused_vocab_head": bool(fused_vocab_head),
                 # None / False: no telemetry tape (the port has no obs
                 # layer yet); a tape object asks for one
                 "telemetry": telemetry not in (None, False)}
        for name, given in later.items():
            if given:
                raise NotImplementedError(
                    f"{name} is not ported yet: {LATER}")
        self.master_model = keras_model
        opt_kwargs = dict(optimizer_kwargs or {})
        if learning_rate is not None and not isinstance(worker_optimizer,
                                                        Optimizer):
            opt_kwargs.setdefault("learning_rate", learning_rate)
        self.worker_optimizer = get_optimizer(worker_optimizer, **opt_kwargs)
        if clip_grad_norm is not None:
            self.worker_optimizer = clip_by_global_norm(
                self.worker_optimizer, clip_grad_norm)
        self.loss = get_loss(loss)
        self.metrics = metrics or []
        self.features_col = features_col
        self.label_col = label_col
        self.batch_size = int(batch_size)
        self.num_epoch = int(num_epoch)
        self.seed = int(seed)
        self.shuffle_each_epoch = bool(shuffle_each_epoch)
        self.grad_accum_steps = int(grad_accum_steps)
        self.validation_data = validation_data
        self.history = History()

    # -- reference-parity bookkeeping -------------------------------------
    def record_training_start(self):
        self.history.record_training_start()

    def record_training_stop(self):
        self.history.record_training_stop()

    def get_training_time(self) -> float:
        return self.history.get_training_time()

    def get_history(self) -> History:
        return self.history

    def _metric_fns(self):
        """``{name: fn}`` for the constructor's ``metrics``, or None."""
        if not self.metrics:
            return None
        return {metric_name(m): get_metric(m) for m in self.metrics}

    # -- data ---------------------------------------------------------------
    def _training_arrays(self, dataset):
        if not isinstance(dataset, Dataset):
            raise NotImplementedError(
                f"{type(dataset).__name__} input is not ported yet (only an "
                f"in-memory Dataset; ShardedDataset is later): {LATER}")
        X, y = dataset.arrays(self.features_col, self.label_col)
        if y is None:
            raise ValueError(
                f"label column {self.label_col!r} not in dataset "
                f"(columns: {dataset.columns})")
        return X, y

    def _epoch_perm(self, epoch: int, n: int):
        if not self.shuffle_each_epoch:
            return None
        return np.random.RandomState(self.seed + 1000 * epoch).permutation(n)

    def _make_validator(self, model, device):
        """Full-set evaluation after each epoch: ``{"val_loss": [x],
        "val_<metric>": [x]}`` as float arrays, or None without
        ``validation_data``. The validation set goes to the device once."""
        vd = self.validation_data
        if vd is None:
            return None
        if isinstance(vd, Dataset):
            Xv, yv = vd.arrays(self.features_col, self.label_col)
        else:
            Xv, yv = (coerce_column(a) for a in vd)
        Xv = torch.from_numpy(Xv).to(device)
        yv = torch.from_numpy(yv).to(device)
        metric_fns = self._metric_fns() or {}

        @torch.no_grad()
        def validate():
            out = model.module.apply(model.params, Xv)
            res = {"val_loss": self.loss(yv, out)}
            for name, fn in metric_fns.items():
                res[f"val_{name}"] = fn(yv, out)
            return {k: np.asarray([float(v)]) for k, v in res.items()}

        return validate

    def train(self, dataset):
        raise NotImplementedError


class SingleTrainer(Trainer):
    """Single-device training: each epoch is a loop of ``make_train_step``
    over the shuffled, stacked batches, on the model's device."""

    def train(self, dataset):
        model = self.master_model
        device = resolve_device(model.device)
        X, y = self._training_arrays(dataset)
        step = make_train_step(model.module, self.loss,
                               self.worker_optimizer, self._metric_fns(),
                               self.grad_accum_steps)
        # the key chain starts from PRNGKey(seed) (JAX :550)
        carry = TrainCarry(model.params,
                           self.worker_optimizer.init(model.params),
                           prng.key(self.seed, device))
        validate = self._make_validator(model, device)
        self.record_training_start()
        try:
            for epoch in range(self.num_epoch):
                Xs, Ys, _ = stack_batches(X, y, self.batch_size,
                                          self._epoch_perm(epoch, len(X)))
                carry, losses, mets = run_epoch(
                    step, carry, torch.from_numpy(Xs).to(device),
                    torch.from_numpy(Ys).to(device))
                # the epoch's one device-to-host read
                logs = {"loss": losses.cpu().numpy(),
                        **{k: v.cpu().numpy() for k, v in mets.items()}}
                if validate is not None:
                    logs.update(validate())
                self.history.append_epoch(**logs)
        finally:
            self.record_training_stop()
        return model
