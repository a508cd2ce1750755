"""Trainers of the port: the ``Trainer`` base, ``SingleTrainer`` and
``EnsembleTrainer``.

Mirrors ``distkeras_tpu/parallel/trainers.py``: the constructor
(:107-212) for the options the port supports, the shared epoch-loop
pieces (``val_logs`` :35, ``epoch_exit`` :68, ``request_preempt`` :214,
``_reject_step_options`` :227, ``get_averaged_history`` :325,
``_split_outs`` :343), ``SingleTrainer.train``
(:524-672) and ``EnsembleTrainer`` (:675). The constructor keeps the
reference's ergonomics (``(model, worker_optimizer, loss, batch_size,
num_epoch, features_col, label_col, ...)``) and ``train(dataset)``
returns the model, trained IN PLACE on the model's device (the CUDA
card, or the CPU for a model built with ``device="cpu"``): its
parameters and its model state (BatchNorm's running statistics, which
the validator's eval forward reads). The
distributed family (``distributed``) and ``HostAsyncTrainer``
(``async_host``) share this base.

The epoch shuffle is exactly the JAX package's
``np.random.RandomState(seed + 1000 * epoch).permutation(n)``, so both
see the same batches. The options that wait for a later slice raise
``NotImplementedError`` naming the ROADMAP item: ``checkpoint_dir``,
``resume``, ``checkpoint_async``, ``callbacks``, ``profile_dir``,
``class_weight``, ``fused_vocab_head``, ``telemetry`` and
``ShardedDataset`` input. The flight recorder that JAX's ``epoch_exit``
writes to is ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

import copy
import threading
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from distkeras_tpu_torch.compat import resolve_device
from distkeras_tpu_torch.data.dataset import Dataset, coerce_column
from distkeras_tpu_torch.models.core import Model, eval_mode
from distkeras_tpu_torch.ops import prng
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.ops.metrics import get_metric, metric_name
from distkeras_tpu_torch.ops.optimizers import (Optimizer,
                                                clip_by_global_norm,
                                                get_optimizer)
from distkeras_tpu_torch.parallel.engine import (WorkerStack, stack_outputs,
                                                 stacked_opt_init)
from distkeras_tpu_torch.parallel.worker import (LATER, TrainCarry,
                                                 make_train_step, run_epoch,
                                                 stack_batches)
from distkeras_tpu_torch.utils.history import History
from distkeras_tpu_torch.utils.tree import tree_map


def val_logs(values) -> dict:
    """Validator outputs -> the ``extra`` logs dict (``{key: [scalar]}``
    float arrays) every epoch loop records: the one device-to-host read
    of the validation scalars, once per epoch at its boundary."""
    return {k: np.asarray([float(v)]) for k, v in values.items()}


def epoch_exit(trainer) -> bool:
    """Shared end-of-epoch stop rule: on ``stop_training`` or a
    preemption request, tell the loop to break. The preemption notice is
    consumed here, when it is acted on. (JAX's also saves the epoch
    first: checkpoints are ROADMAP Queue 1 item 9.)"""
    trainer.preempted = trainer._preempt.is_set()
    if not (trainer.stop_training or trainer.preempted):
        return False
    if trainer.preempted:
        trainer._preempt.clear()   # consumed: acted on exactly once
    return True


def load_params(params, values) -> None:
    """Copy a tree of tensors or numpy arrays into the parameter (or
    state) tensors ``params``, in place."""
    with torch.no_grad():
        tree_map(lambda p, v: p.copy_(
            v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))),
            params, values)


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
        self.stop_training = False
        # request_preempt() (signal-handler safe) asks the epoch loop to
        # stop at the end of the current epoch; ``preempted`` reports
        # whether the last train() ended that way
        self._preempt = threading.Event()
        self.preempted = False

    def request_preempt(self) -> None:
        """Ask the running epoch loop to stop at the end of the current
        epoch. Safe from a signal handler or another thread; the notice
        stands until an epoch loop acts on it (``epoch_exit``)."""
        self._preempt.set()

    def _reject_step_options(self):
        """Trainers whose steps do not compose with gradient accumulation
        (a SingleTrainer option) refuse it: the engine family counts
        window steps; ensembles and host-async have loops of their own.
        (``fused_vocab_head``, JAX's other such option, is refused by
        the constructor: it is not ported.)"""
        if self.grad_accum_steps != 1:
            raise ValueError(
                f"{type(self).__name__} does not support grad_accum_steps "
                "(only SingleTrainer and SPMDTrainer do)")

    # -- reference-parity bookkeeping -------------------------------------
    def record_training_start(self):
        self.history.record_training_start()

    def record_training_stop(self):
        self.history.record_training_stop()

    def get_training_time(self) -> float:
        return self.history.get_training_time()

    def get_history(self) -> History:
        return self.history

    def get_averaged_history(self) -> np.ndarray:
        """Per-step losses averaged over workers (scalar per step)."""
        losses = self.history.losses()
        return losses.mean(axis=-1) if losses.ndim > 1 else losses

    @staticmethod
    def _split_outs(outs):
        """Epoch outputs -> ``(losses, metrics_dict)`` for either shape."""
        if isinstance(outs, tuple):
            return outs[0], outs[1]
        return outs, {}

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
        """Full-set evaluation after each epoch, in eval mode:
        ``validate(params, state=None) -> {"val_loss": [x],
        "val_<metric>": [x]}`` as float arrays (``state`` None: the
        model's own running statistics), or None without
        ``validation_data``. The validation set goes to the device
        once."""
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
        def validate(params, state=None):
            kw = {"state": state} if model.module.has_state else {}
            with eval_mode(model.module):
                out = model.module.apply(params, Xv, **kw)
            res = {"val_loss": self.loss(yv, out)}
            for name, fn in metric_fns.items():
                res[f"val_{name}"] = fn(yv, out)
            return val_logs(res)

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
                           prng.key(self.seed, device), model.state)
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
                    logs.update(validate(model.params))
                self.history.append_epoch(**logs)
                if epoch_exit(self):
                    break
        finally:
            self.record_training_stop()
        return model


class EnsembleTrainer(Trainer):
    """Trains ``num_models`` independent models (JAX :675): member ``i``
    is ``Model.build`` of a copy of the module with ``seed + i`` (JAX's
    threefry init), draws with key ``i`` of ``split(PRNGKey(seed), k)``
    and sees its own epoch permutation ``RandomState(seed + 1000 * epoch
    + i)``. The members are stacked on a leading axis and trained by the
    engine's stacked-worker loop (``engine.WorkerStack``), member after
    member each step. ``train`` returns the member list (also on
    ``models_``; ``master_model`` is the first); history is ``[steps,
    k]``."""

    def __init__(self, keras_model, num_models: int = 2, **kwargs):
        super().__init__(keras_model, **kwargs)
        self.num_models = int(num_models)
        self.models_: List[Model] = []

    def train(self, dataset) -> List[Model]:
        self._reject_step_options()
        if self.validation_data is not None:
            raise ValueError(
                "EnsembleTrainer does not support validation_data (k "
                "independent members have no single validation score); "
                "evaluate members individually after train()")
        base = self.master_model
        device = resolve_device(base.device)
        X, y = self._training_arrays(dataset)
        k = self.num_models
        members = [Model.build(copy.deepcopy(base.module), base.input_shape,
                               seed=self.seed + i, device=device)
                   for i in range(k)]
        with torch.no_grad():
            params, state = (tree_map(lambda *xs: torch.stack(
                [x.detach() for x in xs]), *trees) for trees in
                ([m.params for m in members], [m.state for m in members]))
        stack = WorkerStack(
            make_train_step(base.module, self.loss, self.worker_optimizer,
                            self._metric_fns()),
            params, stacked_opt_init(self.worker_optimizer, params),
            prng.split(prng.key(self.seed, device), k), state)
        self.record_training_start()
        try:
            for epoch in range(self.num_epoch):
                stacked = [stack_batches(
                    X, y, self.batch_size,
                    np.random.RandomState(self.seed + 1000 * epoch + i)
                    .permutation(len(X)) if self.shuffle_each_epoch
                    else None) for i in range(k)]
                Xk = torch.from_numpy(np.stack([s[0] for s in stacked])) \
                    .to(device)  # [k, steps, batch, ...]
                Yk = torch.from_numpy(np.stack([s[1] for s in stacked])) \
                    .to(device)
                outs = [[stack.step(i, Xk[i, s], Yk[i, s]) for i in range(k)]
                        for s in range(Xk.shape[1])]
                # [steps, k]; the epoch's one device-to-host read
                losses, mets = self._split_outs(stack_outputs(outs))
                self.history.append_epoch(
                    loss=losses.cpu().numpy(),
                    **{n: v.cpu().numpy() for n, v in mets.items()})
        finally:
            self.record_training_stop()
        for i, m in enumerate(members):
            load_params(m.params, tree_map(lambda s: s[i], params))
            load_params(m.state, tree_map(lambda s: s[i], state))
        self.models_ = members
        self.master_model = members[0]
        return members
