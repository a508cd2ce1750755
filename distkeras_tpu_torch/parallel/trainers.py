"""Trainers of the port: the ``Trainer`` base, ``SingleTrainer`` and
``EnsembleTrainer``.

Mirrors ``distkeras_tpu/parallel/trainers.py``: the constructor
(:107-212), the shared epoch-loop pieces (``val_logs`` :35,
``epoch_exit`` :68, ``request_preempt`` :214, ``_reject_step_options``
:227, the masks :242, checkpoints and resume :254-296, ``_profile_ctx``
:297, the callback API :349-407, ``_sharded_stream`` :451),
``SingleTrainer.train`` (:524-672) and ``EnsembleTrainer`` (:675). The
constructor keeps the reference's ergonomics (``(model,
worker_optimizer, loss, batch_size, num_epoch, features_col, label_col,
...)``) and ``train(dataset)`` returns the model, trained IN PLACE on
the model's device (the CUDA card, or the CPU for a model built with
``device="cpu"``): its parameters and its model state (BatchNorm's
running statistics). The distributed family (``distributed``) and
``HostAsyncTrainer`` (``async_host``) share this base.

The epoch shuffle is exactly the JAX package's
``np.random.RandomState(seed + 1000 * epoch).permutation(n)`` (a
shard's rows: ``seed + 1000 * epoch + 31 * shard``), so both see the
same batches. ``SingleTrainer`` checkpoints its whole carry (``{"params",
"state", "opt", "rng"}``, the key as JAX's two uint32 words) in JAX's
format, so a resumed run is bitwise an uninterrupted one and a
checkpoint crosses between the packages. Its epochs come from a
``utils.prefetch.Prefetcher`` that assembles the next epoch (or shard)
and stages it on the device while the current one trains.
``telemetry`` (JAX's ``obs`` training tape) and the flight recorder
that JAX's ``epoch_exit`` writes to are ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

import contextlib
import copy
import threading
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from distkeras_tpu_torch.compat import resolve_device
from distkeras_tpu_torch.data.dataset import Dataset, coerce_column
from distkeras_tpu_torch.data.sharded import ShardedDataset
from distkeras_tpu_torch.models.core import Model, eval_mode, trainable_mask
from distkeras_tpu_torch.models.serialization import jax_state_tree
from distkeras_tpu_torch.ops import prng
from distkeras_tpu_torch.ops.losses import get_loss, with_class_weight
from distkeras_tpu_torch.ops.metrics import get_metric, metric_name
from distkeras_tpu_torch.ops.optimizers import (Optimizer,
                                                clip_by_global_norm,
                                                get_optimizer)
from distkeras_tpu_torch.parallel.engine import (WorkerStack, stack_outputs,
                                                 stacked_opt_init)
from distkeras_tpu_torch.parallel.worker import (TrainCarry, make_train_step,
                                                 run_epoch, stack_batches)
from distkeras_tpu_torch.utils.history import History
from distkeras_tpu_torch.utils.prefetch import (Prefetcher, device_stager,
                                                to_device)
from distkeras_tpu_torch.utils.tree import tree_map

#: the ROADMAP item of the trainers' ``telemetry`` tape, named in errors
TELEMETRY_ITEM = ("ROADMAP, Queue 1 item 11 (host-side systems: the obs/ "
                  "layer's training tape)")


def val_logs(values) -> dict:
    """Validator outputs -> the ``extra`` logs dict (``{key: [scalar]}``
    float arrays) every epoch loop records: the one device-to-host read
    of the validation scalars, once per epoch at its boundary."""
    return {k: np.asarray([float(v)]) for k, v in values.items()}


def epoch_exit(trainer, epoch: int, saved: bool, save_fn) -> bool:
    """Shared end-of-epoch stop rule (JAX :68): on ``stop_training`` or
    a preemption request, make sure THIS epoch is checkpointed (or a
    resume would lose it) and tell the loop to break. The preemption
    notice is consumed here, when it is acted on."""
    trainer.preempted = trainer._preempt.is_set()
    if not (trainer.stop_training or trainer.preempted):
        return False
    if trainer.preempted:
        trainer._preempt.clear()   # consumed: acted on exactly once
    if save_fn is not None and not saved:
        save_fn(epoch)
    return True


def load_params(params, values) -> None:
    """Copy a tree of tensors or numpy arrays into the parameter (or
    state) tensors ``params``, in place."""
    with torch.no_grad():
        tree_map(lambda p, v: p.copy_(
            v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))),
            params, values)


def host_tree(tree):
    """Host numpy copies of a tree of tensors (JAX's ``device_get``)."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy()
                    if torch.is_tensor(t) else np.array(t), tree)


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
        # None / False: no telemetry tape (the port has no obs layer); a
        # tape object asks for one
        if telemetry not in (None, False):
            raise NotImplementedError(
                f"telemetry is not ported yet: {TELEMETRY_ITEM}")
        self.master_model = keras_model
        opt_kwargs = dict(optimizer_kwargs or {})
        if learning_rate is not None and not isinstance(worker_optimizer,
                                                        Optimizer):
            opt_kwargs.setdefault("learning_rate", learning_rate)
        self.worker_optimizer = get_optimizer(worker_optimizer, **opt_kwargs)
        if clip_grad_norm is not None:
            self.worker_optimizer = clip_by_global_norm(
                self.worker_optimizer, clip_grad_norm)
        # the validation loss stays unweighted under class_weight (Keras:
        # class weights shape the training objective only)
        self.eval_loss = get_loss(loss)
        self.loss = (with_class_weight(loss, class_weight)
                     if class_weight is not None else self.eval_loss)
        self.metrics = metrics or []
        self.features_col = features_col
        self.label_col = label_col
        self.batch_size = int(batch_size)
        self.num_epoch = int(num_epoch)
        self.seed = int(seed)
        self.shuffle_each_epoch = bool(shuffle_each_epoch)
        self.history = History()
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(checkpoint_every)
        if self.checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got {checkpoint_every}")
        self.resume = bool(resume)
        self.checkpoint_async = bool(checkpoint_async)
        self.profile_dir = profile_dir
        self.grad_accum_steps = int(grad_accum_steps)
        self.validation_data = validation_data
        self.callbacks = list(callbacks or [])
        if fused_vocab_head and class_weight is not None:
            raise ValueError(
                "fused_vocab_head does not compose with class_weight: "
                "the fused loss never materializes the per-sample logits "
                "the class-weight wrapper scales. Drop one of the two.")
        # True = the default chunking; an int = the token chunk count
        self.fused_vocab_head = fused_vocab_head
        self.stop_training = False
        self._weights_fn = None       # bound by the trainers in train()
        self._pending_weights = None  # set through set_weights()
        # request_preempt() (signal-handler safe) asks the epoch loop to
        # checkpoint and stop at the end of the current epoch;
        # ``preempted`` reports whether the last train() ended that way
        self._preempt = threading.Event()
        self.preempted = False

    def request_preempt(self) -> None:
        """Ask the running epoch loop to checkpoint the current epoch and
        stop at its end. Safe from a signal handler or another thread;
        the notice stands until an epoch loop acts on it
        (``epoch_exit``)."""
        self._preempt.set()

    def _reject_step_options(self):
        """Trainers whose steps do not compose with the step options of
        ``SingleTrainer`` (gradient accumulation, the fused vocab head)
        refuse them: the engine family counts window steps; ensembles and
        host-async have loops of their own."""
        if self.grad_accum_steps != 1:
            raise ValueError(
                f"{type(self).__name__} does not support grad_accum_steps "
                "(only SingleTrainer and SPMDTrainer do)")
        if self.fused_vocab_head:
            raise ValueError(
                f"{type(self).__name__} does not support fused_vocab_head "
                "(only SingleTrainer and SPMDTrainer do)")

    def _param_mask(self, model):
        """The ``layer.trainable = False`` mask over the parameters
        (``models.core.trainable_mask``); None when nothing is frozen."""
        return trainable_mask(model.module, model.params)

    def _state_mask(self, model):
        """The same over the state tree (a frozen BatchNorm keeps its
        running statistics)."""
        return trainable_mask(model.module, model.state)

    # -- checkpoints ------------------------------------------------------
    def _checkpoint_manager(self):
        if self.checkpoint_dir is None:
            return None
        from distkeras_tpu_torch.utils.checkpoint import CheckpointManager
        return CheckpointManager(self.checkpoint_dir,
                                 async_writes=self.checkpoint_async)

    def _maybe_resume(self, manager, template):
        """``(tree, start_epoch)``: the latest checkpoint as host arrays
        in ``template``'s structure and the epoch after the one it
        saved, or ``(template, 0)`` when there is nothing to resume. The
        weights and the metadata come from the same step."""
        if manager is None or not self.resume:
            return template, 0
        latest = manager.latest_step()
        if latest is None:
            return template, 0
        tree = manager.restore(template, step=latest)
        meta = manager.metadata(step=latest)
        return tree, int(meta.get("epoch", -1)) + 1

    def _should_checkpoint(self, epoch: int) -> bool:
        return ((epoch + 1) % self.checkpoint_every == 0
                or epoch == self.num_epoch - 1)

    def _profile_ctx(self):
        """A ``torch.profiler`` trace of the run written under
        ``profile_dir`` (``utils.profiling.trace``), or nothing."""
        if self.profile_dir is None:
            return contextlib.nullcontext()
        from distkeras_tpu_torch.utils.profiling import trace
        return trace(self.profile_dir)

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

    # -- callbacks ----------------------------------------------------------
    def _cb_list(self, weights_fn: Optional[Callable] = None):
        """Bind the callbacks for a fresh ``train()``. ``weights_fn``
        returns host ``(params, state)`` trees of the CURRENT training
        weights (each trainer its own view: the carry, the engine's
        center, ...)."""
        from distkeras_tpu_torch.utils.callbacks import CallbackList
        self.stop_training = False
        # a standing preemption notice is not cleared here: epoch_exit
        # consumes it when it acts on it
        self.preempted = False
        self._pending_weights = None
        self._weights_fn = weights_fn
        cbs = CallbackList(self.callbacks, self)
        cbs.train_begin()
        return cbs

    def _epoch_logs(self, losses, mets, extra) -> dict:
        """Per-epoch scalar logs for the callbacks: the epoch means of
        the loss and the metrics, and the validation scalars (host
        arrays)."""
        logs = {"loss": float(np.mean(np.asarray(losses)))}
        for k, v in mets.items():
            logs[k] = float(np.mean(np.asarray(v)))
        for k, v in extra.items():
            logs[k] = float(np.asarray(v).ravel()[0])
        return logs

    def get_weights(self):
        """Host ``(params, state)`` of the training weights (the callback
        API; only while ``train()`` runs)."""
        if self._weights_fn is None:
            raise RuntimeError(
                "get_weights() is only available to callbacks while "
                "train() is running")
        return self._weights_fn()

    def set_weights(self, params, state) -> None:
        """Replace the weights the trainer returns (the callback API, e.g.
        ``EarlyStopping(restore_best_weights=True)``)."""
        self._pending_weights = (params, state)

    def snapshot_model(self) -> Model:
        """A model of its own (a copy of the module on the model's device)
        carrying the current training weights (the callback API)."""
        params, state = self.get_weights()
        m = self.master_model
        snap = Model(copy.deepcopy(m.module), m.input_shape, m.output_shape,
                     m.device)
        load_params(snap.params, params)
        load_params(snap.state, state)
        return snap

    def _apply_pending_weights(self, trained: Model) -> Model:
        if self._pending_weights is not None:
            params, state = self._pending_weights
            load_params(trained.params, params)
            load_params(trained.state, state)
        return trained

    def _reject_callbacks(self):
        if self.callbacks:
            raise ValueError(
                f"{type(self).__name__} does not support callbacks (no "
                "single evolving model to monitor)")

    # -- data ---------------------------------------------------------------
    def _training_arrays(self, dataset):
        if isinstance(dataset, ShardedDataset):
            raise ValueError(
                f"{type(self).__name__} does not support ShardedDataset "
                "(out-of-core training is a SingleTrainer/SPMDTrainer "
                "capability); load shards into one Dataset, or switch "
                "trainer")
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

    def _sharded_stream(self, sds, start_epoch: int, place=None):
        """ONE ``Prefetcher`` over the flat (epoch, shard) sequence of a
        ``ShardedDataset`` (``epoch_items``), yielding ``((epoch, shard,
        is_epoch_last), (Xs, Ys, n_steps))``: the loader stays busy
        across epoch boundaries. ``place`` stages each chunk on the
        device on the loader thread, two chunks deep (JAX :451)."""
        items = sds.epoch_items(start_epoch, self.num_epoch, self.seed,
                                self.shuffle_each_epoch)

        def assemble(item):
            epoch, si, _ = item
            Xc, yc = self._training_arrays(sds.load_shard(si))
            perm = None
            if self.shuffle_each_epoch:
                perm = np.random.RandomState(
                    self.seed + 1000 * epoch + 31 * si).permutation(len(Xc))
            return stack_batches(Xc, yc, self.batch_size, perm)

        return Prefetcher(assemble, items, depth=2 if place else 1,
                          name="shards", place=place)

    def _make_validator(self, model, device):
        """Full-set evaluation after each epoch, in eval mode:
        ``validate(params, state=None) -> {"val_loss": [x],
        "val_<metric>": [x]}`` as float arrays (``state`` None: the
        model's own running statistics; the loss unweighted), or None
        without ``validation_data``. The validation set goes to the
        device once."""
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
        loss_fn = self.eval_loss

        @torch.no_grad()
        def validate(params, state=None):
            kw = {"state": state} if model.module.has_state else {}
            with eval_mode(model.module):
                out = model.module.apply(params, Xv, **kw)
            res = {"val_loss": loss_fn(yv, out)}
            for name, fn in metric_fns.items():
                res[f"val_{name}"] = fn(yv, out)
            return val_logs(res)

        return validate

    def train(self, dataset):
        raise NotImplementedError


class SingleTrainer(Trainer):
    """Single-device training: each epoch is a loop of ``make_train_step``
    over the shuffled, stacked batches, on the model's device. A
    ``ShardedDataset`` trains shard by shard. ``loader`` is the last
    ``train()``'s prefetcher (``loader.wait_s``: the loop's wait for
    data)."""

    def train(self, dataset):
        model = self.master_model
        device = resolve_device(model.device)
        sharded = isinstance(dataset, ShardedDataset)
        if not sharded:
            X, y = self._training_arrays(dataset)
        step = make_train_step(model.module, self.loss,
                               self.worker_optimizer, self._metric_fns(),
                               self.grad_accum_steps,
                               param_mask=self._param_mask(model),
                               state_mask=self._state_mask(model),
                               fused_vocab_head=self.fused_vocab_head)
        # the whole carry is checkpointed, so a resumed run is bitwise an
        # uninterrupted one; the key chain starts from PRNGKey(seed)
        manager = self._checkpoint_manager()
        opt_state = self.worker_optimizer.init(model.params)
        key = prng.key(self.seed, device)
        template = {"params": model.params, "state": model.state,
                    "opt": opt_state, "rng": prng.key_data(key)}
        tree, start_epoch = self._maybe_resume(manager, template)
        if tree is not template:   # a restored checkpoint, onto the device
            load_params(model.params, tree["params"])
            load_params(model.state, tree["state"])
            opt_state = tree_map(lambda a: torch.from_numpy(a).to(device),
                                 tree["opt"])
            key = prng.as_key(tree["rng"], device)
        carry = TrainCarry(model.params, opt_state, key, model.state)

        place = device_stager(device)
        if sharded:
            self.loader = self._sharded_stream(dataset, start_epoch, place)
            stream = self.loader
        else:
            # the next epoch's gather, stacking and staging run while the
            # device trains this one; one epoch ahead is full overlap
            self.loader = Prefetcher(
                lambda e: stack_batches(X, y, self.batch_size,
                                        self._epoch_perm(e, len(X))),
                range(start_epoch, self.num_epoch), depth=1, name="epochs",
                place=place)
            stream = (((e, 0, True), chunk) for e, chunk in self.loader)

        def save_now(epoch):
            manager.save(epoch, {"params": carry.params,
                                 "state": jax_state_tree(model, carry.state),
                                 "opt": carry.opt_state,
                                 "rng": prng.key_data(carry.rng)},
                         metadata={"epoch": epoch})

        validate = self._make_validator(model, device)
        cbs = self._cb_list(lambda: (host_tree(carry.params),
                                     host_tree(carry.state)))
        self.record_training_start()
        try:
            with self._profile_ctx():
                l_acc, m_acc = [], []
                for (epoch, _, last), (Xs, Ys, _) in stream:
                    carry, losses, mets = run_epoch(
                        step, carry, to_device(Xs, device),
                        to_device(Ys, device))
                    l_acc.append(losses)
                    m_acc.append(mets)
                    if not last:
                        continue
                    # the epoch's one device-to-host read
                    losses = torch.cat(l_acc).cpu().numpy()
                    mets = {k: torch.cat([m[k] for m in m_acc]).cpu().numpy()
                            for k in m_acc[0]}
                    l_acc, m_acc = [], []
                    extra = validate(model.params) if validate else {}
                    self.history.append_epoch(loss=losses, **mets, **extra)
                    saved = False
                    if manager is not None and self._should_checkpoint(epoch):
                        save_now(epoch)
                        saved = True
                    cbs.epoch_end(epoch, self._epoch_logs(losses, mets,
                                                          extra))
                    if epoch_exit(self, epoch, saved,
                                  save_now if manager is not None else None):
                        break
        finally:
            self.loader.close()
            self.record_training_stop()
            cbs.train_end()  # closes callback resources on exceptions too
        if manager is not None:
            manager.wait()   # queued snapshots durable before return
        return self._apply_pending_weights(model)


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
        self._reject_callbacks()
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
                            self._metric_fns(),
                            param_mask=self._param_mask(base),
                            state_mask=self._state_mask(base)),
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
