"""The distributed trainer family: DOWNPOUR, EASGD, AEASGD, ADAG, DynSGD,
AveragingTrainer.

Mirrors ``distkeras_tpu/parallel/distributed.py``: the constructors
(``num_workers``, ``batch_size``, ``communication_window``,
``num_epoch``, ``parallelism_factor``, the algorithms' own
hyper-parameters) and ``DistributedTrainer.train`` (:77), with the
workers stacked on the model's device by ``engine.DistributedEngine``
instead of spread over a mesh. Differences:

* ``num_workers=None`` is the number of devices of the model's device
  type (1 on one card, 1 on the CPU), as JAX's ``len(jax.devices())``;
  an explicit ``num_workers`` has no device limit, since the workers
  are stacked on one device;
* ``mesh=`` raises ``NotImplementedError`` naming the multi-device half
  of ROADMAP Queue 1 item 10, and so does a trainer built in a process
  group of more than one process (``deploy.initialize_from_env``): its
  workers would cross processes.

Each epoch passes the ``train.epoch`` chaos point (JAX :133) and lands
a flight-recorder entry (``epoch_exit``).

The center is validated each epoch (the model a user would ship), with
the workers' mean model state (BatchNorm's statistics; the center's own
state never advances, JAX :120-124). A checkpoint holds that center and
mean state only (``{"params", "state"}``, JAX :98): a resume restarts
every worker from the center, the reference's parameter-server retry,
so it is not bitwise an uninterrupted run. Callbacks see the same
center; ``stop_training`` stops every worker. Frozen layers
(``Layer.trainable``) are masked in every worker's step. The trained
model is the algorithm-flushed center and that mean state, copied into
the model's tensors in place.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence, Union

import torch

from distkeras_tpu_torch.compat import resolve_device
from distkeras_tpu_torch.models.serialization import jax_state_tree
from distkeras_tpu_torch.ops import prng
from distkeras_tpu_torch.parallel.engine import (
    AdagAlgo, AveragingAlgo, DistAlgorithm, DistributedEngine, DownpourAlgo,
    DynSGDAlgo, ElasticAlgo, EngineConfig, MESH_ITEM, host_fetch, mean_state)
from distkeras_tpu_torch.parallel.trainers import (Trainer, epoch_exit,
                                                   host_tree, load_params)
from distkeras_tpu_torch.resilience import faults
from distkeras_tpu_torch.utils.prefetch import Prefetcher
from distkeras_tpu_torch.parallel.worker import shard_epoch_data


def process_count() -> int:
    """The processes of this job's ``torch.distributed`` group (1 when
    none is up): JAX's ``jax.process_count()``."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def default_num_workers(device) -> int:
    """The devices of ``device``'s type: JAX's ``len(jax.devices())``."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"  # lint: allow-device-fork (a count)
    return torch.cuda.device_count() if on_card else 1


class DistributedTrainer(Trainer):
    """Base of the stacked-worker family: ``allocate_algorithm()`` fixes
    the commit protocol of both sides of the exchange."""

    def __init__(self, keras_model, num_workers: Optional[int] = None,
                 communication_window: int = 5,
                 parallelism_factor: int = 1, mesh=None, **kwargs):
        super().__init__(keras_model, **kwargs)
        self.num_workers = int(num_workers or
                               default_num_workers(keras_model.device))
        self.communication_window = communication_window
        # the epoch is num_workers x parallelism_factor partitions; each
        # worker consumes parallelism_factor of them in turn, starting
        # every partition from the current center
        self.parallelism_factor = int(parallelism_factor)
        if self.parallelism_factor < 1:
            raise ValueError(
                f"parallelism_factor must be >= 1, got {parallelism_factor}")
        if mesh is not None:
            raise NotImplementedError(
                f"mesh= is not ported yet (the port stacks the workers on "
                f"one card): {MESH_ITEM}")
        procs = process_count()
        if procs > 1:
            raise NotImplementedError(
                f"{type(self).__name__} in a group of {procs} processes "
                f"(deploy.initialize_from_env): its workers would cross "
                f"processes, which needs the mesh: {MESH_ITEM}")
        self.mesh = None
        #: the engine of the last ``train`` (its commit counts)
        self.engine: Optional[DistributedEngine] = None

    def allocate_algorithm(self) -> DistAlgorithm:
        raise NotImplementedError

    # AveragingTrainer binds the window to the epoch length
    def _window(self, steps_per_epoch: int) -> Union[int, Sequence[int]]:
        return self.communication_window

    def train(self, dataset):
        self._reject_step_options()
        model = self.master_model
        device = resolve_device(model.device)
        X, y = self._training_arrays(dataset)
        n = self.num_workers
        # probe the epoch's shape to size the window (and fail fast on a
        # dataset smaller than one global step)
        _, _, S = shard_epoch_data(X, y, n, self.batch_size)
        engine = self.engine = DistributedEngine(
            model.module, self.loss, self.worker_optimizer,
            self.allocate_algorithm(), self.mesh,
            EngineConfig(num_workers=n, window=self._window(S)),
            metric_fns=self._metric_fns(),
            param_mask=self._param_mask(model),
            state_mask=self._state_mask(model))
        # a resume restores the CENTER; the workers restart from it
        manager = self._checkpoint_manager()
        template = {"params": model.params, "state": model.state}
        tree, start_epoch = self._maybe_resume(manager, template)
        if tree is not template:
            load_params(model.params, tree["params"])
            load_params(model.state, tree["state"])
        state = engine.init_state(model.params, prng.key(self.seed, device),
                                  model.state)
        validate = self._make_validator(model, device)
        # the next epoch's shuffle gather and [S, W, B, ...] stacking run
        # while the device trains this one
        loader = Prefetcher(
            lambda e: shard_epoch_data(X, y, n, self.batch_size,
                                       self._epoch_perm(e, len(X))),
            range(start_epoch, self.num_epoch), name="epochs")
        extracted = None   # the center the last save pulled

        def save_center(epoch):
            nonlocal extracted
            extracted = engine.extract_model(state)
            manager.save(epoch, {"params": extracted[0],
                                 "state": jax_state_tree(model,
                                                         extracted[1])},
                         metadata={"epoch": epoch})

        cbs = self._cb_list(lambda: host_tree(engine.extract_model(state)))
        self.record_training_start()
        try:
            with self._profile_ctx():
                for epoch, (Xs, Ys, S) in loader:
                    # chaos hook: a crash mid-training; the family resumes
                    # from the center only (the parameter-server retry)
                    faults.point("train.epoch")
                    Xs = torch.from_numpy(Xs).to(device)
                    Ys = torch.from_numpy(Ys).to(device)
                    pf = self.parallelism_factor
                    if pf > 1:
                        if S < pf:
                            raise ValueError(
                                f"epoch has {S} steps/worker but "
                                f"parallelism_factor={pf} needs >= {pf}")
                        # equal-length partitions; the remainder steps
                        # are dropped, as JAX drops them
                        chunk = S // pf
                        if chunk * pf < S:
                            warnings.warn(
                                f"parallelism_factor={pf}: epoch has {S} "
                                f"steps/worker; the trailing "
                                f"{S - chunk * pf} steps are dropped every "
                                "epoch (equal-length partitions). Size the "
                                "dataset so steps/worker divides by "
                                "parallelism_factor to train on all of "
                                "it.", stacklevel=2)
                        parts = []
                        for j in range(pf):
                            lo, hi = j * chunk, (j + 1) * chunk
                            state = engine.reset_workers(state)
                            state, outs_j = engine.run_epoch(
                                state, Xs[lo:hi], Ys[lo:hi])
                            parts.append(self._split_outs(outs_j))
                        losses = torch.cat([p[0] for p in parts])
                        mets = {k: torch.cat([p[1][k] for p in parts])
                                for k in parts[0][1]}
                    else:
                        state, outs = engine.run_epoch(state, Xs, Ys)
                        losses, mets = self._split_outs(outs)
                    extra = {}
                    if validate is not None:
                        # evaluate the CENTER (the model a user would
                        # ship) with the workers' mean state
                        extra = validate(state["center"]["params"],
                                         mean_state(state["worker"]["state"]))
                    # the epoch's one device-to-host read
                    losses, mets = host_fetch(losses), host_fetch(mets)
                    losses = losses.numpy()  # lint: allow-host-sync
                    mets = {k: v.numpy()  # lint: allow-host-sync
                            for k, v in mets.items()}
                    self.history.append_epoch(loss=losses, **mets, **extra)
                    extracted = None
                    saved = False
                    if (manager is not None
                            and self._should_checkpoint(epoch)):
                        save_center(epoch)
                        saved = True
                    cbs.epoch_end(epoch, self._epoch_logs(losses, mets,
                                                          extra))
                    # stop_training stops ALL workers: the center is
                    # shared; a preemption saves the center first
                    if epoch_exit(self, epoch, saved, save_center
                                  if manager is not None else None):
                        break
        finally:
            loader.close()
            self.record_training_stop()
            cbs.train_end()  # closes callback resources on exceptions too
        if manager is not None:
            manager.wait()   # queued snapshots durable before return
        params, mstate = extracted if extracted is not None \
            else engine.extract_model(state)
        load_params(model.params, params)
        load_params(model.state, mstate)
        return self._apply_pending_weights(model)


class DOWNPOUR(DistributedTrainer):
    """Asynchronous DOWNPOUR SGD (Dean et al. 2012): accumulate
    ``communication_window`` local steps, commit the delta, pull a fresh
    center; commits are staggered across workers (JAX :226)."""

    def __init__(self, keras_model, communication_window: int = 5,
                 commit_scale: float = 1.0, **kwargs):
        super().__init__(keras_model,
                         communication_window=communication_window, **kwargs)
        self.commit_scale = float(commit_scale)

    def allocate_algorithm(self):
        return DownpourAlgo(commit_scale=self.commit_scale)


class EASGD(DistributedTrainer):
    """Synchronous Elastic Averaging SGD (Zhang et al. 2015): barrier
    rounds every ``communication_window`` steps. ``alpha = rho *
    learning_rate``; ``learning_rate`` here is the elastic rate and is
    not passed to the worker optimizer (configure that one through
    ``worker_optimizer``/``optimizer_kwargs``; JAX :246)."""

    def __init__(self, keras_model, rho: float = 5.0,
                 learning_rate: float = 0.01, communication_window: int = 5,
                 center_mode: str = "sum", **kwargs):
        super().__init__(keras_model,
                         communication_window=communication_window, **kwargs)
        self.rho = float(rho)
        self.learning_rate = float(learning_rate)
        self.center_mode = center_mode

    @property
    def alpha(self) -> float:
        return self.rho * self.learning_rate

    def allocate_algorithm(self):
        if (self.center_mode == "sum"
                and self.alpha * self.num_workers >= 1.0):
            warnings.warn(
                f"EASGD stability: num_workers * alpha = "
                f"{self.alpha * self.num_workers:.2f} >= 1 with "
                f"center_mode='sum'; the center update can oscillate. "
                f"Lower rho/learning_rate or use center_mode='mean'.",
                stacklevel=2)
        return ElasticAlgo(alpha=self.alpha, synchronous=True,
                           center_mode=self.center_mode)


class AEASGD(EASGD):
    """Asynchronous EASGD: each worker exchanges its elastic difference
    with the center at its own (staggered) cadence (JAX :286)."""

    def __init__(self, keras_model, rho: float = 5.0,
                 learning_rate: float = 0.01, communication_window: int = 32,
                 center_mode: str = "sum", **kwargs):
        super().__init__(keras_model, rho=rho, learning_rate=learning_rate,
                         communication_window=communication_window,
                         center_mode=center_mode, **kwargs)

    def allocate_algorithm(self):
        return ElasticAlgo(alpha=self.alpha, synchronous=False,
                           center_mode=self.center_mode)


class ADAG(DistributedTrainer):
    """ADAG: asynchronous commits with adaptive per-parameter server
    accumulation (JAX :307)."""

    def __init__(self, keras_model, communication_window: int = 5,
                 adag_learning_rate: float = 0.05, epsilon: float = 1e-8,
                 **kwargs):
        super().__init__(keras_model,
                         communication_window=communication_window, **kwargs)
        self.adag_learning_rate = float(adag_learning_rate)
        self.epsilon = float(epsilon)

    def allocate_algorithm(self):
        return AdagAlgo(adag_lr=self.adag_learning_rate,
                        epsilon=self.epsilon)


class DynSGD(DistributedTrainer):
    """DynSGD: staleness-scaled asynchronous SGD (JAX :325).
    ``communication_window`` may be per-worker (a list of K_i) to model
    heterogeneous worker speeds."""

    def __init__(self, keras_model,
                 communication_window: Union[int, Sequence[int]] = 5,
                 **kwargs):
        super().__init__(keras_model,
                         communication_window=communication_window, **kwargs)

    def allocate_algorithm(self):
        return DynSGDAlgo()


class AveragingTrainer(DistributedTrainer):
    """Per-epoch weight averaging of independently training workers: the
    window is bound to the epoch length (JAX :345)."""

    def __init__(self, keras_model, **kwargs):
        kwargs.setdefault("communication_window", 0)  # bound at train time
        super().__init__(keras_model, **kwargs)

    def _window(self, steps_per_epoch: int):
        return steps_per_epoch

    def allocate_algorithm(self):
        return AveragingAlgo()
