"""Training supervision: auto-resume, preemption handling, anomaly guard
(mirrors ``distkeras_tpu/resilience/supervisor.py``).

``TrainingSupervisor`` wraps any checkpointing trainer of the family
(``SingleTrainer``/``HostAsyncTrainer``/the engine
trainers) and turns "a crash loses the run" (SURVEY §5.4) into "a crash
costs at most one checkpoint interval":

  * **Auto-resume** — when ``train()`` dies (real crash or an armed
    ``resilience.faults`` point), the supervisor flips ``resume=True``
    and restarts; the trainer's full-carry checkpoint/resume contract
    makes the rejoined run bitwise-identical to an uninterrupted one.
    Restart attempts are bounded (``max_restarts``); the budget
    exhausting re-raises the last error.
  * **Preemption** — a SIGTERM (the preemption notice) requests a
    clean stop: the trainer checkpoints the CURRENT epoch and returns,
    and the supervisor either hands the partial model back
    (``on_preempt="return"``) or exits 0 (``on_preempt="exit"``, the
    batch-job contract: the scheduler sees a clean exit and reschedules
    with ``resume=True``).
  * **Anomaly guard** — ``AnomalyGuard`` watches the per-epoch logs
    (loss by default; any logged scalar, e.g. a gradient-norm metric,
    by name) for NaN/Inf or a spike. Detection raises out of the epoch
    loop; the supervisor deletes the checkpoints that may hold the
    poisoned weights (the epoch's save runs before its callbacks) and
    resumes from the last good snapshot — a bounded number of times
    (``rollback_budget``); epoch granularity is deliberate, the epoch
    being ONE compiled scan (see utils/callbacks.py module doc).

Every intervention lands on the obs registry (``supervisor.restarts`` /
``supervisor.rollbacks`` / ``supervisor.preemptions``) so a supervised
run's history is visible in ``telemetry_snapshot()``. State machine and
semantics: ``docs/resilience.md``.
"""

from __future__ import annotations

import math
import signal
import threading
from collections import deque
from typing import Dict, Optional, Sequence, Tuple, Type

from distkeras_tpu_torch.utils.callbacks import Callback

__all__ = ["AnomalyDetected", "AnomalyGuard", "SupervisedRun",
           "TrainingSupervisor"]


class AnomalyDetected(RuntimeError):
    """Raised by ``AnomalyGuard`` out of the trainer's epoch loop."""

    def __init__(self, epoch: int, key: str, value: float, reason: str):
        super().__init__(
            f"training anomaly at epoch {epoch}: {key}={value!r} "
            f"({reason})")
        self.epoch = epoch
        self.key = key
        self.value = value
        self.reason = reason


class AnomalyGuard(Callback):
    """Per-epoch watchdog over the callback ``logs``.

    ``keys`` are the logged scalars to watch (``loss`` by default; add
    any metric the trainer logs — e.g. a grad-norm metric). NaN/Inf
    always trips. ``spike_factor`` (optional) additionally trips when a
    value exceeds ``spike_factor *`` the median of the last ``window``
    good values (needs at least 2 priors, so epoch 0 can't
    false-positive). The guard raises; pairing with a
    ``TrainingSupervisor`` turns the raise into a rollback, but it is
    also usable alone as a loud NaN tripwire.
    """

    def __init__(self, keys: Sequence[str] = ("loss",),
                 spike_factor: Optional[float] = None, window: int = 5):
        if spike_factor is not None and spike_factor <= 1.0:
            raise ValueError(
                f"spike_factor must be > 1, got {spike_factor}")
        self.keys = tuple(keys)
        self.spike_factor = spike_factor
        self._history: Dict[str, deque] = {
            k: deque(maxlen=int(window)) for k in self.keys}

    @staticmethod
    def _median(vals) -> float:
        s = sorted(vals)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def on_epoch_end(self, epoch: int, logs: Optional[Dict] = None) -> None:
        logs = logs or {}
        for key in self.keys:
            value = logs.get(key)
            if value is None:
                continue
            value = float(value)
            if not math.isfinite(value):
                raise AnomalyDetected(epoch, key, value, "non-finite")
            hist = self._history[key]
            if self.spike_factor is not None and len(hist) >= 2:
                baseline = self._median(hist)
                if value > self.spike_factor * abs(baseline):
                    raise AnomalyDetected(
                        epoch, key, value,
                        f"spike > {self.spike_factor}x median "
                        f"{baseline:.6g} of last {len(hist)} epochs")
            hist.append(value)


class SupervisedRun:
    """What ``TrainingSupervisor.run`` returns: the trained model (or
    partial model, when preempted) plus the intervention tally."""

    def __init__(self, model, restarts: int, rollbacks: int,
                 preempted: bool):
        self.model = model
        self.restarts = restarts
        self.rollbacks = rollbacks
        self.preempted = preempted

    def __repr__(self):
        return (f"SupervisedRun(restarts={self.restarts}, "
                f"rollbacks={self.rollbacks}, "
                f"preempted={self.preempted})")


class TrainingSupervisor:
    """Supervise one trainer's ``train(dataset)`` (see module doc).

    The trainer must have ``checkpoint_dir`` set — supervision without
    durable snapshots could only ever restart from scratch, which is
    retry, not recovery. ``restart_on`` classifies which exceptions are
    worth a restart (default: any ``Exception``; ``AnomalyDetected``
    is always handled by the rollback path instead, and
    ``KeyboardInterrupt``/``SystemExit`` always propagate).
    ``handle_signals`` installs preemption handlers around ``run()``
    (main thread only — from other threads deliver preemption by
    calling ``trainer.request_preempt()`` directly).
    """

    def __init__(self, trainer, max_restarts: int = 3,
                 restart_on: Tuple[Type[BaseException], ...] = (Exception,),
                 anomaly_guard: Optional[AnomalyGuard] = None,
                 rollback_budget: int = 1,
                 handle_signals: Sequence[int] = (signal.SIGTERM,),
                 on_preempt: str = "return"):
        if getattr(trainer, "checkpoint_dir", None) is None:
            raise ValueError(
                "TrainingSupervisor needs a trainer with checkpoint_dir "
                "set: auto-resume and rollback restore from its "
                "checkpoints")
        if anomaly_guard is not None \
                and getattr(trainer, "checkpoint_async", False):
            raise ValueError(
                "anomaly_guard does not compose with checkpoint_async: "
                "rollback deletes the poisoned epoch's checkpoint, and an "
                "in-flight background write could republish it after the "
                "delete. Use synchronous checkpoints under supervision.")
        if on_preempt not in ("return", "exit"):
            raise ValueError(
                f"on_preempt must be 'return' or 'exit', got {on_preempt}")
        if max_restarts < 0 or rollback_budget < 0:
            raise ValueError("max_restarts/rollback_budget must be >= 0")
        self.trainer = trainer
        self.max_restarts = int(max_restarts)
        self.restart_on = tuple(restart_on)
        self.anomaly_guard = anomaly_guard
        self.rollback_budget = int(rollback_budget)
        self.handle_signals = tuple(handle_signals)
        self.on_preempt = on_preempt
        self.restarts = 0
        self.rollbacks = 0

    # -- plumbing -----------------------------------------------------------
    def _manager(self):
        maker = getattr(self.trainer, "_checkpoint_manager", None)
        if maker is not None:
            return maker()
        from distkeras_tpu_torch.utils.checkpoint import CheckpointManager
        return CheckpointManager(self.trainer.checkpoint_dir)

    def _counter(self, name: str):
        from distkeras_tpu_torch import obs
        # every call site passes a "supervisor.*" literal; the variable
        # here is just the lazy-import shim
        return obs.get_registry().counter(name)  # lint: allow-dynamic-metric-name

    def _recorder(self):
        from distkeras_tpu_torch.obs.recorder import resolve_recorder
        return resolve_recorder()

    def _install_signals(self):
        installed = {}
        if threading.current_thread() is not threading.main_thread():
            return installed

        def handler(signum, frame):
            self.trainer.request_preempt()

        for sig in self.handle_signals:
            installed[sig] = signal.signal(sig, handler)
        return installed

    def _rollback(self, err: AnomalyDetected) -> None:
        """Delete every checkpoint at/after the anomalous epoch: the
        epoch's save ran before its callbacks saw the logs, so the
        latest snapshot may hold the poisoned weights. Training resumes
        from the newest surviving (good) checkpoint — or from scratch
        when none survives."""
        manager = self._manager()
        for step in manager.all_steps():
            if step >= err.epoch:
                manager.delete(step)

    # -- the loop -----------------------------------------------------------
    def run(self, dataset) -> SupervisedRun:
        trainer = self.trainer
        guard_installed = False
        if self.anomaly_guard is not None \
                and self.anomaly_guard not in trainer.callbacks:
            trainer.callbacks.append(self.anomaly_guard)
            guard_installed = True
        old_handlers = self._install_signals()
        try:
            while True:
                try:
                    model = trainer.train(dataset)
                except AnomalyDetected as err:
                    self._counter("supervisor.anomalies").inc(
                        key=err.key, reason=err.reason.split()[0])
                    if self.rollbacks >= self.rollback_budget:
                        raise
                    self.rollbacks += 1
                    self._counter("supervisor.rollbacks").inc()
                    # flight-recorder forensics: ring state at rollback
                    rec = self._recorder()
                    rec.record("supervisor.rollback",
                               epoch=err.epoch, key=err.key,
                               reason=err.reason, attempt=self.rollbacks)
                    rec.auto_dump("supervisor.rollback")
                    self._rollback(err)
                    trainer.resume = True
                    continue
                except self.restart_on as err:
                    if self.restarts >= self.max_restarts:
                        raise
                    self.restarts += 1
                    self._counter("supervisor.restarts").inc()
                    # dump the ring BEFORE the restart overwrites it —
                    # the crash context (recent epochs/iterations) is
                    # exactly what post-mortems need
                    rec = self._recorder()
                    rec.record("supervisor.restart", error=repr(err),
                               attempt=self.restarts)
                    rec.auto_dump("supervisor.restart")
                    trainer.resume = True
                    continue
                preempted = bool(getattr(trainer, "preempted", False))
                if preempted:
                    self._counter("supervisor.preemptions").inc()
                    if self.on_preempt == "exit":
                        # the clean-preemption contract: checkpoint is
                        # durable (train() waits on async writes before
                        # returning), so exit 0 and let the scheduler
                        # relaunch with resume=True
                        raise SystemExit(0)
                return SupervisedRun(model, self.restarts, self.rollbacks,
                                     preempted)
        finally:
            for sig, old in old_handlers.items():
                signal.signal(sig, old)
            if guard_installed:
                trainer.callbacks.remove(self.anomaly_guard)
