"""Fault injection: a process-global registry of named injection points
(mirrors ``distkeras_tpu/resilience/faults.py``).

Every failure mode this repo claims to survive must be *injectable and
tested*, not hoped for. Library code plants cheap hooks at the places
real systems break — checkpoint writes/renames/restores
(``utils/checkpoint.py``), the prefetch producer (``utils/prefetch.py``),
shard fetches (``Trainer._sharded_stream``), the serving engine's
prefill/decode (``serving/engine.py``) and the trainer epoch loops — and
the chaos suite (``tests/test_resilience.py``) arms them one at a time.

Disarmed, a hook is one dict lookup under a lock (the sites run per
epoch / per chunk / per engine iteration, never per device op). Armed,
a hook fires per its deterministic trigger:

  * ``nth=N``   — fire exactly once, on the N-th call (1-based);
  * ``every=K`` — fire on every K-th call;
  * ``prob=P``  — fire with probability P per call, from a private
    ``random.Random(seed)`` stream (reproducible chaos).

and performs its action:

  * **raise** (default) — raise ``error`` (default an
    ``InjectedFault``, whose ``transient`` flag decides whether
    ``resilience.retry`` policies may heal it);
  * **stall** (``stall_s=...``) — sleep, then continue (slow disk,
    slow prefill, a wedged producer);
  * **nan** (``action="nan"``) — only at ``corrupt()`` sites: replace
    the value flowing past with NaNs (poisoned loss / gradient).

Activation is by API (``faults.inject("ckpt.write", nth=2)``) or
environment::

    DKT_FAULTS="ckpt.write=nth:2;serving.prefill=every:4,stall:0.05"

(specs split on ``;``, options on ``,``, each ``key:value``; keys:
``nth``, ``every``, ``prob``, ``seed``, ``stall``, ``action``,
``transient``). Every trigger increments the ``faults.triggered``
counter (labeled by point) on the obs registry, so chaos runs are
visible in ``telemetry_snapshot()`` — and notifies any registered
``add_trigger_listener`` callbacks (the flight recorder
``obs.recorder`` uses this to snapshot its ring at the moment of
failure). ``CATALOG`` is the port's injection-point catalog, the names
chaos schedules bind to (the JAX package keeps its own in
``docs/resilience.md``); ``tools/lint_torch_fault_points.py`` holds it
equal to the sites in the code.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, List, Optional

__all__ = [
    "CATALOG", "InjectedFault", "active", "add_trigger_listener", "clear",
    "corrupt", "fired", "inject", "load_env", "point", "points",
    "remove_trigger_listener", "reset",
]

#: every injection point of the port: name -> the site and what it
#: simulates
CATALOG = {
    "ckpt.d2h": "utils/checkpoint.py, the snapshot's device-to-host "
                "fence: a crash mid-transfer during a save",
    "ckpt.write": "CheckpointManager._write, before the npz write (on "
                  "the writer thread when async): a failed write",
    "ckpt.rename": "before the atomic publish rename: a crash between "
                   "write and publish",
    "ckpt.restore": "CheckpointManager.restore, before the load: a "
                    "flaky read at resume",
    "data.fetch": "the trainers' shard load: a flaky filesystem",
    "prefetch.produce": "the Prefetcher producer, per item: a loader "
                        "that raises, stalls or dies",
    "train.epoch": "the epoch-loop top of every trainer: a crash at an "
                   "arbitrary epoch",
    "train.loss": "the epoch-loss assembly (a corrupt() site): NaN "
                  "poisoning the logged loss",
    "serving.prefill": "ServingEngine._advance_prefill: a poisoned "
                       "request or a slow prefill",
    "serving.decode": "ServingEngine._advance_decode: a batch-wide "
                      "decode-step error before any mutation",
    "router.dispatch": "Router.submit: a dispatch failure before any "
                       "placement state moves",
    "replica.die": "EngineReplica.step: a replica's death, its streams "
                   "failed over to the fleet",
}


class InjectedFault(RuntimeError):
    """The default error an armed injection point raises.

    ``transient=True`` marks it retryable (``retry.classify_retryable``
    treats it like a flaky-IO error); the default ``False`` models a
    hard crash that only supervision-level restart can absorb.
    """

    def __init__(self, point: str, transient: bool = False):
        super().__init__(f"injected fault at {point!r}")
        self.point = point
        self.transient = transient


class _Spec:
    """One armed fault: a trigger plus an action."""

    def __init__(self, point: str, nth: Optional[int] = None,
                 every: Optional[int] = None, prob: Optional[float] = None,
                 seed: int = 0, error: Optional[BaseException] = None,
                 stall_s: Optional[float] = None,
                 action: Optional[str] = None, transient: bool = False):
        triggers = [t for t in (nth, every, prob) if t is not None]
        if len(triggers) != 1:
            raise ValueError(
                f"fault {point!r}: exactly one trigger of nth/every/prob "
                f"required, got nth={nth} every={every} prob={prob}")
        if nth is not None and int(nth) < 1:
            raise ValueError(f"fault {point!r}: nth must be >= 1")
        if every is not None and int(every) < 1:
            raise ValueError(f"fault {point!r}: every must be >= 1")
        if prob is not None and not 0.0 < float(prob) <= 1.0:
            raise ValueError(f"fault {point!r}: prob must be in (0, 1]")
        if action is None:
            action = "stall" if stall_s is not None else "raise"
        if action not in ("raise", "stall", "nan"):
            raise ValueError(f"fault {point!r}: unknown action {action!r}")
        if action == "stall" and stall_s is None:
            raise ValueError(f"fault {point!r}: stall action needs stall_s")
        self.point = point
        self.nth = None if nth is None else int(nth)
        self.every = None if every is None else int(every)
        self.prob = None if prob is None else float(prob)
        self.seed = int(seed)
        self.error = error
        self.stall_s = stall_s
        self.action = action
        self.transient = bool(transient)
        self._rng = random.Random(self.seed)

    def fires(self, call_index: int) -> bool:
        """``call_index`` is 1-based, counted per point since the last
        ``reset()``/``inject()`` for that point."""
        if self.nth is not None:
            return call_index == self.nth
        if self.every is not None:
            return call_index % self.every == 0
        return self._rng.random() < self.prob

    def describe(self) -> Dict:
        trig = (f"nth:{self.nth}" if self.nth is not None
                else f"every:{self.every}" if self.every is not None
                else f"prob:{self.prob}(seed={self.seed})")
        return {"trigger": trig, "action": self.action,
                "stall_s": self.stall_s, "transient": self.transient,
                "error": repr(self.error) if self.error else None}


_lock = threading.Lock()
_specs: Dict[str, _Spec] = {}
_calls: Dict[str, int] = {}      # per-point site-call counts
_fires: Dict[str, int] = {}      # per-point trigger counts
_seen: Dict[str, bool] = {}      # self-registering site catalog
_listeners: List = []            # trigger observers (flight recorder)


def add_trigger_listener(fn) -> None:
    """Register ``fn(point_name)`` to run on EVERY fault trigger,
    before the fault's action executes — how the flight recorder
    (``obs.recorder``) snapshots its ring at the moment of failure.
    Idempotent per callable; listener errors are reported as warnings,
    never masking the fault itself."""
    with _lock:
        if fn not in _listeners:
            _listeners.append(fn)


def remove_trigger_listener(fn) -> None:
    with _lock:
        if fn in _listeners:
            _listeners.remove(fn)


def _notify_listeners(name: str) -> None:
    with _lock:
        listeners = list(_listeners)
    for fn in listeners:
        try:
            fn(name)
        except Exception as e:
            import warnings
            warnings.warn(f"fault trigger listener {fn!r} failed for "
                          f"point {name!r}: {e!r}", stacklevel=3)


def inject(name: str, *, nth: Optional[int] = None,
           every: Optional[int] = None, prob: Optional[float] = None,
           seed: int = 0, error: Optional[BaseException] = None,
           stall_s: Optional[float] = None, action: Optional[str] = None,
           transient: bool = False) -> None:
    """Arm injection point ``name``; resets its call/fire counters so
    triggers count from this arming."""
    spec = _Spec(name, nth=nth, every=every, prob=prob, seed=seed,
                 error=error, stall_s=stall_s, action=action,
                 transient=transient)
    with _lock:
        _specs[name] = spec
        _calls[name] = 0
        _fires[name] = 0


def clear(name: str) -> None:
    """Disarm one point (its site stays registered in the catalog)."""
    with _lock:
        _specs.pop(name, None)


def reset() -> None:
    """Disarm everything and zero all counters (test isolation)."""
    with _lock:
        _specs.clear()
        _calls.clear()
        _fires.clear()


def active() -> Dict[str, Dict]:
    """Currently armed faults, ``{point: spec description}``."""
    with _lock:
        return {n: s.describe() for n, s in _specs.items()}


def points() -> List[str]:
    """Every injection point that has registered itself (a site ran) or
    been armed — the live catalog."""
    with _lock:
        return sorted(set(_seen) | set(_specs))


def fired(name: str) -> int:
    """How many times ``name`` has triggered since its arming/reset."""
    with _lock:
        return _fires.get(name, 0)


def _record_trigger(name: str) -> None:
    _fires[name] = _fires.get(name, 0) + 1


def _note_obs(name: str) -> None:
    # imported lazily: faults must stay importable before (and without)
    # the telemetry layer
    from distkeras_tpu_torch import obs
    obs.get_registry().counter("faults.triggered").inc(point=name)


def _check(name: str):
    """Count a site call; return the armed spec if it fires."""
    with _lock:
        _seen[name] = True
        spec = _specs.get(name)
        if spec is None:
            return None
        _calls[name] = _calls.get(name, 0) + 1
        if not spec.fires(_calls[name]):
            return None
        _record_trigger(name)
    _note_obs(name)
    _notify_listeners(name)
    return spec


def point(name: str) -> None:
    """The control-flow injection hook. Library code calls this at a
    named site; a disarmed point is a cheap no-op. An armed point that
    fires either stalls (``stall_s``) or raises (``error`` or an
    ``InjectedFault``). An ``action="nan"`` spec belongs to
    ``corrupt()`` sites — one firing at a control point is a loud
    usage error, never a silent no-op (the trigger would be consumed
    and ``fired()`` incremented while injecting nothing, making a
    chaos test pass vacuously)."""
    spec = _check(name)
    if spec is None:
        return
    if spec.action == "nan":
        raise ValueError(
            f"fault {name!r}: action='nan' specs only act at corrupt() "
            f"sites, but {name!r} is a control-flow point — arm a "
            "raise/stall action here, or target a corrupt() site")
    if spec.action == "stall":
        time.sleep(spec.stall_s)
        return
    raise spec.error if spec.error is not None \
        else InjectedFault(name, transient=spec.transient)


def corrupt(name: str, value):
    """The value-corruption hook: returns ``value`` unchanged unless an
    armed ``action="nan"`` spec fires, in which case a NaN-filled copy
    comes back (float arrays/scalars). Raise/stall specs act here
    exactly as at ``point()`` sites. A disarmed site returns ``value``
    itself without reading it."""
    spec = _check(name)
    if spec is None:
        return value
    if spec.action == "stall":
        time.sleep(spec.stall_s)
        return value
    if spec.action == "raise":
        raise spec.error if spec.error is not None \
            else InjectedFault(name, transient=spec.transient)
    import numpy as np
    arr = np.asarray(value, dtype=np.result_type(value, np.float32))
    return np.full_like(arr, np.nan)


def load_env(spec_string: Optional[str] = None) -> None:
    """Parse ``DKT_FAULTS`` (or an explicit string) and arm each spec.
    Format: ``point=opt:val,opt:val;point2=...`` — see module doc."""
    raw = (os.environ.get("DKT_FAULTS", "")
           if spec_string is None else spec_string)
    for part in raw.split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, opts = part.partition("=")
        if not opts:
            raise ValueError(
                f"DKT_FAULTS spec {part!r}: expected point=opt:val[,...]")
        kw: Dict = {}
        for opt in opts.split(","):
            key, _, val = opt.strip().partition(":")
            if key in ("nth", "every", "seed"):
                kw[key] = int(val)
            elif key == "prob":
                kw["prob"] = float(val)
            elif key == "stall":
                kw["stall_s"] = float(val)
            elif key == "action":
                kw["action"] = val
            elif key == "transient":
                kw["transient"] = val.lower() in ("1", "true", "yes")
            else:
                raise ValueError(
                    f"DKT_FAULTS spec {part!r}: unknown option {key!r}")
        inject(name.strip(), **kw)


load_env()
