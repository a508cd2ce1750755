"""Flight recorder: a fixed-size ring of recent engine/trainer activity,
dumped to JSONL when something goes wrong.

Post-incident forensics need the iterations *leading up to* a failure
— batch composition, occupancy, scheduler decisions, admission
rejections, trainer epochs — which steady-state metrics have already
aggregated away by the time anyone looks. The recorder keeps the last
``capacity`` records in memory (O(ring), no per-record IO) and writes
them out only on a trigger:

* any armed ``resilience.faults`` point firing (the chaos/crash path;
  installed via ``faults.add_trigger_listener``);
* an admission-rejection storm (``reject_storm`` sheds since the last
  dump — sustained overload, not one unlucky submit);
* a ``DegradedRequest`` surfacing from ``ServingEngine.run()``;
* ``TrainingSupervisor`` restarts/rollbacks;
* an explicit ``dump()`` call.

Record vocabulary (each line carries ``seq``, ``t`` —
``utils.profiling.wall`` epoch seconds — and ``kind``):

* ``serving.iteration`` — per engine ``step()``: queue depth,
  occupancy, decoding/prefilling/admitted rids, and — paged engines —
  ``pages_free`` (written BEFORE the iteration's prefill/decode run,
  so a mid-iteration fault dump contains the failing iteration
  itself; an admission stall reads directly as queue growth against a
  starved page budget);
* ``serving.rejected`` — one shed submit;
* ``serving.preempted`` — a decoding request's pages evicted back to
  the queue (rid, slot, tokens generated so far, pages freed);
* ``train.epoch`` — per epoch-loop iteration of any trainer
  (``parallel.trainers.epoch_exit``, the shared exit point);
* ``supervisor.restart`` / ``supervisor.rollback`` — interventions;
* ``fault.triggered`` — an injection point fired.

Dumps are JSONL: a ``{"type": "meta", "schema_version": ...}`` header
(same versioning as ``obs.exporters``) followed by the ring, oldest
first. Auto-triggered dumps are throttled (``min_auto_interval_s``) so
a fault firing every iteration produces one dump, not one per step.

One PROCESS-GLOBAL recorder (``get_recorder()``) is shared by serving
engines, trainers and the supervisor — a crash dump shows what *all*
of them were doing. ``obs.disable()`` (or ``DKT_TELEMETRY=0``) routes
every instrumentation site to ``NULL_RECORDER`` instead (resolved at
engine/loop setup via ``resolve_recorder``): the steady-state cost of
a disabled recorder is one attribute check.
"""

from __future__ import annotations

import itertools
import json
import os
import tempfile
import threading
from collections import deque
from typing import Dict, List, Optional

from distkeras_tpu_torch.utils.profiling import now, wall

__all__ = ["FlightRecorder", "NULL_RECORDER", "get_recorder",
           "read_flight_dump", "reset_recorder", "resolve_recorder"]

#: ring slots (records) a recorder retains
DEFAULT_CAPACITY = 256
#: admission rejections since the last dump that count as a storm
DEFAULT_REJECT_STORM = 8
#: minimum seconds between AUTO dumps (explicit ``dump()`` ignores it)
DEFAULT_MIN_AUTO_INTERVAL_S = 1.0


class _NullRecorder:
    """Disabled path: every hook a no-op (single shared instance)."""

    enabled = False

    def record(self, kind, **fields):
        pass

    def note_rejection(self, **fields):
        pass

    def auto_dump(self, reason):
        return None

    def dump(self, reason="manual", path=None):
        return None

    def records(self):
        return []

    def clear(self):
        pass


NULL_RECORDER = _NullRecorder()


class FlightRecorder:
    """Bounded ring + trigger-driven JSONL dumps (module doc).

    ``dump_dir`` defaults to ``$DKT_FLIGHT_DIR`` or a per-process
    directory under the system temp dir; each dump is one new file
    ``flight_<seq>_<reason>.jsonl`` (paths retained on ``dumps``)."""

    enabled = True

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 dump_dir: Optional[str] = None,
                 reject_storm: int = DEFAULT_REJECT_STORM,
                 min_auto_interval_s: float = DEFAULT_MIN_AUTO_INTERVAL_S):
        if capacity < 1 or reject_storm < 1:
            raise ValueError(
                f"capacity/reject_storm must be >= 1, got "
                f"{capacity}/{reject_storm}")
        self.capacity = int(capacity)
        self.reject_storm = int(reject_storm)
        self.min_auto_interval_s = float(min_auto_interval_s)
        self.dump_dir = (dump_dir
                         or os.environ.get("DKT_FLIGHT_DIR")
                         or os.path.join(tempfile.gettempdir(),
                                         f"dkt_flight_{os.getpid()}"))
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = itertools.count()
        self._dump_seq = itertools.count()
        self._rejects_since_dump = 0
        self._last_auto: Optional[float] = None
        self.dumps: List[str] = []       # paths written, oldest first

    # -- recording ---------------------------------------------------------

    def record(self, kind: str, **fields) -> None:
        """Append one ring record. Cheap: a dict build + deque append
        under a lock; callers gate any expensive field ASSEMBLY on
        ``recorder.enabled`` (the engine builds its rid lists only when
        a live recorder will keep them)."""
        rec = {"seq": next(self._seq), "t": wall(), "kind": str(kind)}
        if fields:
            rec.update(fields)
        with self._lock:
            self._ring.append(rec)

    def note_rejection(self, **fields) -> None:
        """One shed submit; dumps automatically when sheds since the
        last dump reach ``reject_storm`` (sustained overload)."""
        self.record("serving.rejected", **fields)
        with self._lock:
            self._rejects_since_dump += 1
            storm = self._rejects_since_dump >= self.reject_storm
        if storm:
            self.auto_dump("admission_storm")

    def records(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._rejects_since_dump = 0

    # -- dumping -----------------------------------------------------------

    def auto_dump(self, reason: str) -> Optional[str]:
        """Trigger-path dump, throttled to one per
        ``min_auto_interval_s`` (a fault storm firing every iteration
        writes one forensic file, not one per step). Returns the path,
        or None when throttled."""
        t = now()
        with self._lock:
            if self._last_auto is not None \
                    and t - self._last_auto < self.min_auto_interval_s:
                return None
            self._last_auto = t
        return self.dump(reason)

    def dump(self, reason: str = "manual",
             path: Optional[str] = None) -> str:
        """Write the ring (oldest first) as JSONL under a meta header;
        returns the path written. Resets the rejection-storm counter —
        the next storm counts from this dump."""
        from distkeras_tpu_torch.obs.exporters import SCHEMA_VERSION
        with self._lock:
            records = list(self._ring)
            self._rejects_since_dump = 0
            dseq = next(self._dump_seq)
        if path is None:
            os.makedirs(self.dump_dir, exist_ok=True)
            safe = "".join(c if c.isalnum() or c in "._-" else "_"
                           for c in str(reason))[:64]
            path = os.path.join(self.dump_dir,
                                f"flight_{dseq:04d}_{safe}.jsonl")
        header = {"type": "meta", "schema_version": SCHEMA_VERSION,
                  "reason": str(reason), "dumped_at": wall(),
                  "capacity": self.capacity, "n_records": len(records)}
        with open(path, "w") as f:
            f.write(json.dumps(header) + "\n")
            for rec in records:
                f.write(json.dumps(rec) + "\n")
        self.dumps.append(path)
        return path


def read_flight_dump(path: str):
    """Parse a dump back into ``(header, records)`` — unknown record
    kinds and extra keys pass through untouched (the same
    forward-compatibility contract as ``exporters.read_jsonl``)."""
    header: Dict = {}
    records: List[Dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("type") == "meta" and not header:
                header = rec
            else:
                records.append(rec)
    return header, records


_global_lock = threading.Lock()
_global: List[Optional[FlightRecorder]] = [None]
_hook_installed = [False]


def _fault_listener(point: str) -> None:
    rec = _global[0]
    if rec is None:
        return
    rec.record("fault.triggered", point=point)
    rec.auto_dump(f"fault:{point}")


def get_recorder() -> FlightRecorder:
    """The process-global recorder (created on first use). Creation
    installs the ``resilience.faults`` trigger listener, so every
    armed fault that fires from then on snapshots the ring."""
    with _global_lock:
        if _global[0] is None:
            _global[0] = FlightRecorder()
        if not _hook_installed[0]:
            from distkeras_tpu_torch.resilience import faults
            faults.add_trigger_listener(_fault_listener)
            _hook_installed[0] = True
        return _global[0]


def reset_recorder() -> None:
    """Drop the global recorder and its fault hook (test isolation)."""
    with _global_lock:
        if _hook_installed[0]:
            from distkeras_tpu_torch.resilience import faults
            faults.remove_trigger_listener(_fault_listener)
            _hook_installed[0] = False
        _global[0] = None


def resolve_recorder():
    """The instrumentation-site policy: the global recorder while obs
    is enabled, ``NULL_RECORDER`` otherwise (NULL-object path — the
    disabled steady state costs one attribute check per site)."""
    from distkeras_tpu_torch import obs
    return get_recorder() if obs.enabled() else NULL_RECORDER
