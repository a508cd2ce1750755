"""Engine replicas: one ``ServingEngine`` behind a lifecycle, the unit
the router places work on (mirrors
``distkeras_tpu/serving/router/replica.py``).

A replica is STARTING until ``start()``, SERVING while it takes work,
DRAINING once ``drain()`` closed admission (in-flight streams finish;
new submits shed with ``ReplicaUnavailable``, an ``AdmissionRejected``)
and DEAD after a failure: the router takes any exception out of
``step()`` as the replica's death and fails its requests over.

``role`` splits the fleet for disaggregated serving: a ``"prefill"``
replica takes fresh requests up to their first token, then the router
hands them to a ``"decode"`` replica; ``"both"`` (the default) does
everything. The fault point ``replica.die`` fires at the top of every
``step()`` (``faults.inject("replica.die", nth=K)`` kills the replica
that takes the K-th fleet step).

The placement signals (``queue_depth``, ``occupied``, ``free_pages``,
``accepting``, ``slo_burn``) read host state only: no device sync.
"""

from __future__ import annotations

import enum
from typing import Dict, Optional

from distkeras_tpu_torch.resilience import faults
from distkeras_tpu_torch.serving.engine import ServingEngine
from distkeras_tpu_torch.serving.scheduler import AdmissionRejected

__all__ = ["EngineReplica", "ReplicaDead", "ReplicaState",
           "ReplicaUnavailable"]


class ReplicaState(enum.Enum):
    STARTING = "starting"    # built, not yet taking traffic
    SERVING = "serving"      # admitting and decoding
    DRAINING = "draining"    # admission closed, in-flight finishing
    DEAD = "dead"            # failed; never stepped again


class ReplicaDead(RuntimeError):
    """The replica failed and cannot serve (``step()`` after death)."""

    def __init__(self, name: str, cause: Optional[BaseException] = None):
        tail = f": {cause!r}" if cause is not None else ""
        super().__init__(f"replica {name!r} is dead{tail}")
        self.name = name
        self.cause = cause


class ReplicaUnavailable(AdmissionRejected):
    """Submit refused because the replica is not SERVING; an
    ``AdmissionRejected``, so every shed path treats it as a full
    queue."""

    def __init__(self, name: str, state: "ReplicaState",
                 queue_depth: int = 0):
        RuntimeError.__init__(
            self, f"replica {name!r} is {state.value}: admission closed")
        self.queue_depth = queue_depth
        self.max_queue = 0


class EngineReplica:
    """One paged ``ServingEngine`` with a lifecycle and placement signals
    (handoff and failover re-enter through the paged engine's resumable
    re-prefill). ``name`` defaults to the engine's ``engine_id``; a name
    given here relabels the engine and its tracer (the telemetry
    component keeps the name it was built with: pass ``engine_id=`` to
    the engine to align them)."""

    def __init__(self, engine: ServingEngine, *, name: Optional[str] = None,
                 role: str = "both"):
        if engine.kv_layout != "paged":
            raise ValueError(
                "EngineReplica needs a paged-KV engine "
                "(kv_layout='paged'): handoff/failover re-enter "
                "through the resumable re-prefill path")
        if role not in ("both", "prefill", "decode"):
            raise ValueError(
                f"role must be 'both', 'prefill' or 'decode', "
                f"got {role!r}")
        self.engine = engine
        self.role = role
        if name is not None:
            engine.engine_id = str(name)
            if engine.tracer.enabled:
                engine.tracer.engine = str(name)
        self.name = str(name) if name is not None else engine.engine_id
        self.state = ReplicaState.STARTING
        self.error: Optional[BaseException] = None
        #: fleet steps this replica has taken
        self.steps = 0
        #: set by ``Router.remove_replica``: the retire sweep drops the
        #: replica once it drains empty; controllers neither resume it
        #: nor count it as capacity
        self.retiring = False

    def __repr__(self):
        return (f"EngineReplica({self.name!r}, role={self.role!r}, "
                f"state={self.state.value})")

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """STARTING/DRAINING -> SERVING; cancels a pending retirement. A
        dead replica stays dead."""
        if self.state is ReplicaState.DEAD:
            raise ReplicaDead(self.name, self.error)
        self.state = ReplicaState.SERVING
        self.retiring = False

    def drain(self) -> None:
        """Close admission; in-flight streams run to completion."""
        if self.state is ReplicaState.DEAD:
            raise ReplicaDead(self.name, self.error)
        self.state = ReplicaState.DRAINING

    resume = start

    def mark_dead(self, error: Optional[BaseException] = None) -> None:
        self.state = ReplicaState.DEAD
        if error is not None:
            self.error = error
        # a unit the engine launched and never fetched finishes into its
        # own pool and is dropped unread: failover trusts only the
        # router's host token mirror
        self.engine._pending = None

    @property
    def drained(self) -> bool:
        """DRAINING and empty."""
        return (self.state is ReplicaState.DRAINING
                and not self.engine.scheduler.pending)

    @property
    def pending(self) -> bool:
        """Work left: the scheduler's, or terminals a pipeline flush
        parked outside a step (a handoff's preemption may finish a
        neighbour stream, which only the next ``step()`` delivers)."""
        if self.state is ReplicaState.DEAD:
            return False
        eng = self.engine
        return eng.scheduler.pending or bool(eng._finish_buf)

    # -- placement signals -------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return self.engine.scheduler.queue_depth

    @property
    def occupied(self) -> int:
        return self.engine.scheduler.occupied

    @property
    def free_pages(self) -> int:
        return self.engine.pool.free_pages

    @property
    def accepting(self) -> bool:
        """SERVING and the bounded queue has room."""
        if self.state is not ReplicaState.SERVING:
            return False
        sch = self.engine.scheduler
        return sch.max_queue is None or sch.queue_depth < sch.max_queue

    # -- work --------------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, **kw) -> int:
        """``engine.submit``; a replica not SERVING sheds with
        ``ReplicaUnavailable``."""
        if self.state is not ReplicaState.SERVING:
            raise ReplicaUnavailable(self.name, self.state,
                                     self.queue_depth)
        return self.engine.submit(prompt, max_new_tokens, **kw)

    def transfer_in(self, req) -> int:
        """``engine.transfer_in`` under the same shed rule."""
        if self.state is not ReplicaState.SERVING:
            raise ReplicaUnavailable(self.name, self.state,
                                     self.queue_depth)
        return self.engine.transfer_in(req)

    def step(self):
        """One engine iteration, after the ``replica.die`` fault point: a
        fault raised there is, to the router, the engine failing
        mid-step."""
        if self.state is ReplicaState.DEAD:
            raise ReplicaDead(self.name, self.error)
        if self.state is ReplicaState.STARTING:
            self.start()
        faults.point("replica.die")
        self.steps += 1
        return self.engine.step()

    # -- views -------------------------------------------------------------

    def slo_burn(self) -> Optional[float]:
        """The largest burn rate over the engine's SLO objectives (an
        evaluation that records nothing), or None without objectives or
        samples: the drain controller's input."""
        eng = self.engine
        if eng.slo is None:
            return None
        statuses = eng.slo.evaluate(eng.metrics, record=False)
        if not statuses:
            return None
        return max(st["burn_rate"] for st in statuses.values())

    def health(self) -> Dict:
        """The engine's ``health()`` with the replica's name and role;
        ``status`` says ``"dead"`` or ``"draining"`` where the lifecycle
        overrides the engine's view."""
        if self.state is ReplicaState.DEAD:
            return {"status": "dead", "replica": self.name,
                    "role": self.role, "accepting": False,
                    "error": repr(self.error) if self.error else None}
        out = self.engine.health()
        out["replica"] = self.name
        out["role"] = self.role
        if self.state is not ReplicaState.SERVING:
            out["status"] = self.state.value
            out["accepting"] = False
        return out
