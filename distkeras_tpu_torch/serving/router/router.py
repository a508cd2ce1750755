"""The router: N engine replicas behind one submit/step/run surface
(mirrors ``distkeras_tpu/serving/router/router.py``).

``Router`` has the single engine's client API (``submit`` returns a
fleet-wide id, ``step`` the finished requests, ``run`` drains, ``stream``
yields tokens, ``cancel``, ``health``) over a fleet of
``EngineReplica``s, and adds:

* **Placement** (``policies``): a submit goes to one SERVING replica,
  by prefix affinity or least load; a replica that sheds passes it to
  the next, and the router sheds only when every eligible replica did.
* **Disaggregated prefill/decode** (replica ``role``): fresh requests
  land on prefill-class replicas; once a stream has its first token the
  router moves it to a decode-class replica through
  ``ServingEngine.transfer_out``/``transfer_in``, a re-prefill of
  ``prompt + generated[:-1]`` on the target (shipping the KV pages
  instead is later work; this path is the oracle).
* **Failover and drain**: an exception out of a replica's ``step()``
  (the ``replica.die`` fault point included) marks it DEAD, and every
  request it held is re-admitted elsewhere from the router's own log:
  the host token mirror, and the sampling key replayed from the seed
  (one split per emitted token, the engine's key rule), on the host,
  with no kernel launch and no device read. Nothing of the dead engine
  is trusted: a unit it launched and never fetched finishes into its
  own pool and is dropped. Drained replicas shed while in-flight
  streams finish; ``SLOBurnController`` drains on SLO burn and
  rebalances queued work.
* **Elasticity** (``add_replica``/``remove_replica``): removal is drain,
  rebalance the queue, retire once empty; a DEAD replica retires the
  same way. Every change lands in ``fleet_events`` and the
  ``router.fleet_size`` gauge; ``AutoscaleController`` drives both. A
  deadline's REMAINING budget follows a stream across every move.

Every request routed, handed off, failed over or drained produces the
single engine's tokens (byte for byte when sampled).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

from distkeras_tpu_torch import obs
from distkeras_tpu_torch.obs.recorder import resolve_recorder
from distkeras_tpu_torch.obs.timeseries import TimeSeries
from distkeras_tpu_torch.ops import prng
from distkeras_tpu_torch.resilience import faults
from distkeras_tpu_torch.serving.engine import (DegradedRequest,
                                                ServingEngine)
from distkeras_tpu_torch.serving.router.policies import resolve_policy
from distkeras_tpu_torch.serving.router.replica import (EngineReplica,
                                                        ReplicaDead,
                                                        ReplicaState)
from distkeras_tpu_torch.serving.scheduler import (AdmissionRejected,
                                                   Request, RequestState,
                                                   TERMINAL_STATES)

__all__ = ["Router", "RouterClient"]


def _replay_key(seed: int, n_tokens: int) -> np.ndarray:
    """The key of a live stream that has emitted ``n_tokens`` tokens,
    rebuilt from its seed alone (JAX :76): the engine's key advances by
    one ``split`` (keeping row 0) per emitted token, whatever the path
    (first token, decode step, fused window, speculative verify). The
    threefry runs on CPU tensors, so a failover launches no kernel and
    reads nothing from the card. Returns the host ``[2]`` int64 array
    ``req.rng`` holds in the port (JAX's ``uint32[2]`` words)."""
    key = prng.key(int(seed))
    for _ in range(int(n_tokens)):
        key = prng.split(key)[0]
    return key.numpy()


class _Tracked:
    """Router-side record of one in-flight request: the stable
    fleet-wide id, the replica currently serving it, and the live
    ``Request`` object (the router's request log — its host token
    mirror is what failover trusts)."""

    __slots__ = ("grid", "replica", "req", "handoffs", "failovers")

    def __init__(self, grid: int, replica: EngineReplica, req: Request):
        self.grid = grid
        self.replica = replica          # None while orphaned
        self.req = req
        self.handoffs = 0
        self.failovers = 0


class Router:
    """See module doc. ``replicas`` is a sequence of ``EngineReplica``
    (or bare paged ``ServingEngine``s, auto-wrapped ``role="both"``
    with their ``engine_id`` as the replica name). Roles either all
    ``"both"`` (homogeneous fleet) or at least one ``"prefill"`` AND
    one ``"decode"`` (disaggregated; ``"both"`` replicas then serve in
    both pools). ``policy`` places fresh admissions;
    decode-handoff/failover placement always uses the same policy over
    the decode-capable pool."""

    #: router steps between attached-controller ticks
    _CTL_EVERY = 16

    def __init__(self, replicas, *, policy="prefix_affinity",
                 start: bool = True, timeseries=None):
        reps: List[EngineReplica] = []
        for r in replicas:
            if isinstance(r, ServingEngine):
                r = EngineReplica(r)
            reps.append(r)
        if not reps:
            raise ValueError("Router needs at least one replica")
        names = [r.name for r in reps]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        roles = {r.role for r in reps}
        if roles - {"both"} and not (
                {"prefill", "both"} & roles and {"decode", "both"} & roles):
            raise ValueError(
                "disaggregated fleets need at least one prefill-capable "
                "AND one decode-capable replica "
                f"(roles: {sorted(roles)})")
        self.replicas = reps
        self.policy = resolve_policy(policy)
        #: disaggregated = any role-split replica exists: the router
        #: then migrates streams off prefill-class replicas at first
        #: token
        self.disaggregated = bool(roles - {"both"})
        self.controller = None
        self._grid = itertools.count()
        self._requests: Dict[int, _Tracked] = {}
        #: (id(replica), local rid) -> grid
        self._local: Dict[Tuple[int, int], int] = {}
        #: detached requests awaiting a replica (all targets shed)
        self._orphans: List[_Tracked] = []
        #: terminals surfaced out-of-band (death sweep, cancel races)
        self._finish_buf: List[Tuple[int, Request]] = []
        self._steps = 0
        self.recorder = resolve_recorder()
        # registry series for exporters (labeled by replica where it
        # means something) + plain totals for counters()/bench reads
        reg = obs.get_registry()
        self._c_dispatch = reg.counter("router.dispatched")
        self._c_handoff = reg.counter("router.handoffs")
        self._c_failover = reg.counter("router.failovers")
        self._c_rebalance = reg.counter("router.rebalanced")
        self._c_shed = reg.counter("router.rejected")
        self._c_added = reg.counter("router.replicas_added")
        self._c_removed = reg.counter("router.replicas_removed")
        self._c_deadline = reg.counter("router.deadline_expired")
        self._g_fleet = reg.gauge("router.fleet_size")
        self._n: Dict[str, int] = {
            "dispatched": 0, "handoffs": 0, "failovers": 0,
            "rebalanced": 0, "rejected": 0, "deadline_expired": 0,
            "replicas_added": 0, "replicas_removed": 0}
        #: bumped on every fleet mutation (add/remove/death) — harness
        #: code (loadgen.replay) keys per-engine instrumentation sync
        #: off this instead of diffing the replica list
        self._fleet_version = 0
        #: (router step, event, replica name) for add/remove/dead —
        #: the fleet-size timeline's raw material
        self.fleet_events: List[Tuple[int, str, str]] = []
        self._g_fleet.set(len(reps))
        # fleet-level time series (obs.timeseries): scrapes the GLOBAL
        # registry (router.* counters, slo gauges, device watermarks)
        # on the controller cadence; per-replica serving series live on
        # each engine's OWN scraper (engine-id-tagged). ``None`` =
        # default scraper, ``False`` = off, instance = used as-is.
        if timeseries is False:
            self.timeseries = None
        elif isinstance(timeseries, TimeSeries):
            self.timeseries = timeseries
        else:
            self.timeseries = TimeSeries(
                obs.get_registry(),
                interval_s=0.0 if timeseries is None else float(timeseries),
                tags={"component": "router"})
        if start:
            for r in reps:
                if r.state is ReplicaState.STARTING:
                    r.start()

    # -- pools -------------------------------------------------------------

    def _admission_pool(self) -> List[EngineReplica]:
        """Replicas a FRESH request may land on."""
        return [r for r in self.replicas
                if r.state is ReplicaState.SERVING
                and r.role in ("both", "prefill")]

    def _decode_pool(self) -> List[EngineReplica]:
        """Replicas a decode-progress stream may land on."""
        return [r for r in self.replicas
                if r.state is ReplicaState.SERVING
                and r.role in ("both", "decode")]

    def replica(self, name: str) -> EngineReplica:
        for r in self.replicas:
            if r.name == name:
                return r
        raise KeyError(name)

    def attach_controller(self, controller) -> None:
        """Tick ``controller`` every ``_CTL_EVERY`` router steps (the
        SLO-burn drain controller's cadence)."""
        self.controller = controller

    # -- fleet elasticity --------------------------------------------------

    def add_replica(self, replica, *, start: bool = True) -> EngineReplica:
        """Grow the fleet mid-flight. ``replica`` is an
        ``EngineReplica``, a bare paged ``ServingEngine`` (auto-wrapped
        ``role="both"``) or a zero-arg factory returning either — the
        factory form is what ``AutoscaleController`` holds, so engine
        construction cost is only paid when a scale-up actually fires.
        The new replica joins the placement pools immediately (next
        ``submit``/``_place`` sees it); queued work already on other
        replicas moves only through an explicit ``rebalance_queued``
        or the normal shed-retry paths. Returns the added replica."""
        if not isinstance(replica, (EngineReplica, ServingEngine)) \
                and callable(replica):
            replica = replica()
        if isinstance(replica, ServingEngine):
            replica = EngineReplica(replica)
        if any(r.name == replica.name for r in self.replicas):
            raise ValueError(
                f"duplicate replica name: {replica.name!r}")
        self.replicas.append(replica)
        if replica.role != "both":
            self.disaggregated = True
        self._fleet_version += 1
        self._c_added.inc(replica=replica.name)
        self._n["replicas_added"] += 1
        self.fleet_events.append((self._steps, "add", replica.name))
        self._g_fleet.set(len(self.replicas))
        if self.recorder.enabled:
            self.recorder.record(
                "router.replica_added", replica=replica.name,
                role=replica.role, fleet=len(self.replicas))
        if start and replica.state is ReplicaState.STARTING:
            replica.start()
        return replica

    def remove_replica(self, name: str) -> EngineReplica:
        """Shrink the fleet: drain ``name`` (admission closes, in-flight
        streams finish in place through the normal drain contract),
        rebalance its queued work onto the rest of the fleet, and mark
        it retiring — the end-of-step sweep pops it from the fleet once
        it is empty. A DEAD replica is garbage-collected through the
        same path (its in-flight work was already failed over), so dead
        weight and planned retirement share one bookkeeping funnel.
        Raises when removing the last live admission-capable (or, in a
        disaggregated fleet, decode-capable) replica."""
        rep = self.replica(name)
        if rep.state is not ReplicaState.DEAD:
            survivors = [r for r in self.replicas
                         if r is not rep and not r.retiring
                         and r.state is not ReplicaState.DEAD]
            if not any(r.role in ("both", "prefill") for r in survivors) \
                    or (self.disaggregated and not any(
                        r.role in ("both", "decode") for r in survivors)):
                raise ValueError(
                    f"cannot remove {name!r}: the fleet would have no "
                    "live admission/decode-capable replica left")
            if rep.state is not ReplicaState.DRAINING:
                rep.drain()
            rep.retiring = True
            self.rebalance_queued(rep)
        else:
            rep.retiring = True
        self._retire_pass()
        return rep

    def _retire_pass(self) -> None:
        """Pop retiring replicas that have gone empty (and retiring
        DEAD replicas outright — after re-homing any stragglers a
        death outside ``step()`` left behind)."""
        for r in list(self.replicas):
            if not r.retiring:
                continue
            if r.state is ReplicaState.DEAD:
                if any(tr.replica is r
                       for tr in self._requests.values()):
                    # died outside step() (operator mark_dead): the
                    # failover sweep never ran for it — run it now so
                    # retirement cannot strand tracked requests
                    self._on_replica_death(
                        r, r.error or ReplicaDead(r.name))
            elif r.pending:
                continue
            self.replicas.remove(r)
            self._fleet_version += 1
            self._c_removed.inc(replica=r.name)
            self._n["replicas_removed"] += 1
            self.fleet_events.append((self._steps, "remove", r.name))
            self._g_fleet.set(len(self.replicas))
            if self.recorder.enabled:
                self.recorder.record(
                    "router.replica_removed", replica=r.name,
                    state=r.state.value, fleet=len(self.replicas))

    def fleet_counts(self) -> Dict[str, int]:
        """Replica-lifecycle census: total plus per-state counts (the
        fleet-size timeline samples this)."""
        out = {"total": len(self.replicas), "serving": 0,
               "starting": 0, "draining": 0, "dead": 0}
        for r in self.replicas:
            out[r.state.value] += 1
        return out

    # -- client surface ----------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, **kw) -> int:
        """Place one request on the fleet; returns its FLEET-WIDE id
        (stable across handoffs and failovers — local engine rids are
        an implementation detail). Tries the policy's ranked candidates
        in order; raises ``AdmissionRejected`` only when every eligible
        replica shed."""
        # chaos hook: a dispatch fault fires BEFORE any placement or
        # tracking state mutates, so a failed dispatch leaves the
        # router consistent (the caller retries wholesale)
        faults.point("router.dispatch")
        candidates = self._admission_pool()
        last_shed: Optional[AdmissionRejected] = None
        for r in self.policy.rank(candidates, prompt):
            try:
                rid = r.submit(prompt, max_new_tokens, **kw)
            except AdmissionRejected as e:
                last_shed = e
                continue
            grid = next(self._grid)
            tr = _Tracked(grid, r, r.engine[rid])
            self._requests[grid] = tr
            self._local[(id(r), rid)] = grid
            self._c_dispatch.inc(replica=r.name)
            self._n["dispatched"] += 1
            return grid
        self._c_shed.inc()
        self._n["rejected"] += 1
        if last_shed is not None:
            raise last_shed
        raise AdmissionRejected(0, 0)    # no admission-capable replica

    def __getitem__(self, grid: int) -> Request:
        """The live ``Request`` behind a fleet id (its host token
        mirror — the object may move between replicas)."""
        return self._requests[grid].req

    @property
    def pending(self) -> bool:
        return bool(self._requests or self._finish_buf)

    def step(self) -> Dict[int, Request]:
        """One fleet iteration: every live replica advances one engine
        iteration (a replica failure here triggers the failover sweep,
        not an exception), then — disaggregated fleets — streams whose
        first token just landed on a prefill-class replica hand off to
        the decode pool. Returns ``{fleet id: terminal Request}``."""
        finished: Dict[int, Request] = {}
        for grid, req in self._finish_buf:
            finished[grid] = req
        self._finish_buf.clear()
        for r in list(self.replicas):
            if r.state is ReplicaState.DEAD or not r.pending:
                continue
            try:
                done = r.step()
            except Exception as e:     # lint: allow-swallow (fleet failover: the error is kept on the replica and every request is re-homed)
                self._on_replica_death(r, e)
                continue
            for req in done:
                grid = self._local.pop((id(r), req.rid), None)
                if grid is None:
                    continue           # not router-placed (direct use)
                tr = self._requests.pop(grid, None)
                if tr is not None:
                    self._stamp(tr)
                finished[grid] = req
        if self.disaggregated:
            self._handoff_pass()
        if self._orphans:
            self._retry_orphans()
        self._retire_pass()
        self._steps += 1
        if self.controller is not None \
                and self._steps % self._CTL_EVERY == 0:
            self.controller.tick()
        if self.timeseries is not None \
                and self._steps % self._CTL_EVERY == 0:
            # fleet scrape on the controller cadence — host-side
            # registry reads only, no device syncs
            self.timeseries.maybe_sample(step=self._steps)
        for grid, req in self._finish_buf:
            finished[grid] = req       # produced by handoff/cancel races
        self._finish_buf.clear()
        return finished

    def run(self, max_steps: Optional[int] = None,
            on_degraded: str = "raise") -> Dict[int, np.ndarray]:
        """Drive ``step()`` until every routed request is terminal;
        returns ``{fleet id: tokens}`` — the same contract as
        ``ServingEngine.run`` (``DegradedRequest`` on TIMED_OUT /
        CANCELLED drains unless ``on_degraded="return"``)."""
        if on_degraded not in ("raise", "return"):
            raise ValueError(
                f"on_degraded must be 'raise' or 'return', "
                f"got {on_degraded!r}")
        out: Dict[int, np.ndarray] = {}
        steps = 0
        while self.pending:
            for grid, req in self.step().items():
                if req.state is not RequestState.FINISHED \
                        and on_degraded == "raise":
                    self.recorder.auto_dump(
                        f"degraded_request:{req.state.value}")
                    raise DegradedRequest(req)
                out[grid] = req.tokens
            steps += 1
            if max_steps is not None and steps >= max_steps \
                    and self.pending:
                raise RuntimeError(
                    f"router made no full drain in {max_steps} steps "
                    f"({len(self._requests)} requests in flight)")
        return out

    def stream(self, grid: int):
        """Generator of this request's generated tokens as the fleet
        produces them: it drives ``step()`` while it waits, so the
        neighbours that finish meanwhile are not returned to anyone (use
        it alone, not beside ``step()``/``run``). The stream is seamless
        across handoffs and failovers: the router-side token log
        persists while the request moves."""
        tr = self._requests.get(grid)
        if tr is None:
            raise KeyError(grid)
        sent = 0
        while True:
            gen = tr.req.generated
            while sent < len(gen):
                yield int(gen[sent])
                sent += 1
            if tr.req.state in TERMINAL_STATES \
                    and sent >= len(tr.req.generated):
                return
            self.step()

    def cancel(self, grid: int) -> Request:
        """Cancel a routed request wherever it currently lives."""
        tr = self._requests.pop(grid)
        self._stamp(tr)
        if tr.replica is None:                    # orphaned: no engine
            self._orphans = [o for o in self._orphans if o is not tr]
            tr.req.state = RequestState.CANCELLED
            return tr.req
        self._local.pop((id(tr.replica), tr.req.rid), None)
        return tr.replica.engine.cancel(tr.req.rid)

    # -- migration ---------------------------------------------------------

    def _stamp(self, tr: _Tracked) -> None:
        """Copy the router-side movement counts onto the request before
        it is delivered: terminal requests carry how many times they
        moved (handoff/rebalance) and how many replica deaths they
        survived — the recovery accounting's per-request ground truth."""
        tr.req.n_handoffs = tr.handoffs
        tr.req.n_failovers = tr.failovers

    def _shrink_deadline(self, tr: _Tracked, req: Request,
                         src: EngineReplica) -> bool:
        """Carry the REMAINING deadline budget across a replica move.
        ``transfer_in`` restarts ``submit_t`` on the adopting engine's
        clock, so without this adjustment every migration would silently
        re-arm the full original budget. Returns False when the budget
        is already spent — the request is terminated TIMED_OUT at the
        router (it never reaches a new replica) and surfaced through
        the finish buffer."""
        if req.deadline_s is None:
            return True
        elapsed = max(0.0, src.engine.metrics.clock() - req.submit_t)
        remaining = req.deadline_s - elapsed
        if remaining <= 0:
            req.state = RequestState.TIMED_OUT
            self._requests.pop(tr.grid, None)
            self._stamp(tr)
            self._finish_buf.append((tr.grid, req))
            self._c_deadline.inc(src=src.name)
            self._n["deadline_expired"] += 1
            if self.recorder.enabled:
                self.recorder.record(
                    "router.deadline_expired", grid=tr.grid,
                    src=src.name, n_generated=len(req.generated))
            return False
        req.deadline_s = remaining
        return True

    def _targets_for(self, req: Request) -> List[EngineReplica]:
        pool = (self._decode_pool() if req.generated
                else self._admission_pool())
        return self.policy.rank(pool, req.prompt)

    def _place(self, tr: _Tracked, req: Request,
               exclude: Optional[EngineReplica] = None):
        """THE placement loop (every migration/failover/retry path
        funnels through here so the mapping bookkeeping cannot drift):
        try the policy's ranked targets; on success bind ``tr`` to the
        target and return it, else detach ``tr`` onto the orphan retry
        queue and return None."""
        for target in self._targets_for(req):
            if target is exclude:
                continue
            try:
                new_rid = target.transfer_in(req)
            except AdmissionRejected:
                continue
            tr.replica = target
            self._local[(id(target), new_rid)] = tr.grid
            return target
        tr.replica = None
        if tr not in self._orphans:
            self._orphans.append(tr)
        return None

    def _migrate(self, tr: _Tracked, counter, kind: str,
                 nkey: str) -> bool:
        """Move one live request off its replica through
        ``transfer_out``/``transfer_in``. Returns True when it landed
        somewhere; False when it finished during the pipeline drain
        (stays on the source for delivery) or no target accepted (the
        request is orphaned and retried next step)."""
        src = tr.replica
        old_key = (id(src), tr.req.rid)
        req = src.engine.transfer_out(tr.req.rid)
        if req is None:
            return False       # finished mid-drain; src delivers it
        self._local.pop(old_key, None)
        if not self._shrink_deadline(tr, req, src):
            return False       # budget spent mid-move: TIMED_OUT here
        target = self._place(tr, req, exclude=src)
        if target is None:
            return False
        counter.inc()
        self._n[nkey] += 1
        if self.recorder.enabled:
            self.recorder.record(
                f"router.{kind}", grid=tr.grid,
                src=src.name, dst=target.name,
                n_generated=len(req.generated))
        return True

    def _handoff_pass(self) -> None:
        """Disaggregated fleets: a stream whose first token landed on a
        prefill-class replica moves to the decode pool (token-identical
        re-prefill re-entry on the target)."""
        for tr in list(self._requests.values()):
            if tr.replica is None or tr.replica.role != "prefill":
                continue
            if tr.req.state is RequestState.DECODING \
                    and tr.req.generated:
                if self._migrate(tr, self._c_handoff, "handoff",
                                 "handoffs"):
                    tr.handoffs += 1

    def _retry_orphans(self) -> None:
        """Place detached requests that had nowhere to go (every
        target shed when they left their replica)."""
        orphans, self._orphans = self._orphans, []
        for tr in orphans:
            target = self._place(tr, tr.req)
            if target is not None and self.recorder.enabled:
                self.recorder.record(
                    "router.placed", grid=tr.grid, dst=target.name,
                    n_generated=len(tr.req.generated))

    def rebalance_queued(self, replica: EngineReplica) -> int:
        """Move a (typically draining) replica's QUEUED requests to the
        rest of the fleet; admitted streams stay and finish in place —
        the drain contract. Returns the number moved."""
        moved = 0
        for tr in list(self._requests.values()):
            if tr.replica is not replica:
                continue
            if tr.req.state is RequestState.QUEUED:
                if self._migrate(tr, self._c_rebalance, "rebalance",
                                 "rebalanced"):
                    tr.handoffs += 1
                    moved += 1
        return moved

    # -- failure handling --------------------------------------------------

    def _on_replica_death(self, replica: EngineReplica,
                          error: BaseException) -> None:
        """Replica failure = mass preemption at fleet scope: every
        in-flight request is re-admitted elsewhere from the router's
        request log alone — generated-token mirror plus a seed-replayed
        sampling key — and completes token-identically. Nothing from
        the dead engine (device state, pipeline, KV pages) is
        trusted."""
        replica.mark_dead(error)
        self._fleet_version += 1
        self.fleet_events.append((self._steps, "dead", replica.name))
        failed_over = 0
        for tr in list(self._requests.values()):
            if tr.replica is not replica:
                continue
            req = tr.req
            self._local.pop((id(replica), req.rid), None)
            if req.state in TERMINAL_STATES:
                # terminal but undelivered (the dying step's finished
                # list was lost with the exception): surface it now
                self._requests.pop(tr.grid, None)
                self._stamp(tr)
                self._finish_buf.append((tr.grid, req))
                continue
            if not self._shrink_deadline(tr, req, replica):
                continue       # budget spent before the re-admit
            # discard everything engine-local: the in-flight pipeline
            # step (recomputed identically), page/prefix bookkeeping,
            # and the slot key — replayed from the seed instead
            req.rng = _replay_key(req.seed, len(req.generated))
            tr.failovers += 1
            self._place(tr, req)
            self._c_failover.inc()
            self._n["failovers"] += 1
            failed_over += 1
        if self.recorder.enabled:
            self.recorder.record(
                "router.replica_dead", replica=replica.name,
                error=repr(error), failed_over=failed_over)
        self.recorder.auto_dump(f"replica_dead:{replica.name}")

    # -- views -------------------------------------------------------------

    def counters(self) -> Dict[str, int]:
        """Plain fleet totals (the registry carries the same series,
        labeled by replica, for exporters)."""
        return dict(self._n)

    def health(self) -> Dict:
        """Fleet readiness: per-replica ``health()`` plus the fleet
        verdict — ``"ok"`` while every live replica is clean,
        ``"degraded"`` while any replica is breaching/draining/dead but
        admission is still possible somewhere, ``"saturated"`` when no
        replica accepts."""
        reps = {r.name: r.health() for r in self.replicas}
        accepting = any(r.accepting for r in self._admission_pool())
        clean = all(
            st.get("status") == "ok" for st in reps.values())
        status = ("ok" if accepting and clean
                  else "degraded" if accepting else "saturated")
        return {
            "status": status,
            "accepting": accepting,
            "replicas": reps,
            "in_flight": len(self._requests),
            "orphans": len(self._orphans),
            "counters": self.counters(),
        }

    def telemetry(self) -> Dict:
        """Cross-replica telemetry: ``obs.aggregate_serving()`` over
        the unified snapshot (per-replica component summaries + summed
        fleet totals) plus router counters and replica lifecycle
        states."""
        agg = obs.aggregate_serving()
        agg["router"] = self.counters()
        agg["states"] = {r.name: r.state.value for r in self.replicas}
        agg["fleet"] = self.fleet_counts()
        if self.timeseries is not None:
            agg["timeseries"] = self.timeseries.summary()
        return agg


#: the client-facing alias: ``Router`` IS the client surface
#: (submit/run/stream mirror the single-engine API); the name exists
#: so call sites can say what they hold
RouterClient = Router
