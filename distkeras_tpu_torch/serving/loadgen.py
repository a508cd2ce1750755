"""Production-shaped workload generator and deterministic replayer
(mirrors ``distkeras_tpu/serving/loadgen.py``).

Production traffic comes in phases (diurnal ramps, step bursts, flash
crowds), with heavy-tailed prompt and output lengths and structured
prompt populations (shared templates that exercise the prefix cache,
tenants with their own priorities). This module makes such traffic a
replayable artifact and drives it through an engine or a router fleet:

* :func:`synthesize` expands a :class:`WorkloadSpec` into a
  :class:`Trace`, every request explicit (arrival iteration, prompt
  tokens, output budget, tenant, phase), from one numpy seed: the same
  spec and seed give the same trace, bit for bit, on any host and in
  both packages.
* ``Trace.to_jsonl`` / ``Trace.from_jsonl`` write and read it as typed
  JSONL lines under ``obs.exporters.SCHEMA_VERSION`` (``phase``,
  ``chaos`` and ``request`` records; unknown types are skipped).
* :func:`replay` drives the trace open-loop on the engine's iteration
  clock: arrivals are indexed by iteration, and an
  :class:`IterationClock` (``t = iteration * dt``) is the metrics, SLO
  and time-series clock, so no recorded number reads the wall clock and
  two replays give identical outcomes and reports. Each phase gets its
  own ``ServingMetrics`` window per engine.

The :class:`ReplayResult` is ``obs.report.build_report``'s input.
"""

from __future__ import annotations

import json
import math
import weakref
import zlib
from dataclasses import asdict, dataclass, field, fields
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from distkeras_tpu_torch.obs.exporters import SCHEMA_VERSION
from distkeras_tpu_torch.obs.slo import Objective, SLOEngine
from distkeras_tpu_torch.obs.timeseries import TimeSeries
from distkeras_tpu_torch.resilience import faults
from distkeras_tpu_torch.serving.metrics import ServingMetrics
from distkeras_tpu_torch.serving.scheduler import AdmissionRejected

__all__ = ["ChaosSpec", "IterationClock", "PhaseSpec", "PhaseResult",
           "ReplayResult", "TenantSpec", "Trace", "TraceRequest",
           "WorkloadSpec", "diurnal_burst_scenario",
           "flash_crowd_chaos_scenario", "replay", "synthesize"]


# --- workload specification -------------------------------------------------


@dataclass(frozen=True)
class PhaseSpec:
    """One arrival-process phase, ``duration`` engine iterations long.

    ``rate`` is the mean arrivals per iteration at the phase's end;
    ``shape="flat"`` holds it constant (a step burst / flash crowd is
    just a short flat phase at a high rate), ``shape="ramp"``
    interpolates linearly from ``rate0`` to ``rate`` (a diurnal ramp
    up, or down when ``rate0 > rate``)."""

    name: str
    duration: int
    rate: float
    shape: str = "flat"
    rate0: float = 0.0

    def __post_init__(self):
        if self.duration < 1:
            raise ValueError(f"phase {self.name!r}: duration must be "
                             f">= 1, got {self.duration}")
        if self.shape not in ("flat", "ramp"):
            raise ValueError(f"phase {self.name!r}: shape must be "
                             f"'flat' or 'ramp', got {self.shape!r}")
        if self.rate < 0 or self.rate0 < 0:
            raise ValueError(f"phase {self.name!r}: rates must be >= 0")

    def rate_at(self, i: int) -> float:
        """Arrival rate at iteration ``i`` of the phase (0-based)."""
        if self.shape == "flat" or self.duration <= 1:
            return self.rate
        frac = i / (self.duration - 1)
        return self.rate0 + (self.rate - self.rate0) * frac


@dataclass(frozen=True)
class TenantSpec:
    """One tenant class in the mix: sampled by ``weight``, submitted at
    ``priority`` (the PriorityScheduler classes)."""

    name: str
    weight: float = 1.0
    priority: int = 1


@dataclass(frozen=True)
class ChaosSpec:
    """One phase-anchored fault script entry: arm a
    ``resilience.faults`` injection point when the replay's iteration
    cursor reaches ``at``, optionally disarm it at ``clear_at``.

    The trigger knobs mirror ``faults.inject`` — ``nth`` (fire on the
    N-th pass after arming; default 1 when no trigger is given),
    ``every`` (a sustained fault storm), ``prob`` + ``seed`` (seeded
    stochastic faults — still deterministic, the fault point keeps its
    own ``RandomState``), ``action`` (``"raise"``/``"stall"``/
    ``"nan"``), ``stall_s`` and ``transient``. Scripts serialize into
    the trace JSONL as additive ``"chaos"`` records, so a chaos
    scenario is a replayable artifact exactly like its traffic:
    same trace + same fleet = byte-identical outcome, twice."""

    point: str
    at: int
    clear_at: Optional[int] = None
    nth: Optional[int] = None
    every: Optional[int] = None
    prob: Optional[float] = None
    seed: int = 0
    action: Optional[str] = None     # faults.inject default: raise
    stall_s: Optional[float] = None
    transient: bool = False

    def __post_init__(self):
        if not self.point:
            raise ValueError("ChaosSpec needs an injection point name")
        if self.at < 0:
            raise ValueError(f"chaos {self.point!r}: at must be >= 0")
        if self.clear_at is not None and self.clear_at <= self.at:
            raise ValueError(
                f"chaos {self.point!r}: clear_at ({self.clear_at}) "
                f"must be > at ({self.at})")

    def inject_kwargs(self) -> Dict:
        """The ``faults.inject`` keyword set this entry arms (defaults
        to ``nth=1`` when no trigger knob is given)."""
        kw: Dict = {"seed": self.seed, "transient": self.transient}
        if self.action is not None:
            kw["action"] = self.action
        if self.stall_s is not None:
            kw["stall_s"] = self.stall_s
        if self.nth is not None:
            kw["nth"] = self.nth
        if self.every is not None:
            kw["every"] = self.every
        if self.prob is not None:
            kw["prob"] = self.prob
        if self.nth is None and self.every is None and self.prob is None:
            kw["nth"] = 1
        return kw


@dataclass(frozen=True)
class WorkloadSpec:
    """The full workload shape :func:`synthesize` expands.

    Lengths are heavy-tailed lognormals (median/sigma), clipped to
    ``[1, *_max]``; prompt lengths additionally round UP to multiples
    of ``length_quantum``, as production deployments bucket prompt
    lengths. A ``template_frac`` fraction of prompts start with one of
    ``n_templates`` shared ``template_len``-token prefixes (the
    prefix-cache exercise); the rest are fully random.

    A ``sampled_frac`` fraction of requests decode stochastically
    (``temperature``/``top_p`` — the byte-identity acceptance for
    chaos scenarios needs sampled streams, greedy ones cannot expose a
    broken failover key replay); a ``deadline_frac`` fraction carry a
    ``deadline_iters``-iteration submit→finish budget (a deadline
    flood = a phase worth of arrivals with tight budgets). ``chaos``
    is the phase-anchored fault script (:class:`ChaosSpec`), carried
    into the trace and armed live by :func:`replay`."""

    vocab: int
    phases: Tuple[PhaseSpec, ...]
    prompt_median: float = 12.0
    prompt_sigma: float = 0.6
    prompt_max: int = 32
    output_median: float = 8.0
    output_sigma: float = 0.6
    output_max: int = 24
    length_quantum: int = 4
    n_templates: int = 4
    template_len: int = 8
    template_frac: float = 0.5
    tenants: Tuple[TenantSpec, ...] = (TenantSpec("standard"),)
    sampled_frac: float = 0.0
    temperature: float = 0.9
    top_p: float = 0.95
    deadline_frac: float = 0.0
    deadline_iters: int = 0
    chaos: Tuple[ChaosSpec, ...] = ()

    def __post_init__(self):
        if not 0.0 <= self.sampled_frac <= 1.0:
            raise ValueError("sampled_frac must be in [0, 1]")
        if not 0.0 <= self.deadline_frac <= 1.0:
            raise ValueError("deadline_frac must be in [0, 1]")
        if self.deadline_frac > 0 and self.deadline_iters < 1:
            raise ValueError(
                "deadline_frac > 0 needs deadline_iters >= 1")
        if self.vocab < 3:
            raise ValueError(f"vocab must be >= 3, got {self.vocab}")
        if not self.phases:
            raise ValueError("WorkloadSpec needs at least one phase")
        if self.length_quantum < 1:
            raise ValueError("length_quantum must be >= 1")
        if self.template_len >= self.prompt_max:
            raise ValueError(
                f"template_len ({self.template_len}) must be < "
                f"prompt_max ({self.prompt_max})")
        if not self.tenants:
            raise ValueError("WorkloadSpec needs at least one tenant")
        if not 0.0 <= self.template_frac <= 1.0:
            raise ValueError("template_frac must be in [0, 1]")

    @property
    def total_iterations(self) -> int:
        return sum(p.duration for p in self.phases)


# --- the trace --------------------------------------------------------------


@dataclass(frozen=True)
class TraceRequest:
    """One materialized request: everything replay needs, explicit.
    ``deadline`` is an ITERATION budget (converted to seconds with the
    replay's ``dt``); ``temperature``/``top_p`` make the stream
    stochastic (seeded per-request at replay — index = seed)."""

    arrival: int                  # engine iteration it becomes visible
    prompt: Tuple[int, ...]
    max_new_tokens: int
    tenant: str = "standard"
    priority: int = 1
    phase: str = ""
    template: Optional[int] = None
    deadline: Optional[int] = None
    temperature: float = 0.0
    top_p: float = 1.0


@dataclass(frozen=True)
class PhaseSpan:
    """Iteration span ``[start, end)`` a phase covered in the trace."""

    name: str
    start: int
    end: int


@dataclass(frozen=True)
class Trace:
    """A replayable workload: requests + phase spans + the chaos
    script + provenance. The chaos entries ride in the same JSONL
    artifact as the traffic (additive ``"chaos"`` record type), so a
    stored chaos scenario is one self-contained file."""

    requests: Tuple[TraceRequest, ...]
    phases: Tuple[PhaseSpan, ...]
    meta: Dict = field(default_factory=dict, compare=True)
    chaos: Tuple[ChaosSpec, ...] = ()

    def __len__(self) -> int:
        return len(self.requests)

    # -- JSONL round trip (exporter conventions) ---------------------

    def to_jsonl(self, path: str) -> None:
        """Typed JSONL lines: one ``meta`` header (carries
        ``schema_version`` + provenance), one ``phase`` line per span,
        one ``chaos`` line per fault-script entry, one ``request`` line
        per request. Additive record types under the exporter
        forward-compat contract."""
        with open(path, "w") as f:
            f.write(json.dumps(
                {"type": "meta", "seq": 0,
                 "schema_version": SCHEMA_VERSION,
                 "kind": "loadgen_trace", "n_requests": len(self.requests),
                 **self.meta}) + "\n")
            for p in self.phases:
                f.write(json.dumps(
                    {"type": "phase", "seq": 0, "name": p.name,
                     "start": p.start, "end": p.end}) + "\n")
            for c in self.chaos:
                f.write(json.dumps(
                    {"type": "chaos", "seq": 0, **asdict(c)}) + "\n")
            for i, r in enumerate(self.requests):
                rec = {"type": "request", "seq": 0, "i": i,
                       "arrival": r.arrival, "prompt": list(r.prompt),
                       "max_new_tokens": r.max_new_tokens,
                       "tenant": r.tenant, "priority": r.priority,
                       "phase": r.phase, "template": r.template}
                # additive keys, written only when non-default so old
                # traces byte-compare against re-serialized ones
                if r.deadline is not None:
                    rec["deadline"] = r.deadline
                if r.temperature:
                    rec["temperature"] = r.temperature
                    rec["top_p"] = r.top_p
                f.write(json.dumps(rec) + "\n")

    @classmethod
    def from_jsonl(cls, path: str) -> "Trace":
        """Inverse of :meth:`to_jsonl`; skips record types it does not
        know (the same forward-compat stance as
        ``exporters.read_jsonl``)."""
        meta: Dict = {}
        phases: List[PhaseSpan] = []
        chaos: List[ChaosSpec] = []
        reqs: List[Tuple[int, TraceRequest]] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                t = rec.get("type")
                if t == "meta" and rec.get("kind") == "loadgen_trace":
                    meta = {k: v for k, v in rec.items()
                            if k not in ("type", "seq", "schema_version",
                                         "kind", "n_requests")}
                elif t == "phase":
                    phases.append(PhaseSpan(rec["name"], rec["start"],
                                            rec["end"]))
                elif t == "chaos":
                    # unknown keys skipped: additive chaos-record
                    # fields must not break old readers
                    known = {f.name for f in fields(ChaosSpec)}
                    chaos.append(ChaosSpec(**{
                        k: v for k, v in rec.items() if k in known}))
                elif t == "request":
                    reqs.append((rec["i"], TraceRequest(
                        arrival=rec["arrival"],
                        prompt=tuple(rec["prompt"]),
                        max_new_tokens=rec["max_new_tokens"],
                        tenant=rec.get("tenant", "standard"),
                        priority=rec.get("priority", 1),
                        phase=rec.get("phase", ""),
                        template=rec.get("template"),
                        deadline=rec.get("deadline"),
                        temperature=rec.get("temperature", 0.0),
                        top_p=rec.get("top_p", 1.0))))
        reqs.sort(key=lambda p: p[0])
        return cls(requests=tuple(r for _, r in reqs),
                   phases=tuple(phases), meta=meta,
                   chaos=tuple(chaos))


def synthesize(spec: WorkloadSpec, seed: int = 0) -> Trace:
    """Expand a :class:`WorkloadSpec` into a :class:`Trace` — one
    ``numpy.random.RandomState(seed)`` drives every draw (arrival
    counts, lengths, tenant/template picks, token values), so the
    trace is bit-identical across hosts and runs."""
    rs = np.random.RandomState(seed)
    templates = [rs.randint(1, spec.vocab, size=spec.template_len)
                 .tolist() for _ in range(spec.n_templates)]
    weights = np.asarray([t.weight for t in spec.tenants], np.float64)
    cum = np.cumsum(weights / weights.sum())
    q = spec.length_quantum

    def _length(median: float, sigma: float, lo: int, hi: int,
                quantize: bool) -> int:
        n = int(np.round(rs.lognormal(mean=math.log(median),
                                      sigma=sigma)))
        if quantize:
            n = int(math.ceil(max(n, 1) / q) * q)
        return int(np.clip(n, lo, hi))

    requests: List[TraceRequest] = []
    phases: List[PhaseSpan] = []
    it0 = 0
    for ph in spec.phases:
        for i in range(ph.duration):
            for _ in range(int(rs.poisson(ph.rate_at(i)))):
                tenant = spec.tenants[int(np.searchsorted(
                    cum, rs.random_sample()))]
                tid = None
                total = _length(spec.prompt_median, spec.prompt_sigma,
                                q, spec.prompt_max, quantize=True)
                if spec.n_templates and rs.random_sample() \
                        < spec.template_frac:
                    tid = int(rs.randint(spec.n_templates))
                    if total <= spec.template_len:
                        total = min(spec.prompt_max,
                                    spec.template_len + q)
                    prompt = templates[tid] + rs.randint(
                        1, spec.vocab,
                        size=total - spec.template_len).tolist()
                else:
                    prompt = rs.randint(1, spec.vocab,
                                        size=total).tolist()
                out_len = _length(spec.output_median, spec.output_sigma,
                                  1, spec.output_max, quantize=False)
                # conditional draws: with the fractions at their 0.0
                # defaults the RandomState stream is untouched, so
                # pre-existing (spec, seed) pairs keep their traces
                temp, top_p = 0.0, 1.0
                if spec.sampled_frac > 0 and \
                        rs.random_sample() < spec.sampled_frac:
                    temp, top_p = spec.temperature, spec.top_p
                deadline = None
                if spec.deadline_frac > 0 and \
                        rs.random_sample() < spec.deadline_frac:
                    deadline = spec.deadline_iters
                requests.append(TraceRequest(
                    arrival=it0 + i, prompt=tuple(prompt),
                    max_new_tokens=out_len, tenant=tenant.name,
                    priority=tenant.priority, phase=ph.name,
                    template=tid, deadline=deadline,
                    temperature=temp, top_p=top_p))
        phases.append(PhaseSpan(ph.name, it0, it0 + ph.duration))
        it0 += ph.duration
    meta = {"seed": int(seed), "vocab": spec.vocab,
            "total_iterations": spec.total_iterations,
            "spec": {**asdict(spec),
                     "phases": [asdict(p) for p in spec.phases],
                     "tenants": [asdict(t) for t in spec.tenants],
                     "chaos": [asdict(c) for c in spec.chaos]}}
    return Trace(requests=tuple(requests), phases=tuple(phases),
                 meta=meta, chaos=tuple(sorted(
                     spec.chaos, key=lambda c: (c.at, c.point))))


def diurnal_burst_scenario(vocab: int, *, scale: float = 1.0,
                           prompt_max: int = 24, output_max: int = 12,
                           length_quantum: int = 8,
                           tenants: Optional[Sequence[TenantSpec]] = None
                           ) -> WorkloadSpec:
    """The fixed reference scenario: a diurnal ramp to
    steady state, a 4x step burst, recovery, a short flash crowd, and
    a ramp-down — ~200 iterations end to end. ``scale`` multiplies
    every arrival rate (0.25 for quick tier-1 runs)."""
    s = float(scale)
    return WorkloadSpec(
        vocab=vocab,
        phases=(
            PhaseSpec("ramp_up", 40, rate=0.30 * s, shape="ramp",
                      rate0=0.02 * s),
            PhaseSpec("steady", 50, rate=0.30 * s),
            PhaseSpec("burst", 25, rate=1.20 * s),
            PhaseSpec("recovery", 40, rate=0.25 * s),
            PhaseSpec("flash", 10, rate=2.50 * s),
            PhaseSpec("cooldown", 40, rate=0.05 * s, shape="ramp",
                      rate0=0.25 * s),
        ),
        prompt_median=10.0, prompt_sigma=0.5, prompt_max=prompt_max,
        output_median=6.0, output_sigma=0.5, output_max=output_max,
        length_quantum=length_quantum,
        n_templates=3, template_len=min(8, prompt_max - length_quantum),
        template_frac=0.5,
        tenants=tuple(tenants) if tenants is not None else (
            TenantSpec("interactive", weight=3.0, priority=0),
            TenantSpec("standard", weight=6.0, priority=1),
            TenantSpec("batch", weight=1.0, priority=2)))


def flash_crowd_chaos_scenario(vocab: int, *, scale: float = 1.0,
                               prompt_max: int = 24, output_max: int = 12,
                               length_quantum: int = 8,
                               kill_at: Optional[int] = None,
                               sampled_frac: float = 0.5
                               ) -> WorkloadSpec:
    """The fixed chaos reference scenario: warm-up to steady state, a
    flash crowd with
    a scripted ``replica.die`` mid-crowd (``kill_at`` defaults to the
    crowd's first third), then recovery and cooldown — the overload
    and the capacity loss land TOGETHER, which is exactly when an
    autoscaler must not flap. Half the streams sample stochastically
    so failover byte-identity is actually exercised."""
    s = float(scale)
    warm, steady, crowd = 30, 30, 30
    if kill_at is None:
        kill_at = warm + steady + crowd // 3
    return WorkloadSpec(
        vocab=vocab,
        phases=(
            PhaseSpec("warmup", warm, rate=0.20 * s, shape="ramp",
                      rate0=0.02 * s),
            PhaseSpec("steady", steady, rate=0.25 * s),
            PhaseSpec("flash", crowd, rate=2.00 * s),
            PhaseSpec("recovery", 40, rate=0.20 * s),
            PhaseSpec("cooldown", 30, rate=0.04 * s, shape="ramp",
                      rate0=0.20 * s),
        ),
        prompt_median=10.0, prompt_sigma=0.5, prompt_max=prompt_max,
        output_median=6.0, output_sigma=0.5, output_max=output_max,
        length_quantum=length_quantum,
        n_templates=2, template_len=min(8, prompt_max - length_quantum),
        template_frac=0.5, sampled_frac=sampled_frac,
        tenants=(TenantSpec("interactive", weight=3.0, priority=0),
                 TenantSpec("standard", weight=6.0, priority=1)),
        chaos=(ChaosSpec("replica.die", at=int(kill_at)),))


# --- deterministic replay ---------------------------------------------------


class IterationClock:
    """A virtual clock ticking ``dt`` seconds per engine iteration.
    Installed as the metrics/SLO/time-series clock during replay, it
    makes every recorded timestamp, latency and rate a pure function
    of iteration count — deterministic on any host, no sleeps."""

    def __init__(self, dt: float = 1e-3, t0: float = 0.0):
        if dt <= 0:
            raise ValueError(f"dt must be > 0, got {dt}")
        self.dt = float(dt)
        self._t = float(t0)

    def __call__(self) -> float:
        return self._t

    def advance(self, n: int = 1) -> float:
        self._t += n * self.dt
        return self._t


@dataclass
class PhaseResult:
    """One phase's outcome: per-engine metrics-window summaries and
    SLO statuses (single-engine replays are a fleet of one), plus the
    submit/shed counts of arrivals that fell inside the phase."""

    name: str
    start: int                    # iteration span [start, end)
    end: int
    t0: float                     # virtual-clock span
    t1: float
    submitted: int = 0
    shed: int = 0
    summaries: Dict[str, Dict] = field(default_factory=dict)
    slo: Dict[str, Dict] = field(default_factory=dict)


@dataclass
class ReplayResult:
    """Everything :func:`obs.report.build_report` joins: the trace,
    per-phase results, per-request outcomes, and the live handles
    (time series per engine, SLO engines) for timeline slicing."""

    trace: Trace
    phases: List[PhaseResult]
    outcomes: List[Dict]
    iterations: int
    dt: float
    fleet: bool
    engine_ids: List[str]
    timeseries: Dict[str, TimeSeries]
    slo: Dict[str, Optional[SLOEngine]]
    #: chaos triggers observed live: {"t", "iteration", "point"} per
    #: firing (the recovery report's incident anchors)
    incidents: List[Dict] = field(default_factory=list)
    #: fleet-size census at t=0 and after every fleet mutation:
    #: {"t", "iteration", "total", "serving", ...} (router targets)
    fleet_timeline: List[Dict] = field(default_factory=list)
    #: autoscale decisions stamped with virtual time as they appeared
    autoscale_events: List[Dict] = field(default_factory=list)

    @property
    def totals(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for o in self.outcomes:
            counts[o["state"]] = counts.get(o["state"], 0) + 1
        counts["total"] = len(self.outcomes)
        return counts


def _token_crc(tokens) -> int:
    """Cheap deterministic fingerprint of a request's full token
    sequence — two replays are token-identical iff these match."""
    return zlib.crc32(np.ascontiguousarray(
        np.asarray(tokens, np.int64)).tobytes())




def replay(trace: Trace, target, *,
           objectives: Optional[Sequence[Objective]] = None,
           dt: float = 1e-3, max_steps: Optional[int] = None,
           timeseries_capacity: int = 2048) -> ReplayResult:
    """Drive ``trace`` open-loop through ``target`` (a ``ServingEngine``
    or a ``Router`` fleet) on a virtual iteration clock (JAX :590).

    Per engine the replay installs a fresh ``ServingMetrics`` window on
    the shared :class:`IterationClock` (swapped at every phase boundary,
    the pipeline drained into the old window first), a time series on
    the same clock that follows the live window, and with
    ``objectives`` an ``SLOEngine`` that the engine evaluates on its own
    cadence and the replay at each phase boundary.

    Arrivals submit when the clock reaches their iteration; an
    ``AdmissionRejected`` records the request as shed. Idle gaps jump to
    the next arrival, phase end or chaos event. After the last phase the
    fleet drains as the phase ``(drain)``.

    The trace's :class:`ChaosSpec` entries arm their fault points when
    the cursor reaches ``at`` (and disarm at ``clear_at`` and on exit);
    each firing is an incident ``{"t", "iteration", "point"}``. For a
    fleet the replay follows what the fleet does to itself: a replica a
    controller adds is put on the same clock, a dead one is not flushed
    again, the census lands in ``fleet_timeline`` and the controller's
    decisions in ``autoscale_events``.

    The replay holds each engine weakly: a replica that leaves the fleet
    keeps its metrics windows and time series here, while its pool and
    weights go with the engine (a retired engine's windows are empty
    from then on, as an idle engine's are)."""
    fleet = hasattr(target, "replicas")

    # report keys must not depend on the obs registry's disambiguators
    # ("serving[0x..]", "r0#0x..") unless the plain name collides
    def _stable(name: str) -> str:
        return name.split("[", 1)[0].split("#", 1)[0]

    clock = IterationClock(dt)
    #: engine id -> weak reference to the engine
    engines: Dict[str, weakref.ref] = {}
    #: engine id -> its current metrics window (the time series reads
    #: it here, so nothing of the replay's keeps an engine alive)
    windows: Dict[str, ServingMetrics] = {}
    tseries: Dict[str, TimeSeries] = {}
    slos: Dict[str, Optional[SLOEngine]] = {}
    eid_of: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def _install(name: str, eng) -> None:
        """Put one engine on the virtual clock: a fresh window, a time
        series on the clock, its SLO engine; also for a replica a
        controller adds mid-replay."""
        key = _stable(name)
        eid = name if key in engines else key
        windows[eid] = eng.metrics = ServingMetrics(clock=clock)
        ts = TimeSeries(
            (lambda e=eid: windows[e].registry),
            capacity=timeseries_capacity, clock=clock,
            tags={"engine": eid})
        eng.timeseries = ts
        tseries[eid] = ts
        slo = (SLOEngine(list(objectives), clock=clock)
               if objectives else None)
        eng.slo = slo
        slos[eid] = slo
        engines[eid] = weakref.ref(eng)
        eid_of[eng] = eid

    if fleet:
        for rep in target.replicas:
            _install(rep.name, rep.engine)
        del rep           # this frame must not hold a replica
    else:
        _install(target.engine_id, target)

    def _busy() -> bool:
        if fleet:
            return target.pending
        if target.scheduler.pending or target._finish_buf:
            return True
        if target._pending is not None:
            # a unit launched before the flush that finished the batch's
            # last stream: step() would never consume it, so consume it
            # here (anything live lands in _finish_buf)
            target._flush_pending()
            return bool(target._finish_buf)
        return False

    reqs = sorted(enumerate(trace.requests), key=lambda p: p[1].arrival)
    outcomes: List[Dict] = [
        {"i": i, "phase": r.phase, "tenant": r.tenant,
         "state": "unsubmitted", "n_tokens": 0}
        for i, r in enumerate(trace.requests)]
    rid_to_idx: Dict[int, int] = {}

    def _submit(idx: int, tr: TraceRequest) -> None:
        prompt = np.asarray(tr.prompt, np.int32)
        kw: Dict = {}
        if tr.deadline is not None:
            # iteration budget -> virtual seconds
            kw["deadline_s"] = tr.deadline * dt
        if tr.temperature:
            kw["temperature"] = tr.temperature
            kw["top_p"] = tr.top_p
        try:
            rid = target.submit(prompt, tr.max_new_tokens,
                                priority=tr.priority, seed=idx, **kw)
        except AdmissionRejected:
            outcomes[idx]["state"] = "shed"
            return
        rid_to_idx[rid] = idx
        outcomes[idx]["state"] = "submitted"

    def _consume(terminals) -> None:
        items = (terminals.items() if isinstance(terminals, dict)
                 else ((r.rid, r) for r in terminals))
        for rid, req in items:
            idx = rid_to_idx.pop(rid, None)
            if idx is None:
                continue
            o = outcomes[idx]
            o["state"] = req.state.name.lower()
            o["n_tokens"] = len(req.generated)
            o["tokens_crc"] = _token_crc(req.tokens)
            o["failovers"] = req.n_failovers
            o["handoffs"] = req.n_handoffs

    def _close_phase(name: str, start: int, end: int,
                     t0: float, submitted_slice) -> PhaseResult:
        res = PhaseResult(name=name, start=start, end=end,
                          t0=t0, t1=clock())
        for eid in engines:
            eng = engines[eid]()
            if eng is not None and eid not in dead:
                # a chaos-killed engine is never flushed again
                eng._flush_pending()
                eng._flush_host_window()
            tseries[eid].sample(iteration=end)
            win = windows[eid]
            if slos[eid] is not None:
                res.slo[eid] = slos[eid].evaluate(win)
            res.summaries[eid] = win.summary()
            # a fresh window per phase; the scraper's counter baselines
            # are void across the swap
            windows[eid] = ServingMetrics(clock=clock)
            if eng is not None:
                eng.metrics = windows[eid]
            tseries[eid].reset_baseline()
        for o in submitted_slice:
            if o["state"] == "shed":
                res.shed += 1
            else:
                res.submitted += 1
        return res

    # -- chaos script + recovery bookkeeping -----------------------------
    if fleet:
        from distkeras_tpu_torch.serving.router.replica import ReplicaState
    dead: set = set()               # engine ids of dead replicas
    incidents: List[Dict] = []
    fleet_timeline: List[Dict] = []
    autoscale_events: List[Dict] = []
    chaos = sorted(trace.chaos, key=lambda c: (c.at, c.point))
    armed: List[ChaosSpec] = []
    pending_clears: List[ChaosSpec] = []
    chaos_i = 0
    cur_it = [0]                    # the listener reads the live cursor

    def _on_trigger(point: str) -> None:
        incidents.append({"t": clock(), "iteration": cur_it[0],
                          "point": point})

    def _chaos_tick(i: int) -> None:
        """Arm every entry whose iteration has come, disarm expired
        storms: anchored to the iteration cursor, so two replays arm
        identically."""
        nonlocal chaos_i
        while chaos_i < len(chaos) and chaos[chaos_i].at <= i:
            c = chaos[chaos_i]
            faults.inject(c.point, **c.inject_kwargs())
            armed.append(c)
            if c.clear_at is not None:
                pending_clears.append(c)
            chaos_i += 1
        for c in list(pending_clears):
            if c.clear_at <= i:
                faults.clear(c.point)
                pending_clears.remove(c)

    def _next_chaos_event(after: int) -> Optional[int]:
        cands = ([chaos[chaos_i].at] if chaos_i < len(chaos) else []) \
            + [c.clear_at for c in pending_clears]
        return min((x for x in cands if x > after), default=None)

    def _find_decisions(t):
        ctl = getattr(t, "controller", None)
        if ctl is None:
            return None
        if hasattr(ctl, "decisions"):
            return ctl.decisions
        for c in getattr(ctl, "controllers", ()):
            if hasattr(c, "decisions"):
                return c.decisions
        return None

    ctl_decisions = _find_decisions(target) if fleet else None
    decisions_seen = len(ctl_decisions) if ctl_decisions else 0
    fleet_ver = [getattr(target, "_fleet_version", 0)] if fleet else [0]
    if fleet:
        fleet_timeline.append({"t": clock(), "iteration": 0,
                               **target.fleet_counts()})

    def _post_step(i: int) -> None:
        """After every fleet step: mark newly dead engines, install the
        clock on replicas a controller just added, extend the census,
        stamp fresh autoscale decisions."""
        nonlocal decisions_seen
        if not fleet:
            return
        for r in target.replicas:
            if r.state is ReplicaState.DEAD and r.engine in eid_of:
                dead.add(eid_of[r.engine])
        if target._fleet_version != fleet_ver[0]:
            fleet_ver[0] = target._fleet_version
            for r in target.replicas:
                if r.engine not in eid_of:
                    _install(r.name, r.engine)
            fleet_timeline.append({"t": clock(), "iteration": i,
                                   **target.fleet_counts()})
        if ctl_decisions is not None:
            while decisions_seen < len(ctl_decisions):
                d = dict(ctl_decisions[decisions_seen])
                d["t"] = clock()
                d["iteration"] = i
                autoscale_events.append(d)
                decisions_seen += 1

    phase_results: List[PhaseResult] = []
    next_i = 0                      # cursor into arrival-sorted reqs
    it = 0
    budget = (max_steps if max_steps is not None
              else trace.meta.get("total_iterations", 0) * 50 + 20000)
    steps = 0
    faults.add_trigger_listener(_on_trigger)
    try:
        for span in trace.phases:
            t0 = clock()
            lo_i = next_i
            while it < span.end:
                cur_it[0] = it
                _chaos_tick(it)
                while next_i < len(reqs) and \
                        reqs[next_i][1].arrival <= it:
                    idx, tr = reqs[next_i]
                    _submit(idx, tr)
                    next_i += 1
                if _busy():
                    _consume(target.step())
                    _post_step(it)
                    steps += 1
                    if steps > budget:
                        raise RuntimeError(
                            f"replay exceeded {budget} steps (phase "
                            f"{span.name!r}, iteration {it}) — engine "
                            "not draining?")
                    clock.advance()
                    it += 1
                else:
                    # jump to the next arrival, chaos event or phase end,
                    # never past a scripted arming iteration
                    nxt = (reqs[next_i][1].arrival
                           if next_i < len(reqs) else span.end)
                    ce = _next_chaos_event(it)
                    if ce is not None:
                        nxt = min(nxt, ce)
                    jump = max(1, min(nxt, span.end) - it)
                    clock.advance(jump)
                    it += jump
            phase_results.append(_close_phase(
                span.name, span.start, span.end, t0,
                [outcomes[i] for i, _ in reqs[lo_i:next_i]]))
        # drain tail: everything still in flight finishes here
        t0 = clock()
        start = it
        while _busy():
            cur_it[0] = it
            _chaos_tick(it)
            _consume(target.step())
            _post_step(it)
            steps += 1
            if steps > budget:
                raise RuntimeError(
                    f"replay drain exceeded {budget} steps — engine "
                    "not draining?")
            clock.advance()
            it += 1
        if it > start or any(o["state"] == "submitted"
                             for o in outcomes):
            phase_results.append(
                _close_phase("(drain)", start, it, t0, []))
    finally:
        # no script entry stays armed past the replay
        for c in armed:
            faults.clear(c.point)
        faults.remove_trigger_listener(_on_trigger)
    return ReplayResult(
        trace=trace, phases=phase_results, outcomes=outcomes,
        iterations=it, dt=dt, fleet=fleet,
        engine_ids=list(engines), timeseries=tseries, slo=slos,
        incidents=incidents, fleet_timeline=fleet_timeline,
        autoscale_events=autoscale_events)
