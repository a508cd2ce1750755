"""SLO engine: declarative latency/availability objectives with
burn-rate accounting over the existing reservoir histograms.

The degradation machinery (deadlines, bounded admission —
``docs/resilience.md``) so far triggered on ad-hoc thresholds; this
module gives it the principled trigger production serving uses:
*objectives* stated as user-facing promises ("99% of requests see
TTFT under X seconds", "99.9% of terminal requests end FINISHED —
sheds, timeouts and cancellations all spend the availability budget")
evaluated continuously, with a *burn rate* that says how fast the
error budget is being spent.

Definitions (the SRE-workbook convention):

* an objective promises that a ``target`` fraction of requests are
  *good* — under the latency ``threshold``, or terminal-state
  ``finished`` for availability;
* the **error budget** is ``1 - target`` (the tolerated bad fraction);
* the **burn rate** is ``bad_fraction / (1 - target)``: 1.0 means
  exactly on budget, 2.0 means the budget spends twice as fast as it
  accrues, 0 means a clean window. A **breach** is
  ``good_fraction < target`` — for a latency objective this is the
  same statement as "the target percentile exceeds the threshold".

Evaluation reads the ``ServingMetrics`` window's reservoir histograms
(``serving.ttft_s`` / ``serving.tpot_s``) and terminal counters — no
new per-request storage; good fractions come from the reservoir
samples (exact until the reservoir fills, a uniform sample after).
Each ``evaluate()`` lands ``slo.good_fraction`` / ``slo.burn_rate``
gauges (labeled by objective) on the obs registry and increments the
``slo.breach`` counter on each ok->breach transition; evaluations are
retained over a rolling ``window_s`` so ``status()`` can report the
window-max burn rate (the page-worthy number) next to the latest one.

``ServingEngine(slo=[...])`` evaluates every few iterations and
reports objective status in ``health()`` and
``telemetry_snapshot()["components"]["serving"]["slo"]``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from distkeras_tpu_torch.obs.timeseries import Ring
from distkeras_tpu_torch.utils.profiling import now, percentiles

__all__ = ["Objective", "SLOEngine", "availability", "latency_objective",
           "tpot_p99", "ttft_p99"]


@dataclass(frozen=True)
class Objective:
    """One declarative objective (see module doc).

    ``kind="latency"``: ``target`` fraction of ``metric`` histogram
    samples must sit at or under ``threshold`` seconds (``ttft_p99 <
    0.5`` == ``Objective("ttft_p99", "latency", "serving.ttft_s",
    0.5, 0.99)``). ``kind="availability"``: ``target`` fraction of
    terminal requests must end FINISHED (not rejected / timed out /
    cancelled)."""

    name: str
    kind: str = "latency"
    metric: str = ""
    threshold: float = 0.0
    target: float = 0.99

    def __post_init__(self):
        if self.kind not in ("latency", "availability"):
            raise ValueError(
                f"objective {self.name!r}: kind must be 'latency' or "
                f"'availability', got {self.kind!r}")
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"objective {self.name!r}: target must be in (0, 1), "
                f"got {self.target}")
        if self.kind == "latency":
            if not self.metric:
                raise ValueError(
                    f"objective {self.name!r}: latency objectives need "
                    "a histogram metric name")
            if self.threshold <= 0.0:
                raise ValueError(
                    f"objective {self.name!r}: threshold must be > 0, "
                    f"got {self.threshold}")


def latency_objective(name: str, metric: str, threshold_s: float,
                      target: float = 0.99) -> Objective:
    return Objective(name, "latency", metric, float(threshold_s),
                     float(target))


def ttft_p99(threshold_s: float) -> Objective:
    """``ttft_p99 < threshold_s``: 99% of requests see their first
    token within the threshold (queueing + prompt ingestion)."""
    return latency_objective("ttft_p99", "serving.ttft_s", threshold_s)


def tpot_p99(threshold_s: float) -> Objective:
    """``tpot_p99 < threshold_s``: 99% of finished multi-token requests
    average at most the threshold per generated token after the first
    (the streaming-smoothness promise)."""
    return latency_objective("tpot_p99", "serving.tpot_s", threshold_s)


def availability(target: float = 0.999) -> Objective:
    """``target`` fraction of terminal requests end FINISHED."""
    return Objective("availability", "availability", target=float(target))


class SLOEngine:
    """Evaluate a set of objectives against a ``ServingMetrics`` window
    (module doc has the burn-rate definitions).

    ``registry`` (default: the global obs registry) receives the
    ``slo.good_fraction`` / ``slo.burn_rate`` gauges and the
    ``slo.breach`` transition counter, so SLO state rides every
    exporter. Thread-safe; ``clock`` is injectable for tests and
    should match the metrics window's clock."""

    def __init__(self, objectives: Sequence[Objective],
                 window_s: float = 300.0, clock=now, registry=None,
                 history_capacity: int = 1024):
        objectives = list(objectives)
        if not objectives:
            raise ValueError("SLOEngine needs at least one objective")
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        if registry is None:
            from distkeras_tpu_torch import obs
            registry = obs.get_registry()
        self.objectives = objectives
        self.window_s = float(window_s)
        self.clock = clock
        self.registry = registry
        self._lock = threading.Lock()
        #: timestamped evaluation history — the ONE burn trajectory.
        #: ``status()``/``health()`` window-max and ``obs.report``'s
        #: per-phase max-burn both read this ring (capacity-bounded;
        #: ``window_s`` filtering happens at read time).
        self.history = Ring(history_capacity)  # (t, {name: status})
        self._breached: Dict[str, bool] = {}
        self._g_frac = registry.gauge("slo.good_fraction")
        self._g_burn = registry.gauge("slo.burn_rate")
        self._c_breach = registry.counter("slo.breach")

    # -- evaluation --------------------------------------------------------

    def _eval_one(self, o: Objective, metrics) -> Dict:
        if o.kind == "availability":
            finished = metrics.requests_finished
            bad = (metrics.requests_rejected + metrics.requests_timed_out
                   + metrics.requests_cancelled)
            n = finished + bad
            good_fraction = 1.0 if n == 0 else finished / n
            value = good_fraction
        else:
            # the engine only ever READS configured series here —
            # objective sets are small and static, so the dynamic name
            # cannot explode cardinality
            hist = metrics.registry.histogram(  # lint: allow-dynamic-metric-name
                o.metric)
            samples = hist.samples()
            n = len(samples)
            if n == 0:
                good_fraction, value = 1.0, None
            else:
                good_fraction = (sum(1 for s in samples
                                     if s <= o.threshold) / n)
                pct = percentiles(samples, (o.target * 100.0,))
                value = next(iter(pct.values())) if pct else None
        budget = 1.0 - o.target
        burn_rate = (1.0 - good_fraction) / budget
        breach = good_fraction < o.target
        out = {"kind": o.kind, "target": o.target, "n": n,
               "good_fraction": good_fraction,
               "burn_rate": burn_rate, "breach": breach, "value": value}
        if o.kind == "latency":
            out["threshold_s"] = o.threshold
        return out

    def evaluate(self, metrics, record: bool = True) -> Dict[str, Dict]:
        """One evaluation pass over the given ``ServingMetrics``
        window; returns ``{objective name: status}`` and records the
        gauges/transition counter. ``record=False`` computes the same
        statuses with NO side effects — no history append, no gauges,
        no breach-transition counting — the read-endpoint variant
        ``health()`` probes use (otherwise breach counts and the
        window-max burn would depend on how often a balancer polls)."""
        t = self.clock()
        statuses = {o.name: self._eval_one(o, metrics)
                    for o in self.objectives}
        if not record:
            return statuses
        self.history.append(t, statuses)
        with self._lock:
            transitions = []
            for name, st in statuses.items():
                was = self._breached.get(name, False)
                if st["breach"] and not was:
                    transitions.append(name)
                self._breached[name] = st["breach"]
        for name, st in statuses.items():
            self._g_frac.set(st["good_fraction"], objective=name)
            self._g_burn.set(st["burn_rate"], objective=name)
        for name in transitions:
            self._c_breach.inc(objective=name)
        return statuses

    # -- views -------------------------------------------------------------

    def breached(self) -> List[str]:
        """Objectives in breach as of the latest evaluation."""
        with self._lock:
            return [n for n, b in self._breached.items() if b]

    def burn_history(self, t0: Optional[float] = None,
                     t1: Optional[float] = None
                     ) -> List[tuple]:
        """Timestamped burn trajectory ``[(t, {objective: burn}), ...]``
        over ``[t0, t1]`` (either bound optional) — the join surface
        ``obs.report`` slices per trace phase. Same ring ``status()``
        computes its window-max from, so reports and ``health()`` can
        never disagree."""
        return [(t, {name: st["burn_rate"] for name, st in sts.items()})
                for t, sts in self.history.window(t0, t1)]

    def status(self) -> Optional[Dict]:
        """The latest evaluation, each objective annotated with its
        window-max burn rate (the rolling-window view, computed over
        the ``history`` ring entries within ``window_s`` of the latest
        evaluation); None before the first ``evaluate()``."""
        last = self.history.last()
        if last is None:
            return None
        t_latest, latest = last
        window_max: Dict[str, float] = {}
        for _, statuses in self.history.window(t_latest - self.window_s):
            for name, st in statuses.items():
                window_max[name] = max(window_max.get(name, 0.0),
                                       st["burn_rate"])
        out = {name: dict(st) for name, st in latest.items()}
        for name, st in out.items():
            st["window_max_burn_rate"] = window_max.get(name, 0.0)
        return {"window_s": self.window_s, "objectives": out,
                "ok": not any(st["breach"] for st in out.values())}
