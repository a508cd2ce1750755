"""Windowed time-series telemetry: metrics *over time*, bounded.

The registry (``obs.registry``) is cumulative by design — counters only
go up, histograms pool every observation since the window began. That
answers "how much, total?" but not the questions a scenario replay or a
capacity review actually asks: when did queue depth start growing, what
was TTFT p99 *during the burst*, how fast was the error budget burning
at minute three. This module adds the missing axis:

* ``Ring`` — a bounded deque of ``(t, payload)`` samples. It is the one
  timestamped-history primitive in the repo: ``TimeSeries`` stores
  scrapes in one, and ``SLOEngine`` keeps its burn-rate history in one
  (so ``obs.report`` and ``ServingEngine.health()`` read the *same*
  trajectory — no duplicate bookkeeping).
* ``TimeSeries`` — a periodic scraper over a live ``MetricsRegistry``.
  Each scrape converts the cumulative state into windowed form:

  - **counters → rates**: per-series delta since the previous scrape
    divided by elapsed time (reset-clamped: a value that went *down*
    means the registry was swapped — e.g. the serving engine's
    per-window ``metrics`` setter — and the delta restarts from zero);
  - **gauges → levels**: the instantaneous value;
  - **histograms → windowed percentiles**: observations that arrived
    since the previous scrape, recovered by diffing the fixed-size
    reservoir (appended tail while it is still filling, replaced slots
    once full — a uniform subsample of the window when the reservoir
    has wrapped), with the exact window count from the streaming
    counter.

Scrapes are pure host-side Python — no ``np.asarray``, no device reads
— so the serving/router step loops can sample on their existing
deferred host-window cadence without adding host syncs
(``tools/lint_host_sync.py`` stays green).

Exports follow the ``obs.exporters`` conventions: a JSONL form using a
new ``"timeseries"`` record type (additive — forward-compatible readers
skip it, no ``SCHEMA_VERSION`` bump needed) and a *timestamped*
Prometheus exposition form (trailing epoch-milliseconds per line, the
optional timestamp the text format allows).
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple, Union

from distkeras_tpu_torch.obs.exporters import (SCHEMA_VERSION, _prom_labels,
                                         _prom_name)
from distkeras_tpu_torch.obs.registry import (Counter, Gauge, Histogram,
                                        MetricsRegistry)
from distkeras_tpu_torch.utils.profiling import now as _now
from distkeras_tpu_torch.utils.profiling import percentiles
from distkeras_tpu_torch.utils.profiling import wall as _wall

#: default bound on retained samples (per TimeSeries / Ring)
DEFAULT_CAPACITY = 512

#: ``series()`` field fallback per instrument kind
_DEFAULT_FIELD = {"counters": "rate", "gauges": "value",
                  "histograms": "p50"}

#: percentiles computed for each histogram window
_WINDOW_PS = (50.0, 90.0, 99.0)


class Ring:
    """Bounded timestamped history: ``(t, payload)`` pairs, oldest
    evicted first. Thread-safe; iteration yields a point-in-time copy."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: deque = deque(maxlen=self.capacity)

    def append(self, t: float, payload) -> None:
        with self._lock:
            self._entries.append((float(t), payload))

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __iter__(self):
        with self._lock:
            return iter(list(self._entries))

    def last(self) -> Optional[Tuple[float, object]]:
        with self._lock:
            return self._entries[-1] if self._entries else None

    def window(self, t0: Optional[float] = None,
               t1: Optional[float] = None) -> List[Tuple[float, object]]:
        """Entries with ``t0 <= t <= t1`` (either bound optional)."""
        with self._lock:
            entries = list(self._entries)
        return [(t, p) for t, p in entries
                if (t0 is None or t >= t0) and (t1 is None or t <= t1)]

    def span_s(self) -> float:
        with self._lock:
            if len(self._entries) < 2:
                return 0.0
            return self._entries[-1][0] - self._entries[0][0]


class TimeSeries:
    """Periodic registry scraper feeding a bounded :class:`Ring`.

    ``registry`` is either a :class:`MetricsRegistry` or a zero-arg
    callable returning one (or ``None`` to skip) — the callable form
    lets the serving engine's scraper follow its *live* registry across
    the per-window ``metrics`` swaps without re-wiring.

    ``clock`` defaults to the profiling monotonic clock; a replay
    installs a virtual iteration clock here so sample timestamps (and
    therefore every rate) are deterministic. ``tags`` annotate exports
    and ``summary()`` (the router fleet uses ``{"engine": <id>}`` so
    per-replica series separate cleanly).
    """

    def __init__(self,
                 registry: Union[MetricsRegistry,
                                 Callable[[], Optional[MetricsRegistry]]],
                 *,
                 capacity: int = DEFAULT_CAPACITY,
                 interval_s: float = 0.0,
                 clock: Callable[[], float] = _now,
                 tags: Optional[Dict[str, str]] = None):
        if interval_s < 0:
            raise ValueError(f"interval_s must be >= 0, got {interval_s}")
        self._registry_src = registry
        self.interval_s = float(interval_s)
        self.clock = clock
        self.tags = dict(tags or {})
        self.ring = Ring(capacity)
        self._lock = threading.Lock()
        self._last_t: Optional[float] = None
        # per-(name, labels) scrape state for windowed conversion
        self._prev_counter: Dict[Tuple[str, str], float] = {}
        self._prev_hist: Dict[Tuple[str, str], Tuple[int, list]] = {}
        # wall anchor for the timestamped Prometheus form: monotonic /
        # virtual offsets map onto epoch time captured at construction
        self._t0 = clock()
        self._wall0 = _wall()

    # -- scraping ----------------------------------------------------

    def _registry(self) -> Optional[MetricsRegistry]:
        src = self._registry_src
        if callable(src):
            return src()
        return src

    def maybe_sample(self, **extra) -> Optional[Dict]:
        """Scrape iff ``interval_s`` has elapsed since the last scrape
        (always scrapes when ``interval_s == 0``). The serving loops
        call this unconditionally on their host-window cadence and let
        the interval gate do the rest."""
        t = self.clock()
        with self._lock:
            if (self._last_t is not None
                    and t - self._last_t < self.interval_s):
                return None
        return self.sample(**extra)

    def sample(self, **extra) -> Optional[Dict]:
        """Force one scrape; returns the sample dict (also appended to
        the ring) or ``None`` when the registry provider yields none.
        Keyword extras (e.g. ``iteration=...``) are stored on the
        sample so reports can join samples to trace phases."""
        reg = self._registry()
        if reg is None:
            return None
        t = self.clock()
        with self._lock:
            dt = None if self._last_t is None else t - self._last_t
            sample: Dict = dict(extra)
            sample["t"] = t
            sample["counters"] = {}
            sample["gauges"] = {}
            sample["histograms"] = {}
            for name, metric in sorted(reg.instruments().items()):
                if isinstance(metric, Counter):
                    out = {}
                    for labels, v in metric.values().items():
                        key = (name, labels)
                        prev = self._prev_counter.get(key)
                        # reset clamp: a shrinking counter means the
                        # backing registry was swapped — restart at 0
                        delta = v - prev if (prev is not None
                                             and v >= prev) else v
                        rate = (delta / dt) if dt else None
                        self._prev_counter[key] = v
                        out[labels] = {"value": v, "delta": delta,
                                       "rate": rate}
                    if out:
                        sample["counters"][name] = out
                elif isinstance(metric, Gauge):
                    out = {ls: {"value": c["value"]}
                           for ls, c in metric.values().items()}
                    if out:
                        sample["gauges"][name] = out
                elif isinstance(metric, Histogram):
                    out = self._scrape_histogram(name, metric)
                    if out:
                        sample["histograms"][name] = out
            self._last_t = t
        self.ring.append(t, sample)
        return sample

    def reset_baseline(self) -> None:
        """Forget per-instrument scrape state so the next sample treats
        every counter/histogram as starting from zero. Callers that
        deliberately swap the backing registry (e.g. the trace replayer
        opening a fresh per-phase metrics window) must call this: the
        automatic reset clamp only detects a swap when the new value is
        *smaller* than the old one, which a coincidentally equal new
        window defeats."""
        with self._lock:
            self._prev_counter.clear()
            self._prev_hist.clear()

    def _scrape_histogram(self, name: str, metric: Histogram) -> Dict:
        """Windowed stats per label set via reservoir deltas. Cells
        whose observation count is unchanged since the last scrape are
        skipped BEFORE their reservoir is copied — the scraper rides
        the serving loop's host-window cadence, so an idle histogram
        must cost O(1) per scrape, not O(reservoir)."""
        from distkeras_tpu_torch.obs.registry import label_string
        out = {}
        with metric._lock:
            cells = []
            for k, c in metric._series.items():
                labels = label_string(k)
                prev = self._prev_hist.get((name, labels))
                if prev is not None and c.count == prev[0]:
                    continue
                cells.append((labels, c.count, list(c.reservoir)))
        for labels, count, res in cells:
            key = (name, labels)
            prev_count, prev_res = self._prev_hist.get(key, (0, []))
            if count < prev_count:          # registry swap / reset
                prev_count, prev_res = 0, []
            self._prev_hist[key] = (count, res)
            wcount = count - prev_count
            if wcount <= 0:
                continue
            # window values: appended tail while the reservoir fills,
            # replaced slots once full (uniform subsample of the window)
            vals = res[len(prev_res):]
            for i in range(min(len(prev_res), len(res))):
                if res[i] != prev_res[i]:
                    vals.append(res[i])
            stats = {"count": wcount}
            if vals:
                stats["mean"] = sum(vals) / len(vals)
                stats["min"] = min(vals)
                stats["max"] = max(vals)
                stats.update(percentiles(vals, _WINDOW_PS))
            out[labels] = stats
        return out

    # -- views -------------------------------------------------------

    def samples(self) -> List[Tuple[float, Dict]]:
        return list(self.ring)

    def latest(self) -> Optional[Dict]:
        last = self.ring.last()
        return last[1] if last else None

    def series(self, name: str, labels: str = "",
               field: Optional[str] = None) -> List[Tuple[float, float]]:
        """``[(t, value), ...]`` for one series across all samples.
        ``field`` defaults per kind: counter ``rate``, gauge ``value``,
        histogram ``p50`` (ask for ``p99``/``mean``/``count``/...)."""
        out = []
        for t, s in self.ring:
            for kind in ("counters", "gauges", "histograms"):
                entry = s.get(kind, {}).get(name, {}).get(labels)
                if entry is None:
                    continue
                v = entry.get(field or _DEFAULT_FIELD[kind])
                if v is not None:
                    out.append((t, v))
                break
        return out

    def summary(self) -> Dict:
        """Compact descriptor for ``telemetry_snapshot()`` components
        (deliberately not the full ring — bounded output)."""
        last = self.ring.last()
        out = {"capacity": self.ring.capacity,
               "interval_s": self.interval_s,
               "n_samples": len(self.ring),
               "span_s": self.ring.span_s(),
               "tags": dict(self.tags)}
        if last is not None:
            t, s = last
            out["last_t"] = t
            if "iteration" in s:
                out["last_iteration"] = s["iteration"]
            out["n_series"] = sum(
                len(by_name) for kind in ("counters", "gauges",
                                          "histograms")
                for by_name in s.get(kind, {}).values())
        return out

    # -- exports -----------------------------------------------------

    def jsonl_lines(self, seq: int = 0) -> List[str]:
        """One ``meta`` header + one ``"timeseries"`` record per
        (sample, series) — an additive record type under the
        ``SCHEMA_VERSION`` forward-compat contract (old readers skip
        it; no version bump required)."""
        lines = [json.dumps({"type": "meta", "seq": seq,
                             "schema_version": SCHEMA_VERSION,
                             "kind": "timeseries",
                             "interval_s": self.interval_s,
                             "capacity": self.ring.capacity,
                             "tags": self.tags})]
        kinds = (("counters", "counter"), ("gauges", "gauge"),
                 ("histograms", "histogram"))
        for t, s in self.ring:
            extras = {k: v for k, v in s.items()
                      if k not in ("t", "counters", "gauges",
                                   "histograms")}
            for plural, singular in kinds:
                for name, by_label in s.get(plural, {}).items():
                    for labels, entry in by_label.items():
                        rec = {"type": "timeseries", "seq": seq,
                               "t": t, "kind": singular, "name": name,
                               "labels": labels}
                        rec.update(extras)
                        rec.update(entry)
                        lines.append(json.dumps(rec))
        return lines

    def export_jsonl(self, path: str, seq: int = 0) -> None:
        with open(path, "a") as f:
            for line in self.jsonl_lines(seq=seq):
                f.write(line + "\n")

    def prometheus_text(self, prefix: str = "distkeras_") -> str:
        """The LATEST sample in Prometheus text exposition format with
        trailing epoch-millisecond timestamps (the optional per-line
        timestamp the format allows). Counter lines carry the cumulative
        value (Prometheus computes its own rates); gauge lines the
        level; histogram windows render as quantile/sum-less summary
        lines plus a ``_window_count``."""
        last = self.ring.last()
        if last is None:
            return ""
        t, s = last
        ts_ms = int((self._wall0 + (t - self._t0)) * 1000)
        out = []
        for name, by_label in sorted(s.get("counters", {}).items()):
            pname = prefix + _prom_name(name) + "_total"
            out.append(f"# TYPE {pname} counter")
            for labels, entry in sorted(by_label.items()):
                out.append(f"{pname}{_prom_labels(labels)} "
                           f"{entry['value']} {ts_ms}")
        for name, by_label in sorted(s.get("gauges", {}).items()):
            pname = prefix + _prom_name(name)
            out.append(f"# TYPE {pname} gauge")
            for labels, entry in sorted(by_label.items()):
                out.append(f"{pname}{_prom_labels(labels)} "
                           f"{entry['value']} {ts_ms}")
        for name, by_label in sorted(s.get("histograms", {}).items()):
            pname = prefix + _prom_name(name) + "_window"
            out.append(f"# TYPE {pname} summary")
            for labels, entry in sorted(by_label.items()):
                for q in ("p50", "p99"):
                    if q in entry:
                        quant = f'quantile="{float(q[1:]) / 100:g}"'
                        out.append(
                            f"{pname}{_prom_labels(labels, quant)} "
                            f"{entry[q]} {ts_ms}")
                out.append(f"{pname}_count{_prom_labels(labels)} "
                           f"{entry['count']} {ts_ms}")
        return "\n".join(out) + "\n"
