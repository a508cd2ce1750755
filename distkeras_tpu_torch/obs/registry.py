"""Metrics registry: counters, gauges and reservoir histograms with labels
(mirrors ``distkeras_tpu/obs/registry.py``; the JAX package's tests hold
the snapshots equal on the same operations).

The repo's telemetry fragments (``utils.profiling.StepTimer``, the
serving-local ``ServingMetrics`` lists, ad-hoc prints in ``bench.py``)
each invented their own storage. This registry is the one shared
substrate: named instruments, optional label sets, thread-safe updates,
and a ``snapshot()`` dict every exporter (``obs.exporters``) renders
from.

Design constraints, stated because they are the point:

* **Bounded memory.** Histograms keep a fixed-size uniform reservoir
  (Vitter's algorithm R) plus exact streaming count/sum/min/max, so a
  server that runs forever holds O(reservoir) floats per series — the
  fix for ``ServingMetrics``' unbounded ``ttfts``/``latencies`` lists.
  Percentiles come from the reservoir (exact until it fills, sampled
  after).
* **Bounded cardinality.** Each metric caps its distinct label sets
  (``max_series``); past the cap new label sets fold into one overflow
  series and warn ONCE — a label-per-request bug degrades telemetry
  instead of eating the heap.
* **Cheap updates.** One lock acquire + a few float ops per record; the
  hot serving/training paths record per *iteration* or *epoch*, never
  per device op.
"""

from __future__ import annotations

import random
import threading
import warnings
import zlib
from typing import Dict, Iterable, Optional, Tuple

from distkeras_tpu_torch.utils.profiling import percentiles

#: label sets per metric before folding into the overflow series
DEFAULT_MAX_SERIES = 64
#: reservoir floats per histogram series
DEFAULT_RESERVOIR = 1024

_OVERFLOW_KEY = (("overflow", "true"),)


def _label_key(labels: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _esc(s: str) -> str:
    """Escape the flattening metacharacters: label values like a device
    string (``TPU_0(process=0,(0,0,0,0))``) contain ``,`` and
    ``=``, which would otherwise corrupt the flat form and everything
    parsed back out of it (the Prometheus renderer mis-split exactly
    this way before escaping)."""
    return s.replace("\\", "\\\\").replace(",", "\\,").replace("=", "\\=")


def label_string(key: Tuple[Tuple[str, str], ...]) -> str:
    """``(('a','1'),('b','x'))`` -> ``"a=1,b=x"`` (``""`` unlabeled);
    ``,``/``=``/``\\`` inside keys or values are backslash-escaped.
    ``parse_label_string`` is the exact inverse."""
    return ",".join(f"{_esc(k)}={_esc(v)}" for k, v in key)


_process_label: list = [None]


def process_label() -> Tuple[str, str]:
    """``("process_index", "<rank>")`` — THE one helper every exporter
    stamps onto its output lines (a fleet's scraped series aggregate by
    process without any per-call-site label plumbing). The rank is
    ``torch.distributed.get_rank()`` while a process group is up (JAX
    reads ``jax.process_index()``), else ``"0"``. Only a rank read from
    a live group is cached: an export that runs before
    ``init_process_group`` does not pin every later export to
    process 0."""
    if _process_label[0] is None:
        try:
            import torch.distributed as dist
            if not (dist.is_available() and dist.is_initialized()):
                return ("process_index", "0")   # no group yet: retry
            idx = str(int(dist.get_rank()))
        except Exception:
            return ("process_index", "0")
        _process_label[0] = ("process_index", idx)
    return _process_label[0]


def parse_label_string(s: str):
    """Inverse of ``label_string``: ``[(key, value), ...]``."""
    if not s:
        return []
    pairs, field, fields, i = [], [], [], 0
    while i < len(s):
        ch = s[i]
        if ch == "\\" and i + 1 < len(s):
            field.append(s[i + 1])
            i += 2
            continue
        if ch == "=" and not fields:        # first unescaped = splits k/v
            fields.append("".join(field))
            field = []
        elif ch == ",":                     # unescaped , ends the pair
            fields.append("".join(field))
            pairs.append(tuple(fields))
            field, fields = [], []
        else:
            field.append(ch)
        i += 1
    fields.append("".join(field))
    pairs.append(tuple(fields))
    return [(k, v) for k, v in pairs]


class _Metric:
    """Shared series bookkeeping; subclasses define the per-series cell."""

    kind = "metric"

    def __init__(self, name: str, registry: "MetricsRegistry",
                 max_series: int):
        self.name = name
        self._registry = registry
        self._lock = registry._lock
        self._series: Dict[Tuple, object] = {}
        self._max_series = max_series
        self._overflow_warned = False

    def _new_cell(self):
        raise NotImplementedError

    def _cell(self, labels: Optional[Dict] = None):
        key = _label_key(labels) if labels else ()
        cell = self._series.get(key)
        if cell is None:
            if len(self._series) >= self._max_series \
                    and key not in self._series:
                if not self._overflow_warned:
                    self._overflow_warned = True
                    warnings.warn(
                        f"metric {self.name!r} exceeded max_series="
                        f"{self._max_series} label sets; further label "
                        "sets fold into the overflow series "
                        "(check for per-request/per-step label values)",
                        stacklevel=4)
                key = _OVERFLOW_KEY
                cell = self._series.get(key)
                if cell is not None:
                    return cell
            cell = self._series[key] = self._new_cell()
        return cell

    def series_keys(self) -> Iterable[Tuple]:
        with self._lock:
            return list(self._series)


class Counter(_Metric):
    """Monotonically increasing float per label set."""

    kind = "counter"

    def _new_cell(self):
        return [0.0]

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {amount})")
        with self._lock:
            self._cell(labels)[0] += amount

    def value(self, **labels) -> float:
        with self._lock:
            key = _label_key(labels) if labels else ()
            cell = self._series.get(key)
            return cell[0] if cell else 0.0

    def values(self) -> Dict[str, float]:
        with self._lock:
            return {label_string(k): v[0] for k, v in self._series.items()}


class Gauge(_Metric):
    """Last-set value per label set; ``track_max`` keeps the watermark."""

    kind = "gauge"

    def _new_cell(self):
        return [0.0, float("-inf")]        # value, watermark

    def set(self, value: float, **labels) -> None:
        with self._lock:
            cell = self._cell(labels)
            cell[0] = float(value)
            if value > cell[1]:
                cell[1] = float(value)

    def value(self, **labels) -> Optional[float]:
        with self._lock:
            key = _label_key(labels) if labels else ()
            cell = self._series.get(key)
            return cell[0] if cell else None

    def max(self, **labels) -> Optional[float]:
        with self._lock:
            key = _label_key(labels) if labels else ()
            cell = self._series.get(key)
            return cell[1] if cell else None

    def values(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {label_string(k): {"value": c[0], "max": c[1]}
                    for k, c in self._series.items()}


class _HistCell:
    __slots__ = ("count", "sum", "min", "max", "reservoir", "rng")

    def __init__(self, seed: int):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.reservoir = []
        # deterministic per-series stream: snapshots are reproducible
        # under a fixed observation sequence (test requirement)
        self.rng = random.Random(seed)


class Histogram(_Metric):
    """Exact streaming count/sum/min/max + fixed-size uniform reservoir
    (algorithm R) for percentile estimates. Memory per series is
    O(``reservoir_size``) regardless of observation count."""

    kind = "histogram"

    def __init__(self, name, registry, max_series,
                 reservoir_size: int = DEFAULT_RESERVOIR):
        super().__init__(name, registry, max_series)
        if reservoir_size < 1:
            raise ValueError(f"reservoir_size must be >= 1, got "
                             f"{reservoir_size}")
        self.reservoir_size = int(reservoir_size)

    def _new_cell(self):
        # crc32, not hash(): str hashing is salted per process
        # (PYTHONHASHSEED), which would break cross-process
        # reproducibility of which samples survive a full reservoir
        return _HistCell(seed=zlib.crc32(
            f"{self.name}:{len(self._series)}".encode()))

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        with self._lock:
            cell = self._cell(labels)
            cell.count += 1
            cell.sum += value
            if value < cell.min:
                cell.min = value
            if value > cell.max:
                cell.max = value
            if len(cell.reservoir) < self.reservoir_size:
                cell.reservoir.append(value)
            else:
                j = cell.rng.randrange(cell.count)
                if j < self.reservoir_size:
                    cell.reservoir[j] = value

    def samples(self, **labels):
        """Reservoir contents (a copy) — exact until the reservoir
        fills, a uniform sample after."""
        with self._lock:
            key = _label_key(labels) if labels else ()
            cell = self._series.get(key)
            return list(cell.reservoir) if cell else []

    def stats(self, ps=(50.0, 99.0), **labels) -> Optional[Dict]:
        with self._lock:
            key = _label_key(labels) if labels else ()
            cell = self._series.get(key)
            if cell is None or cell.count == 0:
                return None
            return self._stats_locked(cell, ps)

    @staticmethod
    def _stats_locked(cell: _HistCell, ps=(50.0, 99.0)) -> Dict:
        out = {"count": cell.count, "sum": cell.sum,
               "mean": cell.sum / cell.count,
               "min": cell.min, "max": cell.max}
        pct = percentiles(cell.reservoir, ps)
        if pct:
            out.update(pct)
        return out


class MetricsRegistry:
    """Named instruments, one per (name, kind); re-asking returns the
    same object, asking with a different kind raises (the classic
    metrics-registry contract)."""

    def __init__(self, max_series: int = DEFAULT_MAX_SERIES,
                 reservoir_size: int = DEFAULT_RESERVOIR):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}
        self.max_series = int(max_series)
        self.reservoir_size = int(reservoir_size)

    def _get(self, name: str, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, self,
                                              self.max_series, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"not {cls.kind}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  reservoir_size: Optional[int] = None) -> Histogram:
        return self._get(name, Histogram,
                         reservoir_size=reservoir_size
                         or self.reservoir_size)

    def instruments(self) -> Dict[str, _Metric]:
        """Live ``{name: instrument}`` map (a shallow copy). The
        time-series scraper (``obs.timeseries``) and the report-series
        lint walk this to see which series exist and, for histograms,
        to diff reservoirs between scrapes — read-only access; mutate
        through the instruments themselves."""
        with self._lock:
            return dict(self._metrics)

    def snapshot(self) -> Dict:
        """``{"counters": {name: {labels: v}}, "gauges": ...,
        "histograms": {name: {labels: stats}}}`` — the one shape every
        exporter consumes and ``exporters.read_jsonl`` reconstructs."""
        with self._lock:
            out = {"counters": {}, "gauges": {}, "histograms": {}}
            for name, m in sorted(self._metrics.items()):
                if isinstance(m, Counter):
                    out["counters"][name] = m.values()
                elif isinstance(m, Gauge):
                    out["gauges"][name] = m.values()
                elif isinstance(m, Histogram):
                    out["histograms"][name] = {
                        label_string(k): Histogram._stats_locked(c)
                        for k, c in m._series.items() if c.count}
            return out
