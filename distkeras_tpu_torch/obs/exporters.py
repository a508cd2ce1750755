"""Exporters: the registry/span state rendered for the outside world.

Three formats, deliberately boring:

* **JSONL event log** — one self-describing line per series
  (``{"type": "counter"|"gauge"|"histogram"|"span", ...}``) plus a
  ``meta`` header carrying ``schema_version``, and one ``empty`` line
  per metric registered with no series yet (the JAX package's log drops
  those, so its round trip misses them). Append-oriented (a
  long-running job re-exports snapshots under increasing ``seq``), and
  lossless for the snapshot shape: ``read_jsonl(path)`` reconstructs
  exactly what ``registry.snapshot()`` produced (the round-trip test).
  FORWARD-compatible by contract: readers skip record types they don't
  know and ignore unknown top-level keys, so the format can grow
  (new ``type`` lines, new fields) without breaking old consumers —
  bump ``SCHEMA_VERSION`` on any change an old reader must not
  silently misread.
* **Prometheus text** — the ``# TYPE``-annotated exposition format, for
  scraping or file-based node-exporter pickup. Histograms render as
  summaries (quantile series + ``_sum``/``_count``); metric names are
  sanitized (dots -> underscores). Every line carries a
  ``process_index`` label (``registry.process_label()``) so multi-host
  fleets aggregate without per-call-site label plumbing.
* **In-process snapshot** — ``obs.telemetry_snapshot()`` (the
  ``obs/__init__`` API) returns the unified dict; these functions only
  serialize it.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from distkeras_tpu_torch.obs import spans as _spans

#: telemetry format version, stamped into ``telemetry_snapshot()``,
#: every JSONL ``meta`` header and flight-recorder dump. Version 2 =
#: this scheme's introduction (version 1 is the implicit, unstamped
#: first telemetry format). Bump on changes an old reader must not
#: silently misread; additive keys/record types do NOT need a bump
#: (readers tolerate them by contract).
SCHEMA_VERSION = 2

_QUANTILE_KEYS = ("p50", "p99")


def snapshot_lines(snapshot: Dict, spans: Optional[List] = None,
                   seq: int = 0) -> List[str]:
    """Decompose a registry snapshot (+ optional
    ``spans.span_records()`` list) into JSONL lines."""
    lines = [json.dumps({"type": "meta", "seq": seq,
                         "schema_version": SCHEMA_VERSION})]
    for name, series in snapshot.get("counters", {}).items():
        for labels, value in series.items():
            lines.append(json.dumps(
                {"type": "counter", "seq": seq, "name": name,
                 "labels": labels, "value": value}))
    for name, series in snapshot.get("gauges", {}).items():
        for labels, cell in series.items():
            lines.append(json.dumps(
                {"type": "gauge", "seq": seq, "name": name,
                 "labels": labels, "value": cell["value"],
                 "max": cell["max"]}))
    for name, series in snapshot.get("histograms", {}).items():
        for labels, stats in series.items():
            lines.append(json.dumps(
                {"type": "histogram", "seq": seq, "name": name,
                 "labels": labels, **stats}))
    for kind in ("counters", "gauges", "histograms"):
        for name, series in snapshot.get(kind, {}).items():
            if not series:
                lines.append(json.dumps({"type": "empty", "seq": seq,
                                         "kind": kind, "name": name}))
    for path, total_s, count in (spans or []):
        lines.append(json.dumps(
            {"type": "span", "seq": seq, "path": list(path),
             "total_s": total_s, "count": count}))
    return lines


def read_jsonl(path: str, seq: Optional[int] = None
               ) -> Tuple[Dict, List]:
    """Parse a JSONL export back into ``(snapshot, span_records)``.
    With ``seq=None`` the LATEST sequence in the file wins (the
    append-log read convention). Forward-compatible: record types this
    reader doesn't know are skipped and unknown top-level keys are
    ignored, so a newer writer's log (higher ``schema_version``, extra
    line types) still yields the series this version understands."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    if seq is None:
        seq = max((r.get("seq", 0) for r in records), default=0)
    snapshot: Dict = {"counters": {}, "gauges": {}, "histograms": {}}
    span_records = []
    for r in records:
        if r.get("seq", 0) != seq:
            continue
        t = r.get("type")
        if t == "counter":
            snapshot["counters"].setdefault(r["name"], {})[
                r["labels"]] = r["value"]
        elif t == "gauge":
            snapshot["gauges"].setdefault(r["name"], {})[r["labels"]] = \
                {"value": r["value"], "max": r["max"]}
        elif t == "histogram":
            stats = {k: v for k, v in r.items()
                     if k not in ("type", "seq", "name", "labels")}
            snapshot["histograms"].setdefault(r["name"], {})[
                r["labels"]] = stats
        elif t == "empty" and r.get("kind") in snapshot:
            snapshot[r["kind"]].setdefault(r["name"], {})
        elif t == "span":
            span_records.append((tuple(r["path"]), r["total_s"],
                                 r["count"]))
    return snapshot, span_records


class JsonlExporter:
    """Append-only JSONL event log. Each ``export()`` call writes one
    full snapshot under the next ``seq`` — a reporting-interval tick."""

    def __init__(self, path: str):
        self.path = str(path)
        self._seq = 0

    def export(self, snapshot: Optional[Dict] = None,
               spans: Optional[List] = None) -> int:
        """Append one snapshot (default: the global registry + span
        tree); returns the sequence number written."""
        if snapshot is None:
            from distkeras_tpu_torch.obs import get_registry
            snapshot = get_registry().snapshot()
        if spans is None:
            spans = _spans.span_records()
        seq = self._seq
        self._seq += 1
        with open(self.path, "a") as f:
            for line in snapshot_lines(snapshot, spans, seq=seq):
                f.write(line + "\n")
        return seq


def _prom_name(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def _prom_value(v: str) -> str:
    """Prometheus label-value escaping: backslash, quote, newline."""
    return (v.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_labels(labels: str, extra: str = "") -> str:
    from distkeras_tpu_torch.obs.registry import (parse_label_string,
                                            process_label)
    pk, pv = process_label()
    pairs = parse_label_string(labels)
    # process_index first on EVERY line (multi-host groundwork; the
    # single registry.process_label() helper is the only source) —
    # unless the series carries its own, which wins (a duplicate label
    # name is invalid exposition format and fails the whole scrape)
    parts = ([] if any(_prom_name(k) == pk for k, _ in pairs)
             else [f'{pk}="{_prom_value(pv)}"'])
    parts += [f'{_prom_name(k)}="{_prom_value(v)}"' for k, v in pairs]
    if extra:
        parts.append(extra)            # quantile goes last, per convention
    return "{" + ",".join(parts) + "}"


def prometheus_text(snapshot: Optional[Dict] = None,
                    prefix: str = "distkeras_") -> str:
    """Render a snapshot in the Prometheus text exposition format."""
    if snapshot is None:
        from distkeras_tpu_torch.obs import get_registry
        snapshot = get_registry().snapshot()
    out = []
    for name, series in sorted(snapshot.get("counters", {}).items()):
        pname = prefix + _prom_name(name) + "_total"
        out.append(f"# TYPE {pname} counter")
        for labels, value in sorted(series.items()):
            out.append(f"{pname}{_prom_labels(labels)} {value}")
    for name, series in sorted(snapshot.get("gauges", {}).items()):
        pname = prefix + _prom_name(name)
        out.append(f"# TYPE {pname} gauge")
        for labels, cell in sorted(series.items()):
            out.append(f"{pname}{_prom_labels(labels)} {cell['value']}")
    for name, series in sorted(snapshot.get("histograms", {}).items()):
        pname = prefix + _prom_name(name)
        out.append(f"# TYPE {pname} summary")
        for labels, stats in sorted(series.items()):
            for q in _QUANTILE_KEYS:
                if q in stats:
                    quant = f'quantile="{float(q[1:]) / 100:g}"'
                    out.append(f"{pname}{_prom_labels(labels, quant)} "
                               f"{stats[q]}")
            out.append(f"{pname}_sum{_prom_labels(labels)} "
                       f"{stats['sum']}")
            out.append(f"{pname}_count{_prom_labels(labels)} "
                       f"{stats['count']}")
    return "\n".join(out) + "\n"


def dump_prometheus(path: str, snapshot: Optional[Dict] = None) -> None:
    with open(path, "w") as f:
        f.write(prometheus_text(snapshot))
