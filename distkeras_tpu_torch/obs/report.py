"""Scenario SLO reports: trace phases joined against the time series
(mirrors ``distkeras_tpu/obs/report.py``; ``build_report`` takes the
``ReplayResult`` of ``serving.loadgen.replay``).

``serving.loadgen.replay`` produces per-phase metrics windows, a
per-engine :class:`~distkeras_tpu_torch.obs.timeseries.TimeSeries`, and
per-engine ``SLOEngine`` burn-history rings. This module joins them
into the artifact a capacity review actually reads:

* **per-phase SLO attainment** and **max burn rate** — the worst
  good-fraction across engines per objective, and the peak of the
  burn trajectory inside the phase's virtual-time span (sliced from
  the SAME ring ``SLOEngine.status()`` computes its window-max from);
* **saturation detection** — sustained queue-depth growth inside a
  phase, and the first sample where admission started shedding
  (``serving.requests_rejected`` rate > 0): "queue grew while sheds
  were zero" (under-provisioned but absorbing) reads differently from
  "shed onset at t=X" (actively refusing);
* **TTFT/TPOT percentile timelines per phase** from the windowed
  histogram scrapes, plus **per-replica divergence** for fleet runs
  (a straggler replica hides inside fleet totals; the spread doesn't);
* renderers: JSON (machine), markdown (review comment), and a
  self-contained HTML timeline dashboard (inline SVG, no external
  assets — attachable to a ticket as one file).

Every number in the report derives from the virtual iteration clock
and exact counters, so two replays of the same seeded scenario yield
byte-identical reports (the tier-1 determinism assertion). Wall-clock
values (``StepTimer`` phase seconds, ``fetch_seconds``) are
deliberately excluded.

``REPORT_SERIES`` names every registry series this module reads —
``tools/lint_report_series.py`` asserts each one exists in a live
registry after a smoke scenario, so renaming a metric fails tier-1
instead of silently emptying a report panel.
"""

from __future__ import annotations

import html as _html
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

from distkeras_tpu_torch.obs.exporters import SCHEMA_VERSION

#: every registry series name this report reads (via time-series
#: scrapes or the SLO engine's gauges) — the lint contract surface
REPORT_SERIES = (
    "serving.queue_depth",
    "serving.slot_occupancy",
    "serving.requests_finished",
    "serving.requests_rejected",
    "serving.tokens_generated",
    "serving.ttft_s",
    "serving.tpot_s",
    "serving.latency_s",
    "slo.good_fraction",
    "slo.burn_rate",
    "slo.breach",
)

#: metrics-summary keys copied into per-phase engine rows — the
#: deterministic subset (virtual-clock or exact-count derived); the
#: wall-clock keys ("phases" StepTimer seconds) are excluded so two
#: replays report byte-identical numbers
_DET_SUMMARY_KEYS = (
    "requests_submitted", "requests_finished", "requests_rejected",
    "requests_timed_out", "requests_cancelled", "requests_preempted",
    "requests_transferred", "tokens_generated", "tokens_per_sec",
    "prefill_chunks", "ttft_s", "tpot_s", "latency_s", "queue_depth",
    "slot_occupancy", "acceptance_rate", "speculation", "prefix_cache",
    "pages")


# --- joins ------------------------------------------------------------------


def _phase_samples(ts, t0: float, t1: float) -> List[Tuple[float, Dict]]:
    # half-open (t0, t1]: the replayer forces a closing scrape at each
    # phase boundary, so the sample at exactly t0 summarizes the
    # *previous* phase and must not be re-attributed to this one
    return [(t, s) for t, s in ts.ring.window(t0, t1) if t > t0]


def _series_from(samples, kind: str, name: str, field: str,
                 labels: str = "") -> List[Tuple[float, float]]:
    out = []
    for t, s in samples:
        entry = s.get(kind, {}).get(name, {}).get(labels)
        if entry is None:
            continue
        v = entry.get(field)
        if v is not None:
            out.append((t, v))
    return out


def _detect_growth(vals: Sequence[float], min_run: int = 3,
                   min_rise: float = 1.0) -> bool:
    """Sustained growth: a non-decreasing run of >= ``min_run``
    consecutive samples rising by >= ``min_rise`` total."""
    run_start = 0
    for i in range(1, len(vals)):
        if vals[i] < vals[i - 1]:
            run_start = i
        elif (i - run_start + 1 >= min_run
              and vals[i] - vals[run_start] >= min_rise):
            return True
    return False


def _saturation(samples) -> Dict:
    """Queue-growth vs admission-shed onset within one phase."""
    qd = _series_from(samples, "histograms", "serving.queue_depth",
                      "mean")
    shed = _series_from(samples, "counters", "serving.requests_rejected",
                        "delta")
    onset = next((t for t, d in shed if d > 0), None)
    return {
        "queue_growth": _detect_growth([v for _, v in qd]),
        "max_queue_depth": max((v for _, v in qd), default=0.0),
        "shed_onset_t": onset,
    }


def _phase_timeline(samples) -> Dict[str, List]:
    """Compact per-phase series for the dashboard charts."""
    specs = (("queue_depth", "histograms", "serving.queue_depth",
              "mean"),
             ("ttft_p99", "histograms", "serving.ttft_s", "p99"),
             ("tpot_p99", "histograms", "serving.tpot_s", "p99"),
             ("tokens_rate", "counters", "serving.tokens_generated",
              "rate"),
             ("rejected_rate", "counters", "serving.requests_rejected",
              "rate"))
    out: Dict[str, List] = {"t": [round(t, 9) for t, _ in samples]}
    for key, kind, name, field in specs:
        by_t = dict(_series_from(samples, kind, name, field))
        out[key] = [by_t.get(t) for t, _ in samples]
    return out


def _merged_burn_history(result) -> List[Tuple[float, float]]:
    """Fleet-wide burn trajectory: (t, max burn across engines and
    objectives), merged from every engine's burn-history ring. All
    engines scrape on the same virtual clock, so samples group by t."""
    by_t: Dict[float, float] = {}
    for eid, slo in (result.slo or {}).items():
        if slo is None:
            continue
        for t, burns in slo.burn_history():
            if burns:
                by_t[t] = max(by_t.get(t, 0.0), max(burns.values()))
    return sorted(by_t.items())


def _recovery(result) -> Optional[Dict]:
    """Per-incident recovery SLOs for chaos replays.

    For each fault trigger recorded by the replayer:

    * **time_to_first_action** — virtual seconds from the trigger to
      the first non-blocked autoscale decision (scale_up/scale_down/gc)
      at or after it; None when no controller acted.
    * **mttr** — mean-time-to-recovery from the SLO burn-history
      rings: the first post-incident sample where the fleet-max burn
      rate exceeds 1.0 (the budget-neutral line) marks the outage;
      recovery is the first later sample back at <= 1.0. ``mttr`` is
      recovery-t minus incident-t; None while still burning at the end
      of the replay, and absent entirely if the incident never pushed
      burn past 1.0.

    Request accounting splits terminal outcomes into **lost**
    (timed out / cancelled), **replayed** (finished after replica
    failover — tokens re-derived from the seed ledger), and
    **degraded** (finished after a prefill->decode handoff only).
    """
    incidents = getattr(result, "incidents", None) or []
    timeline = getattr(result, "fleet_timeline", None) or []
    events = getattr(result, "autoscale_events", None) or []
    if not incidents and not timeline and not events:
        return None
    burn = _merged_burn_history(result)
    rows: List[Dict] = []
    for inc in incidents:
        t_inc = inc["t"]
        row = dict(inc)
        act = next((e for e in events
                    if e["t"] >= t_inc and e.get("action") != "blocked"),
                   None)
        row["time_to_first_action"] = (
            None if act is None else round(act["t"] - t_inc, 9))
        breach_t = next((t for t, b in burn if t >= t_inc and b > 1.0),
                        None)
        if breach_t is not None:
            rec_t = next((t for t, b in burn
                          if t > breach_t and b <= 1.0), None)
            row["breach_t"] = round(breach_t, 9)
            row["mttr"] = (None if rec_t is None
                           else round(rec_t - t_inc, 9))
        rows.append(row)
    lost = replayed = degraded = 0
    for o in result.outcomes:
        st = o.get("state")
        if st in ("timed_out", "cancelled"):
            lost += 1
        elif st == "finished" and o.get("failovers", 0) > 0:
            replayed += 1
        elif st == "finished" and o.get("handoffs", 0) > 0:
            degraded += 1
    sizes = [e.get("total", 0) for e in timeline]
    actions: Dict[str, int] = {}
    for e in events:
        a = e.get("action", "?")
        actions[a] = actions.get(a, 0) + 1
    out: Dict = {
        "incidents": rows,
        "requests": {"lost": lost, "replayed": replayed,
                     "degraded": degraded},
        "fleet_timeline": timeline,
        "autoscale_actions": actions,
    }
    if sizes:
        out["fleet_size"] = {"min": min(sizes), "max": max(sizes),
                             "final": sizes[-1]}
    mttrs = [r["mttr"] for r in rows if r.get("mttr") is not None]
    if mttrs:
        out["max_mttr"] = max(mttrs)
    return out


def build_report(result) -> Dict:
    """Join a ``loadgen.ReplayResult`` into the scenario report dict
    (JSON-serializable; see the renderers for markdown/HTML forms)."""
    trace = result.trace
    phases_out: List[Dict] = []
    all_att: List[Tuple[str, str, float]] = []   # (phase, objective, v)
    all_burn: List[Tuple[str, str, float]] = []
    for ph in result.phases:
        row: Dict = {
            "name": ph.name, "span": [ph.start, ph.end],
            "t": [round(ph.t0, 9), round(ph.t1, 9)],
            "submitted": ph.submitted, "shed": ph.shed,
        }
        # SLO attainment: worst good-fraction across engines, per
        # objective; max burn from the burn-history ring slice
        attain: Dict[str, float] = {}
        breach = False
        for eid, statuses in (ph.slo or {}).items():
            for name, st in statuses.items():
                v = st["good_fraction"]
                attain[name] = min(attain.get(name, 1.0), v)
                breach = breach or st["breach"]
        if attain:
            row["attainment"] = attain
            row["breach"] = breach
            for name, v in attain.items():
                all_att.append((ph.name, name, v))
        max_burn: Dict[str, float] = {}
        for eid, slo in (result.slo or {}).items():
            if slo is None:
                continue
            for t, burns in slo.burn_history(ph.t0, ph.t1):
                for name, b in burns.items():
                    max_burn[name] = max(max_burn.get(name, 0.0), b)
        if max_burn:
            row["max_burn_rate"] = max_burn
            for name, b in max_burn.items():
                all_burn.append((ph.name, name, b))
        # per-engine deterministic summary subset + fleet sums
        engines: Dict[str, Dict] = {}
        for eid, summary in ph.summaries.items():
            engines[eid] = {k: summary[k] for k in _DET_SUMMARY_KEYS
                            if k in summary}
        row["engines"] = engines
        totals: Dict[str, float] = {}
        for eid, e in engines.items():
            for k in ("requests_finished", "requests_rejected",
                      "requests_timed_out", "requests_preempted",
                      "tokens_generated", "prefill_chunks"):
                v = e.get(k)
                if isinstance(v, (int, float)):
                    totals[k] = totals.get(k, 0) + v
        row["totals"] = totals
        if result.fleet and len(engines) > 1:
            div: Dict[str, Dict] = {}
            for k in ("requests_finished", "tokens_generated"):
                vals = [e.get(k, 0) for e in engines.values()]
                div[k] = {"min": min(vals), "max": max(vals),
                          "spread": max(vals) - min(vals)}
            row["divergence"] = div
        # saturation + timelines from each engine's phase samples
        sat: Dict[str, Dict] = {}
        tl: Dict[str, Dict] = {}
        for eid in result.engine_ids:
            ts = result.timeseries.get(eid)
            if ts is None:
                continue
            samples = _phase_samples(ts, ph.t0, ph.t1)
            if not samples:
                continue
            sat[eid] = _saturation(samples)
            tl[eid] = _phase_timeline(samples)
        row["saturation"] = sat
        row["timeline"] = tl
        phases_out.append(row)

    headline: Dict = {}
    if all_att:
        phname, obj, v = min(all_att, key=lambda x: x[2])
        headline["min_attainment"] = v
        headline["worst_phase"] = phname
        headline["worst_objective"] = obj
    if all_burn:
        phname, obj, b = max(all_burn, key=lambda x: x[2])
        headline["max_burn_rate"] = b
        headline["max_burn_phase"] = phname
    # fleet-wide burn trajectories for the dashboard
    burn_tl: Dict[str, Dict] = {}
    for eid, slo in (result.slo or {}).items():
        if slo is None:
            continue
        hist = slo.burn_history()
        if not hist:
            continue
        objs = sorted({n for _, burns in hist for n in burns})
        burn_tl[eid] = {"t": [round(t, 9) for t, _ in hist]}
        for n in objs:
            burn_tl[eid][n] = [burns.get(n) for _, burns in hist]

    out = {
        "schema_version": SCHEMA_VERSION,
        "kind": "scenario_report",
        "scenario": {
            "seed": trace.meta.get("seed"),
            "n_requests": len(trace.requests),
            "total_iterations": trace.meta.get("total_iterations"),
            "phases": [[p.name, p.start, p.end] for p in trace.phases],
        },
        "dt": result.dt,
        "iterations": result.iterations,
        "fleet": result.fleet,
        "engines": result.engine_ids,
        "requests": result.totals,
        "headline": headline,
        "phases": phases_out,
        "burn": burn_tl,
    }
    # recovery SLOs — only for chaos/autoscale replays (additive key:
    # readers of plain scenario reports see no change)
    rec = _recovery(result)
    if rec is not None:
        out["recovery"] = rec
        if "max_mttr" in rec:
            headline["max_mttr"] = rec["max_mttr"]
    return out


# --- renderers --------------------------------------------------------------


def to_json(report: Dict) -> str:
    return json.dumps(report, indent=2, sort_keys=True)


# --- weight-quantization accuracy ---------------------


def weight_quant_report(source, weight_quant=None) -> Dict:
    """The accuracy-drift artifact of serving quantized weights: one
    deterministic dict from the per-leaf reconstruction errors a
    ``ServingEngine(weight_quant=...)`` computes at construction
    (``engine.weight_quant_error`` — ``ops.quant_matmul.quant_error``
    per quantized leaf). ``source`` is the engine itself or the raw
    path-keyed error dict."""
    errors = getattr(source, "weight_quant_error", source)
    if weight_quant is None:
        weight_quant = getattr(source, "weight_quant", None)
    if not errors:
        raise ValueError(
            "no weight-quantization errors to report (engine built "
            "without weight_quant?)")
    worst = max(errors, key=lambda k: errors[k]["rel_rms"])
    return {
        "schema_version": SCHEMA_VERSION,
        "weight_quant": weight_quant,
        "num_leaves": len(errors),
        "mean_rel_rms": (sum(v["rel_rms"] for v in errors.values())
                         / len(errors)),
        "worst_leaf": worst,
        "worst_rel_rms": errors[worst]["rel_rms"],
        "max_abs_err": max(v["max_abs_err"] for v in errors.values()),
        "leaves": {k: dict(v) for k, v in sorted(errors.items())},
    }


def weight_quant_markdown(report: Dict) -> str:
    """Review-comment form of :func:`weight_quant_report`: headline +
    one row per quantized leaf."""
    lines = [
        f"# Weight quantization accuracy ({report['weight_quant']})", "",
        f"{report['num_leaves']} quantized leaves — mean rel-RMS "
        f"{_fmt(report['mean_rel_rms'])}, worst "
        f"{_fmt(report['worst_rel_rms'])} at `{report['worst_leaf']}`.",
        "",
        "| leaf | rel RMS | max abs err |", "|---|---|---|"]
    for k, v in report["leaves"].items():
        lines.append(f"| `{k}` | {_fmt(v['rel_rms'])} "
                     f"| {_fmt(v['max_abs_err'], 4)} |")
    return "\n".join(lines) + "\n"


def _fmt(v, nd: int = 3) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def to_markdown(report: Dict) -> str:
    """The review-comment form: headline + one row per phase."""
    lines = [f"# Scenario report ({report['requests'].get('total', 0)} "
             f"requests, {len(report['phases'])} phases)", ""]
    h = report.get("headline") or {}
    if "min_attainment" in h:
        lines.append(
            f"**Headline:** min SLO attainment "
            f"**{_fmt(h['min_attainment'])}** "
            f"({h['worst_objective']} during {h['worst_phase']}); "
            f"max burn rate {_fmt(h.get('max_burn_rate'))} "
            f"(during {h.get('max_burn_phase', '-')}).")
        lines.append("")
    lines += ["| phase | span | submitted | shed | finished | "
              "attainment | max burn | max queue | shed onset |",
              "|---|---|---:|---:|---:|---|---|---:|---|"]
    for ph in report["phases"]:
        att = ph.get("attainment") or {}
        att_s = " ".join(f"{k}={_fmt(v)}" for k, v in sorted(att.items())) \
            or "-"
        burn = ph.get("max_burn_rate") or {}
        burn_s = _fmt(max(burn.values())) if burn else "-"
        sat = ph.get("saturation") or {}
        maxq = max((s.get("max_queue_depth", 0.0)
                    for s in sat.values()), default=0.0)
        onset = next((s["shed_onset_t"] for s in sat.values()
                      if s.get("shed_onset_t") is not None), None)
        fin = ph.get("totals", {}).get("requests_finished", 0)
        lines.append(
            f"| {ph['name']} | {ph['span'][0]}-{ph['span'][1]} | "
            f"{ph['submitted']} | {ph['shed']} | {int(fin)} | {att_s} | "
            f"{burn_s} | {_fmt(maxq, 1)} | {_fmt(onset)} |")
    if report.get("fleet"):
        lines += ["", "## Per-replica divergence", ""]
        for ph in report["phases"]:
            div = ph.get("divergence")
            if div:
                spread = " ".join(
                    f"{k}: {_fmt(v['spread'], 0)}"
                    for k, v in sorted(div.items()))
                lines.append(f"- {ph['name']}: {spread}")
    rec = report.get("recovery")
    if rec:
        lines += ["", "## Recovery", ""]
        reqs = rec.get("requests", {})
        lines.append(
            f"Requests: **{reqs.get('lost', 0)} lost**, "
            f"{reqs.get('replayed', 0)} replayed (failover), "
            f"{reqs.get('degraded', 0)} degraded (handoff).")
        fs = rec.get("fleet_size")
        if fs:
            lines.append(
                f"Fleet size: {fs['min']}-{fs['max']} "
                f"(final {fs['final']}). Autoscale actions: "
                + (" ".join(f"{k}={v}" for k, v in
                            sorted(rec.get("autoscale_actions",
                                           {}).items())) or "none")
                + ".")
        if rec.get("incidents"):
            lines += ["", "| incident | t | first action | MTTR |",
                      "|---|---:|---:|---:|"]
            for inc in rec["incidents"]:
                lines.append(
                    f"| {inc.get('point', '?')} | {_fmt(inc.get('t'))} "
                    f"| {_fmt(inc.get('time_to_first_action'))} "
                    f"| {_fmt(inc.get('mttr')) if 'breach_t' in inc else 'no breach'} |")
    return "\n".join(lines) + "\n"


_CHART_COLORS = ("#2563eb", "#dc2626", "#059669", "#d97706", "#7c3aed",
                 "#0891b2")
_PHASE_COLORS = ("#93c5fd", "#fca5a5", "#86efac", "#fcd34d", "#c4b5fd",
                 "#67e8f9")


def _svg_chart(title: str, series: List[Tuple[str, List[Tuple[float, float]]]],
               phases: List[Tuple[str, float, float]],
               width: int = 880, height: int = 150) -> str:
    """One inline-SVG line chart: phase bands + polylines. Pure
    string-building — the dashboard must stay a single self-contained
    file with no JS/CSS/image dependencies."""
    pad_l, pad_r, pad_t, pad_b = 46, 8, 18, 16
    iw, ih = width - pad_l - pad_r, height - pad_t - pad_b
    pts = [p for _, s in series for p in s if p[1] is not None]
    t_min = min((p[0] for p in pts), default=0.0)
    t_max = max((p[0] for p in pts), default=1.0)
    if phases:
        t_min = min(t_min, min(p[1] for p in phases))
        t_max = max(t_max, max(p[2] for p in phases))
    v_max = max((p[1] for p in pts), default=1.0) or 1.0
    t_span = (t_max - t_min) or 1.0

    def sx(t):
        return pad_l + (t - t_min) / t_span * iw

    def sy(v):
        return pad_t + ih - (v / v_max) * ih

    parts = [f'<svg width="{width}" height="{height}" '
             f'xmlns="http://www.w3.org/2000/svg" '
             f'style="background:#fff;border:1px solid #e5e7eb">']
    for i, (name, p0, p1) in enumerate(phases):
        c = _PHASE_COLORS[i % len(_PHASE_COLORS)]
        parts.append(
            f'<rect x="{sx(p0):.1f}" y="{pad_t}" '
            f'width="{max(sx(p1) - sx(p0), 1):.1f}" height="{ih}" '
            f'fill="{c}" fill-opacity="0.18"/>')
        parts.append(
            f'<text x="{sx(p0) + 2:.1f}" y="{pad_t + 10}" '
            f'font-size="8" fill="#6b7280">{_html.escape(name)}</text>')
    for i, (label, s) in enumerate(series):
        c = _CHART_COLORS[i % len(_CHART_COLORS)]
        path = " ".join(f"{sx(t):.1f},{sy(v):.1f}"
                        for t, v in s if v is not None)
        if path:
            parts.append(f'<polyline points="{path}" fill="none" '
                         f'stroke="{c}" stroke-width="1.3"/>')
        parts.append(
            f'<text x="{pad_l + 4 + i * 130}" y="{height - 4}" '
            f'font-size="9" fill="{c}">{_html.escape(label)}</text>')
    parts.append(f'<text x="2" y="{pad_t + 8}" font-size="9" '
                 f'fill="#374151">{v_max:.3g}</text>')
    parts.append(f'<text x="2" y="{pad_t + ih}" font-size="9" '
                 f'fill="#374151">0</text>')
    parts.append(f'<text x="{pad_l}" y="{pad_t - 6}" font-size="11" '
                 f'font-weight="bold" fill="#111827">'
                 f'{_html.escape(title)}</text>')
    parts.append("</svg>")
    return "".join(parts)


def to_html(report: Dict) -> str:
    """The self-contained timeline dashboard: headline, per-phase
    table (as rendered markdown-ish HTML), and per-engine SVG charts
    for queue depth, TTFT/TPOT p99, token/shed rates and SLO burn."""
    phases = [(ph["name"], ph["t"][0], ph["t"][1])
              for ph in report["phases"]]
    # stitch per-phase timelines back into full-run series per engine
    per_engine: Dict[str, Dict[str, List[Tuple[float, float]]]] = {}
    for ph in report["phases"]:
        for eid, tl in (ph.get("timeline") or {}).items():
            eng = per_engine.setdefault(eid, {})
            for key in ("queue_depth", "ttft_p99", "tpot_p99",
                        "tokens_rate", "rejected_rate"):
                eng.setdefault(key, []).extend(
                    (t, v) for t, v in zip(tl["t"], tl.get(key, []))
                    if v is not None)
    h = report.get("headline") or {}
    head = ""
    if "min_attainment" in h:
        head = (f"min attainment <b>{_fmt(h['min_attainment'])}</b> "
                f"({_html.escape(str(h['worst_objective']))} during "
                f"{_html.escape(str(h['worst_phase']))}), max burn "
                f"{_fmt(h.get('max_burn_rate'))}")
    rows = []
    for ph in report["phases"]:
        att = ph.get("attainment") or {}
        att_s = " ".join(f"{k}={_fmt(v)}"
                         for k, v in sorted(att.items())) or "-"
        fin = ph.get("totals", {}).get("requests_finished", 0)
        rows.append(
            f"<tr><td>{_html.escape(ph['name'])}</td>"
            f"<td>{ph['span'][0]}&ndash;{ph['span'][1]}</td>"
            f"<td>{ph['submitted']}</td><td>{ph['shed']}</td>"
            f"<td>{int(fin)}</td><td>{_html.escape(att_s)}</td></tr>")
    charts = []
    for eid, series in sorted(per_engine.items()):
        charts.append(f"<h3>engine {_html.escape(eid)}</h3>")
        charts.append(_svg_chart(
            "queue depth (window mean)",
            [("queue_depth", series.get("queue_depth", []))], phases))
        charts.append(_svg_chart(
            "latency p99 (s, windowed)",
            [("ttft_p99", series.get("ttft_p99", [])),
             ("tpot_p99", series.get("tpot_p99", []))], phases))
        charts.append(_svg_chart(
            "rates (/s)",
            [("tokens_rate", series.get("tokens_rate", [])),
             ("rejected_rate", series.get("rejected_rate", []))],
            phases))
    for eid, tl in sorted((report.get("burn") or {}).items()):
        objs = [k for k in tl if k != "t"]
        charts.append(_svg_chart(
            f"SLO burn rate — {eid}",
            [(o, [(t, v) for t, v in zip(tl["t"], tl[o])
                  if v is not None]) for o in objs], phases))
    rec = report.get("recovery")
    if rec and rec.get("fleet_timeline"):
        # step-function fleet-size series: repeat each size until the
        # next mutation so the chart reads as levels, not ramps
        tl = rec["fleet_timeline"]
        series = []
        for key in ("total", "serving", "dead"):
            pts: List[Tuple[float, float]] = []
            for i, e in enumerate(tl):
                if i > 0:
                    pts.append((e["t"], tl[i - 1].get(key, 0)))
                pts.append((e["t"], e.get(key, 0)))
            series.append((key, pts))
        charts.append("<h3>fleet</h3>")
        charts.append(_svg_chart("fleet size", series, phases))
        inc_s = " ".join(
            f"{_html.escape(str(i.get('point')))}@t={_fmt(i.get('t'))}"
            f" (first action {_fmt(i.get('time_to_first_action'))}, "
            f"MTTR {_fmt(i.get('mttr')) if 'breach_t' in i else 'no breach'})"
            for i in rec.get("incidents", []))
        reqs = rec.get("requests", {})
        charts.append(
            f"<p>incidents: {inc_s or 'none'}<br>requests: "
            f"{reqs.get('lost', 0)} lost, {reqs.get('replayed', 0)} "
            f"replayed, {reqs.get('degraded', 0)} degraded</p>")
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        "<title>scenario report</title></head>"
        "<body style='font-family:system-ui,sans-serif;max-width:960px;"
        "margin:24px auto'>"
        f"<h1>Scenario report</h1><p>{head}</p>"
        "<table border='1' cellspacing='0' cellpadding='4' "
        "style='border-collapse:collapse;font-size:13px'>"
        "<tr><th>phase</th><th>span</th><th>submitted</th><th>shed</th>"
        "<th>finished</th><th>attainment</th></tr>"
        + "".join(rows) + "</table>"
        + "".join(charts)
        + "</body></html>")


def save_report(report: Dict, out_dir: str,
                basename: str = "scenario") -> Dict[str, str]:
    """Write the JSON + markdown + HTML artifacts; returns their
    paths (the bench record carries these)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for ext, render in (("json", to_json), ("md", to_markdown),
                        ("html", to_html)):
        p = os.path.join(out_dir, f"{basename}.{ext}")
        with open(p, "w") as f:
            f.write(render(report))
        paths[ext] = p
    return paths
