"""``distkeras_tpu_torch.obs`` — the unified telemetry layer (mirrors
``distkeras_tpu/obs``: the same registry, spans, exporters, training
tape, request tracer, flight recorder, time series, SLO engine and
reports; the compile totals count the port's kernel builds).

One subsystem answering, from a single snapshot: where did the step
time go (spans + the training tape's data/host/device breakdown), did
we recompile (``collectors.RecompileDetector`` + process-global compile
totals), are we data-stalled (``Prefetcher`` queue-depth/stall gauges),
and what is the serving fleet doing (``ServingMetrics`` re-expressed on
the registry). Exporters: JSONL event log, Prometheus text, and the
in-process ``telemetry_snapshot()``.

Quick tour::

    from distkeras_tpu_torch import obs

    with obs.span("epoch"):
        ...                        # nested spans build a tree

    reqs = obs.get_registry().counter("myapp.requests")
    reqs.inc(route="predict")

    snap = obs.telemetry_snapshot()          # everything, one dict
    obs.exporters.JsonlExporter("t.jsonl").export()
    print(obs.exporters.prometheus_text())

Global switch: ``obs.disable()`` (or env ``DKT_TELEMETRY=0``) turns the
instrumentation points — spans, tapes, prefetch gauges, the serving
engine's tracer, recorder and time series — into no-ops. Explicit registry use (e.g. ``ServingMetrics``, whose
``summary()`` is a functional API, not telemetry) keeps recording
regardless; the switch gates overhead, not correctness.
"""

from __future__ import annotations

import os
import threading
import weakref
from typing import Callable, Dict, Optional

from distkeras_tpu_torch.obs.registry import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry)
from distkeras_tpu_torch.obs.spans import (  # noqa: F401
    current_path, reset_spans, span, span_records, span_summary)
from distkeras_tpu_torch.obs import collectors, exporters  # noqa: F401
from distkeras_tpu_torch.obs.collectors import (  # noqa: F401
    RecompileDetector, RecompileWarning, compile_totals,
    memory_watermark)
from distkeras_tpu_torch.obs.exporters import SCHEMA_VERSION  # noqa: F401
from distkeras_tpu_torch.obs.tape import (  # noqa: F401
    NULL_TAPE, TrainingTape, detect_peak_flops, resolve_tape,
    timed_stream)
from distkeras_tpu_torch.obs.tracing import (  # noqa: F401
    NULL_TRACER, RequestTracer, resolve_tracer)
from distkeras_tpu_torch.obs.recorder import (  # noqa: F401
    NULL_RECORDER, FlightRecorder, get_recorder, resolve_recorder)
from distkeras_tpu_torch.obs.timeseries import Ring, TimeSeries  # noqa: F401
from distkeras_tpu_torch.obs.slo import Objective, SLOEngine  # noqa: F401

_enabled = [os.environ.get("DKT_TELEMETRY", "1") not in ("0", "false")]
_registry_lock = threading.Lock()
_registry: Optional[MetricsRegistry] = None
_components: Dict[str, Callable] = {}


def enabled() -> bool:
    return _enabled[0]


def enable() -> None:
    _enabled[0] = True


def disable() -> None:
    """No-op the instrumentation points (spans/tapes/gauges)."""
    _enabled[0] = False


def get_registry() -> MetricsRegistry:
    """The process-global default registry (created on first use)."""
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = MetricsRegistry()
        return _registry


def reset_registry() -> MetricsRegistry:
    """Swap in a fresh global registry (test isolation / new reporting
    window); returns the new one. Existing instrument handles keep
    writing to the OLD registry — re-fetch instruments after a reset."""
    global _registry
    with _registry_lock:
        _registry = MetricsRegistry()
        return _registry


def attach(name: str, provider, owner=None) -> None:
    """Register a component snapshot provider (a zero-arg callable
    returning a dict) under ``name`` — how subsystem-local state (e.g.
    the serving engine's current ``ServingMetrics`` window) joins
    ``telemetry_snapshot()`` without living on the global registry.

    With ``owner``, the registration auto-detaches when ``owner`` is
    garbage-collected, so short-lived engines don't leak. A BOUND
    METHOD provider (``obs.attach(n, self.snapshot, owner=self)`` — the
    natural pattern) is held via ``weakref.WeakMethod`` so the registry
    never keeps ``owner`` alive; any other callable is held strongly,
    so it must not capture ``owner`` itself (close over a
    ``weakref.ref`` instead)."""
    import types
    if owner is not None:
        box = {}
        if isinstance(provider, types.MethodType):
            wm = weakref.WeakMethod(provider)

            def wrapped():
                fn = wm()
                return (fn() if fn is not None
                        and box["ref"]() is not None else None)
        else:
            fn = provider

            def wrapped():
                return fn() if box["ref"]() is not None else None

        def _cleanup(_ref, n=name):
            # pop only OUR registration: a newer attach under the same
            # name must survive an older owner's garbage collection
            if _components.get(n) is wrapped:
                _components.pop(n, None)

        box["ref"] = weakref.ref(owner, _cleanup)
        provider = wrapped
    _components[name] = provider


def detach(name: str) -> None:
    _components.pop(name, None)


def components() -> list:
    """Currently attached component names (registration order)."""
    return list(_components)


def aggregate_serving(snapshot: Optional[Dict] = None) -> Dict:
    """Cross-replica serving aggregation: collect
    every serving component from a ``telemetry_snapshot()`` — with N
    live engines each attaches under its own name (``"serving"`` /
    ``"serving[<engine_id>]"``) — and sum the fleet-wide counters.
    Returns ``{"replicas": {component name: summary}, "totals":
    {counter: fleet sum}}``; per-replica detail (percentiles, pages,
    SLO status, request timelines — each timeline tagged with its
    engine id) stays under ``"replicas"`` because percentiles do not
    sum."""
    snap = snapshot if snapshot is not None else telemetry_snapshot()
    replicas = {
        name: comp
        for name, comp in (snap.get("components") or {}).items()
        if name == "serving" or name.startswith("serving[")}
    keys = ("requests_finished", "requests_rejected",
            "requests_timed_out", "requests_cancelled",
            "requests_preempted", "requests_transferred",
            "tokens_generated", "prefill_chunks")
    totals: Dict[str, float] = {k: 0 for k in keys}
    for comp in replicas.values():
        if not isinstance(comp, dict):
            continue
        for k in keys:
            v = comp.get(k)
            if isinstance(v, (int, float)):
                totals[k] += v
    return {"replicas": replicas, "totals": totals}


def telemetry_snapshot(registry: Optional[MetricsRegistry] = None) -> Dict:
    """THE unified view: registry metrics + span tree + compile totals
    + device-memory stats + every attached component's snapshot."""
    registry = registry if registry is not None else get_registry()
    components = {}
    for name, provider in list(_components.items()):
        try:
            snap = provider()
        except Exception as e:       # a dying component must not take
            snap = {"error": repr(e)}  # the whole snapshot down
        if snap is not None:
            components[name] = snap
    # watermark BEFORE the metrics snapshot: it writes the
    # device.bytes_in_use gauges on this registry, and the "metrics"
    # view must include the reading taken in this same call
    mem = memory_watermark(registry)
    return {
        "schema_version": SCHEMA_VERSION,
        "metrics": registry.snapshot(),
        "spans": span_summary(),
        "compile": compile_totals(),
        "device_memory": mem,
        "components": components,
    }
