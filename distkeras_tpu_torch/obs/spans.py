"""Tracing spans: a zero-dependency ``with span("epoch"):`` tree.

Spans answer "where did the wall time go" at the orchestration level —
epoch / data_wait / prefill / decode — the layer ABOVE what a
profiler trace shows. Each ``span(name)`` pushes onto a thread-local stack, so
nesting builds a path tree (``("train", "epoch", "device")``) without
any caller plumbing; aggregation (total seconds + count per path) is
process-global and lock-protected, so worker threads (serving engine,
``StreamingPredictor``, ``Prefetcher``) land in the same tree.

Bridged to ``torch.profiler.record_function`` (where JAX's
``distkeras_tpu/obs/spans.py`` uses ``jax.profiler.TraceAnnotation``):
under a ``torch.profiler`` session (``utils.profiling.trace``, the
trainers' ``profile_dir``) the same span names show up on the host
timeline of the Chrome trace next to the kernels they enclose.

Disabled path (``obs.disable()``): one predicate check, no clock reads,
no allocation — the overhead contract for production hot loops.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Tuple

from distkeras_tpu_torch.utils.profiling import now

#: distinct span paths kept before new paths are dropped (a span name
#: built from a request id would otherwise grow without bound)
MAX_PATHS = 4096

_lock = threading.RLock()
_agg: Dict[Tuple[str, ...], list] = {}   # path -> [total_s, count]
_tls = threading.local()
_overflow_warned = [False]

# the profiler bridge is best-effort: one failure to open a range
# disables it rather than taxing every span
_trace_annotation = [None]


def _get_annotation_cls():
    if _trace_annotation[0] is None:
        try:
            from torch.profiler import record_function
            _trace_annotation[0] = record_function
        except Exception:
            _trace_annotation[0] = False
    return _trace_annotation[0]


def _enabled() -> bool:
    from distkeras_tpu_torch import obs
    return obs.enabled()


@contextlib.contextmanager
def span(name: str):
    """Time the enclosed block under ``name``, nested inside whatever
    span is active on this thread. Exception-safe: the stack pops and
    the (partial) duration records on every exit path."""
    if not _enabled():
        yield
        return
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(str(name))
    path = tuple(stack)
    ann_cls = _get_annotation_cls()
    ann = None
    if ann_cls:
        try:
            ann = ann_cls(name)
            ann.__enter__()
        except Exception:
            _trace_annotation[0] = False
            ann = None
    t0 = now()
    try:
        yield
    finally:
        dt = now() - t0
        if ann is not None:
            try:
                ann.__exit__(None, None, None)
            except Exception:
                pass
        stack.pop()
        with _lock:
            rec = _agg.get(path)
            if rec is not None:
                rec[0] += dt
                rec[1] += 1
            elif len(_agg) < MAX_PATHS:
                _agg[path] = [dt, 1]
            elif not _overflow_warned[0]:
                _overflow_warned[0] = True
                import warnings
                warnings.warn(
                    f"span tree exceeded {MAX_PATHS} distinct paths; "
                    "further paths are dropped (span names should be "
                    "static, not per-request values)", stacklevel=3)


def current_path() -> Tuple[str, ...]:
    """The active span path on THIS thread (empty outside any span)."""
    return tuple(getattr(_tls, "stack", ()) or ())


def reset_spans() -> None:
    with _lock:
        _agg.clear()
        _overflow_warned[0] = False


def span_records():
    """Flat ``[(path_tuple, total_s, count)]`` — the exporter view."""
    with _lock:
        return [(path, rec[0], rec[1]) for path, rec in _agg.items()]


def span_summary() -> Dict:
    """Nested tree: ``{name: {"count", "total_s", "self_s",
    "children": {...}}}``. ``self_s`` is wall time not accounted to any
    child span (the "accounted time" view: a large ``self_s`` on a
    parent means untraced work inside it)."""
    with _lock:
        items = sorted(_agg.items())
    root: Dict = {}
    for path, (total, count) in items:
        node_map = root
        node = None
        for part in path:
            node = node_map.setdefault(
                part, {"count": 0, "total_s": 0.0, "children": {}})
            node_map = node["children"]
        node["count"] += count
        node["total_s"] += total

    def finish(node_map):
        for node in node_map.values():
            child_total = sum(c["total_s"]
                              for c in node["children"].values())
            node["self_s"] = max(node["total_s"] - child_total, 0.0)
            finish(node["children"])
    finish(root)
    return root
