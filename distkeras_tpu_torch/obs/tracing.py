"""Request-level tracing: a bounded per-request event timeline.

The telemetry layer's registry/spans answer "how is the system doing
on average"; a production serving incident needs "what happened to
*this request*" — where did its latency go (queued behind a burst?
chunked prefill of a long neighbour? slow decode?), which slot served
it, how deep was the queue when it arrived. dist-keras shipped
per-worker training histories as first-class artifacts; the
serving-engine equivalent is the per-request timeline this module
records.

Event vocabulary (every event carries a ``utils.profiling.now``
timestamp on the engine clock):

* ``submitted`` — entered the admission queue (queue depth attached);
* ``admitted`` — took a KV slot (slot id + remaining queue depth);
* ``prefix_hit`` — the paged engine served the first N context tokens
  off shared prefix-cache pages (prefill skipped them);
* ``prefill_chunk`` — one prompt chunk ingested (bounded by
  ``ceil(max_len / prefill_chunk)`` per request);
* ``first_token`` — prefill complete, first sample emitted (the TTFT
  edge);
* ``decode`` — AGGREGATED: one event per ``decode_agg`` decode ticks
  (not per token — the hot loop stays cheap), plus a final flush at
  terminal. Since the zero-bubble serving loop, the engine delivers
  ticks in deferred batches (``on_decode_batch``, one call per host
  window rather than one ``on_decode`` per iteration), back-dated to
  the window start — totals are exact, event timestamps are
  window-granular;
* ``spec_verify`` — AGGREGATED like ``decode`` (flushed on the same
  cadence): draft tokens proposed vs accepted for this request's
  speculative verify steps since the last flush;
* ``moe_route`` — AGGREGATED like ``decode`` (flushed on the same
  cadence, MoE engines only): mean router entropy and the max
  top-expert share over the iterations this request decoded since the
  last flush — per-request visibility into the routing concentration
  that shapes MoE decode cost;
* ``preempted`` / ``resumed`` — the paged engine evicted the
  request's pages back to the queue under budget pressure / brought
  it back after the recompute prefill or the host-page swap-in
  (tokens generated so far attached; the request stays live —
  ``admitted`` fires again on re-admission);
* ``swap_out`` / ``swap_in`` — the victim's KV pages moved D2H into
  the host pool at eviction / back H2D at re-admission (``n_pages`` attached; a preemption WITHOUT ``swap_out`` resumes by
  re-prefill instead);
* ``finished`` / ``timed_out`` / ``cancelled`` — terminal.

Memory is bounded everywhere: completed timelines live in a
``deque(maxlen=max_requests)``, each timeline caps its event list at
``max_events`` (overflow counted, not stored), and in-flight state is
evicted at terminal.

Two export views:

* ``summaries()`` — compact per-request dicts (phase durations that
  sum exactly to the request's measured latency); the serving engine
  merges them into
  ``telemetry_snapshot()["components"]["serving"]["requests"]``.
* ``chrome_trace()`` / ``dump_chrome_trace(path)`` — Chrome
  trace-event JSON loadable in Perfetto (https://ui.perfetto.dev):
  one track per KV slot (slot occupancy intervals), one track per
  request (queued/prefill/decode phases), and one flow arrow per
  request linking its submission to its completion.

``NULL_TRACER`` is the disabled path (``obs.disable()`` /
``DKT_TELEMETRY=0``): every hook a no-op, resolved once at engine
construction via ``resolve_tracer``.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import Dict, List, Optional

from distkeras_tpu_torch.utils.profiling import now

__all__ = ["NULL_TRACER", "RequestTimeline", "RequestTracer",
           "resolve_tracer"]

#: completed timelines retained (ring; oldest evicted)
DEFAULT_MAX_REQUESTS = 256
#: engine iterations folded into one aggregated ``decode`` event
DEFAULT_DECODE_AGG = 16
#: events stored per timeline before overflow counting kicks in
DEFAULT_MAX_EVENTS = 256

#: terminal states a timeline can end in (mirrors the scheduler's
#: ``TERMINAL_STATES`` without importing serving from obs)
TERMINAL_EVENTS = ("finished", "timed_out", "cancelled")


class RequestTimeline:
    """One request's event list plus the landmark timestamps the
    summary durations derive from. Host-side bookkeeping only."""

    __slots__ = ("rid", "submit_t", "admit_t", "first_token_t", "end_t",
                 "state", "slot", "queue_depth_at_submit",
                 "queue_depth_at_admit", "prefill_chunks", "decode_iters",
                 "n_tokens", "events", "dropped_events", "_agg_count",
                 "_agg_t0", "n_preempted", "prefix_hit_tokens",
                 "spec_proposed", "spec_accepted", "_spec_agg_proposed",
                 "_spec_agg_accepted", "_spec_agg_width",
                 "_spec_agg_path", "_moe_agg_n", "_moe_agg_entropy",
                 "_moe_agg_top")

    def __init__(self, rid: int):
        self.rid = rid
        self.submit_t: Optional[float] = None
        self.admit_t: Optional[float] = None
        self.first_token_t: Optional[float] = None
        self.end_t: Optional[float] = None
        self.state = "in_flight"
        self.slot: Optional[int] = None
        self.queue_depth_at_submit: Optional[int] = None
        self.queue_depth_at_admit: Optional[int] = None
        self.prefill_chunks = 0
        self.decode_iters = 0
        self.n_tokens = 0
        self.events: List[Dict] = []
        self.dropped_events = 0
        self._agg_count = 0          # decode iters since last flush
        self._agg_t0: Optional[float] = None
        self.n_preempted = 0         # page-budget evictions survived
        self.prefix_hit_tokens = 0   # context tokens off shared pages
        self.spec_proposed = 0       # draft tokens offered to verify
        self.spec_accepted = 0       # drafts the target accepted
        self._spec_agg_proposed = 0  # since last spec_verify flush
        self._spec_agg_accepted = 0
        self._spec_agg_width = 0     # max tree width in the window
        self._spec_agg_path = 0      # max accepted root-path length
        self._moe_agg_n = 0          # MoE iters since last flush
        self._moe_agg_entropy = 0.0  # summed router entropy (nats)
        self._moe_agg_top = 0.0      # max top-expert share seen

    def add_event(self, name: str, t: float, max_events: int,
                  **fields) -> None:
        if len(self.events) >= max_events:
            self.dropped_events += 1
            return
        ev = {"name": name, "t": t}
        if fields:
            ev.update(fields)
        self.events.append(ev)

    def flush_decode(self, t: float, max_events: int) -> None:
        """Close the open aggregated-decode window (if any), and the
        speculative-verify aggregation riding on the same cadence."""
        if self._agg_count:
            self.add_event("decode", t, max_events,
                           iters=self._agg_count, t0=self._agg_t0)
            self._agg_count = 0
            self._agg_t0 = None
        if self._spec_agg_proposed:
            extra = {}
            if self._spec_agg_width:
                # tree speculation: the widest
                # tree and longest accepted root path in the window
                extra = {"tree_width": self._spec_agg_width,
                         "accepted_path_len": self._spec_agg_path}
            self.add_event("spec_verify", t, max_events,
                           proposed=self._spec_agg_proposed,
                           accepted=self._spec_agg_accepted, **extra)
            self._spec_agg_proposed = 0
            self._spec_agg_accepted = 0
            self._spec_agg_width = 0
            self._spec_agg_path = 0
        if self._moe_agg_n:
            self.add_event(
                "moe_route", t, max_events,
                entropy=round(self._moe_agg_entropy / self._moe_agg_n,
                              4),
                top_share=round(self._moe_agg_top, 4),
                iters=self._moe_agg_n)
            self._moe_agg_n = 0
            self._moe_agg_entropy = 0.0
            self._moe_agg_top = 0.0

    def durations(self) -> Dict[str, float]:
        """Per-phase durations. By construction the emitted phases
        partition the request's life exactly — ``queued_s +
        prefill_s + decode_s == total_s`` (missing phases contribute
        nothing: same landmark timestamps on both sides) — so a
        timeline is token-exact against the measured latency. A
        request terminated while still QUEUED is all queued phase; one
        terminated after admission but before its first token gets the
        admit->end span as ``prefill_s`` (that is the work it died
        in), with no ``ttft_s``/``decode_s``."""
        out: Dict[str, float] = {}
        sub, adm = self.submit_t, self.admit_t
        first, end = self.first_token_t, self.end_t
        if sub is None:
            return out
        if adm is not None:
            out["queued_s"] = adm - sub
            if first is not None:
                out["prefill_s"] = first - adm
                out["ttft_s"] = first - sub
                if end is not None:
                    out["decode_s"] = end - first
            elif end is not None:
                out["prefill_s"] = end - adm
        elif end is not None:
            out["queued_s"] = end - sub
        if end is not None:
            out["total_s"] = end - sub
        return out

    def summary(self) -> Dict:
        out = {
            "rid": self.rid,
            "state": self.state,
            "slot": self.slot,
            "queue_depth_at_submit": self.queue_depth_at_submit,
            "queue_depth_at_admit": self.queue_depth_at_admit,
            "prefill_chunks": self.prefill_chunks,
            "decode_iters": self.decode_iters,
            "n_tokens": self.n_tokens,
            "durations": self.durations(),
        }
        if self.n_preempted:
            out["n_preempted"] = self.n_preempted
        if self.prefix_hit_tokens:
            out["prefix_hit_tokens"] = self.prefix_hit_tokens
        if self.spec_proposed:
            out["spec_proposed"] = self.spec_proposed
            out["spec_accepted"] = self.spec_accepted
        if self.dropped_events:
            out["dropped_events"] = self.dropped_events
        return out


class _NullTracer:
    """Disabled tracing: every hook a no-op (single shared instance)."""

    enabled = False
    engine = None

    def on_submit(self, rid, queue_depth):
        pass

    def on_admit(self, rid, slot, queue_depth):
        pass

    def on_prefill_chunk(self, rid, t0, q_len):
        pass

    def on_prefix_hit(self, rid, n_tokens):
        pass

    def on_first_token(self, rid):
        pass

    def on_decode(self, rids):
        pass

    def on_decode_batch(self, ticks, t0=None):
        pass

    def on_spec_verify(self, items):
        pass

    def on_moe_route(self, rids, entropy, top_share):
        pass

    def on_preempt(self, rid, n_generated=0):
        pass

    def on_swap_out(self, rid, n_pages):
        pass

    def on_swap_in(self, rid, n_pages):
        pass

    def on_resume(self, rid):
        pass

    def on_terminal(self, rid, state, n_tokens=0):
        pass

    def summaries(self):
        return {}

    def timelines(self):
        return []

    def chrome_trace(self):
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def dump_chrome_trace(self, path):
        return None


NULL_TRACER = _NullTracer()


class RequestTracer:
    """Thread-safe, bounded per-request timeline recorder (module doc
    has the event vocabulary and bounds). ``clock`` must be the SAME
    clock the engine's ``ServingMetrics`` uses, so timeline durations
    and measured latencies are directly comparable — the engine passes
    ``metrics.clock`` when it auto-creates a tracer."""

    enabled = True

    def __init__(self, clock=now, max_requests: int = DEFAULT_MAX_REQUESTS,
                 decode_agg: int = DEFAULT_DECODE_AGG,
                 max_events: int = DEFAULT_MAX_EVENTS):
        if max_requests < 1 or decode_agg < 1 or max_events < 8:
            raise ValueError(
                f"max_requests/decode_agg must be >= 1 and max_events "
                f">= 8, got {max_requests}/{decode_agg}/{max_events}")
        self.clock = clock
        self.max_requests = int(max_requests)
        self.decode_agg = int(decode_agg)
        self.max_events = int(max_events)
        #: engine/replica tag (serving router): with N live engines,
        #: each engine's tracer stamps its summaries and Chrome-trace
        #: tracks with the engine id so cross-replica aggregations stay
        #: separable. Set by the engine at construction
        #: (``resolve_tracer(engine=...)``); None on a standalone
        #: tracer.
        self.engine: Optional[str] = None
        self._lock = threading.Lock()
        self._live: Dict[int, RequestTimeline] = {}
        self._done: deque = deque(maxlen=self.max_requests)
        self._origin = clock()        # chrome-trace time zero
        self.rejected = 0             # shed submits (no timeline)

    # -- recording hooks (engine/scheduler call sites) --------------------

    def on_submit(self, rid: int, queue_depth: int) -> None:
        t = self.clock()
        with self._lock:
            tl = self._live.get(rid)
            if tl is None:
                tl = self._live[rid] = RequestTimeline(rid)
            tl.submit_t = t
            tl.queue_depth_at_submit = int(queue_depth)
            tl.add_event("submitted", t, self.max_events,
                         queue_depth=int(queue_depth))

    def on_admit(self, rid: int, slot: int, queue_depth: int) -> None:
        t = self.clock()
        with self._lock:
            tl = self._live.get(rid)
            if tl is None:
                return
            tl.admit_t = t
            tl.slot = int(slot)
            tl.queue_depth_at_admit = int(queue_depth)
            tl.add_event("admitted", t, self.max_events, slot=int(slot),
                         queue_depth=int(queue_depth))

    def on_prefill_chunk(self, rid: int, t0: int, q_len: int) -> None:
        t = self.clock()
        with self._lock:
            tl = self._live.get(rid)
            if tl is None:
                return
            tl.prefill_chunks += 1
            tl.add_event("prefill_chunk", t, self.max_events,
                         pos=int(t0), len=int(q_len))

    def on_prefix_hit(self, rid: int, n_tokens: int) -> None:
        """The paged engine served ``n_tokens`` of this request's
        context off shared prefix-cache pages (their prefill compute
        was skipped)."""
        t = self.clock()
        with self._lock:
            tl = self._live.get(rid)
            if tl is None:
                return
            tl.prefix_hit_tokens += int(n_tokens)
            tl.add_event("prefix_hit", t, self.max_events,
                         tokens=int(n_tokens))

    def on_first_token(self, rid: int) -> None:
        t = self.clock()
        with self._lock:
            tl = self._live.get(rid)
            if tl is None:
                return
            tl.first_token_t = t
            tl.add_event("first_token", t, self.max_events)

    def on_preempt(self, rid: int, n_generated: int = 0) -> None:
        """Page-budget eviction: the request left its slot but stays
        LIVE (its timeline keeps accumulating through re-admission —
        ``admitted`` fires again; latency still measures to the real
        terminal)."""
        t = self.clock()
        with self._lock:
            tl = self._live.get(rid)
            if tl is None:
                return
            tl.flush_decode(t, self.max_events)
            tl.n_preempted += 1
            tl.add_event("preempted", t, self.max_events,
                         n_generated=int(n_generated))

    def on_swap_out(self, rid: int, n_pages: int) -> None:
        """The preemption victim's KV pages were offloaded D2H to the
        host pool — its resume will be a page swap-in,
        not a re-prefill."""
        t = self.clock()
        with self._lock:
            tl = self._live.get(rid)
            if tl is None:
                return
            tl.add_event("swap_out", t, self.max_events,
                         n_pages=int(n_pages))

    def on_swap_in(self, rid: int, n_pages: int) -> None:
        """Host pages restored H2D into fresh pool pages; the request
        rejoined decode without recomputing its context."""
        t = self.clock()
        with self._lock:
            tl = self._live.get(rid)
            if tl is None:
                return
            tl.add_event("swap_in", t, self.max_events,
                         n_pages=int(n_pages))

    def on_resume(self, rid: int) -> None:
        """Recompute prefill (or a page swap-in) finished after a
        preemption; the request rejoined the decode batch."""
        t = self.clock()
        with self._lock:
            tl = self._live.get(rid)
            if tl is None:
                return
            tl.add_event("resumed", t, self.max_events)

    def on_decode(self, rids) -> None:
        """One engine decode iteration over ``rids`` (the decoding
        batch). Aggregated: one stored event per ``decode_agg``
        iterations per request. One tick per rid — the aggregation
        rule lives in :meth:`on_decode_batch`."""
        ticks: Dict[int, int] = {}
        for rid in rids:
            ticks[rid] = ticks.get(rid, 0) + 1
        self.on_decode_batch(ticks)

    def on_decode_batch(self, ticks: Dict[int, int],
                        t0: Optional[float] = None) -> None:
        """Deferred decode ticks (zero-bubble serving loop): ``ticks``
        maps ``rid -> n`` decode ticks accumulated since the engine's
        last host-window flush (one tick per emitted token — for plain
        decode that IS one per iteration; a fused K-step window ticks
        once per token it emitted). ``t0`` back-dates the window start
        so the aggregated ``decode`` events still bracket the real
        span. Equivalent to ``n`` single-rid ``on_decode`` calls,
        batched so the serving hot loop pays one lock/clock per window
        instead of one per iteration."""
        t = self.clock()
        with self._lock:
            for rid, n in ticks.items():
                tl = self._live.get(rid)
                if tl is None:
                    continue
                tl.decode_iters += int(n)
                if tl._agg_count == 0:
                    tl._agg_t0 = t0 if t0 is not None else t
                tl._agg_count += int(n)
                if tl._agg_count >= self.decode_agg:
                    tl.flush_decode(t, self.max_events)

    def on_spec_verify(self, items) -> None:
        """One speculative verify step's per-request outcomes:
        ``items`` is an iterable of ``(rid, proposed, accepted)`` —
        or, for TREE verifies, ``(rid, proposed,
        accepted, tree_width, accepted_path_len)``. Aggregated onto
        the decode-event cadence (flushed together), so speculation
        adds no per-iteration event volume; the tree fields aggregate
        as window maxima."""
        with self._lock:
            for item in items:
                rid, proposed, accepted = item[0], item[1], item[2]
                tl = self._live.get(rid)
                if tl is None:
                    continue
                tl.spec_proposed += int(proposed)
                tl.spec_accepted += int(accepted)
                tl._spec_agg_proposed += int(proposed)
                tl._spec_agg_accepted += int(accepted)
                if len(item) > 3:
                    tl._spec_agg_width = max(tl._spec_agg_width,
                                             int(item[3]))
                    tl._spec_agg_path = max(tl._spec_agg_path,
                                            int(item[4]))

    def on_moe_route(self, rids, entropy: float,
                     top_share: float) -> None:
        """One MoE decode iteration's routing picture for the decoding
        batch ``rids``: mean router entropy (nats) and the top
        expert's share of routing assignments. Aggregated onto the
        decode-event cadence (flushed with ``decode``), so MoE
        telemetry adds no per-iteration event volume."""
        with self._lock:
            for rid in rids:
                tl = self._live.get(rid)
                if tl is None:
                    continue
                tl._moe_agg_n += 1
                tl._moe_agg_entropy += float(entropy)
                if top_share > tl._moe_agg_top:
                    tl._moe_agg_top = float(top_share)

    def on_terminal(self, rid: int, state: str, n_tokens: int = 0) -> None:
        t = self.clock()
        with self._lock:
            tl = self._live.pop(rid, None)
            if tl is None:
                return
            tl.flush_decode(t, self.max_events)
            tl.end_t = t
            tl.state = str(state)
            tl.n_tokens = int(n_tokens)
            tl.add_event(str(state), t, self.max_events)
            self._done.append(tl)

    def on_reject(self) -> None:
        with self._lock:
            self.rejected += 1

    # -- views -------------------------------------------------------------

    def timelines(self) -> List[RequestTimeline]:
        """Completed timelines, oldest first, then in-flight ones."""
        with self._lock:
            return list(self._done) + list(self._live.values())

    def summaries(self) -> Dict[int, Dict]:
        """``{rid: compact summary}`` for every retained timeline —
        the view the serving engine merges into
        ``telemetry_snapshot()["components"]["serving"]``. Each
        summary carries the tracer's ``engine`` tag when set, so
        cross-replica aggregations can tell whose request rid 3 was."""
        out = {}
        for tl in self.timelines():
            s = tl.summary()
            if self.engine is not None:
                s["engine"] = self.engine
            out[tl.rid] = s
        return out

    # -- Chrome trace export ----------------------------------------------

    def _us(self, t: float) -> float:
        return (t - self._origin) * 1e6

    def chrome_trace(self) -> Dict:
        """The timelines as Chrome trace-event JSON (the
        ``chrome://tracing`` / Perfetto format): pid 0 = one thread
        per KV slot (occupancy intervals), pid 1 = one thread per
        request (queued/prefill/decode complete events), plus one
        ``s``/``f`` flow pair per request tying its submission to its
        completion across tracks. Durations in microseconds."""
        tag = f"[{self.engine}]" if self.engine is not None else ""
        events: List[Dict] = [
            {"ph": "M", "pid": 0, "name": "process_name",
             "args": {"name": f"kv_slots{tag}"}},
            {"ph": "M", "pid": 1, "name": "process_name",
             "args": {"name": f"requests{tag}"}},
        ]
        slots_seen = set()
        for tl in self.timelines():
            rid = tl.rid
            end_t = tl.end_t if tl.end_t is not None else self.clock()
            events.append({"ph": "M", "pid": 1, "tid": rid,
                           "name": "thread_name",
                           "args": {"name": f"req {rid}"}})
            if tl.submit_t is None:
                continue
            args = {"state": tl.state, "slot": tl.slot,
                    "queue_depth_at_submit": tl.queue_depth_at_submit,
                    "n_tokens": tl.n_tokens}
            # request track: the three phases as complete ("X") slices
            adm = tl.admit_t
            events.append({
                "ph": "X", "pid": 1, "tid": rid, "name": "queued",
                "cat": "request", "ts": self._us(tl.submit_t),
                "dur": max(self._us(adm if adm is not None else end_t)
                           - self._us(tl.submit_t), 0.0),
                "args": args})
            if adm is not None:
                first = tl.first_token_t
                events.append({
                    "ph": "X", "pid": 1, "tid": rid, "name": "prefill",
                    "cat": "request", "ts": self._us(adm),
                    "dur": max(self._us(first if first is not None
                                        else end_t) - self._us(adm), 0.0),
                    "args": {"chunks": tl.prefill_chunks}})
                if first is not None:
                    events.append({
                        "ph": "X", "pid": 1, "tid": rid, "name": "decode",
                        "cat": "request", "ts": self._us(first),
                        "dur": max(self._us(end_t) - self._us(first), 0.0),
                        "args": {"iters": tl.decode_iters,
                                 "tokens": tl.n_tokens}})
            # slot track: this request's occupancy interval
            if tl.slot is not None and adm is not None:
                if tl.slot not in slots_seen:
                    slots_seen.add(tl.slot)
                    events.append({"ph": "M", "pid": 0, "tid": tl.slot,
                                   "name": "thread_name",
                                   "args": {"name": f"slot {tl.slot}"}})
                events.append({
                    "ph": "X", "pid": 0, "tid": tl.slot,
                    "name": f"req {rid}", "cat": "slot",
                    "ts": self._us(adm),
                    "dur": max(self._us(end_t) - self._us(adm), 0.0),
                    "args": {"rid": rid, "state": tl.state}})
            # ONE complete flow per request: submission -> completion
            # (crosses tracks when the request held a slot)
            f_pid, f_tid = ((0, tl.slot)
                            if tl.slot is not None and adm is not None
                            else (1, rid))
            events.append({"ph": "s", "pid": 1, "tid": rid,
                           "name": "req_flow", "cat": "flow", "id": rid,
                           "ts": self._us(tl.submit_t)})
            events.append({"ph": "f", "bp": "e", "pid": f_pid,
                           "tid": f_tid, "name": "req_flow",
                           "cat": "flow", "id": rid,
                           "ts": self._us(end_t)})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def dump_chrome_trace(self, path: str) -> str:
        """Write ``chrome_trace()`` as JSON; returns ``path``. Load in
        Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


def resolve_tracer(tracer=None, clock=now, engine=None):
    """THE engine ``tracer=`` kwarg policy (mirrors
    ``obs.resolve_tape``): ``False`` (or obs disabled) ->
    ``NULL_TRACER``; ``None`` -> a fresh auto tracer on ``clock``;
    anything else is a user-configured tracer used as-is.

    ``engine`` stamps the tracer's engine/replica tag: a fresh auto
    tracer always takes it; a user-configured tracer takes it only if
    it has none yet (the first engine a shared tracer sees names it —
    sharing one tracer across engines is not separable per request
    and a router deployment should give each replica its own)."""
    from distkeras_tpu_torch import obs
    if tracer is False or not obs.enabled():
        return NULL_TRACER
    if tracer is None:
        t = RequestTracer(clock=clock)
        t.engine = engine
        return t
    if engine is not None and tracer.enabled \
            and getattr(tracer, "engine", None) is None:
        tracer.engine = engine
    return tracer
