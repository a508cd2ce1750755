"""Serving metrics of the port: the numbers that describe a serving
workload (mirrors ``distkeras_tpu/serving/metrics.py``).

Per request: TTFT (submit -> first token), TPOT (mean seconds per
generated token after the first, the number the ``tpot_p99`` SLO reads)
and end-to-end latency. Per engine iteration: queue depth, slot
occupancy and the decode time and tokens. The degraded ends (timed
out, cancelled), prefill chunks, preemptions, live transfers to another
replica, prefix-cache lookups, the
page-budget gauges, the host offload tier's traffic and the resume
latencies split by path (page swap-in or context re-prefill), the
speculation counters and the MoE routing picture (None on MoE-free
engines) complete ``summary()``.

As in JAX, the class is a thin shape over an ``obs.MetricsRegistry``:
each instance owns a PRIVATE registry (a metrics object is one
measurement window) with the same instrument names
(``serving.ttft_s``, ``serving.tpot_s``, ``serving.latency_s``,
``serving.queue_depth``, ...). Histograms keep exact streaming
count/sum/min/max and a uniform reservoir of ``reservoir`` values
(algorithm R, seeded per series by crc32), so memory stays bounded in
a long-lived engine AND the percentiles keep moving: they are the JAX
package's, value for value, on the same observations. The engine
attaches the current window to ``obs.telemetry_snapshot()``.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np

from distkeras_tpu_torch.obs import MetricsRegistry
from distkeras_tpu_torch.utils.profiling import now

#: per-histogram reservoir: the percentile window of a metrics instance
DEFAULT_RESERVOIR = 2048


class ServingMetrics:
    """Host-side counters; negligible overhead (a few registry updates
    and clock reads per iteration). ``clock`` is injectable for
    deterministic tests. ``registry`` defaults to a private registry
    per instance."""

    def __init__(self, clock=now, registry: Optional[MetricsRegistry] = None,
                 reservoir: int = DEFAULT_RESERVOIR):
        self.clock = clock
        self.registry = registry if registry is not None \
            else MetricsRegistry(reservoir_size=reservoir)
        self.submit_ts: Dict[int, float] = {}    # in-flight only
        self.first_ts: Dict[int, float] = {}     # in-flight only
        self._ttft = self.registry.histogram("serving.ttft_s")
        self._tpot = self.registry.histogram("serving.tpot_s")
        self._latency = self.registry.histogram("serving.latency_s")
        self._qdepth = self.registry.histogram("serving.queue_depth")
        self._occ = self.registry.histogram("serving.slot_occupancy")
        self._finished = self.registry.counter("serving.requests_finished")
        self._tokens = self.registry.counter("serving.tokens_generated")
        self._chunks = self.registry.counter("serving.prefill_chunks")
        # degradation counters: shed at admission,
        # expired deadlines, poisoned-request isolations
        self._rejected = self.registry.counter("serving.requests_rejected")
        self._timed_out = self.registry.counter(
            "serving.requests_timed_out")
        self._cancelled = self.registry.counter(
            "serving.requests_cancelled")
        self._decode_toks = self.registry.counter("serving.decode_tokens")
        self._decode_secs = self.registry.counter("serving.decode_seconds")
        # paged-KV accounting: page-budget gauges set
        # once per iteration, prefix-cache hit counters, preemptions.
        # Gauges stay unset (None) on a slab engine — summary keys are
        # additive and layout-honest
        self._pages_free = self.registry.gauge("serving.pages_free")
        self._pages_shared = self.registry.gauge("serving.pages_shared")
        self._page_frag = self.registry.gauge(
            "serving.page_fragmentation")
        self._prefix_hits = self.registry.counter("serving.prefix_hits")
        self._prefix_lookups = self.registry.counter(
            "serving.prefix_lookups")
        self._prefix_hit_toks = self.registry.counter(
            "serving.prefix_hit_tokens")
        self._prefix_lookup_toks = self.registry.counter(
            "serving.prefix_lookup_tokens")
        self._preempted = self.registry.counter(
            "serving.requests_preempted")
        # host KV offload tier: pages swapped D2H on
        # preemption / prefix spill, pages restored H2D, bytes moved;
        # resume-latency histograms split by path (page swap-in vs
        # context re-prefill — the bench's crossover measurement) and
        # the re-prefill token tallies (recomputed vs avoided)
        self._pages_offloaded = self.registry.counter(
            "serving.pages_offloaded")
        self._pages_restored = self.registry.counter(
            "serving.pages_restored")
        self._offload_bytes = self.registry.counter(
            "serving.offload_bytes")
        self._resume_swap = self.registry.histogram(
            "serving.resume_swap_s")
        self._resume_reprefill = self.registry.histogram(
            "serving.resume_reprefill_s")
        self._reprefill_toks = self.registry.counter(
            "serving.reprefill_tokens")
        self._reprefill_toks_avoided = self.registry.counter(
            "serving.reprefill_tokens_avoided")
        # serving router: requests detached from this
        # engine for re-admission on another replica (prefill->decode
        # handoff, drain rebalancing) — NOT terminal, NOT preemptions
        self._transferred = self.registry.counter(
            "serving.requests_transferred")
        # speculative decoding: drafts offered to the
        # verify step vs drafts the target accepted, plus a per-slot
        # per-iteration acceptance-rate histogram (the bench's
        # percentile source) and streams the acceptance EMA kicked
        # back to plain decode
        self._spec_proposed = self.registry.counter("serving.spec_proposed")
        self._spec_accepted = self.registry.counter("serving.spec_accepted")
        self._spec_rate = self.registry.histogram(
            "serving.spec_accept_rate")
        self._spec_disabled = self.registry.counter(
            "serving.spec_disabled")
        # adaptive re-enable (ServingEngine(spec_reprobe=...)): demoted
        # streams the cooldown re-probe won back to speculation
        self._spec_reenabled = self.registry.counter(
            "serving.spec_reenabled")
        # tree speculation: the per-verify tree
        # width a stream ran at and the accepted root-path length —
        # the adaptive controller's observable trajectory
        self._spec_tree_width = self.registry.histogram(
            "serving.spec_tree_width")
        self._spec_path_len = self.registry.histogram(
            "serving.spec_path_len")
        # MoE serving: per-expert routing load (one
        # gauge series per expert id — BOUNDED by the model's expert
        # count), the router-entropy gauge, and the concentration the
        # engine's MoE-aware admission reads. Unset (None) on MoE-free
        # engines — summary keys stay layout-honest like "pages"
        self._moe_load = self.registry.gauge("serving.moe_expert_load")
        self._moe_entropy = self.registry.gauge(
            "serving.moe_router_entropy")
        self._moe_conc = self.registry.gauge(
            "serving.moe_concentration")
        self._moe_experts = 0            # label-set bound, for summary
        #: exact (tokens, seconds) aggregation per decoding-slot count,
        #: authoritative for ``decode_tokens_per_sec`` (the labeled
        #: counters mirror it for exporters)
        self._decode_agg: Dict[int, List[float]] = {}
        #: recent (n_decoding, dt) samples, a bounded window
        self._decode_recent = deque(maxlen=reservoir)
        #: wall seconds per engine phase ("prefill", "decode")
        self.phase_seconds: Dict[str, float] = {}
        #: tree verifies: accepted path lengths and tree depths offered
        #: (the longest-chain basis of ``path_acceptance_rate``)
        self.spec_path_accepted = 0
        self.spec_path_offered = 0
        self._t_first_submit: Optional[float] = None
        self._t_last_finish: Optional[float] = None

    # --- per request ------------------------------------------------------

    def record_submit(self, rid: int) -> None:
        now_ = self.clock()
        self.submit_ts[rid] = now_
        if self._t_first_submit is None:
            self._t_first_submit = now_

    def record_first_token(self, rid: int) -> None:
        now_ = self.clock()
        t0 = self.submit_ts.get(rid)
        if t0 is not None:
            self._ttft.observe(now_ - t0)
            self.first_ts[rid] = now_

    def record_finish(self, rid: int, n_generated: int) -> None:
        now_ = self.clock()
        # evict the in-flight entries: finished-request state must not
        # accumulate in a long-lived engine
        t0 = self.submit_ts.pop(rid, None)
        if t0 is not None:
            self._latency.observe(now_ - t0)
        t_first = self.first_ts.pop(rid, None)
        if t_first is not None and n_generated > 1:
            self._tpot.observe((now_ - t_first) / (n_generated - 1))
        self._finished.inc()
        self._tokens.inc(int(n_generated))
        self._t_last_finish = now_

    def record_rejected(self) -> None:
        """A submit shed by the bounded admission queue."""
        self._rejected.inc()

    def record_timeout(self, rid: int) -> None:
        """A request's deadline expired before it finished (JAX :200)."""
        self.submit_ts.pop(rid, None)
        self.first_ts.pop(rid, None)
        self._timed_out.inc()

    def record_cancelled(self, rid: int) -> None:
        """A request isolated after its own work failed, or cancelled by
        API (JAX :206)."""
        self.submit_ts.pop(rid, None)
        self.first_ts.pop(rid, None)
        self._cancelled.inc()

    def record_preemption(self, rid: int) -> None:
        """Not terminal: TTFT already fired, latency runs to the finish."""
        self._preempted.inc()

    def record_transfer(self, rid: int) -> None:
        """A request left this engine alive (``transfer_out``: a router
        handoff or rebalance; JAX :218): its in-flight timestamps go, as
        it finishes in another engine's window."""
        self.submit_ts.pop(rid, None)
        self.first_ts.pop(rid, None)
        self._transferred.inc()

    def record_prefix_lookup(self, hit_tokens: int,
                             total_tokens: int) -> None:
        self._prefix_lookups.inc()
        self._prefix_lookup_toks.inc(int(total_tokens))
        if hit_tokens > 0:
            self._prefix_hits.inc()
            self._prefix_hit_toks.inc(int(hit_tokens))

    def record_pages(self, free: int, shared: int,
                     fragmentation: float) -> None:
        """Per-iteration page-budget gauges (paged engine only)."""
        self._pages_free.set(int(free))
        self._pages_shared.set(int(shared))
        self._page_frag.set(float(fragmentation))

    def record_offload(self, offloaded: int, restored: int,
                       nbytes: int) -> None:
        """Host-tier traffic since the engine's last flush (deltas of
        the pool's odometers)."""
        self._pages_offloaded.inc(int(offloaded))
        self._pages_restored.inc(int(restored))
        self._offload_bytes.inc(int(nbytes))

    def record_swap_resume(self, dur_s: float,
                           tokens_avoided: int) -> None:
        """A preemption resume served by a host-page swap-in:
        ``tokens_avoided`` the context tokens a re-prefill would have
        recomputed."""
        self._resume_swap.observe(float(dur_s))
        self._reprefill_toks_avoided.inc(int(tokens_avoided))

    def record_reprefill_resume(self, dur_s: float, tokens: int) -> None:
        """A preemption resume served by re-prefilling ``tokens`` context
        tokens (first chunk to rejoining the batch)."""
        self._resume_reprefill.observe(float(dur_s))
        self._reprefill_toks.inc(int(tokens))

    def record_spec_verify(self, proposed: int, accepted: int) -> None:
        """One slot's outcome in one verify: ``proposed`` drafts offered,
        ``accepted`` of them matched the target's own choices."""
        proposed, accepted = int(proposed), int(accepted)
        self._spec_proposed.inc(proposed)
        self._spec_accepted.inc(accepted)
        if proposed > 0:
            self._spec_rate.observe(accepted / proposed)

    def record_spec_disabled(self) -> None:
        """The acceptance EMA kicked one stream back to plain decode."""
        self._spec_disabled.inc()

    def record_spec_reenabled(self) -> None:
        """A demoted stream's re-probe won speculation back."""
        self._spec_reenabled.inc()

    def record_spec_tree(self, tree_width: int, accepted_path_len: int,
                         depth: int = 0) -> None:
        """One slot's outcome in one tree verify: its branch width, the
        accepted root-path length (0 = only the bonus token) and the
        tree's depth (its longest chain)."""
        self._spec_tree_width.observe(float(tree_width))
        self._spec_path_len.observe(float(accepted_path_len))
        self.spec_path_accepted += int(accepted_path_len)
        self.spec_path_offered += int(depth)

    def record_moe_route(self, expert_load, entropy: float,
                         concentration: float) -> None:
        """One read MoE step's routing picture: ``expert_load`` [E] top-k
        assignments per expert (summed over the model's MoE layers, live
        slots only), the mean router entropy (nats) and the engine's
        smoothed concentration (0 = uniform, 1 = one expert). One gauge
        series per expert id: the label set is bounded by E."""
        load = np.asarray(expert_load, np.float64)
        self._moe_experts = max(self._moe_experts, len(load))
        for e, v in enumerate(load):
            self._moe_load.set(float(v), expert=str(e))
        self._moe_entropy.set(float(entropy))
        self._moe_conc.set(float(concentration))

    def record_phase(self, name: str, seconds: float) -> None:
        self.phase_seconds[name] = self.phase_seconds.get(name, 0.0) \
            + float(seconds)

    # --- per iteration ----------------------------------------------------

    def record_prefill_chunk(self) -> None:
        self._chunks.inc()

    def record_iteration(self, queue_depth: int, occupied: int,
                         num_slots: int) -> None:
        self._qdepth.observe(int(queue_depth))
        self._occ.observe(occupied / num_slots)

    def record_decode(self, n_decoding: int, dt: float,
                      n_tokens: Optional[int] = None) -> None:
        """One decode iteration over ``n_decoding`` slots taking ``dt``
        seconds and emitting ``n_tokens`` (default one a slot)."""
        n, dt = int(n_decoding), float(dt)
        toks = n if n_tokens is None else int(n_tokens)
        agg = self._decode_agg.setdefault(n, [0.0, 0.0])
        agg[0] += toks
        agg[1] += dt
        self._decode_toks.inc(toks, slots=n)
        self._decode_secs.inc(dt, slots=n)
        self._decode_recent.append((n, dt))

    # --- counters as attributes -------------------------------------------

    @property
    def decode_samples(self) -> List:
        """Recent ``(n_decoding, dt)`` pairs (bounded window)."""
        return list(self._decode_recent)

    @property
    def requests_finished(self) -> int:
        return int(self._finished.value())

    @property
    def tokens_generated(self) -> int:
        return int(self._tokens.value())

    @property
    def prefill_chunks(self) -> int:
        return int(self._chunks.value())

    @property
    def requests_rejected(self) -> int:
        return int(self._rejected.value())

    @property
    def requests_timed_out(self) -> int:
        return int(self._timed_out.value())

    @property
    def requests_cancelled(self) -> int:
        return int(self._cancelled.value())

    @property
    def requests_preempted(self) -> int:
        return int(self._preempted.value())

    @property
    def requests_transferred(self) -> int:
        return int(self._transferred.value())

    @property
    def prefix_lookups(self) -> int:
        return int(self._prefix_lookups.value())

    @property
    def prefix_hits(self) -> int:
        return int(self._prefix_hits.value())

    @property
    def prefix_hit_tokens(self) -> int:
        return int(self._prefix_hit_toks.value())

    @property
    def pages_offloaded(self) -> int:
        return int(self._pages_offloaded.value())

    @property
    def pages_restored(self) -> int:
        return int(self._pages_restored.value())

    @property
    def offload_bytes(self) -> int:
        return int(self._offload_bytes.value())

    @property
    def reprefill_tokens(self) -> int:
        return int(self._reprefill_toks.value())

    @property
    def reprefill_tokens_avoided(self) -> int:
        return int(self._reprefill_toks_avoided.value())

    @property
    def spec_proposed(self) -> int:
        return int(self._spec_proposed.value())

    @property
    def spec_accepted(self) -> int:
        return int(self._spec_accepted.value())

    @property
    def spec_disabled_streams(self) -> int:
        return int(self._spec_disabled.value())

    @property
    def spec_reenabled_streams(self) -> int:
        return int(self._spec_reenabled.value())

    @property
    def moe_router_entropy(self) -> Optional[float]:
        return self._moe_entropy.value()

    @property
    def moe_concentration(self) -> Optional[float]:
        return self._moe_conc.value()

    # --- reductions -------------------------------------------------------

    @property
    def prefix_hit_rate(self) -> Optional[float]:
        total = self._prefix_lookup_toks.value()
        if total <= 0:
            return None
        return self._prefix_hit_toks.value() / total

    @property
    def acceptance_rate(self) -> Optional[float]:
        """Fraction of proposed drafts the target accepted (None before
        any verify)."""
        prop = self._spec_proposed.value()
        if prop <= 0:
            return None
        return self._spec_accepted.value() / prop

    @property
    def moe_expert_load(self) -> Optional[List[float]]:
        """The last read MoE step's per-expert load (None on MoE-free
        engines and before the first MoE decode step)."""
        if not self._moe_experts:
            return None
        return [self._moe_load.value(expert=str(e)) or 0.0
                for e in range(self._moe_experts)]

    def decode_tokens_per_sec(self,
                              min_occupancy: int = 0) -> Optional[float]:
        """Decode throughput over iterations with at least
        ``min_occupancy`` decoding slots."""
        toks = sum(a[0] for n, a in self._decode_agg.items()
                   if n >= min_occupancy)
        secs = sum(a[1] for n, a in self._decode_agg.items()
                   if n >= min_occupancy)
        return toks / secs if secs > 0 else None

    @staticmethod
    def _pcts(hist) -> Optional[Dict[str, float]]:
        stats = hist.stats()
        if stats is None:
            return None
        return {"p50": stats["p50"], "p99": stats["p99"]}

    @staticmethod
    def _mean_max(hist) -> Optional[Dict[str, float]]:
        stats = hist.stats()
        if stats is None:
            return None
        return {"mean": stats["mean"], "max": stats["max"]}

    def summary(self) -> Dict:
        elapsed = (self._t_last_finish - self._t_first_submit
                   if self._t_first_submit is not None
                   and self._t_last_finish is not None else 0.0)
        tokens = self.tokens_generated
        pages_free = self._pages_free.value()
        return {
            "requests_finished": self.requests_finished,
            "requests_rejected": self.requests_rejected,
            "requests_timed_out": self.requests_timed_out,
            "requests_cancelled": self.requests_cancelled,
            "requests_preempted": self.requests_preempted,
            "requests_transferred": self.requests_transferred,
            "pages": (None if pages_free is None else {
                "free": int(pages_free),
                "shared": int(self._pages_shared.value() or 0),
                "fragmentation": self._page_frag.value()}),
            "offload": {
                "pages_offloaded": self.pages_offloaded,
                "pages_restored": self.pages_restored,
                "offload_bytes": self.offload_bytes,
                "reprefill_tokens": self.reprefill_tokens,
                "reprefill_tokens_avoided": self.reprefill_tokens_avoided,
                "resume_swap_s": self._pcts(self._resume_swap),
                "resume_reprefill_s": self._pcts(self._resume_reprefill)},
            "prefix_cache": {"lookups": self.prefix_lookups,
                             "hits": self.prefix_hits,
                             "hit_rate": self.prefix_hit_rate},
            "tokens_generated": tokens,
            "tokens_per_sec": tokens / elapsed if elapsed > 0 else None,
            "decode_tokens_per_sec": self.decode_tokens_per_sec(),
            "ttft_s": self._pcts(self._ttft),
            "tpot_s": self._pcts(self._tpot),
            "latency_s": self._pcts(self._latency),
            "queue_depth": self._mean_max(self._qdepth),
            "slot_occupancy": self._mean_max(self._occ),
            "prefill_chunks": self.prefill_chunks,
            "phases": dict(self.phase_seconds),
            "moe": (None if not self._moe_experts else {
                "expert_load": self.moe_expert_load,
                "router_entropy": self.moe_router_entropy,
                "concentration": self.moe_concentration}),
            "acceptance_rate": self.acceptance_rate,
            "speculation": {
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
                "disabled_streams": self.spec_disabled_streams,
                "reenabled_streams": self.spec_reenabled_streams,
                "accept_rate": self._pcts(self._spec_rate),
                "tree_width": self._pcts(self._spec_tree_width),
                "accepted_path_len": self._pcts(self._spec_path_len),
                # the longest-chain basis of the acceptance EMA: accepted
                # path length over tree depth (a tree's acceptance_rate
                # counts every node offered); None before a tree verify
                "path_acceptance_rate": (
                    self.spec_path_accepted / self.spec_path_offered
                    if self.spec_path_offered else None)},
        }
