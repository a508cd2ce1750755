"""Serving metrics of the port: the counters and ``summary()`` fields
the engine records.

Mirrors the matching part of ``distkeras_tpu/serving/metrics.py``: per
request TTFT (submit -> first token), TPOT and end-to-end latency; per
iteration queue depth, slot occupancy and the decode time and tokens;
the degraded ends (timed out, cancelled; :200-209),
prefill chunks, preemptions, prefix-cache lookups, the page-budget
gauges, the host offload tier's traffic and the resume latencies split
by path (page swap-in or context re-prefill; :95-113, :244-269, :374-387,
the ``"offload"`` key of ``summary()`` :493), the speculation counters
(drafts proposed and accepted per verify, streams disabled and
re-enabled, tree width and accepted path length) and the MoE routing
picture (``record_moe_route`` :297,
``moe_expert_load`` :407, the ``"moe"`` key of ``summary()`` :513, None
on MoE-free engines). Histograms keep a bounded sample of their values (the first
``reservoir``), so memory stays bounded in a long-lived engine. The
JAX package's metrics registry and exporters wait for the
observability slice.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

#: samples a histogram keeps
DEFAULT_RESERVOIR = 2048


class _Histogram:
    def __init__(self, reservoir: int):
        self._cap = int(reservoir)
        self.values: List[float] = []
        self.count = 0
        self.total = 0.0
        self.max = None

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.total += x
        self.max = x if self.max is None else max(self.max, x)
        if len(self.values) < self._cap:
            self.values.append(x)

    def pcts(self) -> Optional[Dict[str, float]]:
        if not self.values:
            return None
        return {"p50": float(np.percentile(self.values, 50)),
                "p99": float(np.percentile(self.values, 99))}

    def mean_max(self) -> Optional[Dict[str, float]]:
        if not self.count:
            return None
        return {"mean": self.total / self.count, "max": self.max}


class ServingMetrics:
    """Host-side counters (a few list appends and clock reads per
    iteration). ``clock`` is injectable for deterministic tests."""

    def __init__(self, clock=time.perf_counter,
                 reservoir: int = DEFAULT_RESERVOIR):
        self.clock = clock
        self.submit_ts: Dict[int, float] = {}     # in flight only
        self.first_ts: Dict[int, float] = {}      # in flight only
        self._ttft = _Histogram(reservoir)
        self._tpot = _Histogram(reservoir)
        self._latency = _Histogram(reservoir)
        self._qdepth = _Histogram(reservoir)
        self._occ = _Histogram(reservoir)
        self.requests_finished = 0
        self.requests_rejected = 0
        self.requests_timed_out = 0
        self.requests_cancelled = 0
        self.requests_preempted = 0
        self.tokens_generated = 0
        self.prefill_chunks = 0
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self._prefix_lookup_toks = 0
        self._pages: Optional[Dict] = None
        #: the host offload tier: pages swapped out (preemption, prefix
        #: spill) and restored, bytes moved out, and the resume latencies
        #: and context tokens of the two resume paths
        self.pages_offloaded = 0
        self.pages_restored = 0
        self.offload_bytes = 0
        self.reprefill_tokens = 0
        self.reprefill_tokens_avoided = 0
        self._resume_swap = _Histogram(reservoir)
        self._resume_reprefill = _Histogram(reservoir)
        #: decoding-slot count -> [tokens, seconds]
        self._decode_agg: Dict[int, List[float]] = {}
        self.phase_seconds: Dict[str, float] = {}
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_disabled_streams = 0
        self.spec_reenabled_streams = 0
        #: tree verifies: accepted path lengths and tree depths offered
        self.spec_path_accepted = 0
        self.spec_path_offered = 0
        self._spec_rate = _Histogram(reservoir)
        self._spec_tree_width = _Histogram(reservoir)
        self._spec_path_len = _Histogram(reservoir)
        #: the last read MoE step's per-expert load, mean router entropy
        #: and the engine's concentration estimate (None until one)
        self._moe_load: Optional[List[float]] = None
        self.moe_router_entropy: Optional[float] = None
        self.moe_concentration: Optional[float] = None
        self._t_first_submit: Optional[float] = None
        self._t_last_finish: Optional[float] = None

    # --- per request ------------------------------------------------------

    def record_submit(self, rid: int) -> None:
        now = self.clock()
        self.submit_ts[rid] = now
        if self._t_first_submit is None:
            self._t_first_submit = now

    def record_first_token(self, rid: int) -> None:
        now = self.clock()
        t0 = self.submit_ts.get(rid)
        if t0 is not None:
            self._ttft.observe(now - t0)
            self.first_ts[rid] = now

    def record_finish(self, rid: int, n_generated: int) -> None:
        now = self.clock()
        t0 = self.submit_ts.pop(rid, None)
        if t0 is not None:
            self._latency.observe(now - t0)
        t_first = self.first_ts.pop(rid, None)
        if t_first is not None and n_generated > 1:
            self._tpot.observe((now - t_first) / (n_generated - 1))
        self.requests_finished += 1
        self.tokens_generated += int(n_generated)
        self._t_last_finish = now

    def record_rejected(self) -> None:
        self.requests_rejected += 1

    def record_timeout(self, rid: int) -> None:
        """A request's deadline expired before it finished (JAX :200)."""
        self.submit_ts.pop(rid, None)
        self.first_ts.pop(rid, None)
        self.requests_timed_out += 1

    def record_cancelled(self, rid: int) -> None:
        """A request cancelled by API (JAX :206)."""
        self.submit_ts.pop(rid, None)
        self.first_ts.pop(rid, None)
        self.requests_cancelled += 1

    def record_preemption(self, rid: int) -> None:
        """Not terminal: TTFT already fired, latency runs to the finish."""
        self.requests_preempted += 1

    def record_prefix_lookup(self, hit_tokens: int,
                             total_tokens: int) -> None:
        self.prefix_lookups += 1
        self._prefix_lookup_toks += int(total_tokens)
        if hit_tokens > 0:
            self.prefix_hits += 1
            self.prefix_hit_tokens += int(hit_tokens)

    def record_pages(self, free: int, shared: int,
                     fragmentation: float) -> None:
        self._pages = {"free": int(free), "shared": int(shared),
                       "fragmentation": float(fragmentation)}

    def record_offload(self, offloaded: int, restored: int,
                       nbytes: int) -> None:
        """Host-tier traffic since the engine's last flush (deltas of
        the pool's odometers)."""
        self.pages_offloaded += int(offloaded)
        self.pages_restored += int(restored)
        self.offload_bytes += int(nbytes)

    def record_swap_resume(self, dur_s: float,
                           tokens_avoided: int) -> None:
        """A preemption resume served by a host-page swap-in:
        ``tokens_avoided`` the context tokens a re-prefill would have
        recomputed."""
        self._resume_swap.observe(float(dur_s))
        self.reprefill_tokens_avoided += int(tokens_avoided)

    def record_reprefill_resume(self, dur_s: float, tokens: int) -> None:
        """A preemption resume served by re-prefilling ``tokens`` context
        tokens (first chunk to rejoining the batch)."""
        self._resume_reprefill.observe(float(dur_s))
        self.reprefill_tokens += int(tokens)

    # --- per iteration ----------------------------------------------------

    def record_prefill_chunk(self) -> None:
        self.prefill_chunks += 1

    def record_iteration(self, queue_depth: int, occupied: int,
                         num_slots: int) -> None:
        self._qdepth.observe(int(queue_depth))
        self._occ.observe(occupied / num_slots)

    def record_decode(self, n_decoding: int, dt: float,
                      n_tokens: Optional[int] = None) -> None:
        n = int(n_decoding)
        agg = self._decode_agg.setdefault(n, [0.0, 0.0])
        agg[0] += n if n_tokens is None else int(n_tokens)
        agg[1] += float(dt)

    def record_spec_verify(self, proposed: int, accepted: int) -> None:
        """One slot's outcome in one verify: ``proposed`` drafts offered,
        ``accepted`` of them matched the target's own choices."""
        proposed, accepted = int(proposed), int(accepted)
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        if proposed > 0:
            self._spec_rate.observe(accepted / proposed)

    def record_spec_disabled(self) -> None:
        """The acceptance EMA kicked one stream back to plain decode."""
        self.spec_disabled_streams += 1

    def record_spec_reenabled(self) -> None:
        """A demoted stream's re-probe won speculation back."""
        self.spec_reenabled_streams += 1

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
        smoothed concentration (0 = uniform, 1 = one expert)."""
        self._moe_load = [float(v) for v in np.asarray(expert_load,
                                                       np.float64)]
        self.moe_router_entropy = float(entropy)
        self.moe_concentration = float(concentration)

    def record_phase(self, name: str, seconds: float) -> None:
        self.phase_seconds[name] = self.phase_seconds.get(name, 0.0) \
            + float(seconds)

    # --- reductions -------------------------------------------------------

    @property
    def prefix_hit_rate(self) -> Optional[float]:
        if self._prefix_lookup_toks <= 0:
            return None
        return self.prefix_hit_tokens / self._prefix_lookup_toks

    @property
    def acceptance_rate(self) -> Optional[float]:
        """Fraction of proposed drafts the target accepted (None before
        any verify)."""
        if self.spec_proposed <= 0:
            return None
        return self.spec_accepted / self.spec_proposed

    @property
    def moe_expert_load(self) -> Optional[List[float]]:
        """The last read MoE step's per-expert load (None on MoE-free
        engines and before the first MoE decode step)."""
        return None if self._moe_load is None else list(self._moe_load)

    def decode_tokens_per_sec(self,
                              min_occupancy: int = 0) -> Optional[float]:
        """Decode throughput over iterations with at least
        ``min_occupancy`` decoding slots."""
        toks = sum(a[0] for n, a in self._decode_agg.items()
                   if n >= min_occupancy)
        secs = sum(a[1] for n, a in self._decode_agg.items()
                   if n >= min_occupancy)
        return toks / secs if secs > 0 else None

    def summary(self) -> Dict:
        elapsed = (self._t_last_finish - self._t_first_submit
                   if self._t_first_submit is not None
                   and self._t_last_finish is not None else 0.0)
        tokens = self.tokens_generated
        return {
            "requests_finished": self.requests_finished,
            "requests_rejected": self.requests_rejected,
            "requests_timed_out": self.requests_timed_out,
            "requests_cancelled": self.requests_cancelled,
            "requests_preempted": self.requests_preempted,
            "pages": self._pages,
            "offload": {
                "pages_offloaded": self.pages_offloaded,
                "pages_restored": self.pages_restored,
                "offload_bytes": self.offload_bytes,
                "reprefill_tokens": self.reprefill_tokens,
                "reprefill_tokens_avoided": self.reprefill_tokens_avoided,
                "resume_swap_s": self._resume_swap.pcts(),
                "resume_reprefill_s": self._resume_reprefill.pcts()},
            "prefix_cache": {"lookups": self.prefix_lookups,
                             "hits": self.prefix_hits,
                             "hit_rate": self.prefix_hit_rate},
            "tokens_generated": tokens,
            "tokens_per_sec": tokens / elapsed if elapsed > 0 else None,
            "decode_tokens_per_sec": self.decode_tokens_per_sec(),
            "ttft_s": self._ttft.pcts(),
            "tpot_s": self._tpot.pcts(),
            "latency_s": self._latency.pcts(),
            "queue_depth": self._qdepth.mean_max(),
            "slot_occupancy": self._occ.mean_max(),
            "prefill_chunks": self.prefill_chunks,
            "phases": dict(self.phase_seconds),
            "moe": (None if self._moe_load is None else {
                "expert_load": self.moe_expert_load,
                "router_entropy": self.moe_router_entropy,
                "concentration": self.moe_concentration}),
            "acceptance_rate": self.acceptance_rate,
            "speculation": {
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
                "disabled_streams": self.spec_disabled_streams,
                "reenabled_streams": self.spec_reenabled_streams,
                "accept_rate": self._spec_rate.pcts(),
                "tree_width": self._spec_tree_width.pcts(),
                "accepted_path_len": self._spec_path_len.pcts(),
                # the longest-chain basis of the acceptance EMA: accepted
                # path length over tree depth (a tree's acceptance_rate
                # counts every node offered); None before a tree verify
                "path_acceptance_rate": (
                    self.spec_path_accepted / self.spec_path_offered
                    if self.spec_path_offered else None)},
        }
