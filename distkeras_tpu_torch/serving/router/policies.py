"""Placement policies: which replica a new request lands on (mirrors
``distkeras_tpu/serving/router/policies.py``).

A policy ranks the SERVING, role-eligible candidates; the router tries
them in order, so a replica that sheds (``AdmissionRejected``) passes
the request to the next. ``LeastLoaded`` reads the replicas' cheap host
accessors (queue depth, free pages, occupied slots). ``PrefixAffinity``
sends a prompt to the replica whose ``PrefixCache`` holds its leading
page (``affinity_key``/``probe``, side-effect free), hottest chain
first, so prefill skips the shared positions there and each template
sticks to the replica that first served it. Neither reads the device.
"""

from __future__ import annotations

from typing import List, Sequence

from distkeras_tpu_torch.serving.router.replica import EngineReplica

__all__ = ["LeastLoaded", "PlacementPolicy", "PrefixAffinity",
           "resolve_policy"]


class PlacementPolicy:
    """Rank candidate replicas for one placement, best first."""

    def rank(self, candidates: Sequence[EngineReplica],
             prompt) -> List[EngineReplica]:
        raise NotImplementedError


class LeastLoaded(PlacementPolicy):
    """Emptiest queue, then most free pages, then fewest occupied slots;
    the replica's name breaks ties, so placement is reproducible."""

    def rank(self, candidates, prompt):
        return sorted(
            candidates,
            key=lambda r: (r.queue_depth, -r.free_pages, r.occupied,
                           r.name))


class PrefixAffinity(PlacementPolicy):
    """Replicas whose prefix cache holds the prompt's leading page first
    (most hits first), the rest in the fallback's order. A replica whose
    queue is more than ``max_queue_advantage`` deeper than the shortest
    counts as cold even on a hit."""

    def __init__(self, fallback: PlacementPolicy = None,
                 max_queue_advantage: int = 4):
        self.fallback = fallback if fallback is not None else LeastLoaded()
        self.max_queue_advantage = int(max_queue_advantage)

    def rank(self, candidates, prompt):
        ordered = self.fallback.rank(candidates, prompt)
        if not ordered:
            return ordered
        min_depth = min(r.queue_depth for r in ordered)
        hot, cold = [], []
        for r in ordered:
            cache = r.engine.prefix
            hits = None
            if cache is not None:
                hits = cache.probe(cache.affinity_key(prompt))
            if hits is not None and (
                    r.queue_depth - min_depth <= self.max_queue_advantage):
                hot.append((hits, r))
            else:
                cold.append(r)
        hot.sort(key=lambda hr: -hr[0])      # stable: fallback breaks ties
        return [r for _, r in hot] + cold


def resolve_policy(policy) -> PlacementPolicy:
    """The router's ``policy=``: a ``PlacementPolicy`` as it is, or
    ``"least_loaded"`` / ``"prefix_affinity"``."""
    if isinstance(policy, PlacementPolicy):
        return policy
    if policy == "least_loaded":
        return LeastLoaded()
    if policy == "prefix_affinity":
        return PrefixAffinity()
    raise ValueError(
        f"unknown placement policy {policy!r}: pass 'least_loaded', "
        "'prefix_affinity' or a PlacementPolicy instance")
