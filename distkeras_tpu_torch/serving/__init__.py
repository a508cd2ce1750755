"""Serving of the port: the continuous-batching engine, its KV pools
(paged, with a host tier, or slab) and prefix cache, the schedulers,
the metrics, the draft sources of speculative decoding, the router tier
(``serving.router``: replicas, placement, handoff, failover, drain and
autoscaling) and the load generator (``serving.loadgen``: seeded traces
replayed on an iteration clock)."""

from distkeras_tpu_torch.serving.engine import (DegradedRequest,
                                                ServingEngine)
from distkeras_tpu_torch.serving.kv_pool import (KVPool, PagedKVPool,
                                                 PrefixCache)
from distkeras_tpu_torch.serving.loadgen import (ChaosSpec, IterationClock,
                                                 PhaseResult, PhaseSpec,
                                                 ReplayResult, TenantSpec,
                                                 Trace, TraceRequest,
                                                 WorkloadSpec,
                                                 diurnal_burst_scenario,
                                                 flash_crowd_chaos_scenario,
                                                 replay, synthesize)
from distkeras_tpu_torch.serving.metrics import ServingMetrics
from distkeras_tpu_torch.serving.router import (AutoscaleController,
                                                ControllerChain,
                                                EngineReplica, LeastLoaded,
                                                PlacementPolicy,
                                                PrefixAffinity, ReplicaDead,
                                                ReplicaState,
                                                ReplicaUnavailable, Router,
                                                RouterClient,
                                                SLOBurnController)
from distkeras_tpu_torch.serving.scheduler import (AdmissionRejected,
                                                   FIFOScheduler,
                                                   PriorityScheduler,
                                                   Request, RequestState,
                                                   TERMINAL_STATES)
from distkeras_tpu_torch.serving.speculation import (DraftModel,
                                                     DraftSource,
                                                     NgramDraft,
                                                     build_token_tree,
                                                     tree_ancestors)

__all__ = ["AdmissionRejected", "AutoscaleController", "ChaosSpec",
           "ControllerChain", "DegradedRequest", "DraftModel",
           "DraftSource", "EngineReplica", "FIFOScheduler",
           "IterationClock", "KVPool", "LeastLoaded", "NgramDraft",
           "PagedKVPool", "PhaseResult", "PhaseSpec", "PlacementPolicy",
           "PrefixAffinity", "PrefixCache", "PriorityScheduler",
           "ReplayResult", "ReplicaDead", "ReplicaState",
           "ReplicaUnavailable", "Request", "RequestState", "Router",
           "RouterClient", "SLOBurnController", "ServingEngine",
           "ServingMetrics", "TERMINAL_STATES", "TenantSpec", "Trace",
           "TraceRequest", "WorkloadSpec", "build_token_tree",
           "diurnal_burst_scenario", "flash_crowd_chaos_scenario",
           "replay", "synthesize", "tree_ancestors"]
