"""Serving of the port: the paged continuous-batching engine, its KV
pool and prefix cache, the scheduler, the metrics and the draft sources
of speculative decoding."""

from distkeras_tpu_torch.serving.engine import (DegradedRequest,
                                                ServingEngine)
from distkeras_tpu_torch.serving.kv_pool import PagedKVPool, PrefixCache
from distkeras_tpu_torch.serving.metrics import ServingMetrics
from distkeras_tpu_torch.serving.scheduler import (AdmissionRejected,
                                                   PriorityScheduler,
                                                   Request, RequestState,
                                                   TERMINAL_STATES)
from distkeras_tpu_torch.serving.speculation import (DraftModel,
                                                     DraftSource,
                                                     NgramDraft,
                                                     build_token_tree,
                                                     tree_ancestors)

__all__ = ["AdmissionRejected", "DegradedRequest", "DraftModel",
           "DraftSource", "NgramDraft", "PagedKVPool", "PrefixCache",
           "PriorityScheduler", "Request", "RequestState", "ServingEngine",
           "ServingMetrics", "TERMINAL_STATES", "build_token_tree",
           "tree_ancestors"]
