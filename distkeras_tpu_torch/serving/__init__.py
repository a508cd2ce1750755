"""Serving of the port: the continuous-batching engine, its KV pools
(paged, with a host tier, or slab) and prefix cache, the schedulers,
the metrics and the draft sources of speculative decoding."""

from distkeras_tpu_torch.serving.engine import (DegradedRequest,
                                                ServingEngine)
from distkeras_tpu_torch.serving.kv_pool import (KVPool, PagedKVPool,
                                                 PrefixCache)
from distkeras_tpu_torch.serving.metrics import ServingMetrics
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

__all__ = ["AdmissionRejected", "DegradedRequest", "DraftModel",
           "DraftSource", "FIFOScheduler", "KVPool", "NgramDraft",
           "PagedKVPool", "PrefixCache", "PriorityScheduler", "Request",
           "RequestState", "ServingEngine", "ServingMetrics",
           "TERMINAL_STATES", "build_token_tree", "tree_ancestors"]
