"""Serving of the port: the paged continuous-batching engine, its KV
pool and prefix cache, the scheduler, the metrics and the draft sources
of speculative decoding."""

from distkeras_tpu_torch.serving.engine import ServingEngine
from distkeras_tpu_torch.serving.kv_pool import PagedKVPool, PrefixCache
from distkeras_tpu_torch.serving.metrics import ServingMetrics
from distkeras_tpu_torch.serving.scheduler import (AdmissionRejected,
                                                   PriorityScheduler,
                                                   Request, RequestState)
from distkeras_tpu_torch.serving.speculation import (DraftModel,
                                                     DraftSource,
                                                     NgramDraft,
                                                     build_token_tree,
                                                     tree_ancestors)

__all__ = ["AdmissionRejected", "DraftModel", "DraftSource", "NgramDraft",
           "PagedKVPool", "PrefixCache", "PriorityScheduler", "Request",
           "RequestState", "ServingEngine", "ServingMetrics",
           "build_token_tree", "tree_ancestors"]
