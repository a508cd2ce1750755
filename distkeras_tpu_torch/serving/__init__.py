"""Serving of the port: the paged continuous-batching engine, its KV
pool and prefix cache, the scheduler and the metrics."""

from distkeras_tpu_torch.serving.engine import ServingEngine
from distkeras_tpu_torch.serving.kv_pool import PagedKVPool, PrefixCache
from distkeras_tpu_torch.serving.metrics import ServingMetrics
from distkeras_tpu_torch.serving.scheduler import (AdmissionRejected,
                                                   PriorityScheduler,
                                                   Request, RequestState)

__all__ = ["AdmissionRejected", "PagedKVPool", "PrefixCache",
           "PriorityScheduler", "Request", "RequestState", "ServingEngine",
           "ServingMetrics"]
