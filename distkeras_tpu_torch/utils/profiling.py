"""Profiling hooks: a ``torch.profiler`` trace of a block, and step
timing (mirrors ``distkeras_tpu/utils/profiling.py``).

``trace(logdir)`` is the port's counterpart of JAX's
``jax.profiler`` session: it profiles the enclosed block (the host's
operators, and the card's kernels when CUDA is available) and writes
one Chrome trace file under ``logdir``. ``StepTimer`` and
``percentiles`` are JAX's; ``device_memory_stats`` reads the CUDA
caching allocator and returns None where there is no card.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Optional

import torch

#: the clock access points: ``now`` is the monotonic timer every
#: duration uses, ``wall`` the epoch-seconds clock for timestamps
now = time.perf_counter
wall = time.time


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block and write its Chrome trace to
    ``logdir/trace-<pid>-<ms>.json`` (viewable in Perfetto or
    ``chrome://tracing``). Yields the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace-{os.getpid()}-{int(wall() * 1e3)}.json"))


class StepTimer:
    """Accumulates wall-clock time per named phase. Thread-safe: the
    accumulate and every read hold a lock; ``reset()`` clears the
    phases, so a long-running caller can treat the timer as a reporting
    window."""

    def __init__(self):
        self._lock = threading.Lock()
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = now()
        try:
            yield
        finally:
            dt = now() - t0
            with self._lock:
                self.totals[name] = self.totals.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self.totals.clear()
            self.counts.clear()

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                name: {"total_s": self.totals[name],
                       "count": self.counts[name],
                       "mean_s": self.totals[name] / self.counts[name]}
                for name in self.totals
            }


def percentiles(values, ps=(50.0, 99.0)) -> Optional[Dict[str, float]]:
    """``{"p50": ..., "p99": ...}`` of a sample list by linear
    interpolation (numpy's default); None for an empty sample."""
    if not len(values):
        return None
    import numpy as np
    arr = np.asarray(list(values), np.float64)
    return {f"p{g:g}": float(np.percentile(arr, g)) for g in ps}


def device_memory_stats() -> Optional[List[Dict]]:
    """``[{"device", "bytes_in_use", "bytes_limit"}]`` for each CUDA
    card (the caching allocator's allocated bytes and the card's total
    memory), or None where there is no card."""
    if not torch.cuda.is_available():
        return None
    stats = []
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        stats.append({"device": f"cuda:{i}",
                      "bytes_in_use": s.get("allocated_bytes.all.current",
                                            0),
                      "bytes_limit": torch.cuda.get_device_properties(i)
                      .total_memory})
    return stats
