"""Retry policies: exponential backoff with full jitter, deadline caps,
and retryable-exception classification (mirrors
``distkeras_tpu/resilience/retry.py``).

Applied where the repo touches the unreliable world — checkpoint IO
(``utils/checkpoint.py``) and out-of-core shard fetches
(``Trainer._sharded_stream``) — so a flaky filesystem costs a delay, not
a training run. Policy mechanics follow the AWS full-jitter scheme:
``delay = uniform(0, min(max_delay, base * 2**attempt))``, which avoids
the synchronized-retry stampedes plain exponential backoff produces.

Classification is deliberately narrow by default
(``classify_retryable``): OS/IO errors and timeouts retry;
``faults.InjectedFault`` retries only when armed ``transient=True``;
everything else (assertion, value, CUDA errors — bugs, not weather)
surfaces immediately. Every retry records on the obs registry
(``retry.attempts`` counter + ``retry.delay_s`` histogram, labeled by
``op``) so healed faults stay visible.
"""

from __future__ import annotations

import functools
import random
import time
from typing import Callable, Optional, Tuple, Type, Union

from distkeras_tpu_torch.resilience.faults import InjectedFault


def _now() -> float:
    # deferred: utils.profiling (the repo's clock owner) sits behind
    # utils/__init__, which imports checkpoint, which imports THIS
    # module — a top-level import would be circular
    from distkeras_tpu_torch.utils.profiling import now
    return now()

__all__ = ["RetryPolicy", "classify_retryable", "io_retry", "no_retry"]


def classify_retryable(err: BaseException) -> bool:
    """Default classification: transient-world errors only."""
    if isinstance(err, InjectedFault):
        return err.transient
    return isinstance(err, (OSError, TimeoutError))


class RetryPolicy:
    """Bounded retries with full-jitter exponential backoff.

    ``max_attempts`` counts total tries (1 = no retry). ``deadline_s``
    caps the whole call including backoff sleeps: a retry whose delay
    would cross the deadline re-raises instead of sleeping. ``sleep``
    and ``seed`` are injectable so tests run deterministic and instant.
    ``retryable`` is either a predicate or an exception-type tuple.
    """

    def __init__(self, max_attempts: int = 3, base_delay_s: float = 0.05,
                 max_delay_s: float = 2.0,
                 deadline_s: Optional[float] = None,
                 retryable: Union[Callable[[BaseException], bool],
                                  Tuple[Type[BaseException], ...],
                                  None] = None,
                 seed: Optional[int] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 op: str = "retry"):
        if max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {max_attempts}")
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.deadline_s = deadline_s
        if retryable is None:
            self._retryable = classify_retryable
        elif callable(retryable) and not isinstance(retryable, tuple):
            self._retryable = retryable
        else:
            types = tuple(retryable)
            self._retryable = lambda e: isinstance(e, types)
        self._rng = random.Random(seed)
        self._sleep = sleep
        self.op = op

    def _delay(self, attempt: int) -> float:
        """Full jitter: uniform over (0, capped exponential]."""
        cap = min(self.max_delay_s,
                  self.base_delay_s * (2.0 ** (attempt - 1)))
        return self._rng.uniform(0.0, cap)

    def call(self, fn: Callable, *args, op: Optional[str] = None, **kw):
        """Run ``fn(*args, **kw)``, retrying retryable failures. The
        final failure re-raises the original exception."""
        op = op if op is not None else self.op
        t0 = _now()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kw)
            except Exception as err:
                if attempt >= self.max_attempts or not self._retryable(err):
                    raise
                delay = self._delay(attempt)
                if self.deadline_s is not None \
                        and (_now() - t0) + delay > self.deadline_s:
                    raise
                self._note(op, delay)
                self._sleep(delay)

    def wrap(self, fn: Callable, op: Optional[str] = None) -> Callable:
        """Decorator form: ``fetch = policy.wrap(fetch, op="data.fetch")``."""
        op = op if op is not None else getattr(fn, "__name__", self.op)

        @functools.wraps(fn)
        def wrapped(*args, **kw):
            return self.call(fn, *args, op=op, **kw)

        return wrapped

    @staticmethod
    def _note(op: str, delay: float) -> None:
        # lazy: keep retry importable before the telemetry layer
        from distkeras_tpu_torch import obs
        reg = obs.get_registry()
        reg.counter("retry.attempts").inc(op=op)
        reg.histogram("retry.delay_s").observe(delay, op=op)


def io_retry(**overrides) -> RetryPolicy:
    """The default policy for local checkpoint/data IO: 3 attempts,
    tens-of-ms jittered backoff — heals a transient EIO/ENOSPC blip
    without masking a persistently broken disk for more than ~0.5 s."""
    kw = dict(max_attempts=3, base_delay_s=0.02, max_delay_s=0.25)
    kw.update(overrides)
    return RetryPolicy(**kw)


def no_retry() -> RetryPolicy:
    """A pass-through policy (``max_attempts=1``) for callers that must
    observe every failure raw."""
    return RetryPolicy(max_attempts=1)
