"""Background prefetching: host data assembly overlapped with the
device's compute (mirrors ``distkeras_tpu/utils/prefetch.py``).

``Prefetcher(fn, items, depth)`` computes ``fn(item)`` on a producer
thread, ``depth`` results ahead of the consumer; ``place`` (optional)
moves each result to the device on that thread, once a queue slot is
free, so at most ``depth`` queued chunks plus the one the consumer holds
sit in device memory. ``device_stager(device)`` is that ``place`` for
the trainers' ``(Xs, Ys, n_steps)`` chunks: pinned, non-blocking copies
to the card (as ``serving.kv_pool.stage`` sends host arrays), the
identity on the CPU. The telemetry gauges and the chaos point of JAX's
producer belong to ``obs/`` and ``resilience/`` (ROADMAP Queue 1 item
11) and are not ported.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, Tuple, TypeVar

import numpy as np
import torch

T = TypeVar("T")
U = TypeVar("U")

_SENTINEL = object()


class Prefetcher:
    """Iterate ``(item, fn(item))`` over ``items`` with ``depth`` results
    computed ahead on a background thread. The iterable is consumed
    lazily, on the producer thread. An exception in ``fn``, in ``place``
    or in the source re-raises, with its own type, at the consuming
    ``next()``.

    The producer thread ends on every exit path: exhaustion, a consumer
    ``break`` or exception (``GeneratorExit`` in the iterator),
    ``close()`` or the context manager's exit. Its puts time out and
    re-check the stop flag, so ``close()`` cannot deadlock; results
    queued before a ``close()`` stay consumable."""

    def __init__(self, fn: Callable[[T], U], items: Iterable[T],
                 depth: int = 1, name: str = "prefetch",
                 place: Optional[Callable[[U], U]] = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._fn = fn
        self._place = place
        self._items = items
        self._name = name
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stopped = threading.Event()
        #: seconds the consumer waited for its items, summed
        self.wait_s = 0.0
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name=name)
        self._thread.start()

    def _put(self, out) -> bool:
        """Put with stop-flag polling; False means shutdown requested."""
        while not self._stopped.is_set():
            try:
                self._q.put(out, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _await_queue_space(self) -> bool:
        """Poll until the queue has a free slot (or shutdown). This
        thread is the only producer, so a slot seen free stays free until
        its own put."""
        while not self._stopped.is_set():
            if not self._q.full():
                return True
            self._stopped.wait(0.05)
        return False

    def _produce(self):
        it = iter(self._items)
        while True:
            try:
                item = next(it)
            except StopIteration:
                break
            except Exception as e:   # a lazy source failing mid-stream
                self._put((None, None, e))
                return
            if self._stopped.is_set():
                return
            try:
                value = self._fn(item)
                if self._place is not None:
                    # stage only once a slot is free: a producer blocked
                    # on a full queue holds a host chunk, not an extra
                    # device-resident one
                    if not self._await_queue_space():
                        return
                    value = self._place(value)
                out = (item, value, None)
            except Exception as e:  # re-raised consumer-side
                self._put((item, None, e))
                return
            if not self._put(out):
                return
        self._put(_SENTINEL)

    def __iter__(self) -> Iterator[Tuple[T, U]]:
        from distkeras_tpu_torch.utils.profiling import now
        try:
            t_wait = now()
            while True:
                try:
                    # a polling get: close() mid-iteration must not leave
                    # the consumer blocked on a queue nothing fills
                    got = self._q.get(timeout=0.05)
                except queue.Empty:
                    # once the thread is dead and the queue empty,
                    # nothing can arrive any more
                    if not self._thread.is_alive() and self._q.empty():
                        if self._stopped.is_set():
                            return   # closed mid-stream and drained
                        raise RuntimeError(
                            f"prefetch producer thread ({self._name!r}) "
                            "died without delivering a result or the "
                            "end-of-stream sentinel; the data stream is "
                            "broken")
                    continue
                if got is _SENTINEL:
                    return
                self.wait_s += now() - t_wait
                item, value, err = got
                if err is not None:
                    raise err
                yield item, value
                t_wait = now()
        finally:
            self.close()

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self):
        """Stop the producer and reap its thread; idempotent, and never
        blocks indefinitely."""
        self._stopped.set()
        self._thread.join(timeout=5.0)


def to_device(a, device) -> torch.Tensor:
    """A host array (or tensor) on ``device``: on the card through a
    pinned buffer and a non-blocking copy on the current stream (the
    pinned block is reused only after that copy completes); on the CPU
    the array's own memory, without a copy."""
    t = a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    if device.type != "cuda" or t.is_cuda:
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def device_stager(device=None) -> Callable:
    """A ``place=`` callable for the trainers' ``(Xs, Ys, n_steps)``
    epoch chunks: both stacked arrays go to ``device`` (default: the
    CUDA card) through ``to_device`` on the loader thread. On the CPU a
    chunk passes through unchanged."""
    from distkeras_tpu_torch.compat import resolve_device
    device = resolve_device(device)

    def place(chunk):
        if device.type != "cuda":
            return chunk
        Xs, Ys, n_steps = chunk
        return to_device(Xs, device), to_device(Ys, device), n_steps

    return place
