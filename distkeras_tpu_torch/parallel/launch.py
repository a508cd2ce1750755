"""A world of processes on this machine, kept up across calls.

``World(n)`` starts ``n`` processes (``spawn``), each a rank of one gloo
``torch.distributed`` world, and keeps them waiting for work: ``world.run(fn, *args)`` calls
``fn(*args)`` on every rank at once and returns the ranks' results in
rank order. The mesh of ``parallel.mesh`` is then made over those ranks
inside ``fn``. Ranks on one machine share its card (the collectives
stage CUDA tensors through pinned host memory on gloo); each rank has
its own CUDA context.

Starting processes costs seconds (each imports torch and the caller's
module), so tests start one world per module and submit each test's
function to it. ``fn`` and its arguments cross by pickling: a function
at the top level of an importable module (or of the ``__main__``
script), numpy arrays and plain values; return numpy arrays or plain
values, not tensors. A rank that raises fails the call with its
traceback; the other ranks, which may then wait in a collective, fail
on the group's timeout, and the world shuts down (``broken``).
``deploy.Job`` is the launcher for scripts and for machines of a
cluster.

The world's rendezvous store is a ``TCPStore`` that the parent holds
for the world's life: it listens on a port the system gives it (port
0), and the ranks connect to that port, so no other process can take
the port between its choice and its use.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import traceback
from datetime import timedelta
from typing import Any, List

from distkeras_tpu_torch.utils.profiling import now


HOST = "127.0.0.1"


def hosted_store(timeout: float):
    """A rendezvous ``TCPStore`` listening on a free port of this machine
    (``.port``), held by the caller while its ranks use it."""
    import torch.distributed as dist
    return dist.TCPStore(HOST, 0, None, True,
                         timeout=timedelta(seconds=timeout),
                         wait_for_workers=False)


def join_store(host: str, port: int, rank: int, size: int,
               timeout: float) -> None:
    """Bring this process into a gloo world as ``rank`` of ``size``
    through the store another process hosts at ``host:port``."""
    import torch.distributed as dist
    store = dist.TCPStore(host, int(port), size, False,
                          timeout=timedelta(seconds=timeout))
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=size,
                            timeout=timedelta(seconds=timeout))


def _rank_main(rank, size, port, threads, timeout, tasks, results):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(threads)
    try:
        join_store(HOST, port, rank, size, timeout)
        results.put((rank, True, "ready"))
    except Exception:  # reported to the parent
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args, kwargs = task
            try:
                results.put((rank, True, fn(*args, **kwargs)))
            except BaseException:  # lint: allow-swallow (the traceback goes to the parent, which raises)
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    """``size`` ranks of a gloo world, each on ``threads`` torch
    threads. ``timeout`` (seconds) bounds a collective that waits on a
    failed rank, and a call's wait for results."""

    def __init__(self, size: int, *, threads: int = 1,
                 timeout: float = 120.0):
        self.size, self.timeout = int(size), float(timeout)
        self.broken = False
        ctx = mp.get_context("spawn")
        self._tasks = [ctx.Queue() for _ in range(self.size)]
        self._results = ctx.Queue()
        self._store = hosted_store(self.timeout)
        port = self._store.port
        saved = dict(os.environ)
        os.environ["OMP_NUM_THREADS"] = str(threads)
        try:
            self._procs = [ctx.Process(
                target=_rank_main, daemon=True,
                args=(r, self.size, port, threads, self.timeout,
                      self._tasks[r], self._results))
                for r in range(self.size)]
            for p in self._procs:
                p.start()
        finally:
            os.environ.clear()
            os.environ.update(saved)
        self._collect("start")

    def _collect(self, what: str) -> List[Any]:
        out, errors = [None] * self.size, {}
        deadline = now() + self.timeout + 60.0
        got = 0
        while got < self.size:
            try:
                rank, ok, value = self._results.get(
                    timeout=max(1.0, deadline - now()))
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive()]
                self.close()
                raise RuntimeError(
                    f"world of {self.size}: no result from "
                    f"{self.size - got} rank(s) for {what} within "
                    f"{self.timeout + 60.0:.0f} s (exited: {dead}); "
                    f"errors so far: {errors}") from None
            got += 1
            if ok:
                out[rank] = value
            else:
                errors[rank] = value
        if errors:
            self.close()
            first = min(errors)
            raise RuntimeError(f"world of {self.size}: {what} failed on "
                               f"rank(s) {sorted(errors)}; rank {first}:\n"
                               f"{errors[first]}")
        return out

    def run(self, fn, *args, **kwargs) -> List[Any]:
        """``fn(*args, **kwargs)`` on every rank; the results by rank."""
        if self.broken:
            raise RuntimeError("this world was shut down")
        for q in self._tasks:
            q.put((fn, args, kwargs))
        return self._collect(getattr(fn, "__name__", repr(fn)))

    def close(self) -> None:
        """Stop every rank (a rank that does not exit is killed)."""
        if self.broken:
            return
        self.broken = True
        for q in self._tasks:
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        for q in self._tasks + [self._results]:
            q.close()
            q.cancel_join_thread()
        self._store = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
