"""Parameter servers: a host-side center with pull/commit.

Mirrors ``distkeras_tpu/parallel/parameter_servers.py``:
``ParameterServer`` (:49; the center, ``num_updates`` and a mutex),
``DeltaParameterServer`` (:111), ``ADAGParameterServer`` (:123),
``DynSGDParameterServer`` (:145), ``EASGDParameterServer`` (:160) and
``PSClient`` (:168). The update rules are the JAX package's host-side
numpy on flat leaf lists, line for line, so one commit sequence gives
the same center bit for bit. The leaves are in the port's tree order
(``utils.tree``: dict entries in insertion order), where JAX's
``tree_flatten`` sorts dict keys; ``get_model`` returns the tree.

The stacked-worker engine (``engine``) needs no server: its center
lives on the device. This path is the reference's own concurrency
model, worker threads racing through a mutex (``async_host``), over
direct calls or the framed socket protocol of ``networking``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distkeras_tpu_torch.parallel import networking
from distkeras_tpu_torch.utils.tree import (tree_leaves, tree_map,
                                            tree_unflatten)


def to_numpy(x) -> np.ndarray:
    """A writable host copy of a tensor or array leaf."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


class ParameterServer:
    """Center leaves + update counter + mutex. Subclasses implement
    ``handle_commit(payload)``; ``handle_pull`` is shared."""

    def __init__(self, center):
        self._leaves: List[np.ndarray] = [to_numpy(l)
                                          for l in tree_leaves(center)]
        # the tree's structure alone (no reference to the live tensors)
        self._skeleton = tree_map(lambda _: None, center)
        self._lock = threading.Lock()
        self.num_updates = 0
        self._server: Optional[networking.MessageServer] = None

    # -- lifecycle -----------------------------------------------------------
    def initialize(self) -> None:  # parity no-op; state built in __init__
        pass

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Serve this PS over TCP; returns the bound port. Without
        ``start`` the PS is in-process only."""
        self._server = networking.MessageServer(self._dispatch, host, port)
        self._server.start()
        return self._server.port

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop()
            self._server = None

    def get_model(self):
        """The center as the parameter tree, numpy leaves (copies)."""
        with self._lock:
            leaves = [l.copy() for l in self._leaves]
        return tree_unflatten(self._skeleton, leaves)

    # -- protocol ------------------------------------------------------------
    def handle_pull(self) -> Tuple[List[np.ndarray], int]:
        with self._lock:
            return [l.copy() for l in self._leaves], self.num_updates

    def handle_commit(self, payload: Dict[str, Any]) -> None:
        raise NotImplementedError

    def _dispatch(self, msg: Dict[str, Any]):
        action = msg.get("action")
        if action == "pull":
            leaves, clock = self.handle_pull()
            return {"center": leaves, "clock": clock}
        if action == "commit":
            self.handle_commit(msg)
            return {"ok": True}
        if action == "clock":
            with self._lock:
                return {"clock": self.num_updates}
        return {"error": f"unknown action {action!r}"}


class DeltaParameterServer(ParameterServer):
    """``center += delta`` (DOWNPOUR)."""

    def handle_commit(self, payload):
        delta = payload["delta"]
        with self._lock:
            for c, d in zip(self._leaves, delta):
                c += d
            self.num_updates += 1


class ADAGParameterServer(ParameterServer):
    """Adaptive per-parameter accumulation of committed deltas: the
    engine's ``AdagAlgo`` rule."""

    def __init__(self, center, learning_rate: float = 0.05,
                 epsilon: float = 1e-8):
        super().__init__(center)
        self.learning_rate = float(learning_rate)
        self.epsilon = float(epsilon)
        self._acc = [np.zeros_like(l) for l in self._leaves]

    def handle_commit(self, payload):
        delta = payload["delta"]
        with self._lock:
            for c, a, d in zip(self._leaves, self._acc, delta):
                a += np.square(d)
                c += self.learning_rate * d / (np.sqrt(a) + self.epsilon)
            self.num_updates += 1


class DynSGDParameterServer(ParameterServer):
    """Staleness-scaled commits: a commit carries the worker's last-pull
    clock and its delta is scaled by 1/staleness."""

    def handle_commit(self, payload):
        delta, last_pull = payload["delta"], payload["clock"]
        with self._lock:
            staleness = max(1, self.num_updates - int(last_pull) + 1)
            inv = 1.0 / staleness
            for c, d in zip(self._leaves, delta):
                c += d * inv
            self.num_updates += 1


class EASGDParameterServer(DeltaParameterServer):
    """EASGD center: the commit IS the elastic term ``alpha * (x_i -
    center)`` the worker computed against its last pull, so the rule is
    the plain add; its own class for parity with the reference."""


class PSClient:
    """Worker-side handle: pull/commit against an in-process PS or a
    socket PS. Payloads are flat numpy leaf lists."""

    def __init__(self, ps: Optional[ParameterServer] = None,
                 host: Optional[str] = None, port: Optional[int] = None):
        if (ps is None) == (host is None):
            raise ValueError("pass exactly one of ps= or host=/port=")
        self._ps = ps
        self._sock = networking.connect(host, port) if host else None
        self._lock = threading.Lock()  # one request in flight per client

    @staticmethod
    def _checked(reply):
        if isinstance(reply, dict) and "error" in reply:
            raise RuntimeError(f"parameter server error: {reply['error']}")
        return reply

    def pull(self) -> Tuple[List[np.ndarray], int]:
        if self._ps is not None:
            return self._ps.handle_pull()
        with self._lock:
            reply = self._checked(
                networking.request(self._sock, {"action": "pull"}))
        return reply["center"], reply["clock"]

    def commit(self, delta: Sequence[np.ndarray],
               clock: Optional[int] = None) -> None:
        msg: Dict[str, Any] = {"action": "commit", "delta": list(delta)}
        if clock is not None:
            msg["clock"] = int(clock)
        if self._ps is not None:
            self._ps.handle_commit(msg)
            return
        with self._lock:
            self._checked(networking.request(self._sock, msg))

    def close(self):
        if self._sock is not None:
            self._sock.close()
            self._sock = None
