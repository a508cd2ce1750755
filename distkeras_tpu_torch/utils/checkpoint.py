"""Checkpoint and resume of training state (mirrors
``distkeras_tpu/utils/checkpoint.py``: ``CheckpointManager`` :123).

The format is the JAX package's, so checkpoints cross both ways: one
directory per step, ``step_<N>/manifest.json`` (the step, the sorted
keys, a crc32 per leaf and the caller's metadata) and
``step_<N>/arrays.npz`` (``{leaf_key: array}``, the key a leaf's path
through the tree as ``models.serialization.leaf_key`` spells it),
written to ``step_<N>.tmp`` and renamed into place, so a crash mid-write
never leaves a half-written step. The newest ``max_to_keep`` steps are
kept.

``save()`` snapshots the tree before it returns (``_snapshot_flat``):
on the card every leaf is copied into a pinned host buffer by a
non-blocking copy, and one CUDA event fences them all, so the caller may
update its tensors in place as soon as ``save()`` returns; a CPU leaf is
cloned. With ``async_writes=True`` the disk write runs on one background
thread, in order, with at most ``max_pending`` snapshots in flight; a
queued write's error re-raises at the next ``save()`` or ``wait()``.
``restore()`` returns host numpy arrays with the stored dtypes: placing
them is the restoring trainer's business. The JAX manager's chaos points
(``faults.point("ckpt.*")``) and its transient-IO retry belong to
``resilience/`` (ROADMAP Queue 1 item 11); ``ShardedCheckpointManager``
(per-process shards of a sharded model) waits for the multi-device item
10.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import warnings
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from distkeras_tpu_torch.models.serialization import _walk, leaf_key
from distkeras_tpu_torch.utils.tree import tree_unflatten

MANIFEST = "manifest.json"
ARRAYS = "arrays.npz"


def _np_dtype(leaf) -> Optional[np.dtype]:
    if torch.is_tensor(leaf):
        return torch.empty((), dtype=leaf.dtype).numpy().dtype
    dt = getattr(leaf, "dtype", None)
    return None if dt is None else np.dtype(dt)


def _jax_order(tree, path=()):
    """``(path, leaf)`` pairs in ``jax.tree_util`` order (dict keys
    sorted), so an ``arrays.npz`` lists its members as JAX's does."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_order(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _jax_order(v, path + (i,))
    elif tree is not None:
        yield path, tree


def _snapshot_flat(tree: Any) -> Dict[str, np.ndarray]:
    """``{leaf_key: host array}`` of a tree of tensors and numpy arrays,
    in memory the snapshot owns (JAX :55). Every CUDA leaf is first
    queued as a non-blocking copy into a pinned host buffer, then one
    event recorded after the last copy is waited on: no device tensor
    is read again once this returns. A CPU tensor is cloned; a numpy
    leaf is copied unless it owns its memory (host trees are the
    caller's, as in JAX)."""
    flat, pending = {}, False
    for path, leaf in _jax_order(tree):
        key = leaf_key(path)
        if torch.is_tensor(leaf):
            leaf = leaf.detach()
            if leaf.is_cuda:
                host = torch.empty(leaf.shape, dtype=leaf.dtype,
                                   pin_memory=True)
                host.copy_(leaf, non_blocking=True)
                pending = True
            else:
                host = leaf.clone()
            flat[key] = host
        else:
            arr = np.asarray(leaf)
            flat[key] = arr if arr.flags["OWNDATA"] else arr.copy()
    if pending:
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
    return {k: v.numpy() if torch.is_tensor(v) else v
            for k, v in flat.items()}


def _unflatten_like(template, flat: Dict[str, np.ndarray]):
    """A tree shaped like ``template`` of the stored host arrays (JAX
    :90): shapes are checked against the template's leaves; a stored
    dtype other than the template's is kept, with a warning (a changed
    precision policy between save and resume should be visible)."""
    leaves = []
    for path, leaf in _walk(template):
        key = leaf_key(path)
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"checkpoint leaf {key!r} shape {arr.shape} != expected "
                f"{tuple(leaf.shape)}")
        want = _np_dtype(leaf)
        if want is not None and want != arr.dtype:
            warnings.warn(
                f"checkpoint leaf {key!r} restores as stored dtype "
                f"{arr.dtype} but the template expects {want} (precision "
                "policy changed between save and resume?)", stacklevel=3)
        leaves.append(np.asarray(arr))
    return tree_unflatten(template, leaves)


class CheckpointManager:
    """Step-indexed atomic checkpoints of trees of tensors and arrays."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_writes: bool = False, max_pending: int = 2):
        self.directory = directory
        self.max_to_keep = int(max_to_keep)
        if self.max_to_keep < 1:
            raise ValueError(
                f"max_to_keep must be >= 1, got {max_to_keep}")
        if int(max_pending) < 1:
            raise ValueError(
                f"max_pending must be >= 1, got {max_pending}")
        os.makedirs(directory, exist_ok=True)
        self._sweep_stale_tmp()
        self.async_writes = bool(async_writes)
        self.max_pending = int(max_pending)
        self._q: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self._slots = threading.Semaphore(self.max_pending)
        self._err_lock = threading.Lock()
        self._write_errors: List[BaseException] = []

    def _sweep_stale_tmp(self) -> None:
        """Remove ``step_*.tmp`` directories a crash left mid-write: they
        were never published, and a later save of the same step must not
        inherit one."""
        for name in os.listdir(self.directory):
            if name.startswith("step_") and name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    # -- write ------------------------------------------------------------
    def save(self, step: int, tree: Any,
             metadata: Optional[Dict] = None) -> str:
        """Snapshot ``tree`` at ``step`` (fenced before return, see
        ``_snapshot_flat``), then write it now or queue the write
        (``async_writes``). Errors of earlier queued writes re-raise
        here. Returns the step's directory."""
        self._raise_write_errors()
        flat = _snapshot_flat(tree)
        final = os.path.join(self.directory, f"step_{step}")
        if not self.async_writes:
            self._write(step, flat, metadata, final)
            return final
        # at most max_pending snapshots in flight: a disk slower than the
        # epochs stalls the loop here instead of growing host memory
        self._slots.acquire()
        self._ensure_worker()
        self._q.put((step, flat, metadata, final))
        return final

    def wait(self) -> None:
        """Block until every queued write is durable; re-raise the first
        queued error."""
        if self._q is not None:
            self._q.join()
        self._raise_write_errors()

    def _raise_write_errors(self) -> None:
        with self._err_lock:
            if not self._write_errors:
                return
            err = self._write_errors[0]
            self._write_errors = []
        raise err

    def _ensure_worker(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        self._q = self._q or queue.Queue()
        self._worker = threading.Thread(target=self._drain_writes,
                                        daemon=True)
        self._worker.start()

    def _drain_writes(self) -> None:
        """The one writer thread: steps publish in submission order."""
        while True:
            step, flat, metadata, final = self._q.get()
            try:
                self._write(step, flat, metadata, final)
            except BaseException as e:  # surfaced at the next wait()/save()
                with self._err_lock:
                    self._write_errors.append(e)
            finally:
                self._slots.release()
                self._q.task_done()

    @staticmethod
    def _crc(arr: np.ndarray) -> int:
        return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF

    def _write(self, step, flat, metadata, final):
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, ARRAYS), **flat)
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump({"step": int(step),
                       "keys": sorted(flat),
                       "crc32": {k: self._crc(v) for k, v in flat.items()},
                       "metadata": metadata or {}}, f, indent=2)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # the atomic publish
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # -- read -------------------------------------------------------------
    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name[len("step_"):]))
                except ValueError:
                    continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        self.wait()  # reads see every queued write
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """The stored step (default: the latest) as host arrays in the
        structure of ``template``, shapes checked, each leaf's crc32
        verified against the manifest."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoints in {self.directory!r}")
        path = os.path.join(self.directory, f"step_{step}")
        return _unflatten_like(template, self._read_verified(path))

    def _read_verified(self, path: str) -> Dict[str, np.ndarray]:
        """``arrays.npz`` checked leaf by leaf (JAX :300): a truncated or
        corrupt snapshot fails with the path and the leaf's name."""
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
        crcs = manifest.get("crc32", {})
        try:
            arrays = np.load(os.path.join(path, ARRAYS))
        except Exception as e:
            raise ValueError(
                f"checkpoint {path!r}: {ARRAYS} unreadable (truncated "
                f"or corrupt): {e}") from e
        flat = {}
        with arrays:
            for k in arrays.files:
                try:
                    arr = arrays[k]
                except Exception as e:
                    raise ValueError(
                        f"checkpoint {path!r}: leaf {k!r} unreadable "
                        f"(truncated or corrupt {ARRAYS}): {e}") from e
                want = crcs.get(k)
                if want is not None and self._crc(arr) != int(want):
                    raise ValueError(
                        f"checkpoint {path!r}: leaf {k!r} failed its crc32 "
                        f"check (manifest {want}, payload {self._crc(arr)})"
                        " — the snapshot is corrupt; restore an older step")
                flat[k] = arr
        missing = [k for k in manifest.get("keys", []) if k not in flat]
        if missing:
            raise ValueError(
                f"checkpoint {path!r}: leaves in the manifest but "
                f"missing from {ARRAYS}: {missing[:5]}"
                f"{'...' if len(missing) > 5 else ''}")
        return flat

    def delete(self, step: int) -> None:
        """Remove one step's snapshot."""
        self.wait()
        shutil.rmtree(os.path.join(self.directory, f"step_{step}"),
                      ignore_errors=True)

    def keys(self, step: Optional[int] = None) -> Optional[List[str]]:
        """The flat array keys a checkpoint stores."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.directory, f"step_{step}")
        with np.load(os.path.join(path, ARRAYS)) as arrays:
            return list(arrays.files)

    def metadata(self, step: Optional[int] = None) -> Dict:
        self.wait()
        if step is None:
            step = self.latest_step()
        path = os.path.join(self.directory, f"step_{step}", MANIFEST)
        with open(path) as f:
            return json.load(f)["metadata"]
