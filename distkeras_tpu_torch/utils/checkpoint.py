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
them is the restoring trainer's business. As in JAX, the writes and
reads go through a transient-IO retry policy (``retry=``, default
``resilience.io_retry()``), and the chaos points ``ckpt.d2h`` (copies
in flight, none fenced), ``ckpt.write``, ``ckpt.rename`` and
``ckpt.restore`` (``resilience.faults``) sit where JAX's do (:52, :248,
:258, :306).

``ShardedCheckpointManager`` (JAX :393) keeps a sharded model's
checkpoint without gathering it: in JAX's layout, every rank of the
world writes its blocks to ``step_<N>/arrays_p<rank>.npz`` under keys
``<leaf-path>|<lo:hi,...>`` (a block that several ranks hold is written
by the first of them only), and rank 0 writes ``manifest.json`` with
every leaf's global shape and dtype. ``save(step, tree, metadata,
shardings=)`` takes the rank's blocks and a tree of ``NamedSharding``
(None: every leaf whole on every rank); ``restore_sharded(shardings)``
returns this rank's block of every leaf as host arrays, cut from stored
pieces that match, from a whole stored leaf, or stitched from the
pieces a mesh of another shape wrote; ``restore(template)`` stitches
whole leaves. Steps of either package's manager restore in the
other's, and dense steps (``arrays.npz``) restore through both.
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
from distkeras_tpu_torch.resilience import faults
from distkeras_tpu_torch.resilience.retry import RetryPolicy, io_retry
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
            if leaf.is_cuda:  # lint: allow-device-fork (pinned snapshot)
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
    # chaos hook: the crash mid-transfer, copies queued, none fenced
    faults.point("ckpt.d2h")
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
                 async_writes: bool = False,
                 retry: Optional[RetryPolicy] = None,
                 max_pending: int = 2):
        self.directory = directory
        self.max_to_keep = int(max_to_keep)
        if self.max_to_keep < 1:
            raise ValueError(
                f"max_to_keep must be >= 1, got {max_to_keep}")
        if int(max_pending) < 1:
            raise ValueError(
                f"max_pending must be >= 1, got {max_pending}")
        os.makedirs(directory, exist_ok=True)
        # transient-IO retry: a flaky write or read costs a jittered
        # backoff, not the snapshot; other errors surface raw
        self.retry = io_retry() if retry is None else retry
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
            self.retry.call(self._write, step, flat, metadata, final,
                            op="ckpt.write")
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
                self.retry.call(self._write, step, flat, metadata, final,
                                op="ckpt.write")
            except BaseException as e:  # lint: allow-swallow — surfaced
                with self._err_lock:    # at the next wait()/save()
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
        faults.point("ckpt.write")
        np.savez(os.path.join(tmp, ARRAYS), **flat)
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump({"step": int(step),
                       "keys": sorted(flat),
                       "crc32": {k: self._crc(v) for k, v in flat.items()},
                       "metadata": metadata or {}}, f, indent=2)
        faults.point("ckpt.rename")
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
        flat = self.retry.call(self._read_verified, path, op="ckpt.restore")
        return _unflatten_like(template, flat)

    def _read_verified(self, path: str) -> Dict[str, np.ndarray]:
        """``arrays.npz`` checked leaf by leaf (JAX :300): a truncated or
        corrupt snapshot fails with the path and the leaf's name."""
        faults.point("ckpt.restore")
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


# --- sharded checkpoints ------------------------------------------------------


def _encode_index(ranges) -> str:
    """``((lo, hi), ...)`` -> ``'lo:hi,...'`` (JAX :370)."""
    return ",".join(f"{lo}:{hi}" for lo, hi in ranges)


def _decode_index(s: str) -> tuple:
    """``'0:4,8:16'`` -> ``((0, 4), (8, 16))``."""
    if not s:
        return ()
    return tuple((int(a), int(b))
                 for a, b in (part.split(":") for part in s.split(",")))


def _as_slices(idx) -> tuple:
    return tuple(slice(lo, hi) for lo, hi in idx)


def _host_array(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()  # lint: allow-host-sync (the rank's block goes to disk)
    return np.asarray(leaf)


def _world():
    """``(rank, size, barrier)`` of the current ``torch.distributed``
    world (a lone process when none is up)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return 0, 1, lambda: None
    return dist.get_rank(), dist.get_world_size(), dist.barrier


class ShardedCheckpointManager(CheckpointManager):
    """Checkpoints of sharded (TP/FSDP/EP) models in JAX's per-process
    layout (see the module docstring): each rank writes only its blocks,
    and restores only its blocks. Every rank of the world calls ``save``
    (it runs barriers); the directory is shared by the ranks."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_writes: bool = False):
        if async_writes:
            raise ValueError(
                "async_writes is not supported for sharded checkpoints: "
                "the save path runs multi-process barriers that must stay "
                "on the training thread")
        super().__init__(directory, max_to_keep=max_to_keep)

    def _sweep_stale_tmp(self) -> None:
        """Rank 0 alone removes a crashed write's ``step_*.tmp``: another
        rank's manager may be made while rank 0 writes one."""
        if _world()[0] == 0:
            super()._sweep_stale_tmp()

    def save(self, step: int, tree: Any, metadata: Optional[Dict] = None,
             shardings: Any = None) -> str:
        """Write this rank's blocks of ``tree`` at ``step``. ``shardings``
        mirrors ``tree`` with a ``NamedSharding`` per leaf (its spec over
        its mesh says which block the leaf is); None: whole leaves, which
        rank 0 writes."""
        from distkeras_tpu_torch.parallel.sharding import (block_counts,
                                                           block_ranges,
                                                           is_replica_zero)
        self.wait()
        rank, _, _ = _world()
        flat, leaves = {}, {}
        if shardings is None:
            pairs = [(path, leaf, None) for path, leaf in _jax_order(tree)]
        else:
            pairs = list(_with_shardings(tree, shardings))
        for path, leaf, sharding in pairs:
            key = leaf_key(path)
            arr = _host_array(leaf)
            if sharding is None:
                shape = tuple(arr.shape)
                ranges = tuple((0, d) for d in shape)
                mine = rank == 0
            else:
                counts = block_counts(sharding, sharding.mesh, arr.ndim)
                shape = tuple(d * n for d, n in zip(arr.shape, counts))
                ranges = block_ranges(sharding, sharding.mesh, shape)
                mine = is_replica_zero(sharding, sharding.mesh)
            leaves[key] = {"shape": list(shape), "dtype": str(arr.dtype)}
            if mine:
                flat[f"{key}|{_encode_index(ranges)}"] = np.array(arr)
        final = os.path.join(self.directory, f"step_{step}")
        self._write_sharded(step, flat, leaves, metadata, final)
        return final

    def _write_sharded(self, step, flat, leaves, metadata, final):
        rank, size, barrier = _world()
        tmp = final + ".tmp"
        if rank == 0:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        barrier()
        # no retry here: one rank retrying would desynchronize the
        # barriers (why async_writes is refused too)
        faults.point("ckpt.write")
        np.savez(os.path.join(tmp, f"arrays_p{rank}.npz"), **flat)
        barrier()
        if rank == 0:
            with open(os.path.join(tmp, MANIFEST), "w") as f:
                json.dump({"step": int(step), "format": "sharded",
                           "keys": sorted(leaves), "leaves": leaves,
                           "num_processes": size,
                           "metadata": metadata or {}}, f, indent=2)
            faults.point("ckpt.rename")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # the atomic publish
            self._gc()
        barrier()

    # -- read ---------------------------------------------------------------
    def _load_shards(self, step):
        """``{leaf key: {index: lazy loader}}`` and the leaves' specs
        (JAX :496): only an index of the npz members is built; a dense
        step's ``arrays.npz`` reads as whole-leaf pieces."""
        path = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
        if "leaves" in manifest:
            specs = dict(manifest["leaves"])
            files = [n for n in sorted(os.listdir(path))
                     if n.startswith("arrays_p") and n.endswith(".npz")]
        else:
            specs, files = {}, [ARRAYS]
        pieces: Dict[str, Dict] = {}
        for name in files:
            arrays = np.load(os.path.join(path, name))  # lazy NpzFile
            for k in arrays.files:
                if "|" in k:
                    key, _, idxstr = k.rpartition("|")
                    idx = _decode_index(idxstr)
                else:
                    key = k
                    if key not in specs:
                        with arrays.zip.open(k + ".npy") as f:
                            np.lib.format.read_magic(f)
                            shp, _, dt = \
                                np.lib.format.read_array_header_1_0(f)
                        specs[key] = {"shape": list(shp), "dtype": str(dt)}
                    idx = tuple((0, d) for d in specs[key]["shape"])
                pieces.setdefault(key, {})[idx] = \
                    (lambda a=arrays, member=k: a[member])
        return pieces, specs

    @staticmethod
    def _stitch(norm, stored, dtype, key):
        """The range ``norm`` from overlapping stored pieces (JAX :544):
        one piece loaded at a time; a gap is an error, not zeros."""
        out = np.empty(tuple(hi - lo for lo, hi in norm), dtype)
        got = 0
        for sidx, loader in stored.items():
            inter = []
            for a, b in zip(sidx, norm):
                lo, hi = max(a[0], b[0]), min(a[1], b[1])
                if lo >= hi:
                    inter = None
                    break
                inter.append((lo, hi))
            if inter is None:
                continue
            piece = loader()
            src = piece[tuple(slice(lo - a[0], hi - a[0])
                              for (lo, hi), a in zip(inter, sidx))]
            out[tuple(slice(lo - b[0], hi - b[0])
                      for (lo, hi), b in zip(inter, norm))] = src
            got += src.size
            del piece
        if got != out.size:
            raise ValueError(
                f"checkpoint shard mismatch for {key!r}: stored pieces "
                f"cover only {got}/{out.size} elements of requested "
                f"index {norm} (stored indices: {list(stored)})")
        return out

    def _steps_pieces(self, step):
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory!r}")
        faults.point("ckpt.restore")
        return self._load_shards(step)

    def restore_sharded(self, shardings: Any,
                        step: Optional[int] = None) -> Any:
        """This rank's block of every leaf, as host arrays in the
        structure of ``shardings`` (a tree of ``NamedSharding``, the
        saved tree's structure): a stored piece that matches, a slice of
        a whole stored leaf, or a block stitched from the pieces another
        mesh wrote. The whole leaf is never assembled."""
        from distkeras_tpu_torch.parallel.sharding import block_ranges
        pieces, leaves = self._steps_pieces(step)

        def load(path, sharding):
            key = leaf_key(path)
            if key not in leaves:
                raise KeyError(f"leaf {key!r} not in checkpoint")
            shape = tuple(leaves[key]["shape"])
            dtype = np.dtype(leaves[key]["dtype"])
            stored = pieces[key]
            norm = block_ranges(sharding, sharding.mesh, shape)
            full = tuple((0, d) for d in shape)
            if norm in stored:
                piece = stored[norm]()
            elif full in stored:
                piece = stored[full]()[_as_slices(norm)]
            else:
                piece = self._stitch(norm, stored, dtype, key)
            return np.array(piece, dtype=dtype, copy=True)

        return _map_shardings(load, shardings)

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """Whole host arrays stitched from the stored pieces, in the
        structure of ``template`` (the compatibility path: it assembles
        every leaf)."""
        pieces, leaves = self._steps_pieces(step)
        flat = {}
        for key, stored in pieces.items():
            shape = tuple(leaves[key]["shape"])
            full = np.empty(shape, np.dtype(leaves[key]["dtype"]))
            for idx, piece in stored.items():
                full[_as_slices(idx)] = piece()
            flat[key] = full
        return _unflatten_like(template, flat)

    def keys(self, step: Optional[int] = None) -> Optional[List[str]]:
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.directory, f"step_{step}", MANIFEST)
        with open(path) as f:
            manifest = json.load(f)
        if "keys" in manifest:
            return list(manifest["keys"])
        return super().keys(step)


def _with_shardings(tree, shardings, path=()):
    """``(path, leaf, sharding)`` in ``jax.tree_util`` order over a tree
    and its mirror of ``NamedSharding`` leaves."""
    from distkeras_tpu_torch.parallel.mesh import NamedSharding
    if isinstance(shardings, NamedSharding):
        yield path, tree, shardings
    elif isinstance(shardings, dict):
        for k in sorted(shardings):
            yield from _with_shardings(tree[k], shardings[k], path + (k,))
    elif isinstance(shardings, (list, tuple)):
        for i, sub in enumerate(shardings):
            yield from _with_shardings(tree[i], sub, path + (i,))
    else:
        raise TypeError(f"not a tree of NamedSharding: {shardings!r}")


def _map_shardings(fn, shardings, path=()):
    """``fn(path, sharding)`` over a tree of ``NamedSharding`` leaves,
    returned in the tree's structure."""
    from distkeras_tpu_torch.parallel.mesh import NamedSharding
    if isinstance(shardings, NamedSharding):
        return fn(path, shardings)
    if isinstance(shardings, dict):
        return {k: _map_shardings(fn, v, path + (k,))
                for k, v in shardings.items()}
    if isinstance(shardings, (list, tuple)):
        return [_map_shardings(fn, v, path + (i,))
                for i, v in enumerate(shardings)]
    raise TypeError(f"not a tree of NamedSharding: {shardings!r}")
