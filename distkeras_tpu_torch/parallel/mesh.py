"""Device mesh of the port: named axes over a ``torch.distributed`` world.

Mirrors ``distkeras_tpu/parallel/mesh.py`` (``make_mesh`` :28,
``make_mesh_2d`` :42, ``replicated`` :57, ``worker_sharded`` :61). In
JAX a mesh position is a device of one process; here it is a PROCESS,
one rank of the current ``torch.distributed`` world: JAX's "devices"
are the world's ranks, so ``make_mesh(4, "sp")`` needs a world of at
least four processes (``parallel.launch.World`` starts one on this
machine, ``deploy.Job`` across machines). A world that was never
started is this one process (a one-rank gloo group is brought up on
first use), so a one-position mesh works anywhere.

``Mesh`` holds a ``torch.distributed.device_mesh.DeviceMesh``
(``device_mesh``) over those ranks with the mesh's axis names, the
subgroup of each axis (``group``), ``axis_size`` and ``axis_index``.
Its device is the CUDA card unless ``device="cpu"`` is asked for; every
rank of a world on one machine shares the one card (the collectives
stage through pinned host memory when the group's backend is gloo:
``parallel.collectives``). An axis index is the rank's position in its
axis group, which is ascending global rank.

A mesh is made current by ``with mesh:`` or by ``shard_map``
(``parallel.collectives``); the named collectives and the layers'
``seq_axis_name`` read the current one. ``AbstractMesh`` is axis
sizes alone (no ranks), which the sharding rules read. ``replicated`` and
``worker_sharded`` return placement specs (``NamedSharding`` over a
``PartitionSpec``, kept here) that ``shard_map`` reads.

Axis conventions are JAX's: ``workers`` (data parallel), ``tp``
(tensor parallel), ``sp`` (sequence parallel).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from distkeras_tpu_torch.compat import resolve_device


class PartitionSpec(tuple):
    """One entry per array dimension: the mesh axis name (or a tuple of
    names) that dimension is split over, or None (JAX's
    ``jax.sharding.PartitionSpec``). ``P()`` is fully replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __reduce__(self):
        return (PartitionSpec, tuple(self))

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A placement: ``spec`` over ``mesh`` (JAX's ``NamedSharding``)."""
    mesh: "Mesh"
    spec: PartitionSpec


def ensure_world() -> None:
    """Bring up a one-rank gloo world when none is up (this process
    alone), so that a one-position mesh needs no launcher."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)


def world_size() -> int:
    ensure_world()
    return dist.get_world_size()


_CURRENT: List["Mesh"] = []


def current_mesh() -> Optional["Mesh"]:
    """The innermost mesh made current by ``with mesh:`` (or None)."""
    return _CURRENT[-1] if _CURRENT else None


class Mesh:
    """Named axes over ranks of the current world (JAX's ``Mesh``):
    ``ranks`` is an integer array of global ranks, one dimension per
    name in ``axis_names``. Every rank of the world constructs it (the
    axis groups are made collectively)."""

    def __init__(self, ranks, axis_names: Sequence[str], device=None):
        ranks = np.asarray(ranks, dtype=np.int64)
        axis_names = tuple(axis_names)
        if ranks.ndim != len(axis_names):
            raise ValueError(f"{ranks.ndim}-d ranks need {ranks.ndim} axis "
                             f"names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names must differ: {axis_names}")
        self.device = resolve_device(device)
        ensure_world()
        from torch.distributed.device_mesh import DeviceMesh
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, ranks.shape))
        self.ranks = ranks
        kind = self.device.type  # lint: allow-device-fork (names the mesh's device, no code path)
        self.device_mesh = DeviceMesh(kind, torch.as_tensor(ranks),
                                      mesh_dim_names=axis_names)

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def _name(self, axis_name: str) -> str:
        if axis_name not in self.shape:
            raise NameError(f"unbound axis name: {axis_name!r} (mesh axes "
                            f"{self.axis_names})")
        return axis_name

    def axis_size(self, axis_name: str) -> int:
        return self.shape[self._name(axis_name)]

    def axis_index(self, axis_name: str) -> int:
        """This rank's position along ``axis_name``."""
        return self.device_mesh.get_local_rank(self._name(axis_name))

    def group(self, axis_name: str):
        """The process group of this rank's line along ``axis_name``."""
        return self.device_mesh.get_group(self._name(axis_name))

    def peer(self, axis_name: str, index: int) -> int:
        """The global rank at ``index`` of this rank's ``axis_name``
        line."""
        return dist.get_global_rank(self.group(axis_name), int(index))

    def __enter__(self):
        _CURRENT.append(self)
        return self

    def __exit__(self, *exc):
        _CURRENT.remove(self)
        return False

    def __repr__(self):
        return f"Mesh({self.shape}, device={str(self.device)!r})"


class AbstractMesh:
    """Named axis sizes with no ranks behind them (JAX's
    ``AbstractMesh``): what ``parallel.sharding``'s rules read
    (``shape``, ``axis_names``), so that a spec tree can be worked out
    in any one process for a mesh of any size."""

    def __init__(self, shape: Dict[str, int]):
        self.shape: Dict[str, int] = {str(k): int(v)
                                      for k, v in dict(shape).items()}
        self.axis_names = tuple(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values()), dtype=np.int64))

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


def make_mesh(num_workers: Optional[int] = None,
              axis_name: str = "workers",
              devices: Optional[Sequence[int]] = None,
              device=None) -> Mesh:
    """1-D worker mesh over the first ``num_workers`` ranks of the world
    (``devices``: the ranks to take them from)."""
    devices = list(devices if devices is not None
                   else range(world_size()))
    n = num_workers or len(devices)
    if n > len(devices):
        raise ValueError(
            f"num_workers={n} exceeds available devices ({len(devices)}). "
            "The reference oversubscribed Spark executors via "
            "parallelism_factor; a mesh maps workers 1:1 onto the "
            "world's processes.")
    return Mesh(np.array(devices[:n]), (axis_name,), device)


def make_mesh_2d(shape: Dict[str, int],
                 devices: Optional[Sequence[int]] = None,
                 device=None) -> Mesh:
    """N-D mesh, e.g. ``{"workers": 4, "tp": 2}``; axis order follows
    the dict's, the last axis varying fastest over the ranks."""
    devices = list(devices if devices is not None
                   else range(world_size()))
    sizes = list(shape.values())
    total = int(np.prod(sizes))
    if total > len(devices):
        raise ValueError(f"mesh {shape} needs {total} devices, "
                         f"have {len(devices)}")
    return Mesh(np.array(devices[:total]).reshape(sizes), tuple(shape),
                device)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def worker_sharded(mesh: Mesh, axis_name: str = "workers") -> NamedSharding:
    """Placement of arrays with a leading per-worker axis."""
    return NamedSharding(mesh, P(axis_name))
