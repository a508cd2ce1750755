"""Named-axis collectives over the current mesh, and ``shard_map``.

The port's counterpart of the ``jax.lax`` collectives that the
sequence-parallel modules call inside a ``shard_map``:
``axis_index``/``axis_size`` (``lax.axis_index``, ``lax.psum(1, ..)``),
``ppermute``, ``all_to_all``, ``psum``, ``all_gather`` and
``reduce_scatter`` (``lax.psum_scatter``), each along a named axis of
the current mesh (``parallel.mesh``: made current by
``with mesh:`` or by ``shard_map``). An axis that no current mesh binds
raises ``NameError``, as JAX's unbound axis names do.

``ppermute``, ``all_to_all``, ``psum``, ``all_gather`` and
``reduce_scatter`` are differentiable: the gradient of a shift is the
inverse shift, of an all-to-all the all-to-all back, of a sum over the
axis the sum of the cotangents, of a gather each rank's slice of the
summed cotangent, of a reduce-scatter the gather of the cotangents.
``replicate_in`` and ``reduce_out`` are Megatron's pair for tensor
parallelism (the SPMD trainer's column and row splits): the identity
forward with a summed backward, and the sum forward with the identity
backward.

Transport follows the axis group's backend. NCCL moves device tensors.
Gloo moves host memory only (no CUDA send/recv or all-to-all), and a
world whose ranks share one card must be gloo (NCCL refuses two ranks
on one device), so a CUDA tensor on a gloo group is staged: copied into
a pinned host buffer (a host sync: the copy waits for the tensor's
producers), moved by gloo, and copied back with a non-blocking copy
from pinned memory. That staging is the design for ranks sharing a
card, not a fallback: a failing collective raises. Moves carry the
tensors' bytes (gloo's all-to-all takes no 16-bit type); ``psum`` adds
bf16 and fp16 in float32.

``shard_map(fn, mesh, in_specs, out_specs)`` (JAX ``shard_map``): each
rank takes its block of every global input by its ``PartitionSpec``,
runs ``fn`` with the mesh current, and all-gathers each output by its
spec, so that JAX's callers keep their shape.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from distkeras_tpu_torch.parallel.mesh import (Mesh, NamedSharding,
                                               PartitionSpec, current_mesh)

def _mesh_for(axis_name: str) -> Mesh:
    mesh = current_mesh()
    if mesh is None or axis_name not in mesh.shape:
        raise NameError(f"unbound axis name: {axis_name!r} (call inside "
                        "shard_map or `with mesh:` over a mesh that has "
                        "it)")
    return mesh


def axis_size(axis_name: str) -> int:
    return _mesh_for(axis_name).axis_size(axis_name)


def axis_index(axis_name: str) -> int:
    return _mesh_for(axis_name).axis_index(axis_name)


def _staged(x: torch.Tensor, group) -> bool:
    """Whether ``x`` must go through pinned host memory on ``group``."""
    on_card = x.device.type == "cuda"  # lint: allow-device-fork (pinned staging buffers, not a code path)
    return on_card and "nccl" not in dist.get_backend(group)


def _host(x: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of ``x``."""
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)  # lint: allow-host-sync (gloo reads host memory: waits for x's producers)
    return host


def _outbound(x: torch.Tensor, staged: bool) -> torch.Tensor:
    """The bytes the transport moves: ``x`` flat as uint8 (gloo's
    all-to-all takes no 16-bit type), pinned on the host when staged."""
    x = x.contiguous().reshape(-1).view(torch.uint8)
    return _host(x) if staged else x


def _inbound_buffer(like: torch.Tensor, staged: bool) -> torch.Tensor:
    nbytes = like.numel() * like.element_size()
    if staged:
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    return torch.empty(nbytes, dtype=torch.uint8, device=like.device)


def _arrived(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Received bytes as a tensor of ``like``'s shape, dtype and device
    (a non-blocking copy from pinned memory: the caching host allocator
    keeps the buffer until the copy has run)."""
    if buf.device != like.device:
        buf = buf.to(like.device, non_blocking=True)
    return buf.view(like.dtype).view(like.shape)


class PendingShift:
    """Receives posted by ``shift_start``; ``wait()`` returns them on
    their devices. The sends it posted read their own buffers, so the
    caller may keep using (not overwrite) the tensors it sent."""

    def __init__(self, reqs, bufs, likes, keep):
        self._reqs, self._bufs, self._likes = reqs, bufs, likes
        self._keep = keep      # the send buffers, alive until the wait

    def wait(self) -> List[torch.Tensor]:
        for r in self._reqs:
            r.wait()
        self._keep = None
        return [_arrived(b, like) for b, like in zip(self._bufs,
                                                     self._likes)]


def shift_start(tensors: Sequence[torch.Tensor],
                axis_name: str) -> PendingShift:
    """Post the ring shift of ``tensors`` one position along ``axis_name``
    (index ``i`` sends to ``i + 1`` and receives from ``i - 1``, modulo
    the axis size) with ``batch_isend_irecv``,
    receives first, and return without waiting: the caller computes
    while the transfers run (NCCL overlaps them with its kernels)."""
    mesh = _mesh_for(axis_name)
    n, i = mesh.axis_size(axis_name), mesh.axis_index(axis_name)
    tensors = list(tensors)
    if n == 1:
        return PendingShift([], tensors, tensors, None)
    group = mesh.group(axis_name)
    dst = mesh.peer(axis_name, (i + 1) % n)
    src = mesh.peer(axis_name, (i - 1) % n)
    recvs, sends, ops = [], [], []
    for tag, t in enumerate(tensors):
        staged = _staged(t, group)
        buf = _inbound_buffer(t, staged)
        recvs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, src, group, tag))
    for tag, t in enumerate(tensors):
        out = _outbound(t, _staged(t, group))
        sends.append(out)
        ops.append(dist.P2POp(dist.isend, out, dst, group, tag))
    return PendingShift(dist.batch_isend_irecv(ops), recvs, tensors, sends)


def _permute(x: torch.Tensor, axis_name: str, perm) -> torch.Tensor:
    mesh = _mesh_for(axis_name)
    n, i = mesh.axis_size(axis_name), mesh.axis_index(axis_name)
    perm = [(int(s) % n, int(d) % n) for s, d in perm]
    if len({s for s, _ in perm}) != len(perm) \
            or len({d for _, d in perm}) != len(perm):
        raise ValueError(f"ppermute needs a permutation: {perm}")
    dst = [d for s, d in perm if s == i]
    src = [s for s, d in perm if d == i]
    if dst == [i] and src == [i]:
        return x.clone()
    group = mesh.group(axis_name)
    staged = _staged(x, group)
    ops, buf = [], None
    if src:
        buf = _inbound_buffer(x, staged)
        ops.append(dist.P2POp(dist.irecv, buf, mesh.peer(axis_name, src[0]),
                              group))
    if dst:
        ops.append(dist.P2POp(dist.isend, _outbound(x, staged),
                              mesh.peer(axis_name, dst[0]), group))
    if ops:
        for r in dist.batch_isend_irecv(ops):
            r.wait()
    if buf is None:          # no source sends here: zeros, as in JAX
        return torch.zeros_like(x)
    return _arrived(buf, x)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, perm):
        ctx.axis_name, ctx.perm = axis_name, perm
        return _permute(x, axis_name, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _permute(g.contiguous(), ctx.axis_name, inverse), None, None


def ppermute(x: torch.Tensor, axis_name: str, perm) -> torch.Tensor:
    """``lax.ppermute``: ``perm`` is a list of ``(source, destination)``
    axis indices; an index no pair sends to receives zeros. Its gradient
    is the inverse permutation."""
    return _PPermute.apply(x, axis_name, [tuple(p) for p in perm])


def _a2a(x, axis_name, split_axis, concat_axis, tiled):
    mesh = _mesh_for(axis_name)
    n = mesh.axis_size(axis_name)
    split_axis %= x.ndim
    if x.shape[split_axis] % n or (not tiled and x.shape[split_axis] != n):
        raise ValueError(f"all_to_all over {n} ranks cannot split axis "
                         f"{split_axis} of {tuple(x.shape)}")
    chunks = torch.stack(torch.tensor_split(x, n, dim=split_axis))
    if n > 1:
        group = mesh.group(axis_name)
        staged = _staged(x, group)
        inp = _outbound(chunks, staged)
        out = torch.empty_like(inp)
        dist.all_to_all_single(out, inp, group=group)
        chunks = _arrived(out, chunks)
    parts = chunks.unbind(0)
    if tiled:
        return torch.cat(parts, dim=concat_axis % x.ndim)
    parts = [p.squeeze(split_axis) for p in parts]
    return torch.stack(parts, dim=concat_axis % x.ndim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, split_axis, concat_axis, tiled):
        ctx.args = (axis_name, split_axis, concat_axis, tiled, x.ndim)
        return _a2a(x, axis_name, split_axis, concat_axis, tiled)

    @staticmethod
    def backward(ctx, g):
        axis_name, split_axis, concat_axis, tiled, ndim = ctx.args
        if tiled:
            back = _a2a(g, axis_name, concat_axis % ndim, split_axis % ndim,
                        True)
        else:
            back = _a2a(g, axis_name, concat_axis % g.ndim,
                        split_axis % ndim, False)
        return back, None, None, None, None


def all_to_all(x: torch.Tensor, axis_name: str, split_axis: int,
               concat_axis: int, tiled: bool = False) -> torch.Tensor:
    """``lax.all_to_all``: split ``split_axis`` into one chunk per index
    of the axis, send chunk ``j`` to index ``j``, and put the received
    chunks in index order along ``concat_axis`` (``tiled=True``:
    concatenated; else the split axis must equal the axis size and the
    chunks stack along a new ``concat_axis``)."""
    return _AllToAll.apply(x, axis_name, split_axis, concat_axis, tiled)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    low = x.dtype in (torch.bfloat16, torch.float16)
    work = x.float() if low else x
    buf = _host(work) if _staged(work, group) else work.clone()
    dist.all_reduce(buf, group=group)
    out = buf.to(work.device, non_blocking=True)
    return out.to(x.dtype) if low else out


def _psum(x, axis_name):
    mesh = _mesh_for(axis_name)
    if mesh.axis_size(axis_name) == 1:
        return x.clone()
    return _all_reduce(x, mesh.group(axis_name))


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return _psum(x, axis_name)

    @staticmethod
    def backward(ctx, g):
        return _psum(g.contiguous(), ctx.axis_name), None


def psum(x, axis_name: str):
    """``lax.psum`` over the axis: a tensor, a Python number (``psum(1,
    axis)`` is the axis size), or a list/tuple of tensors, which are
    summed through ONE flat buffer per dtype (the gradients of a model
    in one transfer)."""
    if isinstance(x, (int, float)):
        return _psum_number(x, axis_name)
    if isinstance(x, (list, tuple)):
        return type(x)(_psum_many(list(x), axis_name))
    return _PSum.apply(x, axis_name)


def _psum_number(x, axis_name):
    mesh = _mesh_for(axis_name)
    if mesh.axis_size(axis_name) == 1:
        return x
    t = torch.tensor([x], dtype=torch.float64)
    dist.all_reduce(t, group=mesh.group(axis_name))
    out = t.item()
    return int(round(out)) if isinstance(x, int) else out


def _psum_many(xs: List[torch.Tensor], axis_name: str):
    mesh = _mesh_for(axis_name)
    if mesh.axis_size(axis_name) == 1:
        return [x.clone() for x in xs]
    group = mesh.group(axis_name)
    out: List = [None] * len(xs)
    by_key = {}
    for j, x in enumerate(xs):
        by_key.setdefault((x.dtype, x.device), []).append(j)
    for idx in by_key.values():
        flat = torch.cat([xs[j].reshape(-1) for j in idx])
        summed = _all_reduce(flat, group)
        at = 0
        for j in idx:
            n = xs[j].numel()
            out[j] = summed[at:at + n].view(xs[j].shape)
            at += n
    return out


def _gather(x, axis_name, axis, tiled):
    mesh = _mesh_for(axis_name)
    n = mesh.axis_size(axis_name)
    if n == 1:
        parts = [x]
    else:
        group = mesh.group(axis_name)
        staged = _staged(x, group)
        inp = _outbound(x, staged)
        bufs = [torch.empty_like(inp) for _ in range(n)]
        dist.all_gather(bufs, inp, group=group)
        parts = [_arrived(b, x) for b in bufs]
    if tiled:
        return torch.cat(parts, dim=axis % x.ndim)
    return torch.stack(parts, dim=axis % (x.ndim + 1))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, axis, tiled):
        ctx.args = (axis_name, axis, tiled, x.shape)
        return _gather(x, axis_name, axis, tiled)

    @staticmethod
    def backward(ctx, g):
        axis_name, axis, tiled, shape = ctx.args
        total = _psum(g.contiguous(), axis_name)
        i = axis_index(axis_name)
        if tiled:
            ax = axis % len(shape)
            part = total.narrow(ax, i * shape[ax], shape[ax])
        else:
            part = total.select(axis % (len(shape) + 1), i)
        return part.contiguous(), None, None, None


def all_gather(x: torch.Tensor, axis_name: str, axis: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """``lax.all_gather``: every index's ``x`` in index order, stacked
    along a new ``axis`` (``tiled=True``: concatenated along ``axis``)."""
    return _AllGather.apply(x, axis_name, axis, tiled)


def _scatter(x, axis_name, dim):
    """This index's block of ``dim`` of the sum over the axis."""
    mesh = _mesh_for(axis_name)
    n = mesh.axis_size(axis_name)
    dim %= x.ndim
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter over {n} ranks cannot split axis "
                         f"{dim} of {tuple(x.shape)}")
    step = x.shape[dim] // n
    total = _psum(x, axis_name)
    return total.narrow(dim, mesh.axis_index(axis_name) * step,
                        step).contiguous()


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, dim):
        ctx.args = (axis_name, dim % x.ndim)
        return _scatter(x, axis_name, dim)

    @staticmethod
    def backward(ctx, g):
        axis_name, dim = ctx.args
        return _gather(g.contiguous(), axis_name, dim, True), None, None


def reduce_scatter(x: torch.Tensor, axis_name: str,
                   scatter_dimension: int = 0) -> torch.Tensor:
    """``lax.psum_scatter(..., tiled=True)``: the sum over the axis, of
    which index ``i`` keeps block ``i`` of ``scatter_dimension``. Its
    gradient is the tiled all-gather of the cotangents."""
    return _ReduceScatter.apply(x, axis_name, scatter_dimension)


class _ReplicateIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum(g.contiguous(), ctx.axis_name), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        return _psum(x.contiguous(), axis_name)

    @staticmethod
    def backward(ctx, g):
        return g, None


def replicate_in(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Megatron's ``f``: the identity forward, and the sum over the axis
    of the cotangents backward. It enters a region where each index of
    the axis computes its own part (its heads, its hidden units) from
    the same replicated ``x``: ``x``'s gradient is the sum of the
    parts'."""
    return _ReplicateIn.apply(x, axis_name)


def reduce_out(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Megatron's ``g``: the sum over the axis forward, and the identity
    backward. It leaves such a region: every index holds the same sum,
    whose cotangent each index already holds whole."""
    return _ReduceOut.apply(x, axis_name)


# --- shard_map ---------------------------------------------------------------


def _spec(spec) -> PartitionSpec:
    if isinstance(spec, NamedSharding):
        return spec.spec
    if spec is None:
        return PartitionSpec()
    if not isinstance(spec, tuple):
        raise TypeError(f"expected a PartitionSpec, got {spec!r}")
    return PartitionSpec(*spec)


def _names(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _block(mesh: Mesh, names):
    """(index, count) of this rank's block over the named axes (the
    first name major)."""
    index, count = 0, 1
    for name in names:
        size = mesh.axis_size(name)
        index = index * size + mesh.axis_index(name)
        count *= size
    return index, count


def _local(x, spec: PartitionSpec, mesh: Mesh):
    if not any(_names(e) for e in spec):
        return x
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"a sharded input must be a tensor, got "
                        f"{type(x).__name__}")
    for dim, entry in enumerate(spec):
        names = _names(entry)
        if not names:
            continue
        index, count = _block(mesh, names)
        if x.shape[dim] % count:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does "
                             f"not split over {names} ({count} blocks)")
        step = x.shape[dim] // count
        x = x.narrow(dim, index * step, step)
    return x.contiguous()


def _global(y, spec: PartitionSpec, mesh: Mesh):
    for dim in reversed(range(len(spec))):
        for name in reversed(_names(spec[dim])):
            y = _gather(y, name, dim, tiled=True)
    return y


def shard_map(fn, mesh: Mesh, in_specs, out_specs):
    """``fn`` over this rank's blocks (JAX's ``shard_map``). ``in_specs``
    holds one ``PartitionSpec`` (or ``NamedSharding``) per argument:
    ``P()`` passes the argument whole (any object), ``P(None, "sp")``
    passes this rank's block of dimension 1 along ``sp``. ``out_specs``
    (one spec, or a tuple for a tuple of outputs) all-gathers each output
    back to its global shape; ``P()`` returns it as this rank computed
    it. Every rank of the mesh calls the result with the same global
    inputs. The gathered outputs leave autograd: take gradients inside
    ``fn``, where each rank holds its own block."""
    multi_out = isinstance(out_specs, (list, tuple)) and not isinstance(
        out_specs, PartitionSpec)

    def mapped(*args):
        specs = in_specs if isinstance(in_specs, (list, tuple)) and not \
            isinstance(in_specs, PartitionSpec) else (in_specs,) * len(args)
        if len(specs) != len(args):
            raise ValueError(f"{len(args)} arguments, {len(specs)} in_specs")
        local = [_local(a, _spec(s), mesh) for a, s in zip(args, specs)]
        with mesh:
            out = fn(*local)
            if multi_out:
                return type(out)(_global(o, _spec(s), mesh)
                                 for o, s in zip(out, out_specs))
            return _global(out, _spec(out_specs), mesh)

    return mapped
