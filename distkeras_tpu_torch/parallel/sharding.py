"""Tensor-, expert- and fully-sharded parameters: the rules that give a
parameter tree its ``PartitionSpec`` tree, and how a sharded step
computes over a world of processes.

Mirrors ``distkeras_tpu/parallel/sharding.py``: ``ShardingRules`` (:51,
the per-layer rules :99-237), ``param_specs`` (:240),
``named_shardings`` (:250) and ``shard_params`` (:256), with the same
specs leaf for leaf: Megatron's column->row split (attention ``wq``/
``wk``/``wv`` on heads and ``wo`` on its heads input, the MLP's ``w1``
on hidden and ``w2`` on its hidden input), the expert axis for an MoE,
the model dimension of embeddings and the units of a ``Dense``, ``Conv2D``
or recurrent layer, FSDP over a leaf's largest divisible dimension, and
replication wherever the axis does not divide. The rules read only
``mesh.shape``, so a ``parallel.mesh.AbstractMesh`` (axis sizes alone)
gives the spec tree of any mesh in one process. ``_generic`` recurses
by matching parameter keys to child attributes: the port's layers keep
JAX's keys as their attribute names, or name their sub-layers by those
keys in ``sub_layers()`` (``Bidirectional``'s ``forward``/``backward``,
which a torch module cannot take as attributes).

Where JAX's GSPMD places the collectives of any layout, the port places
them by hand (``Placement``, made current by ``placed``):

* the rank holds its block of every leaf (``shard_params``);
* inside ``MultiHeadAttention`` and ``TransformerMLP`` the tensor-
  parallel blocks are used where they lie: each rank computes its heads
  or hidden units between Megatron's ``replicate_in`` at the branch
  input and one ``reduce_out`` after ``wo`` and ``w2``
  (``parallel.collectives``; the layers ask ``tensor_parallel_axis``);
* every other sharded leaf, and every FSDP or expert-axis leaf, is
  gathered for the step (``use_params``): its backward hands each rank
  its block of the gradient, summed over the data axes where the
  gather ran over one (a reduce-scatter), and every gradient is summed
  over the remaining data axes in one flat transfer per dtype;
* the batch is sharded over the data axes, and every reduction over it
  is global: the step gathers the model's output rows (``gather_rows``)
  and takes the loss and the metrics of the global batch; BatchNorm
  sums its two moments and its backward's two reductions over the data
  axes (``data_summer``); the MoE balance loss takes the global routing
  fractions (``data_mean``); a dropout mask is the rank's rows of the
  global batch's mask (``data_rows``).

A cotangent is either a rank's CONTRIBUTION (its rows' part of the
gradient: summed over the data axes) or a COPY (every rank of a
replicated computation holds the whole: not summed). That is the one
rule behind every backward here.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distkeras_tpu_torch.parallel.mesh import NamedSharding, PartitionSpec

P = PartitionSpec
Pytree = Any


def _axis_size(mesh, axis) -> int:
    """Total size of a (possibly tuple) mesh-axis spec entry."""
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        size = 1
        for a in axis:
            size *= mesh.shape[a]
        return size
    return mesh.shape[axis]


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(d) for d in leaf.shape)


def map_specs(fn, specs, *trees):
    """``fn(spec, *leaves)`` over a spec tree (``PartitionSpec`` or
    ``NamedSharding`` leaves; dicts and lists) and trees of its
    structure."""
    if isinstance(specs, (PartitionSpec, NamedSharding)):
        return fn(specs, *trees)
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(t[k] for t in trees))
                for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return [map_specs(fn, v, *(t[i] for t in trees))
                for i, v in enumerate(specs)]
    raise TypeError(f"not a spec tree node: {specs!r}")


def spec_leaves(specs) -> List:
    out: List = []
    map_specs(out.append, specs)
    return out


def _child(layer, key):
    """The sub-layer of ``layer`` under parameter key ``key``: the
    attribute of that name, or, where the key is not an attribute of a
    torch module (``Bidirectional``'s ``forward``/``backward``), the
    layer's ``sub_layers()`` entry."""
    subs = getattr(layer, "sub_layers", None)
    if subs is not None:
        found = subs().get(key)
        if found is not None:
            return found
    return getattr(layer, key, None)


class ShardingRules:
    """Produces a PartitionSpec tree for a module's params/state.

    ``tp_axis``/``ep_axis`` name mesh axes (or None to disable). ``fsdp_axis``
    optionally ZeRO-shards otherwise-replicated large kernels along their
    biggest divisible dim (fully-sharded data parallelism over the data
    axis: the leaf is gathered for the step).
    """

    def __init__(self, mesh, tp_axis: Optional[str] = "tp",
                 ep_axis: Optional[str] = None,
                 fsdp_axis: Optional[str] = None,
                 min_fsdp_size: int = 2 ** 16):
        def present(a):
            return a if a is not None and a in mesh.shape else None
        self.mesh = mesh
        self.tp = present(tp_axis)
        self.ep = present(ep_axis)
        self.fsdp = present(fsdp_axis)
        self.min_fsdp_size = int(min_fsdp_size)

    # -- helpers -----------------------------------------------------------
    def _fits(self, axis, dim: int) -> bool:
        return axis is not None and dim % _axis_size(self.mesh, axis) == 0

    def _tp(self, dim: int):
        return self.tp if self._fits(self.tp, dim) else None

    def _ep(self, dim: int):
        return self.ep if self._fits(self.ep, dim) else None

    def _maybe_fsdp(self, spec: P, shape: Tuple[int, ...]) -> P:
        """Shard the largest still-replicated dim over the fsdp axis."""
        if self.fsdp is None or not shape:
            return spec
        if int(np.prod(shape)) < self.min_fsdp_size:
            return spec
        entries = list(spec) + [None] * (len(shape) - len(spec))
        cands = [(shape[i], i) for i, e in enumerate(entries)
                 if e is None and self._fits(self.fsdp, shape[i])]
        if not cands:
            return spec
        _, i = max(cands)
        entries[i] = self.fsdp
        return P(*entries)

    # -- per-layer rules ---------------------------------------------------
    def specs_for(self, layer, params: Pytree) -> Pytree:
        """PartitionSpec tree mirroring ``params`` of ``layer``."""
        name = type(layer).__name__
        rule = getattr(self, f"_rule_{name}", None)
        if rule is not None:
            return rule(layer, params)
        return self._generic(layer, params)

    def _generic(self, layer, params):
        """Containers: recurse by matching param keys to child-layer attrs.
        Leaves with no rule: replicated (+ optional fsdp)."""
        from distkeras_tpu_torch.models.core import Layer, Sequential

        if isinstance(layer, Sequential) and isinstance(params, (list, tuple)):
            return [self.specs_for(l, p)
                    for l, p in zip(layer.layers, params)]
        if isinstance(params, dict) and layer is not None:
            out = {}
            for key, sub in params.items():
                child = _child(layer, key)
                if isinstance(child, Layer):
                    out[key] = self.specs_for(child, sub)
                else:
                    out[key] = self._replicated(sub)
            return out
        return self._replicated(params)

    def _replicated(self, tree):
        if isinstance(tree, dict):
            return {k: self._replicated(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [self._replicated(v) for v in tree]
        return self._maybe_fsdp(P(), _shape(tree))

    # Dense [in, units]: column-parallel on units
    def _rule_Dense(self, layer, params):
        out = {}
        if "kernel" in params:
            units = params["kernel"].shape[-1]
            tp = self._tp(units)
            out["kernel"] = self._maybe_fsdp(P(None, tp),
                                             _shape(params["kernel"]))
        if "bias" in params:
            out["bias"] = P(self._tp(params["bias"].shape[-1]))
        return out

    # Conv2D [kh, kw, cin, cout]: shard output channels.
    def _rule_Conv2D(self, layer, params):
        out = {}
        if "kernel" in params:
            cout = params["kernel"].shape[-1]
            tp = self._tp(cout)
            out["kernel"] = self._maybe_fsdp(P(None, None, None, tp),
                                             _shape(params["kernel"]))
        if "bias" in params:
            out["bias"] = P(self._tp(params["bias"].shape[-1]))
        return out

    # Embedding [vocab, d]: shard the model dim.
    def _rule_Embedding(self, layer, params):
        d = params["embeddings"].shape[-1]
        return {"embeddings": self._maybe_fsdp(
            P(None, self._tp(d)), _shape(params["embeddings"]))}

    def _rule_PositionalEmbedding(self, layer, params):
        d = params["embeddings"].shape[-1]
        return {"embeddings": P(None, self._tp(d))}

    # MHA: wq/wk/wv [d, H, Dh] column-parallel on heads; wo [H, Dh, d]
    # row-parallel on heads. GQA: wk/wv carry only kv_heads heads, so
    # their shard decision uses THEIR head count — tp > kv_heads degrades
    # those two to replicated (never an error).
    def _rule_MultiHeadAttention(self, layer, params):
        tp_q = self._tp(params["wq"].shape[1])
        tp_kv = self._tp(params["wk"].shape[1])
        return {
            "wq": self._maybe_fsdp(P(None, tp_q, None),
                                   _shape(params["wq"])),
            "wk": self._maybe_fsdp(P(None, tp_kv, None),
                                   _shape(params["wk"])),
            "wv": self._maybe_fsdp(P(None, tp_kv, None),
                                   _shape(params["wv"])),
            "wo": self._maybe_fsdp(P(tp_q, None, None),
                                   _shape(params["wo"])),
        }

    # Transformer MLP: w1 [d, hidden] column, w2 [hidden, d] row.
    def _rule_TransformerMLP(self, layer, params):
        hidden = params["w1"].shape[-1]
        tp = self._tp(hidden)
        return {
            "w1": self._maybe_fsdp(P(None, tp), _shape(params["w1"])),
            "b1": P(tp),
            "w2": self._maybe_fsdp(P(tp, None), _shape(params["w2"])),
            "b2": P(),
        }

    # MoE: expert-parallel on the expert axis; hidden additionally
    # tp-sharded (the column->row split inside each expert).
    def _rule_MoE(self, layer, params):
        e = params["w1"].shape[0]
        hidden = params["w1"].shape[-1]
        ep, tp = self._ep(e), self._tp(hidden)
        if ep is not None and getattr(layer, "expert_unroll", False):
            warnings.warn(
                "MoE(expert_unroll=True) with GSPMD expert-axis sharding "
                f"(axis {self.ep!r}): per-expert slices of the "
                "expert-sharded stacked weights force cross-shard "
                "resharding collectives every step. Set "
                "expert_unroll=False for GSPMD expert parallelism, or "
                "use shard_map EP (expert_axis_name) where the unroll "
                "is safe.", stacklevel=2)
        return {
            "gate": P(),
            "w1": P(ep, None, tp),
            "b1": P(ep, tp),
            "w2": P(ep, tp, None),
            "b2": P(ep, None),
        }

    # Remat is a transparent wrapper: its params ARE the inner layer's
    def _rule_Remat(self, layer, params):
        return self.specs_for(layer.inner, params)

    # LSTM/GRU: wx [in, G*units], wh [units, G*units]: with units % tp
    # == 0 each gate block shards identically (the valid column split).
    def _rule_LSTM(self, layer, params):
        units = params["wh"].shape[0]
        tp = self._tp(units)
        return {"wx": P(None, tp), "wh": P(None, tp), "b": P(tp)}

    _rule_GRU = _rule_LSTM


def param_specs(module, params: Pytree, mesh,
                tp_axis: Optional[str] = "tp",
                ep_axis: Optional[str] = None,
                fsdp_axis: Optional[str] = None) -> Pytree:
    """PartitionSpec tree for ``params`` of ``module`` (see ShardingRules)."""
    rules = ShardingRules(mesh, tp_axis=tp_axis, ep_axis=ep_axis,
                          fsdp_axis=fsdp_axis)
    return rules.specs_for(module, params)


def named_shardings(spec_tree: Pytree, mesh) -> Pytree:
    return map_specs(lambda s: NamedSharding(mesh, s), spec_tree)


# --- blocks of a leaf ---------------------------------------------------------


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _spec_of(s) -> PartitionSpec:
    return s.spec if isinstance(s, NamedSharding) else s


def block_counts(spec, mesh, ndim: int) -> Tuple[int, ...]:
    """The number of blocks of each of ``ndim`` dimensions."""
    spec = _spec_of(spec)
    return tuple(_axis_size(mesh, _names(spec[d]) or None)
                 if d < len(spec) else 1 for d in range(ndim))


def block_index(spec, mesh, ndim: int) -> Tuple[int, ...]:
    """This rank's block of each dimension (the first name major)."""
    from distkeras_tpu_torch.parallel.collectives import _block
    spec = _spec_of(spec)
    return tuple(_block(mesh, _names(spec[d]) if d < len(spec) else ())[0]
                 for d in range(ndim))


def block_ranges(spec, mesh, global_shape) -> Tuple[Tuple[int, int], ...]:
    """``((lo, hi), ...)``: this rank's block of a leaf of
    ``global_shape``."""
    counts = block_counts(spec, mesh, len(global_shape))
    index = block_index(spec, mesh, len(global_shape))
    out = []
    for dim, n, i in zip(global_shape, counts, index):
        if dim % n:
            raise ValueError(f"dimension of size {dim} does not split "
                             f"into {n} blocks")
        step = dim // n
        out.append((i * step, (i + 1) * step))
    return tuple(out)


def is_replica_zero(spec, mesh) -> bool:
    """Whether this rank holds the first copy of its block: its index is
    0 on every mesh axis the spec does not name."""
    used = {n for e in _spec_of(spec) for n in _names(e)}
    return all(mesh.axis_index(a) == 0 for a in mesh.axis_names
               if a not in used)


def local_block(x, spec, mesh):
    """This rank's block of the full leaf ``x`` (a tensor or an array)."""
    ranges = block_ranges(spec, mesh, _shape(x))
    return x[tuple(slice(lo, hi) for lo, hi in ranges)]


def shard_params(params: Pytree, spec_tree: Pytree, mesh) -> Pytree:
    """This rank's block of every leaf of the full tree ``params``, as new
    tensors on the mesh's device (leaves that require grad keep
    requiring it): the rank's part of JAX's ``device_put`` by the spec
    tree."""
    def place(spec, x):
        t = x.detach() if torch.is_tensor(x) else torch.from_numpy(
            np.ascontiguousarray(x))
        out = local_block(t, spec, mesh).to(mesh.device).clone() \
            .contiguous()
        if torch.is_tensor(x) and x.requires_grad:
            out.requires_grad_(True)
        return out
    return map_specs(place, spec_tree, params)


def gather_params(local: Pytree, spec_tree: Pytree, mesh) -> Pytree:
    """The full tree from every rank's blocks (a collective: every rank
    of the mesh calls it), detached."""
    from distkeras_tpu_torch.parallel.collectives import _global
    with mesh:
        return map_specs(lambda s, x: _global(x.detach().contiguous(),
                                              _spec_of(s), mesh),
                         spec_tree, local)


# --- the placement of a sharded step -----------------------------------------


class Placement:
    """How a sharded step computes on this rank: the mesh, the tensor-
    parallel axis the attention and MLP layers split over (None: none),
    and the data axes the batch is sharded over (the first major)."""

    def __init__(self, mesh, tp_axis: Optional[str] = None,
                 data_axes: Sequence[str] = ()):
        self.mesh = mesh
        self.tp_axis = tp_axis if tp_axis in mesh.shape else None
        self.data_axes = tuple(data_axes)

    def data_block(self) -> Tuple[int, int]:
        """``(index, count)`` of this rank's rows over the data axes."""
        from distkeras_tpu_torch.parallel.collectives import _block
        return _block(self.mesh, self.data_axes)


_PLACEMENTS: List[Placement] = []


def current_placement() -> Optional[Placement]:
    return _PLACEMENTS[-1] if _PLACEMENTS else None


@contextlib.contextmanager
def placed(placement: Placement):
    """Make ``placement`` (and its mesh) current for the block."""
    _PLACEMENTS.append(placement)
    try:
        with placement.mesh:
            yield placement
    finally:
        _PLACEMENTS.remove(placement)


def tensor_parallel_axis(local: int, full: int, what: str) -> Optional[str]:
    """The axis a layer's ``what`` dimension is split over: None when the
    parameter block holds all ``full`` of it, the current placement's
    tensor-parallel axis when it holds ``full / tp``."""
    if int(local) == int(full):
        return None
    placement = current_placement()
    tp = placement.tp_axis if placement is not None else None
    if tp is None or int(local) * placement.mesh.axis_size(tp) != int(full):
        raise ValueError(
            f"a parameter block holds {local} of the layer's {full} {what}"
            " outside a tensor-parallel placement that splits them "
            "(parallel.sharding.placed)")
    return tp


def _data_split() -> Optional[Placement]:
    placement = current_placement()
    if placement is None or placement.data_block()[1] == 1:
        return None
    return placement


def data_rows() -> Optional[Tuple[int, int]]:
    """``(index, count)`` of this rank's rows of the global batch under a
    placement that shards it, else None."""
    placement = _data_split()
    return None if placement is None else placement.data_block()


def data_summer():
    """The sum over the current placement's data axes of a value each
    rank computes from its own rows (BatchNorm's moments and its
    backward's two sums), bound to that placement so that a backward
    that runs after the block can call it; None without a data split."""
    placement = _data_split()
    if placement is None:
        return None

    def total(x: torch.Tensor) -> torch.Tensor:
        from distkeras_tpu_torch.parallel.collectives import _psum
        with placement.mesh:
            for name in placement.data_axes:
                x = _psum(x.contiguous(), name)
        return x

    return total


def data_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the data axes, for a downstream that every
    rank computes whole (a loss term from batch means, the MoE balance
    loss): each rank keeps its own part of the gradient. The identity
    without a data split."""
    placement = _data_split()
    if placement is None:
        return x
    from distkeras_tpu_torch.parallel.collectives import reduce_out
    for name in placement.data_axes:
        x = reduce_out(x, name)
    return x / placement.data_block()[1]


class _GatherRows(torch.autograd.Function):
    """The global batch from every rank's rows (forward), this rank's
    rows of a copied cotangent (backward)."""

    @staticmethod
    def forward(ctx, x, placement):
        from distkeras_tpu_torch.parallel.collectives import _global
        ctx.rows = (x.shape[0],) + placement.data_block()
        with placement.mesh:
            return _global(x.contiguous(), P(placement.data_axes),
                           placement.mesh)

    @staticmethod
    def backward(ctx, g):
        n, index, _ = ctx.rows
        return g.narrow(0, index * n, n).contiguous(), None


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The rows of every rank of the data axes, in order (the global
    batch), from this rank's; the identity without a data split. The
    step takes its loss and metrics on it; each rank's backward keeps
    its own rows."""
    placement = _data_split()
    if placement is None:
        return x
    return _GatherRows.apply(x, placement)


class _UseParams(torch.autograd.Function):
    """Every leaf as the step uses it (forward): gathered over the axes in
    its plan, the tensor-parallel blocks kept. Backward: each rank's
    block of the gradient (a reduce-scatter where the gather ran over a
    data axis, a slice of the copy otherwise), then summed over the
    data axes the gathers did not cover, in one flat buffer per dtype
    and set of axes."""

    @staticmethod
    def forward(ctx, plan, *leaves):
        from distkeras_tpu_torch.parallel.collectives import _gather
        ctx.plan = plan
        ctx.shapes = [tuple(x.shape) for x in leaves]
        out = []
        with plan.mesh:
            for x, gathers in zip(leaves, plan.gathers):
                if not gathers:
                    out.append(x.view_as(x))
                    continue
                y = x.detach()
                for dim, name in gathers:
                    y = _gather(y.contiguous(), name, dim, True)
                out.append(y)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        from distkeras_tpu_torch.parallel.collectives import (_psum_many,
                                                              _scatter)
        plan = ctx.plan
        mesh = plan.mesh
        data = set(plan.data_axes)
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        pending: Dict[Tuple[str, ...], List[int]] = {}
        with mesh:
            for i, (g, gathers) in enumerate(zip(grads, plan.gathers)):
                if g is None:
                    g = torch.zeros(plan.use_shapes[i], dtype=plan.dtypes[i],
                                    device=mesh.device)
                summed = set()
                for dim, name in reversed(gathers):
                    if name in data:
                        # contributions: this rank's block of their sum
                        g = _scatter(g.contiguous(), name, dim)
                        summed.add(name)
                        continue
                    # copies: this rank's block
                    step = g.shape[dim] // mesh.axis_size(name)
                    g = g.narrow(dim, mesh.axis_index(name) * step, step)
                out[i] = g.contiguous()
                rest = tuple(a for a in plan.data_axes if a not in summed
                             and mesh.axis_size(a) > 1)
                if rest:
                    pending.setdefault(rest, []).append(i)
            for axes, idx in pending.items():
                xs = [out[i] for i in idx]
                for name in axes:
                    xs = _psum_many(xs, name)
                for i, x in zip(idx, xs):
                    out[i] = x
        return (None,) + tuple(out)


class UsePlan:
    """What ``use_params`` does to each leaf of a flat list: its gathers
    ``[(dim, axis), ...]`` in order, and the data axes its gradient is
    summed over."""

    def __init__(self, mesh, gathers, data_axes, use_shapes, dtypes):
        self.mesh = mesh
        self.gathers = gathers
        self.data_axes = tuple(data_axes)
        self.use_shapes = use_shapes
        self.dtypes = dtypes


#: the layers whose tensor-parallel leaves stay where they lie (Megatron),
#: by class name: the leaves they compute on locally
_MEGATRON = {"MultiHeadAttention": ("wq", "wk", "wv", "wo"),
             "TransformerMLP": ("w1", "b1", "w2")}


def _keep_local(module, specs, tp) -> Pytree:
    """A tree over ``specs``: for each leaf, the tensor-parallel axis it
    keeps (a Megatron leaf split over ``tp``) or None."""
    from distkeras_tpu_torch.models.core import Layer, Sequential

    def none(tree):
        return map_specs(lambda s: None, tree)

    def walk(layer, sp):
        name = type(layer).__name__
        if name == "Remat":
            return walk(layer.inner, sp)
        if name in _MEGATRON and isinstance(sp, dict):
            return {k: (tp if tp is not None and k in _MEGATRON[name]
                        and tp in {n for e in _spec_of(v) for n in _names(e)}
                        else None) for k, v in sp.items()}
        if isinstance(layer, Sequential) and isinstance(sp, (list, tuple)):
            return [walk(l, s) for l, s in zip(layer.layers, sp)]
        if isinstance(sp, dict):
            out = {}
            for k, v in sp.items():
                child = _child(layer, k)
                out[k] = walk(child, v) if isinstance(child, Layer) \
                    else none(v)
            return out
        return none(sp)

    return walk(module, specs)


def use_plan(module, specs, local_leaves, placement: Placement) -> UsePlan:
    """The ``UsePlan`` of a module's flat local leaves under ``specs``."""
    mesh = placement.mesh
    keep = []
    map_specs(lambda s, k: keep.append(k), specs,
              _keep_local(module, specs, placement.tp_axis))
    gathers, use_shapes = [], []
    for spec, kept, x in zip(spec_leaves(specs), keep, local_leaves):
        g, shape = [], list(x.shape)
        spec = _spec_of(spec)
        for dim in reversed(range(len(spec))):
            for name in reversed(_names(spec[dim])):
                if name == kept or mesh.axis_size(name) == 1:
                    continue
                g.append((dim, name))
                shape[dim] *= mesh.axis_size(name)
        gathers.append(g)
        use_shapes.append(tuple(shape))
    return UsePlan(mesh, gathers, placement.data_axes, use_shapes,
                   [x.dtype for x in local_leaves])


def use_params(plan: UsePlan, local_leaves: Sequence[torch.Tensor]):
    """The leaves as the step uses them (``_UseParams``): differentiable
    with respect to the local blocks."""
    return list(_UseParams.apply(plan, *local_leaves))
