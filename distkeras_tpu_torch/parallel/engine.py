"""The distributed-SGD engine of the port: ``W`` workers stacked on one
device, a center, and each algorithm's commit protocol.

Mirrors ``distkeras_tpu/parallel/engine.py``. There, each worker is a
mesh position under ``shard_map`` and a worker leaf has shape ``[W,
...]`` across the mesh (``init_state`` :444). The port keeps that
layout on one device:

* every worker leaf (parameters, optimizer state, pull snapshot,
  algorithm extras) is ONE tensor with a leading worker axis; the center
  and the server's aux state are unstacked (``init_state``);
* a micro-step runs each worker's ``worker.make_train_step`` in turn, in
  worker order, on views of its rows (``WorkerStack``): the optimizer's
  in-place update writes into the stack;
* worker ``i`` draws with key ``i`` of ``prng.split(PRNGKey(seed), W)``
  (JAX :454), so a model with ``Dropout`` draws JAX's masks;
* a commit is tensor ops over the worker axis: the committing rows'
  contributions against the PRE-step center, summed over the worker axis
  (JAX's ``lax.psum`` of the masked contributions: a worker whose mask
  is 0 adds zeros), then ONE ``server_update`` and the committers'
  ``worker_post``. Workers that commit on the same micro-step are
  summed, not serialized, exactly as the psum does (ADAG squares the
  sum, :285).

Worker ``i`` commits at global micro-step ``t`` where ``(t + 1 +
offset_i) % K_i == 0``. The mask depends only on host integers (the step
counter and the offsets), so it is computed on the host and an epoch
makes no host sync. On a step where no worker commits, every
``server_update`` is an exact no-op (DOWNPOUR, ADAG and the elastic
rule add zeros, DynSGD's clock adds 0, averaging keeps the old center),
so the engine skips that step's commit work.

Both epoch programs of JAX are here: the per-step masked path
(``_make_inner_perstep`` :630) and, for a uniform window and an
amortizable algorithm, the two-level amortized path
(``_make_inner_amortized`` :521: worker ``i`` snapshots its parameters
at local step ``(K - 1 - offset_i) mod K`` of a block, every worker
commits its snapshot at the block boundary, and the tail carry
``params := post_commit + (params_now - snapshot)`` keeps the steps
taken after the snapshot; a remainder block truncates the final window).
With nonzero offsets the two give different trajectories, as in JAX.
``server_updates`` counts the commits that ran (``ceil(S / K)`` an
amortized epoch: JAX's count of param-sized all-reduces).

Model state (BatchNorm's running statistics) is a worker leaf too:
``init_state`` stacks it ``[W, ...]`` (JAX :444-463), each worker's
training forward writes its own rows in place, the commits never touch
it (the center's state does not advance, as in JAX), and
``extract_model`` returns the workers' mean of each float state leaf
(worker 0's value for an integer one, JAX :718-726) beside the flushed
center. The JAX engine's span and recompile detector (``obs``) are
ROADMAP Queue 1 item 11 and not ported. Batching the workers into one
launch per layer is later work (ROADMAP Queue 2).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from distkeras_tpu_torch.ops import prng
from distkeras_tpu_torch.ops.optimizers import Optimizer
from distkeras_tpu_torch.parallel.worker import TrainCarry, make_train_step
from distkeras_tpu_torch.utils.tree import tree_leaves, tree_map

#: the multi-device half of the family's ROADMAP item, named in errors
MESH_ITEM = ("ROADMAP, Queue 1 item 10 'The paper's distributed-SGD "
             "family' (its multi-device half: a mesh of cards)")


def host_fetch(tree):
    """The tree with every tensor copied to the host (``.cpu()``): the
    epoch loops' one device-to-host read, at the epoch's end."""
    return tree_map(
        lambda x: x.detach().cpu() if torch.is_tensor(x) else x, tree)


def _take(x: torch.Tensor, rows: Sequence[int]) -> torch.Tensor:
    """Rows ``rows`` (ascending worker ids) of a stacked leaf: a view when
    they are contiguous, else a stacked copy."""
    lo, hi = rows[0], rows[-1] + 1
    if hi - lo == len(rows):
        return x[lo:hi]
    return torch.stack([x[i] for i in rows])


def _put(x: torch.Tensor, rows: Sequence[int], value: torch.Tensor):
    """Write ``value`` (``[len(rows), ...]``, or one row to broadcast)
    into rows ``rows`` of the stacked leaf ``x``, in place."""
    lo, hi = rows[0], rows[-1] + 1
    if hi - lo == len(rows):
        x[lo:hi].copy_(value)
        return
    stacked = value.dim() == x.dim()
    for j, i in enumerate(rows):
        x[i].copy_(value[j] if stacked else value)


def _expand(center, like):
    """The center broadcast over the committing rows of ``like``."""
    return tree_map(lambda c, x: c.expand_as(x), center, like)


def _per_row(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A ``[m]`` vector shaped to scale the rows of ``[m, ...]`` ``x``."""
    return v.reshape((-1,) + (1,) * (x.dim() - 1))


# ---------------------------------------------------------------------------
# Algorithms (JAX :137-368). Unlike JAX's per-worker functions under
# shard_map, these take the COMMITTING rows ([m, ...] views of the
# stacks) and no mask: the engine applies worker_post to committers
# only, which is what JAX's masked select computes.
# ---------------------------------------------------------------------------

class DistAlgorithm:
    """Commit/serve behaviour of one distributed SGD variant:
    ``contrib``/``worker_post`` are the worker side, ``server_update``
    the parameter server's handler."""

    #: async emulation (staggered offsets) vs synchronous barrier rounds
    staggered: bool = True
    #: whether workers track a pull-time snapshot of the center
    needs_pull: bool = False
    #: False: per-commit serialization through the center is the
    #: algorithm (DynSGD's staleness, ADAG's accumulator)
    amortizable: bool = True

    def init_server(self, params) -> Dict:
        return {}

    def init_worker_extras(self, num_workers: int, device) -> Dict:
        return {}

    def contrib(self, w, pull, center, server, extras):
        """The committing rows' payloads (``[m, ...]``), e.g. a delta or
        an elastic difference, against the pre-step ``center``."""
        raise NotImplementedError

    def server_update(self, center, server, total, n_commits: float):
        """Apply the sum of the contributions to the center; returns
        ``(center, server)``."""
        raise NotImplementedError

    def worker_post(self, w, pull, contrib, new_center, new_server,
                    extras):
        """The committing rows after their commit: ``(w, pull, extras)``
        (pull the fresh center, subtract the elastic term, ...)."""
        return w, pull, extras

    def finalize(self, center, workers, pulls, num_workers: int):
        """The flush after the last epoch (uncommitted residuals)."""
        return center


@dataclass
class DownpourAlgo(DistAlgorithm):
    """DOWNPOUR: commit the accumulated delta, pull a fresh center;
    ``commit_scale`` scales the committed deltas (JAX :185)."""
    commit_scale: float = 1.0
    staggered: bool = True
    needs_pull: bool = True

    def contrib(self, w, pull, center, server, extras):
        return tree_map(lambda x, p: (x - p) * self.commit_scale, w, pull)

    def server_update(self, center, server, total, n_commits):
        return tree_map(torch.add, center, total), server

    def worker_post(self, w, pull, contrib, new_center, new_server,
                    extras):
        return _expand(new_center, w), _expand(new_center, pull), extras

    def finalize(self, center, workers, pulls, n):
        # flush each worker's uncommitted delta into the center
        return tree_map(lambda c, w, p: c + (w - p).sum(0) * self.commit_scale,
                        center, workers, pulls)


@dataclass
class ElasticAlgo(DistAlgorithm):
    """EASGD family: ``e_i = alpha * (x_i - center)``; the worker does
    ``x_i -= e_i`` and the center accumulates ``+e_i`` (``center_mode
    "mean"`` divides by the committers; JAX :217)."""
    alpha: float = 0.1
    synchronous: bool = False
    center_mode: str = "sum"
    needs_pull: bool = False

    def __post_init__(self):
        self.staggered = not self.synchronous

    def contrib(self, w, pull, center, server, extras):
        return tree_map(lambda x, c: self.alpha * (x - c), w, center)

    def server_update(self, center, server, total, n_commits):
        if self.center_mode == "mean":
            denom = max(n_commits, 1.0)
            total = tree_map(lambda t: t / denom, total)
        return tree_map(torch.add, center, total), server

    def worker_post(self, w, pull, contrib, new_center, new_server,
                    extras):
        return tree_map(lambda x, e: x - e, w, contrib), pull, extras


@dataclass
class AdagAlgo(DistAlgorithm):
    """ADAG: ``acc += delta^2``, ``center += lr * delta / (sqrt(acc) +
    eps)`` over the summed commits (JAX :256). Not amortizable."""
    adag_lr: float = 0.05
    epsilon: float = 1e-8
    commit_scale: float = 1.0
    staggered: bool = True
    needs_pull: bool = True
    amortizable: bool = False

    def init_server(self, params):
        return {"acc": tree_map(torch.zeros_like, params)}

    def contrib(self, w, pull, center, server, extras):
        return tree_map(lambda x, p: (x - p) * self.commit_scale, w, pull)

    def server_update(self, center, server, total, n_commits):
        acc = tree_map(lambda a, t: a + t.square(), server["acc"], total)
        center = tree_map(
            lambda c, t, a: c + self.adag_lr * t / (torch.sqrt(a)
                                                    + self.epsilon),
            center, total, acc)
        return center, {"acc": acc}

    def worker_post(self, w, pull, contrib, new_center, new_server,
                    extras):
        return _expand(new_center, w), _expand(new_center, pull), extras


@dataclass
class DynSGDAlgo(DistAlgorithm):
    """DynSGD: a commit's delta is scaled by 1/staleness, staleness =
    center updates since the worker's last pull (JAX :300). The clock
    and the last pulls are int32 device tensors, the staleness float32,
    as in JAX. Not amortizable."""
    staggered: bool = True
    needs_pull: bool = True
    amortizable: bool = False

    def init_server(self, params):
        device = tree_leaves(params)[0].device
        return {"clock": torch.zeros((), dtype=torch.int32, device=device)}

    def init_worker_extras(self, num_workers, device):
        return {"last_pull": torch.zeros((num_workers,), dtype=torch.int32,
                                         device=device)}

    def contrib(self, w, pull, center, server, extras):
        staleness = torch.clamp(server["clock"] - extras["last_pull"] + 1,
                                min=1).to(torch.float32)
        return tree_map(lambda x, p: (x - p) / _per_row(staleness, x),
                        w, pull)

    def server_update(self, center, server, total, n_commits):
        clock = server["clock"] + int(n_commits)
        return tree_map(torch.add, center, total), {"clock": clock}

    def worker_post(self, w, pull, contrib, new_center, new_server,
                    extras):
        last = new_server["clock"].expand_as(extras["last_pull"])
        return (_expand(new_center, w), _expand(new_center, pull),
                {"last_pull": last})


@dataclass
class AveragingAlgo(DistAlgorithm):
    """Per-round weight averaging: center := mean of the committers'
    parameters; they restart from it (JAX :342)."""
    staggered = False
    needs_pull = False

    def contrib(self, w, pull, center, server, extras):
        return w

    def server_update(self, center, server, total, n_commits):
        if n_commits <= 0:
            return center, server
        denom = max(n_commits, 1.0)
        return tree_map(lambda t: t / denom, total), server

    def worker_post(self, w, pull, contrib, new_center, new_server,
                    extras):
        return _expand(new_center, w), pull, extras

    def finalize(self, center, workers, pulls, n):
        return tree_map(lambda w: w.mean(0), workers)


# ---------------------------------------------------------------------------
# Stacked workers
# ---------------------------------------------------------------------------

def stacked_opt_init(optimizer: Optimizer, params, out=None):
    """``optimizer.init`` of every row of the stacked ``params`` (JAX's
    ``vmap(optimizer.init)``), stacked on the worker axis; with ``out``
    (a stacked state) written into it in place. Rows are initialized one
    at a time, so no more than one row's state is held twice."""
    n = tree_leaves(params)[0].shape[0]
    for i in range(n):
        row = optimizer.init(tree_map(lambda s: s[i], params))
        if out is None:
            out = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), row)
        tree_map(lambda o, x: o[i].copy_(x), out, row)
    return out


class WorkerStack:
    """``W`` replicas of one parameter tree (and model state tree),
    stacked on a leading worker axis on one device, each trained by
    ``train_step`` on views of its rows: the step's in-place parameter
    update and its training forward's state write go into the stack, and
    its new optimizer state and key are copied into their rows.

    The views are detached leaves that share the stack's storage, so
    autograd differentiates each worker's own rows and nothing else."""

    def __init__(self, train_step: Callable, params, opt_state, rng=None,
                 state=None):
        self.train_step = train_step
        self.params, self.opt_state, self.rng = params, opt_state, rng
        self.num_workers = tree_leaves(params)[0].shape[0]
        self.views = [
            tree_map(lambda s: s[i].detach().requires_grad_(True), params)
            for i in range(self.num_workers)]
        self.state_views = [
            None if state is None else tree_map(lambda s: s[i], state)
            for i in range(self.num_workers)]

    def step(self, i: int, xb, yb):
        """One training step of worker ``i`` on ``(xb, yb)``; returns the
        step's output (the loss, or ``(loss, metrics)``) on the device."""
        carry = TrainCarry(self.views[i],
                           tree_map(lambda s: s[i], self.opt_state),
                           None if self.rng is None else self.rng[i],
                           self.state_views[i])
        carry, out = self.train_step(carry, (xb, yb))
        with torch.no_grad():
            tree_map(lambda s, v: s[i].copy_(v), self.opt_state,
                     carry.opt_state)
            if self.rng is not None:
                self.rng[i].copy_(carry.rng)
        return out


def stack_outputs(outs: List[List]):
    """Per-step, per-worker step outputs -> ``losses [S, W]`` or
    ``(losses, {name: [S, W]})``, stacked on the device."""
    losses = torch.stack([torch.stack([o[0] if isinstance(o, tuple) else o
                                       for o in row]) for row in outs])
    first = outs[0][0]
    if not isinstance(first, tuple):
        return losses
    mets = {k: torch.stack([torch.stack([o[1][k] for o in row])
                            for row in outs]) for k in first[1]}
    return losses, mets


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

@dataclass
class EngineConfig:
    num_workers: int
    window: Union[int, Sequence[int]]  # K, scalar or per-worker
    #: None = auto (two-level amortized epoch when the window is uniform
    #: and the algorithm amortizable, per-step masked path otherwise).
    #: False forces the per-step path.
    amortized: Optional[bool] = None


class DistributedEngine:
    """Runs the epochs of one algorithm over ``W`` stacked workers.
    ``mesh`` must be None: the multi-device half is a later slice."""

    def __init__(self, module, loss_fn: Callable, optimizer: Optimizer,
                 algo: DistAlgorithm, mesh, config: EngineConfig,
                 metric_fns: Optional[Dict[str, Callable]] = None,
                 param_mask=None, state_mask=None):
        if mesh is not None:
            raise NotImplementedError(
                f"a device mesh is not ported yet (the port stacks the "
                f"workers on one card): {MESH_ITEM}")
        self.module = module
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.algo = algo
        self.config = config
        self.metric_fns = metric_fns
        self.train_step = make_train_step(module, loss_fn, optimizer,
                                          metric_fns, param_mask=param_mask,
                                          state_mask=state_mask)

        n = config.num_workers
        K = config.window
        Ks = np.full((n,), K, np.int64) if np.isscalar(K) \
            else np.asarray(K, np.int64)
        if Ks.shape != (n,):
            raise ValueError(f"window must be scalar or length-{n}")
        if algo.staggered:
            offsets = (np.arange(n) * Ks) // n
        else:
            offsets = np.zeros((n,), np.int64)
        self._Ks = Ks
        self._offsets = offsets % np.maximum(Ks, 1)
        uniform = bool((Ks == Ks[0]).all())
        if config.amortized and not uniform:
            raise ValueError(
                "amortized=True requires a uniform window; per-worker "
                f"windows {Ks.tolist()} need the per-step path")
        if config.amortized and not algo.amortizable:
            raise ValueError(
                f"{type(algo).__name__} is not amortizable (needs "
                "per-commit serialization through the center)")
        self.amortized = (uniform and algo.amortizable) \
            if config.amortized is None else bool(config.amortized)
        if (config.amortized is None and self.amortized
                and bool((offsets != 0).any())):
            # auto-amortization changes staggered-async trajectories:
            # all workers commit at block boundaries
            warnings.warn(
                "amortized two-level scan auto-enabled with nonzero "
                "stagger offsets: commit interleaving differs from the "
                "per-step path (same fixed point, different trajectory); "
                "pass amortized=False to reproduce per-step numerics",
                stacklevel=3)
        self._uniform_K = int(Ks[0]) if uniform else None
        #: commits that ran (server updates) and worker commits in them
        self.server_updates = 0
        self.worker_commits = 0

    # -- state ------------------------------------------------------------
    def init_state(self, params, rng, model_state=None) -> Dict:
        """The center + stacked-worker state: ``params`` (a parameter
        tree) copied into the center and into every worker's row, the
        model state tree (BatchNorm's statistics; None or empty for a
        stateless model) likewise, the optimizer's state per row, worker
        ``i``'s key ``split(rng, W)[i]``."""
        n = self.config.num_workers
        with torch.no_grad():
            center = tree_map(lambda x: x.detach().clone(), params)
            mstate = tree_map(lambda x: x.detach().clone(),
                              [] if model_state is None else model_state)
            device = tree_leaves(center)[0].device

            def stack(tree):
                return tree_map(lambda x: x.unsqueeze(0).repeat(
                    (n,) + (1,) * x.dim()), tree)

            wparams = stack(center)
            worker = {
                "params": wparams,
                "state": stack(mstate),
                "opt": stacked_opt_init(self.optimizer, wparams),
                "rng": prng.split(prng.as_key(rng, device), n),
                "pull": stack(center) if self.algo.needs_pull else {},
                "extras": self.algo.init_worker_extras(n, device),
            }
        server = {"aux": self.algo.init_server(center),
                  "t": 0}  # the global micro-step counter (host int)
        return {"worker": worker,
                "center": {"params": center, "state": mstate},
                "server": server}

    @torch.no_grad()
    def reset_workers(self, state: Dict) -> Dict:
        """Re-initialize every worker from the CURRENT center (params,
        pull snapshot, optimizer state, extras), in place; the center,
        server aux, step counter and worker keys carry on (JAX :466: the
        reference's task boundary, used by ``parallelism_factor > 1``)."""
        n = self.config.num_workers
        worker = state["worker"]
        center = state["center"]["params"]
        tree_map(lambda s, c: s.copy_(c.expand_as(s)), worker["params"],
                 center)
        stacked_opt_init(self.optimizer, worker["params"], worker["opt"])
        if self.algo.needs_pull:
            tree_map(lambda s, c: s.copy_(c.expand_as(s)), worker["pull"],
                     center)
        fresh = self.algo.init_worker_extras(n, tree_leaves(center)[0].device)
        tree_map(lambda s, v: s.copy_(v), worker["extras"], fresh)
        return state

    # -- commits ------------------------------------------------------------
    @torch.no_grad()
    def _commit(self, state: Dict, rows: List[int], snap=None) -> None:
        """One server update from the workers ``rows``: their
        contributions (of ``snap``'s rows when given, the amortized
        snapshot, else of their live parameters) against the pre-step
        center, summed over the worker axis, then ``server_update`` and
        their ``worker_post``; with ``snap`` the tail carry ``params :=
        post + (params - snap)``."""
        algo, worker = self.algo, state["worker"]
        params = worker["params"]

        def sel(tree):
            return tree_map(lambda s: _take(s, rows), tree)

        w = sel(params if snap is None else snap)
        pull, extras = sel(worker["pull"]), sel(worker["extras"])
        center = state["center"]["params"]
        aux = state["server"]["aux"]
        contrib = algo.contrib(w, pull, center, aux, extras)
        total = tree_map(lambda c: c.sum(0), contrib)
        new_center, new_aux = algo.server_update(center, aux, total,
                                                 float(len(rows)))
        post, new_pull, new_extras = algo.worker_post(
            w, pull, contrib, new_center, new_aux, extras)
        if snap is not None:
            post = tree_map(lambda q, s, p: q + (p - s), post, w,
                            sel(params))
        tree_map(lambda s, v: _put(s, rows, v), params, post)
        tree_map(lambda s, v: _put(s, rows, v), worker["pull"], new_pull)
        tree_map(lambda s, v: _put(s, rows, v), worker["extras"], new_extras)
        state["center"]["params"] = new_center
        state["server"]["aux"] = new_aux
        self.server_updates += 1
        self.worker_commits += len(rows)

    # -- epochs ---------------------------------------------------------------
    def _epoch_perstep(self, state, stack, Xs, Ys):
        """Per-micro-step masked commits (JAX :630): exact fine-grained
        commit interleaving; the window phase carries across epochs."""
        n = self.config.num_workers
        gt = state["server"]["t"]
        outs = []
        for s in range(Xs.shape[0]):
            outs.append([stack.step(i, Xs[s, i], Ys[s, i]) for i in range(n)])
            rows = [i for i in range(n)
                    if (gt + 1 + int(self._offsets[i]))
                    % max(int(self._Ks[i]), 1) == 0]
            if rows:  # no committer: every server_update is a no-op
                self._commit(state, rows)
            gt += 1
        state["server"]["t"] = gt
        return outs

    def _epoch_amortized(self, state, stack, Xs, Ys):
        """Two-level epoch (JAX :521): blocks of K local steps, one
        commit of every worker's snapshot per block (``ceil(S / K)`` an
        epoch); the window phase restarts each epoch and a remainder
        block truncates the last window."""
        n = self.config.num_workers
        K = self._uniform_K
        S = Xs.shape[0]
        params = state["worker"]["params"]
        # the local step of a block at which worker i takes its commit
        # snapshot: solves (lt + 1 + offset_i) % K == 0
        snap_step = (K - 1 - self._offsets) % K
        outs, buf = [], None
        for lo in range(0, S, K):
            L = min(K, S - lo)
            # a short remainder block clamps the snapshot to its last step
            target = np.minimum(snap_step, L - 1)
            # a snapshot at a block's last step IS the live parameters
            # (tail 0): only an earlier one needs a copy, into a stack the
            # epoch allocates once
            snap = None
            if (target != L - 1).any():
                if buf is None:
                    buf = tree_map(torch.empty_like, params)
                snap = buf
            for lt in range(L):
                row = []
                for i in range(n):
                    row.append(stack.step(i, Xs[lo + lt, i], Ys[lo + lt, i]))
                    if snap is not None and lt == target[i]:
                        with torch.no_grad():
                            tree_map(lambda b, p: b[i].copy_(p[i]), snap,
                                     params)
                outs.append(row)
            self._commit(state, list(range(n)), snap)
        state["server"]["t"] += S
        return outs

    def run_epoch(self, state: Dict, Xs, Ys):
        """Run ``S`` micro-steps of every worker over ``Xs``/``Ys`` of
        ``[S, W, batch, ...]`` (tensors on the state's device, or numpy
        arrays, moved there first). Returns ``(state, outs)``: the state
        updated in place, and the per-step losses ``[S, W]`` (or
        ``(losses, {name: [S, W]})`` with metrics) on the device."""
        worker = state["worker"]
        device = tree_leaves(worker["params"])[0].device
        Xs, Ys = (torch.from_numpy(np.asarray(a)).to(device)
                  if not torch.is_tensor(a) else a for a in (Xs, Ys))
        stack = WorkerStack(self.train_step, worker["params"],
                            worker["opt"], worker["rng"], worker["state"])
        outs = (self._epoch_amortized if self.amortized
                else self._epoch_perstep)(state, stack, Xs, Ys)
        return state, stack_outputs(outs)

    # -- final model ------------------------------------------------------
    @torch.no_grad()
    def extract_model(self, state: Dict):
        """The final ``(params, model_state)`` on the state's device (JAX
        :711): the algorithm-flushed center and ``mean_state`` of the
        workers' model state."""
        worker = state["worker"]
        center = self.algo.finalize(state["center"]["params"],
                                    worker["params"], worker["pull"],
                                    self.config.num_workers)
        return center, mean_state(worker["state"])


def mean_state(stacked):
    """A ``[W, ...]`` model state tree averaged over the workers: the
    mean of each float leaf, worker 0's value of an integer leaf (a
    counter; JAX :718-726)."""
    return tree_map(lambda s: s.mean(0) if s.is_floating_point()
                    else s[0].clone(), stacked)
