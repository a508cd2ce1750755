"""True-async training: a thread per worker against a host parameter
server.

Mirrors ``distkeras_tpu/parallel/async_host.py``: ``HostAsyncTrainer``
(:43) with ``_worker_loop`` (:111) and ``train`` (:180). One worker is
one Python thread driving its own replica of the model (a copy of the
module on the model's device):

    pull center -> K local steps -> algorithm commit -> repeat

The parameter server applies commits under its mutex, serializing
concurrent arrivals as the reference's socket PS does, over direct
calls (``transport="inprocess"``) or the framed socket protocol
(``"socket"``, ``networking``). Each commit copies the replica's whole
tree to the host, as in JAX. On one card the threads share its default
stream, so the workers' kernels serialize on the card; their host work
(Python, the commits) overlaps. Staleness here comes from wall-clock
races, not the engine's deterministic staggering.

Model state (BatchNorm's statistics) stays on the workers, as in JAX:
each worker starts every epoch from the model's state, and the trained
model (and the validator) takes their mean (``_mean_state``, JAX :172).
A checkpoint holds the center and that mean state (JAX :190-264), and a
resume restarts the workers from the center, as the distributed family
does; callbacks see the same pair, and frozen layers are masked in
every worker's step.
"""

from __future__ import annotations

import copy
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from distkeras_tpu_torch.compat import resolve_device
from distkeras_tpu_torch.models.serialization import jax_state_tree
from distkeras_tpu_torch.ops import prng
from distkeras_tpu_torch.parallel.distributed import default_num_workers
from distkeras_tpu_torch.parallel.engine import mean_state
from distkeras_tpu_torch.parallel.parameter_servers import (
    ADAGParameterServer, DeltaParameterServer, DynSGDParameterServer,
    EASGDParameterServer, ParameterServer, PSClient, to_numpy)
from distkeras_tpu_torch.parallel.trainers import (Trainer, epoch_exit,
                                                   host_tree, load_params)
from distkeras_tpu_torch.parallel.worker import (TrainCarry, make_train_step,
                                                 shard_epoch_data)
from distkeras_tpu_torch.utils.tree import (tree_leaves, tree_map,
                                            tree_unflatten)

_ALGORITHMS = ("downpour", "easgd", "dynsgd", "adag")


class HostAsyncTrainer(Trainer):
    """Asynchronous PS training with real thread-level concurrency.

    ``algorithm``: ``"downpour"`` (commit the accumulated delta, pull a
    fresh center), ``"easgd"`` (elastic exchange at the worker's own
    cadence), ``"dynsgd"`` (delta tagged with the last-pull clock, scaled
    by 1/staleness on the server), ``"adag"`` (delta, adaptive server
    rule). ``communication_window`` may be per-worker (a list of K_i).
    ``num_workers=None`` is the device count of the model's device type,
    as in the engine family.
    """

    def __init__(self, keras_model, algorithm: str = "downpour",
                 num_workers: Optional[int] = None,
                 communication_window: Union[int, Sequence[int]] = 5,
                 rho: float = 5.0, elastic_lr: float = 0.01,
                 adag_learning_rate: float = 0.05,
                 transport: str = "inprocess", **kwargs):
        super().__init__(keras_model, **kwargs)
        if algorithm not in _ALGORITHMS:
            raise ValueError(f"algorithm must be one of {_ALGORITHMS}, "
                             f"got {algorithm!r}")
        if transport not in ("inprocess", "socket"):
            raise ValueError(f"transport must be 'inprocess' or 'socket', "
                             f"got {transport!r}")
        self.algorithm = algorithm
        self.num_workers = int(num_workers or
                               default_num_workers(keras_model.device))
        self.communication_window = communication_window
        self.alpha = float(rho) * float(elastic_lr)
        self.adag_learning_rate = float(adag_learning_rate)
        self.transport = transport
        self.parameter_server: Optional[ParameterServer] = None

    def allocate_parameter_server(self, params) -> ParameterServer:
        if self.algorithm == "dynsgd":
            return DynSGDParameterServer(params)
        if self.algorithm == "adag":
            return ADAGParameterServer(
                params, learning_rate=self.adag_learning_rate)
        if self.algorithm == "easgd":
            return EASGDParameterServer(params)
        return DeltaParameterServer(params)

    def _windows(self) -> np.ndarray:
        K = self.communication_window
        if np.isscalar(K):
            return np.full((self.num_workers,), int(K), np.int64)
        Ks = np.asarray(K, np.int64)
        if Ks.shape != (self.num_workers,):
            raise ValueError(
                f"communication_window must be scalar or length-"
                f"{self.num_workers}, got shape {Ks.shape}")
        return Ks

    # -- the worker thread body ----------------------------------------------
    def _worker_loop(self, widx: int, client: PSClient, step_fn, replica,
                     state0, Xw, Yw, K: int, out: Dict[int, Any],
                     errors: List):
        try:
            params = replica.param_tree()
            leaves = tree_leaves(params)
            device = leaves[0].device
            leaves0, clock = client.pull()
            load_params(leaves, leaves0)
            state = replica.state_tree()
            load_params(state, state0)   # every epoch from the model's
            carry = TrainCarry(params, self.worker_optimizer.init(params),
                               prng.key(self.seed + 7919 * (widx + 1),
                                        device), state)
            pull_leaves = leaves0
            step_outs = []
            for s in range(Xw.shape[0]):
                carry, sout = step_fn(carry, (Xw[s], Yw[s]))
                step_outs.append(sout)
                if (s + 1) % K != 0:
                    continue
                # the commit: the replica's whole tree to the host
                w_leaves = [to_numpy(l) for l in leaves]
                if self.algorithm == "easgd":
                    center, clock = client.pull()
                    elastic = [self.alpha * (w - c)
                               for w, c in zip(w_leaves, center)]
                    load_params(leaves, [w - e for w, e in
                                         zip(w_leaves, elastic)])
                    client.commit(elastic)
                else:
                    delta = [w - p for w, p in zip(w_leaves, pull_leaves)]
                    client.commit(delta, clock=clock)
                    pull_leaves, clock = client.pull()
                    load_params(leaves, pull_leaves)
            if step_outs and isinstance(step_outs[0], tuple):
                losses = torch.stack([o[0] for o in step_outs]).cpu().numpy()
                metrics = {nm: torch.stack([o[1][nm] for o in step_outs])
                           .cpu().numpy() for nm in step_outs[0][1]}
            else:
                losses, metrics = torch.stack(step_outs).cpu().numpy(), {}
            out[widx] = {
                "losses": losses,
                "metrics": metrics,
                "state": state,
                # the uncommitted residual, flushed into the center after
                # the join
                "params": [to_numpy(l) for l in leaves],
                "pull": pull_leaves,
            }
        except Exception as e:  # surface thread failures to the caller
            errors.append((widx, e))
        finally:
            client.close()

    @staticmethod
    def _mean_state(out, n):
        """The workers' model state averaged (float leaves; an integer
        leaf keeps worker 0's value), as JAX :172."""
        return mean_state(tree_map(lambda *xs: torch.stack(xs),
                                   *[out[i]["state"] for i in range(n)]))

    def train(self, dataset):
        self._reject_step_options()
        model = self.master_model
        device = resolve_device(model.device)
        X, y = self._training_arrays(dataset)
        n = self.num_workers
        Ks = self._windows()

        # a resume restores the CENTER; the workers restart from it
        manager = self._checkpoint_manager()
        template = {"params": model.params, "state": model.state}
        tree, start_epoch = self._maybe_resume(manager, template)
        if tree is not template:
            load_params(model.params, tree["params"])
            load_params(model.state, tree["state"])

        self.parameter_server = self.allocate_parameter_server(model.params)
        self.parameter_server.initialize()
        port = None
        if self.transport == "socket":
            port = self.parameter_server.start(host="127.0.0.1")
        # one replica (and step) per worker: a thread trains its own
        # module, so no two threads share a module's mode or aux losses
        replicas = [copy.deepcopy(model.module) for _ in range(n)]
        state0 = tree_map(torch.clone, model.state)
        out: Dict[int, Any] = {}   # the latest epoch's worker outputs
        param_mask = self._param_mask(model)
        state_mask = self._state_mask(model)
        steps = [make_train_step(r, self.loss, self.worker_optimizer,
                                 self._metric_fns(), param_mask=param_mask,
                                 state_mask=state_mask) for r in replicas]
        validate = self._make_validator(model, device)

        def center():
            """The center and the workers' mean state, on the device."""
            params = [torch.from_numpy(l).to(device) for l in
                      self.parameter_server.handle_pull()[0]]
            return (tree_unflatten(model.params, params),
                    self._mean_state(out, n) if out else model.state)

        def save_center(epoch):
            params, state = center()
            manager.save(epoch, {"params": params,
                                 "state": jax_state_tree(model, state)},
                         metadata={"epoch": epoch})

        cbs = self._cb_list(lambda: host_tree(center()))
        self.record_training_start()
        try:
            with self._profile_ctx():
                for epoch in range(start_epoch, self.num_epoch):
                    perm = self._epoch_perm(epoch, len(X))
                    Xs, Ys, S = shard_epoch_data(X, y, n, self.batch_size,
                                                 perm)
                    Xs = torch.from_numpy(Xs).to(device)
                    Ys = torch.from_numpy(Ys).to(device)
                    out: Dict[int, Any] = {}
                    errors: List = []
                    threads = []
                    for i in range(n):
                        client = (PSClient(host="127.0.0.1", port=port)
                                  if port is not None
                                  else PSClient(ps=self.parameter_server))
                        t = threading.Thread(
                            target=self._worker_loop,
                            args=(i, client, steps[i], replicas[i],
                                  state0, Xs[:, i], Ys[:, i], int(Ks[i]),
                                  out, errors),
                            daemon=True)
                        t.start()
                        threads.append(t)
                    for t in threads:
                        t.join()
                    if errors:
                        raise errors[0][1]
                    losses = np.stack([out[i]["losses"] for i in range(n)],
                                      axis=1)
                    self.history.append_epoch(
                        loss=losses,
                        **{nm: np.stack([out[i]["metrics"][nm]
                                         for i in range(n)], axis=1)
                           for nm in out[0]["metrics"]})

                    # flush the uncommitted partial-window residuals
                    # every epoch: workers re-pull the center at the next
                    # epoch's start, which would drop this progress
                    ps = self.parameter_server
                    if self.algorithm != "easgd":
                        for i in range(n):
                            delta = [w - p for w, p in
                                     zip(out[i]["params"], out[i]["pull"])]
                            if any(np.any(d) for d in delta):
                                ps.handle_commit({"delta": delta,
                                                  "clock": ps.num_updates})
                    if validate is not None:
                        self.history.epochs[-1].update(validate(*center()))
                    saved = False
                    if (manager is not None
                            and self._should_checkpoint(epoch)):
                        save_center(epoch)
                        saved = True
                    epoch_rec = self.history.epochs[-1]
                    cbs.epoch_end(epoch, self._epoch_logs(
                        epoch_rec["loss"],
                        {k: v for k, v in epoch_rec.items() if k != "loss"},
                        {}))
                    if epoch_exit(self, epoch, saved, save_center
                                  if manager is not None else None):
                        break
        finally:
            self.record_training_stop()
            cbs.train_end()  # closes callback resources on exceptions too
            self.parameter_server.stop()
            if manager is not None:
                manager.wait()   # queued snapshots durable before return

        load_params(model.params, self.parameter_server.get_model())
        if out:
            load_params(model.state, self._mean_state(out, n))
        return self._apply_pending_weights(model)
