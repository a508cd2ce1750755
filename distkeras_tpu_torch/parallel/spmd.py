"""SPMDTrainer: synchronous data x tensor x expert (x FSDP) parallel
training over the ranks of a ``torch.distributed`` world.

Mirrors ``distkeras_tpu/parallel/spmd.py`` (``SPMDTrainer`` :40): the
constructor's errors (an unknown data axis :68-75, a global batch that
does not divide over the data axes :80-85, ``checkpoint_async`` with
``sharded_checkpoints`` :108-115), ``param_partition_specs`` (:97), the
optimizer moments placed with their parameters (``_opt_shardings``
:121), a fresh start that shards first and then initialises the
optimizer, and the resumes (:137-223): from a sharded checkpoint, from a
dense one (``sharded_checkpoints=False``), and from the old
params-and-state format with JAX's warning. Every rank of the mesh
runs ``train`` with the same dataset and arguments (a ``parallel.launch.
World`` or a ``deploy.Job``), as every JAX process does.

Where JAX jits the epoch and lets GSPMD place the collectives, each rank
here runs the port's step (``parallel.worker.make_train_step``) on its
block of every parameter and its rows of each batch, with the
collectives placed by ``parallel.sharding`` (see its docstring):
Megatron's split inside the attention and the MLP, every other split
leaf gathered for the step, the loss and the metrics taken on the
gathered global batch, BatchNorm's moments and dropout's masks those
of the global batch, and each gradient summed over the data axes. The
loader thread stacks each epoch, cuts this rank's rows and stages them.
JAX's donation-alias copy (:310-325) has no counterpart: nothing is
donated here.

Norm-based updates (``clip_grad_norm``, ``lars``, ``lamb``) need the
norm of a whole leaf or tree; a rank holds blocks, so they are refused
when a leaf is split (with data parallelism alone they are exact).
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence, Union

import numpy as np
import torch

from distkeras_tpu_torch.compat import resolve_device
from distkeras_tpu_torch.data.sharded import ShardedDataset
from distkeras_tpu_torch.models.core import Model
from distkeras_tpu_torch.models.serialization import _walk, jax_state_tree
from distkeras_tpu_torch.obs import collectors, timed_stream
from distkeras_tpu_torch.ops import prng
from distkeras_tpu_torch.parallel.sharding import (P, Placement, _names,
                                                   gather_params, gather_rows,
                                                   local_block, map_specs,
                                                   named_shardings,
                                                   param_specs, placed,
                                                   shard_params, spec_leaves,
                                                   use_params, use_plan)
from distkeras_tpu_torch.parallel.trainers import (Trainer, epoch_exit,
                                                   host_tree, load_params)
from distkeras_tpu_torch.parallel.worker import (TrainCarry, _fused_head_parts,
                                                 make_train_step, run_epoch,
                                                 stack_batches)
from distkeras_tpu_torch.resilience import faults
from distkeras_tpu_torch.utils.prefetch import (Prefetcher, device_stager,
                                                to_device)
from distkeras_tpu_torch.utils.tree import tree_leaves, tree_unflatten


def _paths(tree):
    return [path for path, _ in _walk(tree)]


def _replicated_specs(tree):
    """``P()`` for every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _replicated_specs(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_replicated_specs(v) for v in tree]
    return P()


class SPMDTrainer(Trainer):
    """Synchronous large-model trainer over an N-D mesh of ranks.

    ``mesh`` axes: data axes (``data_axes``, default ``("workers",)``)
    shard the batch; ``tp_axis``/``ep_axis`` shard params per
    ``sharding.ShardingRules``; ``fsdp_axis`` (usually the data axis
    itself) ZeRO-shards the remaining large kernels. ``batch_size`` is
    the GLOBAL batch. ``mesh=None``: one ``workers`` axis over the world.
    """

    def __init__(self, keras_model: Model, mesh=None,
                 data_axes: Union[str, Sequence[str]] = ("workers",),
                 tp_axis: Optional[str] = "tp",
                 ep_axis: Optional[str] = None,
                 fsdp_axis: Optional[str] = None,
                 sharded_checkpoints: bool = True, **kwargs):
        super().__init__(keras_model, **kwargs)
        #: per-rank block files (utils.checkpoint.ShardedCheckpointManager)
        #: on storage every rank of the world reads and writes
        self.sharded_checkpoints = bool(sharded_checkpoints)
        if mesh is None:
            from distkeras_tpu_torch.parallel.mesh import make_mesh
            mesh = make_mesh(device=keras_model.device)
        self.mesh = mesh
        if isinstance(data_axes, str):
            data_axes = (data_axes,)
        unknown = [a for a in data_axes if a not in mesh.shape]
        if unknown:
            # unlike tp/ep (where replicated fallback is documented), a
            # missing data axis silently disables data parallelism — fail
            raise ValueError(
                f"data_axes {unknown} not in mesh axes "
                f"{tuple(mesh.shape)}")
        self.data_axes = tuple(data_axes)
        self.tp_axis = tp_axis
        self.ep_axis = ep_axis
        self.fsdp_axis = fsdp_axis
        dp = int(np.prod([mesh.shape[a] for a in self.data_axes])) \
            if self.data_axes else 1
        if self.batch_size % max(dp, 1):
            raise ValueError(
                f"global batch_size {self.batch_size} must divide evenly "
                f"over data axes {self.data_axes} (size {dp})")

    # -- sharding plumbing --------------------------------------------------
    def param_partition_specs(self, model: Optional[Model] = None):
        """The PartitionSpec tree this trainer uses (introspection/tests)."""
        model = model or self.master_model
        return param_specs(model.module, model.params, self.mesh,
                           tp_axis=self.tp_axis, ep_axis=self.ep_axis,
                           fsdp_axis=self.fsdp_axis)

    def _opt_shardings(self, opt_state, params, specs):
        """Specs of the optimizer state: moment subtrees that mirror the
        params tree get the params' specs (moments live WITH their
        params); anything else (step counters) is replicated."""
        pstruct = _paths(params)
        if isinstance(opt_state, dict):
            return {k: specs if _paths(v) == pstruct
                    else _replicated_specs(v) for k, v in opt_state.items()}
        return _replicated_specs(opt_state)

    def _check_norms(self, specs) -> None:
        split = any(self.mesh.shape[name] > 1 for s in spec_leaves(specs)
                    for e in s for name in _names(e))
        name = self.worker_optimizer.name
        if split and (name.startswith("clip(") or name in ("lars", "lamb")):
            raise ValueError(
                f"SPMDTrainer: the {name!r} update needs whole-leaf norms, "
                "and this mesh splits leaves over ranks; drop tp/ep/fsdp "
                "sharding or the norm-based optimizer")

    # -- resume plumbing ----------------------------------------------------
    def _checkpoint_manager(self):
        if self.checkpoint_dir is None:
            return None
        if self.sharded_checkpoints:
            if self.checkpoint_async:
                raise ValueError(
                    "checkpoint_async is not supported with "
                    "sharded_checkpoints: the sharded save runs "
                    "multi-process barriers that must stay on the training "
                    "thread. Pass sharded_checkpoints=False to keep async "
                    "dense snapshots.")
            from distkeras_tpu_torch.utils.checkpoint import \
                ShardedCheckpointManager
            return ShardedCheckpointManager(self.checkpoint_dir)
        return super()._checkpoint_manager()

    @staticmethod
    def _full_carry(keys) -> bool:
        """Whether a checkpoint holds the full carry: detected by the rng
        key (an empty optimizer state stores no ``opt/`` entries)."""
        return any(k == "rng" or k.startswith("rng/") for k in keys or [])

    @staticmethod
    def _old_format_warning():
        warnings.warn(
            "checkpoint predates the full-carry format; restoring "
            "params/state only (optimizer moments and rng restart "
            "fresh)", stacklevel=3)

    def _restore_sharded(self, manager, shardings):
        """``(tree of this rank's host blocks | None, start_epoch)`` from
        the latest checkpoint (sharded or dense)."""
        if manager is None or not self.resume:
            return None, 0
        latest = manager.latest_step()
        if latest is None:
            return None, 0
        want = {"params": shardings["params"], "state": shardings["state"]}
        if self._full_carry(manager.keys(latest)):
            want.update(opt=shardings["opt"], rng=shardings["rng"])
        else:
            self._old_format_warning()
        tree = manager.restore_sharded(want, step=latest)
        start = int(manager.metadata(step=latest).get("epoch", -1)) + 1
        return (tree if start > 0 else None), start

    def _restore_dense(self, manager, model, specs, opt_specs):
        """The same from a dense checkpoint: every rank reads the whole
        carry and keeps its blocks. The format is decided on rank 0 and
        broadcast, so every rank restores the same template."""
        if manager is None or not self.resume:
            return None, 0
        import torch.distributed as dist
        flag = [0]
        if dist.get_rank() == 0:
            latest = manager.latest_step()
            flag = [0 if latest is None else
                    2 if self._full_carry(manager.keys(latest)) else 1]
        dist.broadcast_object_list(flag, src=0)
        if flag[0] == 0:
            return None, 0
        template = {"params": model.params, "state": model.state}
        if flag[0] == 2:
            template.update(
                opt=host_tree(self.worker_optimizer.init(model.params)),
                rng=np.zeros(2, np.uint32))
        else:
            self._old_format_warning()
        tree, start = self._maybe_resume(manager, template)
        if start == 0:
            return None, 0
        out = {"params": map_specs(lambda s, x: local_block(x, s, self.mesh),
                                   specs, tree["params"]),
               "state": tree["state"]}
        if flag[0] == 2:
            out["opt"] = map_specs(lambda s, x: local_block(x, s, self.mesh),
                                   opt_specs, tree["opt"])
            out["rng"] = tree["rng"]
        return out, start

    # -- the step -----------------------------------------------------------
    def _objective(self, module, specs, placement, metric_fns):
        """``value_and_grad``'s objective on this rank's blocks: the
        leaves as the step uses them, the forward on this rank's rows,
        the loss (and the metrics) on the gathered global batch."""
        loss_fn = self.loss
        plans = {}
        fused = None
        if self.fused_vocab_head:
            from distkeras_tpu_torch.ops.losses import \
                fused_linear_cross_entropy
            fused = _fused_head_parts(module, loss_fn, metric_fns)
            chunks = 8 if self.fused_vocab_head is True \
                else int(self.fused_vocab_head)

        def objective(params, xb, yb, kw):
            leaves = tree_leaves(params)
            if "plan" not in plans:
                plans["plan"] = use_plan(module, specs, leaves, placement)
            use = tree_unflatten(params, use_params(plans["plan"], leaves))
            labels = gather_rows(yb)
            if fused is not None:
                trunk, ignore_index, cdt = fused
                if "state" in kw:
                    kw = dict(kw, state=kw["state"][:-1])
                hidden = gather_rows(trunk.apply(use[:-1], xb, **kw))
                return fused_linear_cross_entropy(
                    hidden, use[-1]["kernel"], labels, num_chunks=chunks,
                    ignore_index=ignore_index, compute_dtype=cdt), None
            out = gather_rows(module.apply(use, xb, **kw))
            return loss_fn(labels, out), out, labels

        return objective

    # -- training -----------------------------------------------------------
    def train(self, dataset) -> Model:
        model = self.master_model
        device = resolve_device(model.device)
        mesh = self.mesh
        sharded = isinstance(dataset, ShardedDataset)
        if not sharded:
            X, y = self._training_arrays(dataset)
        specs = self.param_partition_specs(model)
        self._check_norms(specs)
        placement = Placement(mesh, self.tp_axis, self.data_axes)
        row, rows = placement.data_block()
        local_batch = self.batch_size // rows

        # fresh start: shard first, then init the optimizer on the blocks
        params = shard_params(model.params, specs, mesh)
        opt_state = self.worker_optimizer.init(params)
        opt_specs = self._opt_shardings(opt_state, params, specs)
        state_specs = _replicated_specs(model.state)
        manager = self._checkpoint_manager()
        shardings = {"params": specs, "state": state_specs,
                     "opt": opt_specs, "rng": P()}
        if self.sharded_checkpoints:
            restored, start_epoch = self._restore_sharded(
                manager,
                {k: named_shardings(v, mesh) for k, v in shardings.items()})
        else:
            restored, start_epoch = self._restore_dense(
                manager, model, specs, opt_specs)
        key = prng.key(self.seed, device)
        if restored is not None:
            load_params(params, restored["params"])
            load_params(model.state, restored["state"])
            if "opt" in restored:
                load_params(opt_state, restored["opt"])
                key = prng.as_key(restored["rng"], device)
        carry = TrainCarry(params, opt_state, key, model.state)

        metric_fns = self._metric_fns()
        step = make_train_step(
            model.module, self.loss, self.worker_optimizer, metric_fns,
            self.grad_accum_steps, param_mask=self._param_mask(model),
            state_mask=self._state_mask(model),
            objective=self._objective(model.module, specs, placement,
                                      metric_fns))
        tape = self._make_tape()
        tape.watch("SPMDTrainer.kernels", collectors.KERNEL_LIBRARIES)

        blk = slice(row * local_batch, (row + 1) * local_batch)

        def mine(chunk):
            Xs, Ys, n_steps = chunk
            return Xs[:, blk], Ys[:, blk], n_steps

        stage = device_stager(device)
        if sharded:
            self.loader = self._sharded_stream(
                dataset, start_epoch, place=lambda c: stage(mine(c)))
            stream = self.loader
        else:
            # the loader thread stacks the next epoch, cuts this rank's
            # rows and stages them while the ranks train this one
            self.loader = Prefetcher(
                lambda e: mine(stack_batches(X, y, self.batch_size,
                                             self._epoch_perm(e, len(X)))),
                range(start_epoch, self.num_epoch), depth=1, place=stage)
            stream = (((e, 0, True), chunk) for e, chunk in self.loader)

        def whole(tree, spec_tree):
            return gather_params(tree, spec_tree, mesh)

        def save_now(epoch):
            tree = {"params": carry.params,
                    "state": jax_state_tree(model, carry.state),
                    "opt": carry.opt_state,
                    "rng": prng.key_data(carry.rng)}
            with tape.phase("checkpoint"):
                if self.sharded_checkpoints:
                    sh = dict(shardings,
                              state=_replicated_specs(tree["state"]))
                    manager.save(epoch, tree, metadata={"epoch": epoch},
                                 shardings={k: named_shardings(v, mesh)
                                            for k, v in sh.items()})
                    return
                # dense: a gather every rank enters; rank 0 writes
                tree = dict(tree, params=whole(carry.params, specs),
                            opt=whole(carry.opt_state, opt_specs))
                import torch.distributed as dist
                if dist.get_rank() == 0:
                    manager.save(epoch, tree, metadata={"epoch": epoch})

        validate = self._make_validator(model, device)
        val_placement = Placement(mesh, self.tp_axis, ())
        val_plan = {}

        def validation():
            leaves = tree_leaves(carry.params)
            if "plan" not in val_plan:
                val_plan["plan"] = use_plan(model.module, specs, leaves,
                                            val_placement)
            with placed(val_placement), torch.no_grad():
                use = tree_unflatten(carry.params,
                                     use_params(val_plan["plan"], leaves))
                return validate(use)

        cbs = self._cb_list(lambda: (host_tree(whole(carry.params, specs)),
                                     host_tree(carry.state)))
        self.record_training_start()
        tape.train_begin()
        try:
            with self._profile_ctx():
                l_acc, m_acc = [], []
                examples = 0
                for (epoch, _, last), (Xs, Ys, n_steps) in timed_stream(
                        stream, tape):
                    # chaos hook: a crash at an arbitrary loop iteration
                    faults.point("train.epoch")
                    with tape.phase("device"), placed(placement):
                        carry, losses, mets = run_epoch(
                            step, carry, to_device(Xs, device),
                            to_device(Ys, device))
                    l_acc.append(losses)
                    m_acc.append(mets)
                    examples += int(n_steps) * self.batch_size
                    if not last:
                        continue
                    with tape.phase("device"):
                        # the epoch's one device-to-host read (the values
                        # are the global batch's, equal on every rank)
                        losses = torch.cat(l_acc)
                        losses = losses.cpu().numpy()  # lint: allow-host-sync
                        mets = {k: torch.cat([m[k] for m in m_acc])
                                for k in m_acc[0]}
                        mets = {k: v.cpu().numpy()  # lint: allow-host-sync
                                for k, v in mets.items()}
                    # chaos hook: NaN-poison the losses the anomaly guard
                    # watches
                    losses = faults.corrupt("train.loss", losses)
                    l_acc, m_acc = [], []
                    extra = {}
                    if validate:
                        with tape.phase("validation"):
                            extra = validation()
                    self.history.append_epoch(loss=losses, **mets, **extra)
                    saved = False
                    if manager is not None and self._should_checkpoint(epoch):
                        save_now(epoch)
                        saved = True
                    # the logs are the global batch's on every rank, so
                    # every rank takes the same callback decisions
                    logs = self._epoch_logs(losses, mets, extra)
                    logs.update(tape.epoch_end(examples))
                    examples = 0
                    if epoch == start_epoch:
                        tape.mark_warm()
                    cbs.epoch_end(epoch, logs)
                    if epoch_exit(self, epoch, saved,
                                  save_now if manager is not None else None):
                        break
        finally:
            self.loader.close()
            self.record_training_stop()
            tape.train_end()
            cbs.train_end()
        if manager is not None:
            manager.wait()
        # every rank returns the whole model
        load_params(model.params, whole(carry.params, specs))
        self.carry = carry
        return self._apply_pending_weights(model)
