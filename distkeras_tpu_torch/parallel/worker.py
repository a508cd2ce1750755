"""Worker compute: the training step and the epoch loop.

Mirrors ``distkeras_tpu/parallel/worker.py``: ``make_train_step`` (:77)
builds the per-minibatch step (forward in training mode, loss plus the
auxiliary losses the layers published (an MoE's balance loss), backward,
an optional global-norm clip inside the optimizer, one optimizer
update), ``shard_epoch_data``/``stack_batches`` (:232-259) shape an
epoch into ``[steps, batch, ...]``. Where the JAX package scans the step
inside one jitted program, the port runs a plain Python loop over the
stacked steps (``run_epoch``); losses and metrics stay on the device
until the epoch's end. The carry's threefry key chains as JAX's does:
``rng, sub = split(rng)`` each step (:165), ``split(sub, accum)`` over
the microbatches (:184), so a model with dropout draws JAX's masks.
Model state (BatchNorm's running statistics) rides in the carry
(``TrainCarry.state``): the training forward writes the new statistics
into those tensors in place (JAX :132-161 returns them), and the
microbatches of an accumulated step write them one after another, as
JAX's scan threads them (:187-196). Frozen layers (``param_mask``/
``state_mask`` from ``models.core.trainable_mask``) get zero gradients
and zero updates, and a frozen state leaf is handed to the forward as a
scratch copy, so its running statistics stay as they were (JAX
:152-160, :206-214). ``fused_vocab_head`` trains the model's trunk and
feeds its last hidden state and the final bias-free ``Dense``'s kernel
to ``ops.losses.fused_linear_cross_entropy`` (JAX ``_fused_head_parts``
:38).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from distkeras_tpu_torch.models.core import collect_aux_losses
from distkeras_tpu_torch.ops import prng
from distkeras_tpu_torch.ops.optimizers import Optimizer, apply_updates
from distkeras_tpu_torch.utils.tree import (tree_leaves, tree_map,
                                            tree_unflatten)


class TrainCarry(NamedTuple):
    """What a step carries to the next: the parameter tree (the model's
    own tensors, updated in place), the optimizer state, the threefry
    key (None: the forward draws nothing) and the model state tree
    (written in place by a training forward; None: each stateful layer's
    own buffers)."""
    params: object
    opt_state: object
    rng: object = None
    state: object = None


def _fused_head_parts(module, loss_fn, metric_fns):
    """Check a model for ``fused_vocab_head`` training and split it:
    ``(trunk, ignore_index, compute_dtype)``, the trunk being the
    ``Sequential`` of every layer but the final vocab projection, whose
    kernel feeds the fused loss (JAX :38)."""
    from distkeras_tpu_torch.models.core import Sequential
    from distkeras_tpu_torch.models.layers import Dense
    from distkeras_tpu_torch.ops import losses as L

    if metric_fns:
        raise ValueError(
            "fused_vocab_head=True cannot compute per-batch metric_fns: "
            "the logits tensor is never materialized. Evaluate metrics "
            "separately (inference.evaluators) or disable the fusion.")
    if not isinstance(module, Sequential) or not len(module.layers):
        raise ValueError("fused_vocab_head needs a Sequential model")
    head = module.layers[-1]
    if not (isinstance(head, Dense) and not head.use_bias
            and head.activation is None):
        raise ValueError(
            "fused_vocab_head needs the final layer to be "
            f"Dense(use_bias=False, activation=None); got {head!r}")
    if loss_fn is L.sparse_categorical_crossentropy_from_logits:
        ignore_index = None
    elif loss_fn is L.masked_sparse_categorical_crossentropy_from_logits:
        ignore_index = -1
    else:
        raise ValueError(
            "fused_vocab_head supports loss="
            "'sparse_categorical_crossentropy_from_logits' or its "
            f"masked_ variant; got {getattr(loss_fn, '__name__', loss_fn)!r}")
    return Sequential(list(module.layers)[:-1]), ignore_index, head.dtype


def _fused_loss(fused, num_chunks):
    """The fused objective ``(params, xb, yb, kw) -> (loss, None)`` of
    ``_fused_head_parts``' split: the trunk's forward (``kw``: its key
    and state), then the fused cross-entropy against the head's
    kernel."""
    from distkeras_tpu_torch.ops.losses import fused_linear_cross_entropy
    trunk, ignore_index, cdt = fused

    def objective(params, xb, yb, kw):
        if "state" in kw:
            kw = dict(kw, state=kw["state"][:-1])
        hidden = trunk.apply(params[:-1], xb, **kw)
        return fused_linear_cross_entropy(
            hidden, params[-1]["kernel"], yb, num_chunks=num_chunks,
            ignore_index=ignore_index, compute_dtype=cdt), None

    return objective


def value_and_grad(module, loss_fn: Callable, params, xb, yb,
                   metric_fns: Optional[dict] = None, rng=None, state=None,
                   objective=None):
    """``(loss, grads, {name: metric})`` of ``loss_fn(yb, module(xb))``
    plus the auxiliary losses the forward's layers published (JAX
    :145-151: both the differentiated and the reported loss hold them),
    for the parameter tree ``params``: the forward runs in training mode
    (the module's mode is restored after it) with the key ``rng`` for
    the layers that draw and the model state tree ``state`` (None: the
    layers' own buffers), which it advances in place; metrics on its
    detached output. ``grads`` is a tree shaped like ``params``; a
    parameter the loss never reached gets zeros, as
    ``jax.value_and_grad`` gives. ``objective(params, xb, yb, kw) ->
    (loss, out)`` replaces the forward and the loss (the fused vocab
    head; its ``out`` is None); ``(loss, out, labels)`` also names the
    labels the metrics take with ``out`` (the SPMD step's global
    batch)."""
    leaves = tree_leaves(params)
    was_training = module.training
    module.train()
    kw = {"rng": rng} if rng is not None and module.uses_rng else {}
    if state is not None and module.has_state:
        kw["state"] = state
    try:
        with torch.enable_grad():
            if objective is None:
                out = module.apply(params, xb, **kw)
                loss = loss_fn(yb, out)
            else:
                res = objective(params, xb, yb, kw)
                loss, out = res[0], res[1]
                if len(res) > 2:
                    yb = res[2]
            loss = loss + collect_aux_losses(module)
    finally:
        module.train(was_training)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    mets = ({name: fn(yb, out.detach()) for name, fn in metric_fns.items()}
            if metric_fns else {})
    return loss.detach(), tree_unflatten(params, grads), mets


def make_train_step(module, loss_fn: Callable, optimizer: Optimizer,
                    metric_fns: Optional[dict] = None,
                    accum_steps: int = 1, param_mask=None, state_mask=None,
                    fused_vocab_head=False, objective=None) -> Callable:
    """The per-minibatch step ``(carry, (xb, yb)) -> (carry, loss)``, or
    ``(carry, (loss, {name: metric}))`` with ``metric_fns``.

    ``accum_steps > 1`` splits the batch into that many microbatches with
    the JAX package's STRIDED split (microbatch ``j`` = rows ``j, j +
    accum, ...``) and averages their gradients before ONE update (the
    mean of equal microbatch means is the batch mean); the reported loss
    and metrics are the means over microbatches.

    ``param_mask`` (a tree of bools shaped like the parameters, from
    ``models.core.trainable_mask``) freezes parameters Keras-style: their
    gradients and their optimizer updates are zero, so a frozen leaf
    stays bitwise as it was under weight-decay optimizers too.
    ``state_mask`` (the same over the state tree) keeps a frozen layer's
    running statistics. ``fused_vocab_head=True`` (or an int, the token
    chunk count; default 8) fuses the final bias-free ``Dense`` into a
    chunked cross-entropy (``ops.losses.fused_linear_cross_entropy``);
    it needs a ``Sequential`` ending in ``Dense(use_bias=False,
    activation=None)``, a sparse-from-logits loss (plain or masked) and
    no ``metric_fns``. ``objective`` (``value_and_grad``'s) replaces the
    forward and the loss: the SPMD trainer's sharded step, which handles
    ``fused_vocab_head`` itself."""
    accum_steps = int(accum_steps)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if fused_vocab_head and objective is None:
        objective = _fused_loss(
            _fused_head_parts(module, loss_fn, metric_fns),
            8 if fused_vocab_head is True else int(fused_vocab_head))
    frozen_state = state_mask is not None and not all(
        tree_leaves(state_mask))

    def grad_of(params, xb, yb, sub, state):
        loss, grads, mets = value_and_grad(module, loss_fn, params, xb, yb,
                                           metric_fns, sub, state,
                                           objective)
        if param_mask is not None:
            grads = tree_map(lambda m, g: g if m else torch.zeros_like(g),
                             param_mask, grads)
        return loss, grads, mets

    def train_step(carry: TrainCarry, batch):
        xb, yb = batch
        rng = sub = None
        if carry.rng is not None:
            rng, sub = prng.split(carry.rng)
        state = carry.state
        if frozen_state:
            # the forward writes its statistics into scratch copies of
            # the frozen leaves, which are dropped after the step
            if state is None:
                state = module.state_tree()
            state = tree_map(lambda m, s: s if m else s.clone(),
                             state_mask, state)
        if accum_steps == 1:
            loss, grads, mets = grad_of(carry.params, xb, yb, sub, state)
        else:
            if xb.shape[0] % accum_steps:
                raise ValueError(
                    f"batch of {xb.shape[0]} must divide into "
                    f"accum_steps={accum_steps} microbatches")
            micro = xb.shape[0] // accum_steps
            xs = xb.reshape((micro, accum_steps) + tuple(xb.shape[1:])) \
                .transpose(0, 1)
            ys = yb.reshape((micro, accum_steps) + tuple(yb.shape[1:])) \
                .transpose(0, 1)
            gsum = tree_map(torch.zeros_like, carry.params)
            subs = [None] * accum_steps if sub is None \
                else prng.split(sub, accum_steps)
            losses, mets_s = [], []
            for j in range(accum_steps):
                loss_j, grads_j, mets_j = grad_of(carry.params, xs[j], ys[j],
                                                  subs[j], state)
                gsum = tree_map(torch.add, gsum, grads_j)
                losses.append(loss_j)
                mets_s.append(mets_j)
            grads = tree_map(lambda g: g / accum_steps, gsum)
            loss = torch.stack(losses).mean()
            mets = {k: torch.stack([m[k] for m in mets_s]).mean()
                    for k in mets_s[0]}
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, carry.opt_state,
                                                  carry.params)
            if param_mask is not None:
                updates = tree_map(
                    lambda m, u: u if m else torch.zeros_like(u),
                    param_mask, updates)
            apply_updates(carry.params, updates)
        new_carry = TrainCarry(carry.params, opt_state, rng, carry.state)
        if metric_fns:
            return new_carry, (loss, mets)
        return new_carry, loss

    return train_step


def run_epoch(train_step: Callable, carry: TrainCarry, Xs, Ys):
    """Run ``train_step`` over ``[steps, batch, ...]`` data in order;
    returns ``(carry, losses [steps], {name: [steps]})`` with the per-step
    values stacked on the device (no host sync inside the loop)."""
    losses, mets = [], {}
    for i in range(Xs.shape[0]):
        carry, out = train_step(carry, (Xs[i], Ys[i]))
        loss, m = out if isinstance(out, tuple) else (out, {})
        losses.append(loss)
        for k, v in m.items():
            mets.setdefault(k, []).append(v)
    return (carry, torch.stack(losses),
            {k: torch.stack(v) for k, v in mets.items()})


def shard_epoch_data(X, Y, num_workers: int, batch_size: int, perm=None):
    """Host side: one epoch as ``[S, num_workers, batch, ...]`` (the
    remainder is dropped). The permutation is the host library's
    multithreaded gather (``data.native.gather``), as in JAX :242."""
    if perm is not None:
        from distkeras_tpu_torch.data import native
        X, Y = native.gather(X, perm), native.gather(Y, perm)
    per_step = num_workers * batch_size
    S = len(X) // per_step
    n = S * per_step
    if S == 0:
        raise ValueError(
            f"dataset ({len(X)} rows) smaller than one global step "
            f"({num_workers} workers x batch_size {batch_size})")
    Xs = np.asarray(X[:n]).reshape((S, num_workers, batch_size)
                                   + X.shape[1:])
    Ys = np.asarray(Y[:n]).reshape((S, num_workers, batch_size)
                                   + Y.shape[1:])
    return Xs, Ys, S


def stack_batches(X, Y, batch_size: int, perm=None):
    """Single-worker epoch stacking: ``[n_steps, batch_size, ...]``."""
    Xs, Ys, S = shard_epoch_data(X, Y, 1, batch_size, perm)
    return Xs[:, 0], Ys[:, 0], S
