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
JAX's scan threads them (:187-196).
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

#: the Trainer options a later slice ports, named in the errors
LATER = "ROADMAP, Queue 1 item 'training: the rest of the Trainer surface'"


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


def value_and_grad(module, loss_fn: Callable, params, xb, yb,
                   metric_fns: Optional[dict] = None, rng=None, state=None):
    """``(loss, grads, {name: metric})`` of ``loss_fn(yb, module(xb))``
    plus the auxiliary losses the forward's layers published (JAX
    :145-151: both the differentiated and the reported loss hold them),
    for the parameter tree ``params``: the forward runs in training mode
    (the module's mode is restored after it) with the key ``rng`` for
    the layers that draw and the model state tree ``state`` (None: the
    layers' own buffers), which it advances in place; metrics on its
    detached output. ``grads`` is a tree shaped like ``params``; a
    parameter the loss never reached gets zeros, as
    ``jax.value_and_grad`` gives."""
    leaves = tree_leaves(params)
    was_training = module.training
    module.train()
    kw = {"rng": rng} if rng is not None and module.uses_rng else {}
    if state is not None and module.has_state:
        kw["state"] = state
    try:
        with torch.enable_grad():
            out = module.apply(params, xb, **kw)
            loss = loss_fn(yb, out) + collect_aux_losses(module)
    finally:
        module.train(was_training)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    out = out.detach()
    mets = ({name: fn(yb, out) for name, fn in metric_fns.items()}
            if metric_fns else {})
    return loss.detach(), tree_unflatten(params, grads), mets


def make_train_step(module, loss_fn: Callable, optimizer: Optimizer,
                    metric_fns: Optional[dict] = None,
                    accum_steps: int = 1, param_mask=None, state_mask=None,
                    fused_vocab_head=False) -> Callable:
    """The per-minibatch step ``(carry, (xb, yb)) -> (carry, loss)``, or
    ``(carry, (loss, {name: metric}))`` with ``metric_fns``.

    ``accum_steps > 1`` splits the batch into that many microbatches with
    the JAX package's STRIDED split (microbatch ``j`` = rows ``j, j +
    accum, ...``) and averages their gradients before ONE update (the
    mean of equal microbatch means is the batch mean); the reported loss
    and metrics are the means over microbatches."""
    if param_mask is not None or state_mask is not None:
        raise NotImplementedError(
            f"frozen layers (param_mask/state_mask) are not ported yet: "
            f"{LATER}")
    if fused_vocab_head:
        raise NotImplementedError(
            f"fused_vocab_head is not ported yet: {LATER}")
    accum_steps = int(accum_steps)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def grad_of(params, xb, yb, sub, state):
        return value_and_grad(module, loss_fn, params, xb, yb, metric_fns,
                              sub, state)

    def train_step(carry: TrainCarry, batch):
        xb, yb = batch
        rng = sub = None
        if carry.rng is not None:
            rng, sub = prng.split(carry.rng)
        if accum_steps == 1:
            loss, grads, mets = grad_of(carry.params, xb, yb, sub,
                                        carry.state)
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
                                                  subs[j], carry.state)
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
    remainder is dropped)."""
    if perm is not None:
        X, Y = X[perm], Y[perm]
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
