"""Optimizers as pure ``(init, update)`` pairs over parameter trees.

Mirrors ``distkeras_tpu/ops/optimizers.py`` formula for formula, NOT
``torch.optim``: Adam folds the bias correction into the step size
(``lr * sqrt(1 - b2^t) / (1 - b1^t)``, a float32 scalar computed from
the float32 step count) and adds ``epsilon`` (the Keras ``1e-7``) to the
uncorrected ``sqrt(v)``, as the JAX package does (:146-149).

    opt = get_optimizer("adam", learning_rate=1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    apply_updates(params, updates)

Trees are nested dicts/lists of tensors (``Layer.param_tree()``). The
step counter ``"t"`` is a 0-d int32 tensor on the parameters' device, so
schedules and the bias correction run there without a host sync.
``apply_updates`` adds the updates to the parameter tensors IN PLACE
(the port keeps one copy of the weights; the JAX version returns a new
tree).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import torch

from distkeras_tpu_torch.utils.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]  # (grads, state, params) ->
    #                                          (updates, new_state)
    name: str = "optimizer"


@torch.no_grad()
def apply_updates(params, updates):
    """``params += updates`` leafwise, in place; returns ``params``."""
    tree_map(lambda p, u: p.add_(u), params, updates)
    return params


def _zeros_like(params):
    return tree_map(torch.zeros_like, params)


def _step_zero(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def _lr_resolver(learning_rate):
    """``learning_rate`` may be a float or a schedule (``step -> lr``,
    see ``ops.schedules``). Returns ``(scheduled, lr_fn)``: when scheduled,
    the optimizer carries a step counter ``"t"`` in its state and evaluates
    the schedule each update."""
    if callable(learning_rate):
        return True, learning_rate
    v = float(learning_rate)
    return False, lambda t: v


def _with_step(scheduled: bool, state: dict, params) -> dict:
    if scheduled:
        state["t"] = _step_zero(params)
    return state


def _step_lr(scheduled, lr_fn, state):
    """Advance the step counter and evaluate the (possibly scheduled) lr."""
    if not scheduled:
        return lr_fn(None), state
    t = state["t"] + 1
    return lr_fn(t - 1), {**state, "t": t}


def sgd(learning_rate: float = 0.01, momentum: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    scheduled, lrf = _lr_resolver(learning_rate)
    mu = float(momentum)

    def init(params):
        return _with_step(scheduled,
                          {"velocity": _zeros_like(params)} if mu else {},
                          params)

    def update(grads, state, params=None):
        lr, state = _step_lr(scheduled, lrf, state)
        if not mu:
            return tree_map(lambda g: -lr * g, grads), state
        vel = tree_map(lambda v, g: mu * v - lr * g, state["velocity"], grads)
        if nesterov:
            upd = tree_map(lambda v, g: mu * v - lr * g, vel, grads)
        else:
            upd = vel
        return upd, {**state, "velocity": vel}

    return Optimizer(init, update, "sgd")


def adagrad(learning_rate: float = 0.01, epsilon: float = 1e-7) -> Optimizer:
    scheduled, lrf = _lr_resolver(learning_rate)
    eps = float(epsilon)

    def init(params):
        return _with_step(scheduled, {"accum": _zeros_like(params)}, params)

    def update(grads, state, params=None):
        lr, state = _step_lr(scheduled, lrf, state)
        accum = tree_map(lambda a, g: a + g.square(), state["accum"], grads)
        upd = tree_map(lambda g, a: -lr * g / (torch.sqrt(a) + eps),
                       grads, accum)
        return upd, {**state, "accum": accum}

    return Optimizer(init, update, "adagrad")


def rmsprop(learning_rate: float = 0.001, rho: float = 0.9,
            epsilon: float = 1e-7) -> Optimizer:
    scheduled, lrf = _lr_resolver(learning_rate)
    r, eps = float(rho), float(epsilon)

    def init(params):
        return _with_step(scheduled, {"ms": _zeros_like(params)}, params)

    def update(grads, state, params=None):
        lr, state = _step_lr(scheduled, lrf, state)
        ms = tree_map(lambda m, g: r * m + (1 - r) * g.square(),
                      state["ms"], grads)
        upd = tree_map(lambda g, m: -lr * g / (torch.sqrt(m) + eps),
                       grads, ms)
        return upd, {**state, "ms": ms}

    return Optimizer(init, update, "rmsprop")


def _adam_moments(b1, b2, state, grads):
    t = state["t"] + 1
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g.square(), state["v"],
                 grads)
    return t, m, v


def adam(learning_rate: float = 0.001, beta1: float = 0.9,
         beta2: float = 0.999, epsilon: float = 1e-7) -> Optimizer:
    scheduled, lrf = _lr_resolver(learning_rate)
    b1, b2, eps = float(beta1), float(beta2), float(epsilon)

    def init(params):
        return {"m": _zeros_like(params), "v": _zeros_like(params),
                "t": _step_zero(params)}  # adam always counts steps

    def update(grads, state, params=None):
        t, m, v = _adam_moments(b1, b2, state, grads)
        lr = lrf(t - 1) if scheduled else lrf(None)
        # bias correction folded into the step size (float32 scalar)
        tf = t.float()
        step = lr * torch.sqrt(1 - b2 ** tf) / (1 - b1 ** tf)
        upd = tree_map(lambda m_, v_: -step * m_ / (torch.sqrt(v_) + eps),
                       m, v)
        return upd, {"m": m, "v": v, "t": t}

    return Optimizer(init, update, "adam")


def adadelta(learning_rate: float = 1.0, rho: float = 0.95,
             epsilon: float = 1e-7) -> Optimizer:
    scheduled, lrf = _lr_resolver(learning_rate)
    r, eps = float(rho), float(epsilon)

    def init(params):
        return _with_step(scheduled, {"acc_g": _zeros_like(params),
                                      "acc_u": _zeros_like(params)}, params)

    def update(grads, state, params=None):
        lr, state = _step_lr(scheduled, lrf, state)
        acc_g = tree_map(lambda a, g: r * a + (1 - r) * g.square(),
                         state["acc_g"], grads)
        upd = tree_map(lambda g, ag, au: -lr * g * torch.sqrt(au + eps)
                       / torch.sqrt(ag + eps), grads, acc_g, state["acc_u"])
        acc_u = tree_map(lambda a, u: r * a + (1 - r) * u.square(),
                         state["acc_u"], upd)
        return upd, {**state, "acc_g": acc_g, "acc_u": acc_u}

    return Optimizer(init, update, "adadelta")


def adamw(learning_rate: float = 0.001, beta1: float = 0.9,
          beta2: float = 0.999, epsilon: float = 1e-7,
          weight_decay: float = 0.01) -> Optimizer:
    """Adam with decoupled weight decay (Loshchilov & Hutter 2019)."""
    scheduled, lrf = _lr_resolver(learning_rate)
    b1, b2, eps, wd = (float(beta1), float(beta2), float(epsilon),
                       float(weight_decay))

    def init(params):
        return {"m": _zeros_like(params), "v": _zeros_like(params),
                "t": _step_zero(params)}

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("adamw needs params (decoupled decay); call "
                             "opt.update(grads, state, params)")
        t, m, v = _adam_moments(b1, b2, state, grads)
        lr = lrf(t - 1) if scheduled else lrf(None)
        tf = t.float()
        step = lr * torch.sqrt(1 - b2 ** tf) / (1 - b1 ** tf)
        upd = tree_map(lambda m_, v_, p: -step * m_ / (torch.sqrt(v_) + eps)
                       - lr * wd * p, m, v, params)
        return upd, {"m": m, "v": v, "t": t}

    return Optimizer(init, update, "adamw")


def _l2(x) -> torch.Tensor:
    return torch.sqrt(x.float().square().sum())


def lars(learning_rate: float = 1.0, momentum: float = 0.9,
         weight_decay: float = 0.0, trust_coefficient: float = 1e-3,
         epsilon: float = 1e-8) -> Optimizer:
    """Layer-wise Adaptive Rate Scaling (You et al. 2017): per tensor, the
    trust ratio ``tc * |w| / (|g + wd*w| + eps)`` scales the momentum
    step."""
    scheduled, lrf = _lr_resolver(learning_rate)
    mu, wd, tc, eps = (float(momentum), float(weight_decay),
                       float(trust_coefficient), float(epsilon))

    def init(params):
        return _with_step(scheduled, {"v": _zeros_like(params)}, params)

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("lars needs params; call "
                             "opt.update(grads, state, params)")
        lr, state = _step_lr(scheduled, lrf, state)

        def leaf(v_, g, p):
            g = g + wd * p
            wn, gn = _l2(p), _l2(g)
            # trust ratio only where both norms are nonzero
            ratio = torch.where((wn > 0) & (gn > 0), tc * wn / (gn + eps),
                                1.0)
            return mu * v_ + (lr * ratio).to(g.dtype) * g

        v = tree_map(leaf, state["v"], grads, params)
        upd = tree_map(lambda v_: -v_, v)
        return upd, {**state, "v": v}

    return Optimizer(init, update, "lars")


def lamb(learning_rate: float = 0.001, beta1: float = 0.9,
         beta2: float = 0.999, epsilon: float = 1e-6,
         weight_decay: float = 0.0) -> Optimizer:
    """LAMB (You et al. 2020): the Adam direction times a per-tensor trust
    ratio."""
    scheduled, lrf = _lr_resolver(learning_rate)
    b1, b2, eps, wd = (float(beta1), float(beta2), float(epsilon),
                       float(weight_decay))

    def init(params):
        return {"m": _zeros_like(params), "v": _zeros_like(params),
                "t": _step_zero(params)}

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("lamb needs params; call "
                             "opt.update(grads, state, params)")
        t, m, v = _adam_moments(b1, b2, state, grads)
        lr = lrf(t - 1) if scheduled else lrf(None)
        tf = t.float()
        c1, c2 = 1 - b1 ** tf, 1 - b2 ** tf

        def leaf(m_, v_, p):
            r = (m_ / c1) / (torch.sqrt(v_ / c2) + eps) + wd * p
            wn, rn = _l2(p), _l2(r)
            ratio = torch.where((wn > 0) & (rn > 0), wn / rn, 1.0)
            return -(lr * ratio).to(r.dtype) * r

        upd = tree_map(leaf, m, v, params)
        return upd, {"m": m, "v": v, "t": t}

    return Optimizer(init, update, "lamb")


def clip_by_global_norm(optimizer: Optimizer, max_norm: float) -> Optimizer:
    """Wrap an optimizer so gradients are rescaled to a maximum GLOBAL L2
    norm before its update (``clip_grad_norm=`` on the trainers)."""
    mx = float(max_norm)
    if mx <= 0:
        raise ValueError(f"max_norm must be > 0, got {max_norm}")

    def update(grads, state, params=None):
        gn = torch.sqrt(sum(g.float().square().sum()
                            for g in tree_leaves(grads)))
        scale = mx / torch.clamp(gn, min=mx)
        grads = tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)
        return optimizer.update(grads, state, params)

    return Optimizer(optimizer.init, update,
                     f"clip({optimizer.name}, {mx})")


OPTIMIZERS = {
    "sgd": sgd,
    "momentum": lambda **kw: sgd(momentum=kw.pop("momentum", 0.9), **kw),
    "nesterov": lambda **kw: sgd(momentum=kw.pop("momentum", 0.9),
                                 nesterov=True, **kw),
    "adagrad": adagrad,
    "rmsprop": rmsprop,
    "adam": adam,
    "adamw": adamw,
    "adadelta": adadelta,
    "lars": lars,
    "lamb": lamb,
}


def get_optimizer(opt: Union[str, Optimizer], **kwargs) -> Optimizer:
    """Resolve ``"adam"`` / ``("sgd", lr=0.1)`` / Optimizer -> Optimizer."""
    if isinstance(opt, Optimizer):
        if kwargs:
            raise ValueError(
                f"got both an Optimizer instance and kwargs {sorted(kwargs)};"
                " configure the instance directly instead (the kwargs would"
                " be silently ignored)")
        return opt
    try:
        factory = OPTIMIZERS[opt]
    except KeyError:
        raise ValueError(f"Unknown optimizer {opt!r}; "
                         f"known: {sorted(OPTIMIZERS)}")
    return factory(**kwargs)
