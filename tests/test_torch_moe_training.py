"""MoE training in the port against the JAX package: the plain versions
of the fused block's backward kernels (K6b, K6c) against the Pallas
kernels in interpret mode, the fused block's gradients against
``jax.vjp`` of ``moe_fused_experts``, the ``MoE`` layer in training mode
(output, balance loss and gradients) under all three dispatches, the
auxiliary-loss channel, and a 2-layer MoE LM through ``make_train_step``
and ``SingleTrainer``.

JAX's fused op runs as its own tests run it on the CPU: under
``moe_kernels.force_interpret()``. Inputs are made with numpy from a
seed; weights cross with ``from_jax_params``. Every comparison is
float32; each tolerance states what can differ."""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distkeras_tpu.data.dataset import Dataset as JaxDataset
from distkeras_tpu.models import Model as JaxModel
from distkeras_tpu.models import zoo as jax_zoo
from distkeras_tpu.models.moe import MoE as JaxMoE
from distkeras_tpu.models.moe import _dispatch_plan as jax_plan
from distkeras_tpu.ops import losses as jax_losses
from distkeras_tpu.ops import moe_kernels as jmk
from distkeras_tpu.ops import optimizers as jax_opt
from distkeras_tpu.parallel import worker as jax_worker
from distkeras_tpu.parallel.trainers import SingleTrainer as JaxSingleTrainer

from distkeras_tpu_torch import kernels
from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.models import (Model, collect_aux_losses,
                                        from_jax_params, to_jax_params, zoo)
from distkeras_tpu_torch.models.moe import MoE
from distkeras_tpu_torch.ops import losses, optimizers
from distkeras_tpu_torch.ops import moe_kernels as mk
from distkeras_tpu_torch.ops import prng
from distkeras_tpu_torch.parallel import (SingleTrainer, TrainCarry,
                                          make_train_step)

#: float32 kernels and plain versions: reassociated sums over <= 64 terms
#: of O(1) values (the JAX suite's own 1e-5)
TOL = 1e-5
V = 29
PATTERN = np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8])
LOSS = "sparse_categorical_crossentropy_from_logits"


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, atol=TOL, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=what)


# --- K6b and K6c: the plain versions against the Pallas kernels --------------

#: (tokens N, capacity C, d, H, block_c): block_c divides C, so JAX's
#: kernels run at this very capacity; C = 7 and 15 are odd
BWD_CASES = [(4, 4, 16, 32, 4), (15, 7, 24, 40, 7), (40, 15, 32, 24, 5)]


def _bwd_inputs(n, c, d, hid, seed, e=4):
    """Random operands of the backward kernels: a plan whose expert 1 no
    slot reached and whose other rows are partly -1, row gates 0 there."""
    rs = np.random.RandomState(seed)
    src = rs.randint(-1, n, (e, c)).astype(np.int32)
    src[1] = -1
    f = lambda *s, k=1.0: (rs.randn(*s) * k).astype(np.float32)
    return dict(xt=f(n, d), g=f(n, d), src=src.reshape(-1),
                rg=(rs.rand(e, c) * (src >= 0)).astype(np.float32)
                .reshape(-1),
                w1=f(e, d, hid, k=0.3), b1=f(e, hid), w2=f(e, hid, d, k=0.3),
                b2=f(e, d), h=f(e, c, hid))


@pytest.mark.parametrize("activation", ["gelu", "relu", "silu"])
@pytest.mark.parametrize("n,c,d,hid,block_c", BWD_CASES)
def test_bwd_dx_reference_matches_pallas_kernel(n, c, d, hid, block_c,
                                                activation):
    """``bwd_dx`` on CPU tensors (its plain version, no launch) against
    JAX ``_bwd_dx`` in interpret mode: dxr, dz, gy and the row dots;
    a row no slot won gives exact zeros."""
    a = _bwd_inputs(n, c, d, hid, seed=n + c)
    want = jmk._bwd_dx(*(jnp.asarray(a[k]) for k in (
        "xt", "g", "src", "rg", "w1", "b1", "w2", "b2", "h")),
        capacity=c, block_c=block_c, act_name=activation, interpret=True)
    before = kernels.launch_counts()["moe_bwd_dx"]
    got = mk.bwd_dx(*(_t(a[k]) for k in (
        "xt", "g", "src", "rg", "w1", "b1", "w2", "b2", "h")), c,
        activation)
    assert kernels.launch_counts()["moe_bwd_dx"] == before
    shapes = [(4, c, d), (4, c, hid), (4, c, d), (4, c, 1)]
    for name, x, y, shape in zip(("dxr", "dz", "gy", "rowdot"), got, want,
                                 shapes):
        assert tuple(x.shape) == shape and x.dtype == torch.float32
        scale = max(1.0, float(np.abs(np.asarray(y)).max()))
        _close(x.numpy(), y, atol=TOL * scale, what=name)
        empty = (a["src"] < 0).reshape(4, c)
        assert (x.numpy()[empty] == 0).all(), name


@pytest.mark.parametrize("n,c,d,hid,block_c", BWD_CASES)
def test_bwd_dw1_reference_matches_pallas_kernel(n, c, d, hid, block_c):
    """``bwd_dw1`` on CPU tensors against JAX ``_bwd_dw1`` in interpret
    mode (its float32 accumulator across the capacity grid)."""
    a = _bwd_inputs(n, c, d, hid, seed=3 * n + c)
    dz = np.random.RandomState(c).randn(4, c, hid).astype(np.float32)
    want = jmk._bwd_dw1(jnp.asarray(a["xt"]), jnp.asarray(dz),
                        jnp.asarray(a["src"]), capacity=c, block_c=block_c,
                        interpret=True)
    before = kernels.launch_counts()["moe_bwd_dw1"]
    got = mk.bwd_dw1(_t(a["xt"]), _t(dz), _t(a["src"]), c)
    assert kernels.launch_counts()["moe_bwd_dw1"] == before
    assert got.shape == (4, d, hid) and got.dtype == torch.float32
    _close(got.numpy(), want, atol=TOL * max(1.0, np.abs(want).max()))
    assert (got.numpy()[1] == 0).all()        # expert 1 won no slot


def test_backward_wrappers_check_their_operands():
    a = {k: _t(v) for k, v in _bwd_inputs(6, 3, 8, 16, seed=1).items()}
    args = [a[k] for k in ("xt", "g", "src", "rg", "w1", "b1", "w2", "b2",
                           "h")]
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        mk.bwd_dx(*(t.to(meta) for t in args), 3)
    with pytest.raises(ValueError, match="cuda or cpu"):
        mk.bwd_dw1(a["xt"].to(meta), a["h"].to(meta), a["src"].to(meta), 3)
    with pytest.raises(ValueError, match="activation"):
        mk._activation_code("K6b", "tanh")
    with pytest.raises(TypeError, match="src_tok must be int32"):
        mk._check("K6b", a["xt"], a["src"].long(), 12, {}, {})
    with pytest.raises(TypeError, match="row_gate must be"):
        mk._check("K6b", a["xt"], a["src"], 12, {},
                  {"row_gate": (a["rg"].double(), (12,))})
    with pytest.raises(ValueError, match="shapes do not match"):
        mk._check("K6c", a["xt"], a["src"], 12,
                  {"dz": (a["h"], (4, 3, 17))}, {})


# --- the fused block's gradients against jax.vjp -----------------------------


def _plan_case(name):
    """``(N, d, H, capacity, gate scale, tied)`` of the JAX oracles in
    ``tests/test_moe_fused.py``: no drops (:57), drops (:74), capacity
    one (:100), all-tied router logits (:119), odd capacity (:224)."""
    return {"no-drops": (20, 8, 16, 20, False),
            "drops": (24, 8, 16, 6, False),
            "capacity-one": (6, 8, 16, 1, False),
            "ties": (16, 8, 16, 8, True),
            "odd-capacity": (10, 8, 16, 5, False)}[name]


@pytest.mark.parametrize("activation", ["gelu", "silu", "relu"])
@pytest.mark.parametrize("case", ["no-drops", "drops", "capacity-one",
                                  "ties", "odd-capacity"])
def test_fused_gradients_match_jax_vjp(case, activation):
    """``fused_moe_apply``'s output and the gradients of xt, w1, b1, w2,
    b2 and sg against ``jax.vjp`` of ``moe_fused_experts`` (interpret
    mode) on one top-2 plan of 4 experts."""
    n, d, hid, cap, tied = _plan_case(case)
    e, k = 4, 2
    rs = np.random.RandomState(n + cap)
    logits = np.zeros((n, e), np.float32) if tied else rs.randn(n, e)
    topi = np.argsort(-logits, axis=1, kind="stable")[:, :k].astype(np.int32)
    gates = rs.rand(n, k).astype(np.float32)
    dest, _, sg, keep = jax_plan(jnp.asarray(topi), jnp.asarray(gates), e,
                                 cap)
    f = lambda *s, sc=1.0: (rs.randn(*s) * sc).astype(np.float32)
    xt, w1, b1, w2, b2 = (f(n, d), f(e, d, hid, sc=0.3), f(e, hid, sc=0.1),
                          f(e, hid, d, sc=0.3), f(e, d, sc=0.1))
    cot = f(n, d)

    def fwd(xt_, w1_, b1_, w2_, b2_, sg_):
        return jmk.fused_moe_apply(xt_, w1_, b1_, w2_, b2_, sg_, dest, keep,
                                   capacity=cap, activation=activation,
                                   interpret=True)

    with jmk.force_interpret():
        want, vjp = jax.vjp(fwd, *(jnp.asarray(a) for a in
                                   (xt, w1, b1, w2, b2, np.asarray(sg))))
        want_g = vjp(jnp.asarray(cot))
    ours = [_t(a).requires_grad_(True) for a in
            (xt, w1, b1, w2, b2, np.asarray(sg))]
    out = mk.fused_moe_apply(*ours, _t(np.asarray(dest)),
                             _t(np.asarray(keep)), capacity=cap,
                             activation=activation)
    _close(out.detach().numpy(), want, what="out")
    got_g = torch.autograd.grad(out, ours, _t(cot))
    for name, a, b in zip(("xt", "w1", "b1", "w2", "b2", "sg"), got_g,
                          want_g):
        scale = max(1.0, float(np.abs(np.asarray(b)).max()))
        _close(a.numpy(), b, atol=TOL * scale, what=name)
    if case in ("drops", "capacity-one", "ties"):
        assert not np.asarray(keep).all()          # slots really dropped


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_block_dw2_on_the_cpu_is_the_float32_einsum(dtype):
    """On the CPU the fused block's ``dw2`` is the float32 einsum of the
    forward's hidden rows and K6b's ``gy`` (plain versions), cast to
    ``w2``'s dtype, bitwise; the tensor-core product is the card's
    alone."""
    n, d, hid, cap, _ = _plan_case("drops")
    e, k = 4, 2
    rs = np.random.RandomState(3)
    topi = np.argsort(rs.randn(n, e), axis=1)[:, :k].astype(np.int32)
    dest, _, sg, keep = (_t(np.asarray(a)) for a in jax_plan(
        jnp.asarray(topi), jnp.asarray(rs.rand(n, k).astype(np.float32)),
        e, cap))
    f = lambda *s, sc=1.0: _t((rs.randn(*s) * sc).astype(np.float32)).to(
        dtype)
    xt, w1, b1, w2, b2 = (f(n, d), f(e, d, hid, sc=0.3), f(e, hid, sc=0.1),
                          f(e, hid, d, sc=0.3), f(e, d, sc=0.1))
    cot = f(n, d)
    leaves = [t.clone().requires_grad_(True) for t in (xt, w1, b1, w2, b2)]
    out = mk.fused_moe_apply(*leaves, sg, dest, keep, capacity=cap)
    dw2 = torch.autograd.grad(out, leaves[3], cot)[0]
    src = mk.src_tokens(dest, n, e, cap)
    rg = mk.row_gates(dest, keep, sg, e, cap)
    h = mk.gather_gemm1_reference(xt, src, w1, b1, cap)
    gy = mk.bwd_dx_reference(xt, cot, src, rg, w1, b1, w2, b2, h, cap)[2]
    want = torch.einsum("ech,ecd->ehd", h.float(), gy.float()).to(dtype)
    assert dw2.dtype == dtype and torch.equal(dw2, want)
    assert torch.equal(mk._dw2(h, gy), torch.einsum("ech,ecd->ehd",
                                                    h.float(), gy.float()))


# --- the MoE layer in training mode -----------------------------------------


def _layer_pair(e, top_k, dispatch, cf, seed=0, d=16, hid=32, **extra):
    kw = dict(top_k=top_k, dispatch=dispatch, capacity_factor=cf,
              aux_loss_weight=0.01, **extra)
    jm = JaxMoE(e, hid, **kw)
    params, state, _ = jm.init(jax.random.PRNGKey(seed), (4, d))
    pm = MoE(e, hid, **kw)
    pm.build((4, d), prng.key(seed))
    tp = {k: _t(np.asarray(v)).requires_grad_(True)
          for k, v in params.items()}
    return jm, params, state, pm, tp


@pytest.mark.parametrize("cf", [1.0, 2.5], ids=["cf1", "cf2.5"])
@pytest.mark.parametrize("e,top_k", [(8, 1), (8, 2), (4, 4)],
                         ids=["top1", "top2", "topk-is-E"])
@pytest.mark.parametrize("dispatch", ["dense", "tokens", "fused"])
def test_moe_training_apply_matches_jax(dispatch, e, top_k, cf):
    """``MoE.apply`` in training mode at capacity factor 1.0 (slots drop
    under the dispatched paths) and 2.5: the output, the published
    balance loss (``top_k == E``: no mask) and the gradients of gate,
    w1, b1, w2, b2 and x of ``<out, cot> + aux`` against JAX's
    (``fused`` in interpret mode)."""
    jm, params, state, pm, tp = _layer_pair(e, top_k, dispatch, cf)
    rs = np.random.RandomState(10 * e + top_k)
    x = rs.randn(2, 12, 16).astype(np.float32)
    cot = rs.randn(2, 12, 16).astype(np.float32)

    def objective(p, xx):
        out, st = jm.apply(p, state, xx, training=True)
        return jnp.sum(out * cot) + st["__aux_loss__"], (out, st)

    ctx = jmk.force_interpret() if dispatch == "fused" \
        else contextlib.nullcontext()
    with ctx:
        (_, (want, st)), (gp, gx) = jax.value_and_grad(
            objective, argnums=(0, 1), has_aux=True)(params,
                                                     jnp.asarray(x))
    pm.train()
    xp = _t(x).requires_grad_(True)
    out = pm.apply(tp, xp)
    aux = collect_aux_losses(pm)
    _close(out.detach().numpy(), want, what="out")
    _close(aux.item(), float(st["__aux_loss__"]), atol=1e-7, what="aux")
    full, _, _, mask = pm._route(xp, tp["gate"])
    jfull, _, _, jmask = jm._route(jnp.asarray(x), params["gate"])
    assert (mask is None) == (top_k == e) == (jmask is None)
    _close(pm._balance_loss(full, mask).item(),
           float(jm._balance_loss(jfull, jmask)), atol=1e-6,
           what="balance loss")
    names = ("gate", "w1", "b1", "w2", "b2")
    grads = torch.autograd.grad((out * _t(cot)).sum() + aux,
                                [tp[k] for k in names] + [xp])
    for name, got in zip(names + ("x",), grads):
        want_g = gx if name == "x" else gp[name]
        scale = max(1.0, float(np.abs(np.asarray(want_g)).max()))
        _close(got.numpy(), want_g, atol=TOL * scale, what=name)


def test_expert_unroll_trains_like_jax():
    """``expert_unroll=True`` (JAX regroups the per-expert products; the
    port computes the same products batched): the training-mode output
    and the gradients of the expert weights equal JAX's."""
    jm, params, state, pm, tp = _layer_pair(8, 2, "tokens", 1.5,
                                            expert_unroll=True)
    x = np.random.RandomState(5).randn(2, 10, 16).astype(np.float32)

    def objective(p):
        out, st = jm.apply(p, state, jnp.asarray(x), training=True)
        return jnp.sum(jnp.square(out)) + st["__aux_loss__"]

    want = jax.grad(objective)(params)
    pm.train()
    out = pm.apply(tp, _t(x))
    loss = out.square().sum() + collect_aux_losses(pm)
    names = ("gate", "w1", "b1", "w2", "b2")
    for name, got in zip(names, torch.autograd.grad(
            loss, [tp[k] for k in names])):
        scale = max(1.0, float(np.abs(np.asarray(want[name])).max()))
        _close(got.numpy(), want[name], atol=TOL * scale, what=name)


def test_aux_losses_publish_in_training_only_and_clear():
    """An eval forward publishes nothing; a second forward replaces the
    first's term; ``collect_aux_losses`` sums every layer's and clears
    them; a layer without a weight publishes nothing."""
    _, _, _, pm, tp = _layer_pair(8, 2, "tokens", 2.0)
    x1 = _t(np.random.RandomState(1).randn(1, 6, 16).astype(np.float32))
    x2 = _t(np.random.RandomState(2).randn(1, 6, 16).astype(np.float32))
    pm.eval()
    pm.apply(tp, x1)
    assert collect_aux_losses(pm) == 0.0
    pm.train()
    pm.apply(tp, x1)
    first = collect_aux_losses(pm).item()
    assert first > 0 and collect_aux_losses(pm) == 0.0
    pm.apply(tp, x1)
    pm.apply(tp, x2)                               # replaces, not adds
    second = collect_aux_losses(pm).item()
    pm.apply(tp, x2)
    assert collect_aux_losses(pm).item() == second != first
    pm.apply(tp, x1)
    pm.eval()
    pm.apply(tp, x1)                               # clears the stale term
    assert collect_aux_losses(pm) == 0.0
    quiet = MoE(8, 32, dispatch="tokens")
    quiet.build((4, 16), prng.key(0))
    quiet.train()
    quiet.apply(quiet.param_tree(), x1)
    assert collect_aux_losses(quiet) == 0.0


# --- a 2-layer MoE LM through make_train_step and SingleTrainer --------------


def _lm_pair(dispatch, seed=2):
    kw = dict(d_model=32, num_heads=4, num_layers=2, mlp_ratio=2,
              moe_every=1, num_experts=4, moe_aux_loss_weight=0.01,
              moe_dispatch=dispatch, moe_capacity_factor=1.0)
    jm = JaxModel.build(jax_zoo.transformer_lm(V, **kw), (11,), seed=seed)
    pm = Model.build(zoo.transformer_lm(V, **kw), (11,), device="cpu")
    from_jax_params(pm, jm.params, jm.state)
    return jm, pm


def _jax_ctx(dispatch):
    return jmk.force_interpret() if dispatch == "fused" \
        else contextlib.nullcontext()


def _tree_close(got, want, **tol):
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol)


#: one step (the dense LM's ``test_train_step_matches_jax`` tolerances):
#: float32 forward/backward through different attention code and
#: summation orders. The step is plain SGD at lr 1, so the weights'
#: difference IS the gradients' difference: Adam would move each weight
#: by about lr * sign(g), and a gradient within a few float32 ulps of
#: its eps (this LM has some of ~5e-8) would turn summation-order noise
#: into a visible fraction of lr
STEP_TOL = dict(rtol=1e-5, atol=2e-6)
STEP_WEIGHT_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("dispatch", ["tokens", "fused"])
def test_moe_train_step_matches_jax(dispatch, accum):
    """One SGD step of a 2-layer all-MoE LM (aux weight 0.01, capacity
    factor 1.0): the loss (the balance terms included, as JAX reports
    it) and the updated weights."""
    jm, pm = _lm_pair(dispatch)
    rs = np.random.RandomState(accum)
    x = rs.randint(0, V, (4, 11)).astype(np.int32)
    y = rs.randint(0, V, (4, 11)).astype(np.int32)
    jo, po = jax_opt.sgd(1.0), optimizers.sgd(1.0)
    jstep = jax_worker.make_train_step(jm.module, jax_losses.get_loss(LOSS),
                                       jo, None, accum)
    carry = jax_worker.TrainCarry(jm.params, jm.state, jo.init(jm.params),
                                  jax.random.PRNGKey(0))
    with _jax_ctx(dispatch):
        jcarry, jloss = jax.jit(jstep)(carry, (x, y))
    pstep = make_train_step(pm.module, losses.get_loss(LOSS), po, None,
                            accum)
    pcarry, ploss = pstep(TrainCarry(pm.params, po.init(pm.params)),
                          (_t(x), _t(y)))
    np.testing.assert_allclose(float(ploss), float(jloss), **STEP_TOL)
    _tree_close(to_jax_params(pm), jcarry.params, **STEP_WEIGHT_TOL)


#: two shuffled epochs (8 adam steps): per-step float32 differences of
#: ~1e-6 compound slightly through the optimizer state (the dense LM's
#: ``FIT_LOSS_TOL``)
FIT_LOSS_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dispatch", ["tokens", "fused"])
def test_moe_model_fit_matches_jax_with_validation_and_accumulation(
        dispatch):
    """``Model.fit`` (SGD, two microbatches a step, a validation split) on
    the 2-layer MoE LM: per-step losses (balance terms included) and
    per-epoch validation losses (eval mode: no balance term) against
    JAX's ``fit``."""
    jm, pm = _lm_pair(dispatch)
    X = np.tile(PATTERN, (96, 1))
    kw = dict(optimizer="sgd", learning_rate=0.2, batch_size=16, epochs=2,
              validation_split=0.25, grad_accum_steps=2, loss=LOSS)
    with _jax_ctx(dispatch):
        jh = jm.fit(X[:, :-1], X[:, 1:], **kw)
    ph = pm.fit(X[:, :-1], X[:, 1:], **kw)
    np.testing.assert_allclose(ph.losses(), jh.losses(), **FIT_LOSS_TOL)
    for e_p, e_j in zip(ph.epochs, jh.epochs):
        np.testing.assert_allclose(e_p["val_loss"], e_j["val_loss"],
                                   **FIT_LOSS_TOL)


@pytest.mark.parametrize("dispatch", ["dense", "tokens", "fused"])
def test_moe_single_trainer_matches_jax(dispatch):
    """``SingleTrainer`` over two shuffled epochs of the pattern: per-step
    losses against JAX's ``SingleTrainer``, and the loss falls."""
    jm, pm = _lm_pair(dispatch)
    X = np.tile(PATTERN, (128, 1))
    x, y = X[:, :-1], X[:, 1:]
    kw = dict(worker_optimizer="adam", learning_rate=5e-3, batch_size=32,
              num_epoch=2, seed=3, loss=LOSS)
    with _jax_ctx(dispatch):
        jt = JaxSingleTrainer(jm, **kw)
        jt.train(JaxDataset.from_arrays(x, y))
    pt = SingleTrainer(pm, **kw)
    assert pt.train(Dataset.from_arrays(x, y)) is pm
    ph, jh = pt.get_history(), jt.get_history()
    assert len(ph.losses()) == 8
    np.testing.assert_allclose(ph.losses(), jh.losses(), **FIT_LOSS_TOL)
    assert ph.losses()[-1] < ph.losses()[0]
