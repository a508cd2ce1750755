"""The port's fused vocab head against the JAX package: the chunked
cross-entropy fused with the vocab projection
(``ops.losses.fused_linear_cross_entropy``), the train step that feeds it
(``make_train_step(fused_vocab_head=)``) and ``SingleTrainer``'s option,
case for case with the JAX package's ``tests/test_fused_head.py``.

The same numpy inputs go to both packages. Float32 values and gradients
agree within 1e-5 (only the order of the float32 sums differs); bf16
compute stays within 2e-2 of the float32 oracle (bf16 rounding of the
operands); train-step losses within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import Model as JaxModel
from distkeras_tpu.models import zoo as jax_zoo
from distkeras_tpu.ops import get_loss as jax_get_loss
from distkeras_tpu.ops import get_optimizer as jax_get_optimizer
from distkeras_tpu.ops import losses as jax_losses
from distkeras_tpu.parallel.worker import TrainCarry as JaxTrainCarry
from distkeras_tpu.parallel.worker import make_train_step as jax_step

from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.models import Model, Sequential, from_jax_params, zoo
from distkeras_tpu_torch.models.blocks import Remat
from distkeras_tpu_torch.models.core import layer_from_spec, layer_spec
from distkeras_tpu_torch.models.layers import Dense
from distkeras_tpu_torch.ops.losses import (
    fused_linear_cross_entropy, get_loss,
    masked_sparse_categorical_crossentropy_from_logits,
    sparse_categorical_crossentropy_from_logits)
from distkeras_tpu_torch.ops.optimizers import get_optimizer
from distkeras_tpu_torch.parallel import (AEASGD, SingleTrainer, TrainCarry,
                                          make_train_step)

#: float32 on both sides: the order of the chunked sums differs
F32_TOL = 1e-5
#: bf16 operands against the float32 oracle
BF16_TOL = 2e-2
LOSS = "sparse_categorical_crossentropy_from_logits"


@pytest.fixture(autouse=True, scope="module")
def _one_intraop_thread():
    """The tensors here are tiny: one intra-op thread runs them faster
    than a pool that contends with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(B=2, S=16, D=8, V=37, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, S, D).astype(np.float32),
            (rs.randn(D, V) * 0.1).astype(np.float32),
            rs.randint(0, V, (B, S)))


def _port_fused(h, w, y, **kw):
    ht = torch.tensor(h, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    loss = fused_linear_cross_entropy(ht, wt, torch.from_numpy(y), **kw)
    gh, gw = torch.autograd.grad(loss, (ht, wt))
    return float(loss.detach()), gh.numpy(), gw.numpy()


def _jax_fused(h, w, y, **kw):
    f = lambda h, w: jax_losses.fused_linear_cross_entropy(
        h, w, jnp.asarray(y), **kw)
    loss, (gh, gw) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    return float(loss), np.asarray(gh), np.asarray(gw)


def _assert_matches(got, ref, tol=F32_TOL):
    np.testing.assert_allclose(got[0], ref[0], rtol=tol)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g, r, atol=tol * max(1.0, np.abs(r).max()))


@pytest.mark.parametrize("num_chunks", [1, 3, 8])
def test_fused_ce_matches_jax_at_indivisible_token_counts(num_chunks):
    """N = 30 tokens: chunk counts 3 divides it, 8 pads it to 32 with
    label -1, 1 is the whole; value and gradients are JAX's fused loss
    and the port's unfused one."""
    h, w, y = _problem(B=2, S=15, D=8, V=11, seed=2)
    got = _port_fused(h, w, y, num_chunks=num_chunks,
                      compute_dtype=torch.float32)
    _assert_matches(got, _jax_fused(h, w, y, num_chunks=num_chunks,
                                    compute_dtype=jnp.float32))
    ht, wt = torch.tensor(h, requires_grad=True), torch.tensor(
        w, requires_grad=True)
    loss = sparse_categorical_crossentropy_from_logits(
        torch.from_numpy(y), torch.einsum("bsd,dv->bsv", ht, wt))
    gh, gw = torch.autograd.grad(loss, (ht, wt))
    _assert_matches(got, (float(loss), gh.numpy(), gw.numpy()))


def test_fused_ce_masked_matches_and_counts_only_live_tokens():
    h, w, y = _problem(seed=3)
    y[0, :9] = -1           # straddles chunk boundaries at num_chunks=4
    kw = dict(num_chunks=4, ignore_index=-1)
    got = _port_fused(h, w, y, compute_dtype=torch.float32, **kw)
    _assert_matches(got, _jax_fused(h, w, y, compute_dtype=jnp.float32,
                                    **kw))
    ht = torch.tensor(h, requires_grad=True)
    ref = masked_sparse_categorical_crossentropy_from_logits(
        torch.from_numpy(y), torch.einsum("bsd,dv->bsv", ht,
                                          torch.from_numpy(w)))
    np.testing.assert_allclose(got[0], float(ref), rtol=F32_TOL)
    # a fully ignored input: a finite zero loss and zero gradients
    loss, gh, _ = _port_fused(h, w, np.full_like(y, -1), ignore_index=-1,
                              compute_dtype=torch.float32)
    assert loss == 0.0 and np.abs(gh).max() == 0.0


def test_fused_ce_bf16_close_to_f32_oracle():
    h, w, y = _problem(B=2, S=32, D=16, V=64, seed=1)
    ht = torch.tensor(h).bfloat16().requires_grad_(True)
    wt = torch.tensor(w, requires_grad=True)
    lb = fused_linear_cross_entropy(ht, wt, torch.from_numpy(y),
                                    compute_dtype="bfloat16")
    gh, gw = torch.autograd.grad(lb, (ht, wt))
    assert ht.grad is None and gh.dtype == torch.bfloat16
    ref = _jax_fused(h, w, y, compute_dtype=jnp.float32)
    assert abs(float(lb) - ref[0]) < BF16_TOL
    for g, r in zip((gh.float().numpy(), gw.numpy()), ref[1:]):
        assert np.abs(g - r).max() <= BF16_TOL * np.abs(r).max()


def test_fused_ce_ignores_any_negative_label_like_masked_loss():
    h, w, y = _problem(seed=5)
    y[0, :5] = -100
    y[1, 3:7] = -1
    kw = dict(num_chunks=4, ignore_index=-1)
    _assert_matches(_port_fused(h, w, y, compute_dtype=torch.float32, **kw),
                    _jax_fused(h, w, y, compute_dtype=jnp.float32, **kw))
    with pytest.raises(ValueError, match="negative sentinel"):
        fused_linear_cross_entropy(torch.from_numpy(h), torch.from_numpy(w),
                                   torch.from_numpy(y), ignore_index=7)


def _lm_pair(V=64, S=16, seed=0, remat=None, **lm_kwargs):
    """A 2-layer LM in both packages with JAX's weights, and a batch."""
    kw = dict(d_model=32, num_heads=4, num_layers=2, mlp_ratio=2, **lm_kwargs)
    jm = JaxModel.build(jax_zoo.transformer_lm(V, attn_impl="xla", **kw),
                        (S,), seed=0)
    pm = Model.build(zoo.transformer_lm(V, remat=remat, **kw), (S,),
                     device="cpu")
    from_jax_params(pm, jax.device_get(jm.params), jax.device_get(jm.state))
    rs = np.random.RandomState(seed)
    return jm, pm, rs.randint(0, V, (4, S)), rs.randint(0, V, (4, S))


def _port_steps(pm, xb, yb, n=3, loss=LOSS, opt="adam", **kw):
    o = get_optimizer(opt, learning_rate=1e-3)
    step = make_train_step(pm.module, get_loss(loss), o, **kw)
    from distkeras_tpu_torch.ops import prng
    c = TrainCarry(pm.params, o.init(pm.params), prng.key(0), pm.state)
    losses = []
    for _ in range(n):
        c, l = step(c, (torch.from_numpy(xb), torch.from_numpy(yb)))
        losses.append(float(l))
    return losses, [p.detach().clone() for p in pm.module.parameters()]


def _jax_steps(jm, xb, yb, n=3, loss=LOSS, **kw):
    o = jax_get_optimizer("adam", learning_rate=1e-3)
    step = jax.jit(jax_step(jm.module, jax_get_loss(loss), o, **kw))
    c = JaxTrainCarry(jm.params, jm.state, o.init(jm.params),
                      jax.random.PRNGKey(0))
    losses = []
    for _ in range(n):
        c, l = step(c, (xb, yb))
        losses.append(float(l))
    return losses


def test_train_step_fused_head_matches_unfused_and_jax():
    jm, pm, xb, yb = _lm_pair()
    _, pu, _, _ = _lm_pair()
    lu, wu = _port_steps(pu, xb, yb, fused_vocab_head=False)
    lf, wf = _port_steps(pm, xb, yb, fused_vocab_head=True)
    np.testing.assert_allclose(lf, lu, rtol=1e-5)
    for a, b in zip(wf, wu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    np.testing.assert_allclose(
        lf, _jax_steps(jm, xb, yb, fused_vocab_head=True), rtol=1e-4)


@pytest.mark.parametrize("policy", ["nothing", "dots", "dots_no_batch"])
def test_remat_policies_match_no_remat_trajectory(policy):
    _, pm, xb, yb = _lm_pair()
    _, pr, _, _ = _lm_pair(remat=policy)
    lu, wu = _port_steps(pm, xb, yb, fused_vocab_head=True)
    lr, wr = _port_steps(pr, xb, yb, fused_vocab_head=True)
    np.testing.assert_allclose(lu, lr, rtol=1e-5)
    for a, b in zip(wu, wr):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_remat_policy_serialization_roundtrip():
    r = Remat(Dense(8, use_bias=False), policy="dots")
    assert layer_from_spec(layer_spec(r)).policy == "dots"
    with pytest.raises(ValueError, match="unknown remat policy"):
        Remat(Dense(8), policy="everything")


def test_fused_head_validation_errors():
    _, pm, _, _ = _lm_pair()
    opt = get_optimizer("adam", learning_rate=1e-3)
    ce = get_loss(LOSS)
    with pytest.raises(ValueError, match="metric_fns"):
        make_train_step(pm.module, ce, opt, fused_vocab_head=True,
                        metric_fns={"acc": lambda a, b: 0.0})
    with pytest.raises(ValueError, match="sparse"):
        make_train_step(pm.module, get_loss("mse"), opt,
                        fused_vocab_head=True)
    biased = Sequential([Dense(8), Dense(11)])  # the head has a bias
    with pytest.raises(ValueError, match="use_bias=False"):
        make_train_step(biased, ce, opt, fused_vocab_head=True)


def test_fused_head_masked_loss_ignores_padding():
    jm, pm, xb, yb = _lm_pair()
    _, pu, _, _ = _lm_pair()
    yb[:, -5:] = -1
    mce = "masked_sparse_categorical_crossentropy_from_logits"
    lf, _ = _port_steps(pm, xb, yb, n=1, loss=mce, opt="sgd",
                        fused_vocab_head=True)
    lu, _ = _port_steps(pu, xb, yb, n=1, loss=mce, opt="sgd")
    np.testing.assert_allclose(lf, lu, rtol=1e-5)
    np.testing.assert_allclose(
        lf, _jax_steps(jm, xb, yb, n=1, loss=mce, fused_vocab_head=True),
        rtol=1e-4)


def test_fused_head_int_chunk_count_passes_through():
    """``fused_vocab_head=2`` is a chunk count, not a bool: the same
    trajectory as the default's 8 chunks and as JAX's 2."""
    jm, pm, xb, yb = _lm_pair(S=15)
    _, p8, _, _ = _lm_pair(S=15)
    l2, _ = _port_steps(pm, xb, yb, n=2, fused_vocab_head=2)
    l8, _ = _port_steps(p8, xb, yb, n=2, fused_vocab_head=True)
    np.testing.assert_allclose(l2, l8, rtol=1e-5)
    np.testing.assert_allclose(
        l2, _jax_steps(jm, xb, yb, n=2, fused_vocab_head=2), rtol=1e-4)


def test_trainer_level_fused_head():
    """``SingleTrainer(fused_vocab_head=)``: the unfused trajectory, and
    JAX's fused trainer's; the engine family refuses it, and so does
    ``class_weight`` beside it."""
    from distkeras_tpu.data import Dataset as JaxDataset
    from distkeras_tpu.parallel import SingleTrainer as JaxSingleTrainer
    V, S = 32, 12
    rs = np.random.RandomState(0)
    pat = rs.randint(0, V, S + 1)
    X, Y = np.tile(pat[:-1], (64, 1)), np.tile(pat[1:], (64, 1))
    kw = dict(batch_size=32, num_epoch=3, worker_optimizer="adam",
              optimizer_kwargs={"learning_rate": 3e-3}, loss=LOSS,
              shuffle_each_epoch=False)
    spec = dict(d_model=32, num_heads=4, num_layers=2, mlp_ratio=2)
    losses = {}
    for fused in (False, True):
        tr = SingleTrainer(Model.build(zoo.transformer_lm(V, **spec), (S,),
                                       device="cpu"),
                           fused_vocab_head=fused, **kw)
        tr.train(Dataset({"features": X, "label": Y}))
        losses[fused] = tr.get_history().losses()
    np.testing.assert_allclose(losses[False], losses[True], rtol=2e-4,
                               atol=2e-4)
    jt = JaxSingleTrainer(JaxModel.build(jax_zoo.transformer_lm(
        V, attn_impl="xla", **spec), (S,), seed=0), fused_vocab_head=True,
        **kw)
    jt.train(JaxDataset({"features": X, "label": Y}))
    np.testing.assert_allclose(losses[True], jt.get_history().losses(),
                               rtol=2e-4, atol=2e-4)
    m = Model.build(zoo.transformer_lm(V, **spec), (S,), device="cpu")
    with pytest.raises(ValueError, match="class_weight"):
        SingleTrainer(m, fused_vocab_head=True, class_weight={0: 2.0}, **kw)
    with pytest.raises(ValueError, match="fused_vocab_head"):
        AEASGD(m, num_workers=2, fused_vocab_head=True, **kw).train(
            Dataset({"features": X, "label": Y}))


def test_fused_head_carries_moe_aux_loss():
    """The MoE balance loss joins the fused objective too: fused and
    unfused trajectories match on an MoE LM with a balance-loss weight,
    and the term is in the loss (not zero)."""
    moe = dict(moe_every=2, num_experts=4, moe_aux_loss_weight=0.05)
    jm, pm, xb, yb = _lm_pair(V=48, seed=1, **moe)
    _, pu, _, _ = _lm_pair(V=48, seed=1, **moe)
    lu, wu = _port_steps(pu, xb, yb, fused_vocab_head=False)
    lf, wf = _port_steps(pm, xb, yb, fused_vocab_head=True)
    np.testing.assert_allclose(lu, lf, rtol=1e-5)
    for a, b in zip(wu, wf):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    out, _ = jm.module.apply(jm.params, jm.state, xb, training=True,
                             rng=jax.random.PRNGKey(0))
    plain = float(jax_losses.sparse_categorical_crossentropy_from_logits(
        yb, out))
    assert lf[0] > plain + 1e-6, (lf[0], plain)
