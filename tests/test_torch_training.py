"""The port's training path against the JAX package: optimizers,
schedules, losses and metrics; one ``make_train_step``; ``SingleTrainer``
and ``Model.fit`` over two shuffled epochs; and serving a model the port
has just trained. Inputs are made with numpy from seeds and handed to
both sides; weights cross with ``from_jax_params`` / ``to_jax_params``.

On the CPU the port's attention runs the plain flash forward and
backward (the JAX side trains through its XLA attention, which is what
it selects off a TPU). Every comparison is float32; each tolerance
states what can differ.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distkeras_tpu.data.dataset import Dataset as JaxDataset
from distkeras_tpu.models import Model as JaxModel
from distkeras_tpu.models import zoo as jax_zoo
from distkeras_tpu.models.decoding import generate
from distkeras_tpu.ops import losses as jax_losses
from distkeras_tpu.ops import metrics as jax_metrics
from distkeras_tpu.ops import optimizers as jax_opt
from distkeras_tpu.ops import schedules as jax_sched
from distkeras_tpu.parallel import worker as jax_worker
from distkeras_tpu.parallel.trainers import SingleTrainer as JaxSingleTrainer

from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.models import (Model, Sequential, from_jax_params,
                                        to_jax_params, zoo)
from distkeras_tpu_torch.models.layers import Dense
from distkeras_tpu_torch.ops import (losses, metrics, optimizers, prng,
                                     schedules)
from distkeras_tpu_torch.parallel import (SingleTrainer, TrainCarry,
                                          make_train_step)
from distkeras_tpu_torch.serving import ServingEngine

V = 29
PATTERN = np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8])
LM_KW = dict(d_model=32, num_heads=4, num_layers=2, mlp_ratio=2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), **tol)


def _tree_close(got, ref, **tol):
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(ref)
    for g, r in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        _close(g, r, **tol)


# --- (b) optimizers, schedules, losses, metrics ------------------------------

def _opt_cases():
    both = lambda name, **kw: (name, kw, kw)
    sched = lambda mod: mod.cosine_decay(0.05, 4, alpha=0.1,
                                         warmup_steps=2)
    expo = lambda mod: mod.exponential_decay(0.1, 2, 0.5, staircase=True)
    pw = lambda mod: mod.piecewise_constant([2, 4], [0.1, 0.05, 0.01])
    return [
        both("sgd", learning_rate=0.1),
        both("momentum", learning_rate=0.1),
        both("nesterov", learning_rate=0.1, momentum=0.8),
        both("adagrad", learning_rate=0.1),
        both("rmsprop", learning_rate=0.01),
        both("adam", learning_rate=0.01),
        both("adamw", learning_rate=0.01, weight_decay=0.1),
        both("adadelta"),
        both("lars", learning_rate=0.5, weight_decay=0.01),
        both("lamb", learning_rate=0.01, weight_decay=0.01),
        ("adam", {"learning_rate": sched(jax_sched)},
         {"learning_rate": sched(schedules)}),
        ("sgd", {"learning_rate": expo(jax_sched)},
         {"learning_rate": expo(schedules)}),
        ("momentum", {"learning_rate": pw(jax_sched)},
         {"learning_rate": pw(schedules)}),
    ]


def _seeded_tree(rs):
    return [{"w": rs.randn(3, 4).astype(np.float32),
             "b": rs.randn(4).astype(np.float32)},
            {"inner": {"k": rs.randn(2, 3, 2).astype(np.float32)}}]


@pytest.mark.parametrize("clip", [None, 0.5])
@pytest.mark.parametrize("case", range(13))
def test_optimizers_match_jax_over_five_updates(case, clip):
    """Same formulas in float32 on both sides; only the reduction order of
    the norms (lars, lamb, clipping) and the last ulp of pow/sqrt may
    differ."""
    name, jkw, pkw = _opt_cases()[case]
    rs = np.random.RandomState(case)
    params = _seeded_tree(rs)
    grads = [_seeded_tree(rs) for _ in range(5)]
    jo, po = (jax_opt.get_optimizer(name, **jkw),
              optimizers.get_optimizer(name, **pkw))
    if clip is not None:
        jo = jax_opt.clip_by_global_norm(jo, clip)
        po = optimizers.clip_by_global_norm(po, clip)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    pp = jax.tree_util.tree_map(_t, params)
    js, ps = jo.init(jp), po.init(pp)
    for g in grads:
        upd, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = jax_opt.apply_updates(jp, upd)
        upd, ps = po.update(jax.tree_util.tree_map(_t, g), ps, pp)
        optimizers.apply_updates(pp, upd)
    _tree_close(jax.tree_util.tree_map(lambda x: x.numpy(), pp),
                jax.tree_util.tree_map(np.asarray, jp), rtol=1e-5, atol=1e-6)


def _loss_cases(rs):
    probs = lambda *s: np.asarray(jax.nn.softmax(rs.randn(*s)), np.float32)
    onehot = np.eye(5, dtype=np.float32)[rs.randint(0, 5, 4)]
    t01 = rs.randint(0, 2, 6).astype(np.float32)
    labels_bs = rs.randint(0, 7, (2, 6))
    masked = labels_bs.copy()
    masked[0, :2] = -1
    return [
        ("mean_squared_error", rs.randn(4, 3), rs.randn(4, 3)),
        ("mean_absolute_error", rs.randn(4, 3), rs.randn(4, 3)),
        ("categorical_crossentropy", onehot, probs(4, 5)),
        ("categorical_crossentropy_from_logits", onehot, rs.randn(4, 5)),
        ("sparse_categorical_crossentropy", rs.randint(0, 5, 4),
         probs(4, 5)),
        ("sparse_categorical_crossentropy", labels_bs, probs(2, 6, 7)),
        ("sparse_categorical_crossentropy_from_logits", labels_bs,
         rs.randn(2, 6, 7)),
        ("masked_sparse_categorical_crossentropy_from_logits", masked,
         rs.randn(2, 6, 7)),
        ("binary_crossentropy", t01, probs(6, 2)[:, :1]),
        ("binary_crossentropy_from_logits", t01, rs.randn(6, 1)),
        ("hinge", t01, rs.randn(6)),
        ("hinge", 2 * t01 - 1, rs.randn(6)),
    ]


@pytest.mark.parametrize("case", range(12))
def test_losses_match_jax(case):
    """float32 elementwise math on both sides (log_softmax and the
    reductions may differ in the last ulps)."""
    name, y, p = _loss_cases(np.random.RandomState(case))[case]
    p = np.asarray(p, np.float32)
    ref = jax_losses.get_loss(name)(jnp.asarray(y), jnp.asarray(p))
    got = losses.get_loss(name)(_t(y), _t(p))
    _close(got, ref, rtol=1e-6, atol=1e-6)


def test_sparse_ce_casts_bf16_logits_to_float32_like_jax():
    """The LM's logits are bf16: both sides cast the same bf16 values to
    float32 before log_softmax."""
    rs = np.random.RandomState(3)
    y, x = rs.randint(0, 11, (3, 5)), rs.randn(3, 5, 11).astype(np.float32)
    name = "sparse_categorical_crossentropy_from_logits"
    ref = jax_losses.get_loss(name)(jnp.asarray(y),
                                    jnp.asarray(x, jnp.bfloat16))
    got = losses.get_loss(name)(_t(y), _t(x).bfloat16())
    _close(got, ref, rtol=1e-6, atol=1e-6)


def _metric_cases(rs):
    onehot = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 8)]
    return [
        ("accuracy", rs.randint(0, 4, 8), rs.randn(8, 4)),
        ("accuracy", onehot, rs.randn(8, 4)),
        # [B, S] integer LM targets with S == vocab: class ids, never
        # argmaxed
        ("accuracy", rs.randint(0, 6, (3, 6)), rs.randn(3, 6, 6)),
        ("accuracy", rs.randint(0, 2, 8), rs.rand(8)),            # probs
        ("accuracy", rs.randint(0, 2, 8), rs.randn(8)),           # logits
        ("top_5_accuracy", rs.randint(0, 9, 8), rs.randn(8, 9)),
        ("top_5_accuracy", rs.randint(0, 9, (2, 9)), rs.randn(2, 9, 9)),
    ]


@pytest.mark.parametrize("case", range(7))
def test_metrics_match_jax(case):
    name, y, p = _metric_cases(np.random.RandomState(case))[case]
    p = np.asarray(p, np.float32)
    ref = jax_metrics.get_metric(name)(jnp.asarray(y), jnp.asarray(p))
    got = metrics.get_metric(name)(_t(y), _t(p))
    assert float(got) == float(ref)
    k2 = metrics.top_k_accuracy(_t(y), _t(p), 2) if p.ndim > 1 else None
    if k2 is not None:
        assert float(k2) == float(jax_metrics.top_k_accuracy(
            jnp.asarray(y), jnp.asarray(p), 2))


def test_dataset_matches_jax():
    rs = np.random.RandomState(0)
    X, y = rs.randn(10, 3), rs.randint(0, 4, 10)
    jd, pd = JaxDataset.from_arrays(X, y), Dataset.from_arrays(X, y)
    assert len(pd) == len(jd) == 10 and pd.columns == jd.columns
    for a, b in zip(pd.shuffle(7).arrays(), jd.shuffle(7).arrays()):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    (pa, pb), (ja, jb) = pd.split(0.7), jd.split(0.7)
    assert (len(pa), len(pb)) == (len(ja), len(jb)) == (7, 3)
    np.testing.assert_array_equal(pd.take(4)["label"], jd.take(4)["label"])


# --- (c) one train step ------------------------------------------------------

def _pair(seed=2, **cfg):
    kw = dict(LM_KW, **cfg)
    jm = JaxModel.build(jax_zoo.transformer_lm(V, **kw), (11,), seed=seed)
    pm = Model.build(zoo.transformer_lm(V, **kw), (11,), device="cpu")
    from_jax_params(pm, jm.params, jm.state)
    return jm, pm


def _pattern_data(rows=256):
    X = np.tile(PATTERN, (rows, 1))
    return X[:, :-1], X[:, 1:]


#: one step: float32 forward/backward through different attention code
#: (XLA softmax vs the plain flash version) and summation orders. The
#: weights get a looser absolute bound: Adam scales each update to about
#: lr * sign(g), so a gradient component near zero, whose float32 value
#: depends on the summation order, can move its weight by a visible
#: fraction of lr (1e-5 is lr / 1000)
STEP_TOL = dict(rtol=1e-5, atol=2e-6)
STEP_WEIGHT_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum):
    jm, pm = _pair(num_kv_heads=2)
    rs = np.random.RandomState(accum)
    x = rs.randint(0, V, (4, 11)).astype(np.int32)
    y = rs.randint(0, V, (4, 11)).astype(np.int32)
    name = "sparse_categorical_crossentropy_from_logits"
    jo = jax_opt.clip_by_global_norm(jax_opt.adam(1e-2), 1.0)
    po = optimizers.clip_by_global_norm(optimizers.adam(1e-2), 1.0)
    jstep = jax_worker.make_train_step(
        jm.module, jax_losses.get_loss(name), jo,
        {"accuracy": jax_metrics.accuracy}, accum)
    carry = jax_worker.TrainCarry(jm.params, jm.state, jo.init(jm.params),
                                  jax.random.PRNGKey(0))
    jcarry, (jloss, jmets) = jax.jit(jstep)(carry, (x, y))
    pstep = make_train_step(pm.module, losses.get_loss(name), po,
                            {"accuracy": metrics.accuracy}, accum)
    pcarry, (ploss, pmets) = pstep(TrainCarry(pm.params, po.init(pm.params)),
                                   (_t(x), _t(y)))
    _close(ploss, jloss, **STEP_TOL)
    assert float(pmets["accuracy"]) == float(jmets["accuracy"])
    assert int(pcarry.opt_state["t"]) == 1
    _tree_close(to_jax_params(pm), jcarry.params, **STEP_WEIGHT_TOL)


# --- (c') dropout: JAX's masks through the key chain ----------------------------


def _dropout_pair(seed=1):
    """A stack with a standalone ``Dropout`` and two blocks with
    ``dropout_rate``, JAX's weights on both sides."""
    from distkeras_tpu.models import Sequential as JaxSequential
    from distkeras_tpu.models.attention import \
        TransformerBlock as JaxBlock
    from distkeras_tpu.models.layers import Dense as JaxDense
    from distkeras_tpu.models.layers import Dropout as JaxDropout
    from distkeras_tpu.models.layers import Embedding as JaxEmbedding
    from distkeras_tpu_torch.models import Sequential
    from distkeras_tpu_torch.models.attention import TransformerBlock
    from distkeras_tpu_torch.models.layers import Dense, Dropout, Embedding

    def spec(seq, emb, block, drop, dense):
        return seq([emb(V, 16), block(num_heads=2, mlp_ratio=2,
                                      dropout_rate=0.2),
                    drop(0.3), block(num_heads=2, mlp_ratio=2,
                                     dropout_rate=0.1), dense(V)])

    jm = JaxModel.build(spec(JaxSequential, JaxEmbedding, JaxBlock,
                             JaxDropout, JaxDense), (8,), seed=seed)
    pm = Model.build(spec(Sequential, Embedding, TransformerBlock, Dropout,
                          Dense), (8,), seed=seed, device="cpu")
    return jm, pm


#: a dropout step: the masks are bitwise JAX's; the float32 forward and
#: backward differ in summation order only (as ``STEP_TOL``)
DROPOUT_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("accum", [1, 2])
def test_dropout_train_step_matches_jax(accum):
    """One SGD step of a model with dropout from the same key: the loss,
    the updated weights (the gradients times lr) and the carried key
    equal JAX's; ``build(seed=)`` gave JAX's weights bitwise."""
    jm, pm = _dropout_pair()
    for a, b in zip(jax.tree_util.tree_leaves(jm.params),
                    jax.tree_util.tree_leaves(to_jax_params(pm))):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    rs = np.random.RandomState(accum)
    x = rs.randint(0, V, (4, 8)).astype(np.int32)
    y = rs.randint(0, V, (4, 8)).astype(np.int32)
    name = "sparse_categorical_crossentropy_from_logits"
    jo, po = jax_opt.sgd(0.5), optimizers.sgd(0.5)
    jstep = jax_worker.make_train_step(jm.module, jax_losses.get_loss(name),
                                       jo, None, accum)
    jcarry, jloss = jax.jit(jstep)(
        jax_worker.TrainCarry(jm.params, jm.state, jo.init(jm.params),
                              jax.random.PRNGKey(4)), (x, y))
    pstep = make_train_step(pm.module, losses.get_loss(name), po, None,
                            accum)
    pcarry, ploss = pstep(TrainCarry(pm.params, po.init(pm.params),
                                     prng.key(4)), (_t(x), _t(y)))
    _close(ploss, jloss, **DROPOUT_TOL)
    _tree_close(to_jax_params(pm), jcarry.params, **DROPOUT_TOL)
    np.testing.assert_array_equal(pcarry.rng.numpy(),
                                  np.asarray(jcarry.rng).astype(np.int64))
    # the masks matter: without a key the step's loss is another one
    _, pm2 = _dropout_pair()
    _, plain = make_train_step(pm2.module, losses.get_loss(name),
                               optimizers.sgd(0.5), None, accum)(
        TrainCarry(pm2.params, po.init(pm2.params)), (_t(x), _t(y)))
    assert abs(float(plain) - float(ploss)) > 1e-3


def test_dropout_single_trainer_matches_jax():
    """``SingleTrainer`` with dropout: the key chain from ``PRNGKey(seed)``
    gives JAX's per-step losses over two shuffled epochs."""
    jm, pm = _dropout_pair(seed=3)
    x, y = _pattern_data(64)
    x, y = x[:, :8], y[:, :8]
    kw = dict(worker_optimizer="sgd", learning_rate=0.2, batch_size=16,
              num_epoch=2, seed=5,
              loss="sparse_categorical_crossentropy_from_logits")
    jt = JaxSingleTrainer(jm, **kw)
    jt.train(JaxDataset.from_arrays(x, y))
    pt = SingleTrainer(pm, **kw)
    pt.train(Dataset.from_arrays(x, y))
    _close(pt.get_history().losses(), jt.get_history().losses(),
           **FIT_LOSS_TOL)


# --- (d) SingleTrainer / Model.fit against JAX's SingleTrainer ---------------

#: two shuffled epochs (8 adam steps): per-step float32 differences of
#: ~1e-6 compound slightly through the optimizer state
FIT_LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
FIT_WEIGHT_TOL = dict(rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("cfg", [{}, {"num_kv_heads": 2}],
                         ids=["mha", "gqa"])
def test_single_trainer_matches_jax(cfg):
    jm, pm = _pair(**cfg)
    x, y = _pattern_data()
    kw = dict(worker_optimizer="adam", learning_rate=5e-3, batch_size=64,
              num_epoch=2, seed=3, metrics=["accuracy"],
              loss="sparse_categorical_crossentropy_from_logits")
    jt = JaxSingleTrainer(jm, **kw)
    trained = jt.train(JaxDataset.from_arrays(x, y))
    pt = SingleTrainer(pm, **kw)
    assert pt.train(Dataset.from_arrays(x, y)) is pm
    jh, ph = jt.get_history(), pt.get_history()
    assert len(ph.epochs) == 2 and len(ph.losses()) == 8
    _close(ph.losses(), jh.losses(), **FIT_LOSS_TOL)
    np.testing.assert_array_equal(ph.metric("accuracy"),
                                  jh.metric("accuracy"))
    _tree_close(to_jax_params(pm), trained.params, **FIT_WEIGHT_TOL)


def test_model_fit_matches_jax_with_validation_and_accumulation():
    jm, pm = _pair()
    x, y = _pattern_data(128)
    kw = dict(optimizer="sgd", learning_rate=0.2, batch_size=32, epochs=2,
              validation_split=0.25, grad_accum_steps=2,
              loss="sparse_categorical_crossentropy_from_logits",
              metrics=["accuracy"])
    jh = jm.fit(x, y, **kw)
    ph = pm.fit(x, y, **kw)
    _close(ph.losses(), jh.losses(), **FIT_LOSS_TOL)
    for e_p, e_j in zip(ph.epochs, jh.epochs):
        assert set(e_p) == set(e_j)
        _close(e_p["val_loss"], e_j["val_loss"], **FIT_LOSS_TOL)
    _tree_close(to_jax_params(pm), jm.params, **FIT_WEIGHT_TOL)


# --- (e) serving right after training ----------------------------------------

def test_engine_after_fit_serves_like_jax_generate():
    """Train the port's LM on the pattern, then serve it: greedy streams
    equal JAX ``generate()`` on the same (exported) trained weights, and
    nothing the engine hands out carries autograd state."""
    jm, pm = _pair(seed=4, num_kv_heads=2)
    x, y = _pattern_data()
    hist = pm.fit(x, y, optimizer="adam", learning_rate=1e-2,
                  batch_size=64, epochs=8,
                  loss="sparse_categorical_crossentropy_from_logits")
    assert hist.losses()[-1] < 0.1 * hist.losses()[0]
    jm.params = to_jax_params(pm)
    grad_seen = []
    eng = ServingEngine(pm, num_slots=2, max_len=32, page_len=4,
                        prefill_chunk=4, device="cpu",
                        on_logits=lambda kind, logits, slots:
                        grad_seen.append(logits.requires_grad))
    prompts = [PATTERN[:4], PATTERN[2:9], np.tile(PATTERN, 2)[5:11]]
    rids = [eng.submit(p, 8) for p in prompts]
    out = eng.run(max_steps=500)
    for rid, p in zip(rids, prompts):
        ref = generate(jm, p[None], max_new_tokens=8, temperature=0.0,
                       prefill_chunk=4)[0]
        np.testing.assert_array_equal(out[rid], ref)
    assert grad_seen and not any(grad_seen)
    assert not pm.apply(_t(x[:2])).requires_grad
    assert all(p.grad is None for p in pm.module.parameters())


# --- (f) devices and the options of later slices -----------------------------

def _tiny(device="cpu"):
    return Model.build(zoo.transformer_lm(V, d_model=16, num_heads=2,
                                          num_layers=1), (11,),
                       device=device)


def test_training_needs_cuda_unless_built_on_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a card")
    x, y = _pattern_data(8)
    cpu = _tiny()
    on_card = Model(cpu.module, cpu.input_shape, cpu.output_shape,
                    torch.device("cuda"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SingleTrainer(on_card, batch_size=4).train(Dataset.from_arrays(x, y))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        on_card.fit(x, y, batch_size=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model.build(zoo.transformer_lm(V, d_model=16, num_heads=2,
                                       num_layers=1), (11,))
    hist = cpu.fit(x, y, batch_size=4, optimizer="sgd",
                   loss="sparse_categorical_crossentropy_from_logits")
    assert np.isfinite(hist.losses()).all() and len(hist.losses()) == 2


@pytest.mark.parametrize("kw", [
    {"checkpoint_dir": "ckpt"}, {"resume": True},
    {"checkpoint_async": True}, {"callbacks": [object()]},
    {"profile_dir": "prof"}, {"class_weight": {0: 2.0}},
    {"fused_vocab_head": True}, {"telemetry": object()},
    {"metrics": ["auc"]}])
def test_later_trainer_options_raise_naming_the_roadmap(kw, tmp_path):
    """The Trainer options of ROADMAP Queue 1 item 9 are ported (the ids
    keep the cases of the options that raised): each takes effect on the
    CPU. ``telemetry`` (JAX's obs tape) still raises, naming item 11."""
    from distkeras_tpu_torch.utils import CheckpointManager, LambdaCallback
    x, y = _pattern_data(8)
    ds = Dataset.from_arrays(x, y)
    (name, value), = kw.items()
    base = dict(batch_size=4, loss="sparse_categorical_crossentropy_from_"
                "logits", worker_optimizer="adam", learning_rate=1e-2)
    if name == "telemetry":
        with pytest.raises(NotImplementedError, match="item 11"):
            SingleTrainer(_tiny(), **base, **kw)
        return
    if name in ("checkpoint_dir", "resume", "checkpoint_async"):
        ck = str(tmp_path / "ckpt")
        opts = {"checkpoint_dir": ck, "checkpoint_async": name ==
                "checkpoint_async"}
        whole = SingleTrainer(_tiny(), num_epoch=2, **base).train(ds)
        SingleTrainer(_tiny(), num_epoch=1, **base, **opts).train(ds)
        assert CheckpointManager(ck).latest_step() == 0
        tr = SingleTrainer(_tiny(), num_epoch=2, resume=True, **base,
                           **opts)
        resumed = tr.train(ds)
        assert len(tr.get_history().epochs) == 1
        for a, b in zip(whole.module.parameters(),
                        resumed.module.parameters()):
            assert torch.equal(a, b)
        return
    if name == "callbacks":
        with pytest.raises(TypeError, match="Callback instances"):
            SingleTrainer(_tiny(), **base, **kw).train(ds)
        seen = []
        SingleTrainer(_tiny(), num_epoch=2, **base, callbacks=[
            LambdaCallback(on_epoch_end=lambda e, logs: seen.append(
                (e, sorted(logs))))]).train(ds)
        assert seen == [(0, ["loss"]), (1, ["loss"])]
        return
    if name == "profile_dir":
        SingleTrainer(_tiny(), profile_dir=str(tmp_path / value),
                      **base).train(ds)
        assert os.listdir(tmp_path / value)
        return
    if name == "metrics":
        rs = np.random.RandomState(0)
        X = rs.randn(64, 4).astype(np.float32)
        m = Model.build(Sequential([Dense(2)]), (4,), device="cpu")
        tr = SingleTrainer(m, **dict(base, batch_size=16), **kw)
        tr.train(Dataset.from_arrays(X, (X[:, 0] > 0).astype(np.int64)))
        auc = tr.get_history().metric("auc")
        assert auc.shape == (4,) and ((auc >= 0) & (auc <= 1)).all()
        return
    plain = SingleTrainer(_tiny(), **base)
    plain.train(ds)
    tr = SingleTrainer(_tiny(), **base, **kw)
    tr.train(ds)
    if name == "class_weight":
        # token 0 never occurs in the pattern: the weight changes nothing
        np.testing.assert_array_equal(tr.get_history().losses(),
                                      plain.get_history().losses())
        tr = SingleTrainer(_tiny(), **dict(base, class_weight={1: 2.0}))
        tr.train(ds)
        assert (tr.get_history().losses()[0]
                > plain.get_history().losses()[0])
    else:   # the fused vocab head: the unfused trajectory
        np.testing.assert_allclose(tr.get_history().losses(),
                                   plain.get_history().losses(), rtol=1e-5)


def test_sharded_input_and_masks_raise_naming_the_roadmap(tmp_path):
    """``ShardedDataset`` input and frozen layers are ported (the name
    keeps the case that raised): a sharded run trains the in-memory run's
    steps, ``param_mask`` freezes a leaf bitwise, and input that is no
    dataset at all still fails."""
    from distkeras_tpu_torch.data import ShardedDataset
    x, y = _pattern_data(8)
    base = dict(batch_size=4, shuffle_each_epoch=False, loss=(
        "sparse_categorical_crossentropy_from_logits"))
    sds = ShardedDataset.write(Dataset.from_arrays(x, y),
                               str(tmp_path / "shards"), 2)
    a = SingleTrainer(_tiny(), **base)
    a.train(Dataset.from_arrays(x, y))
    b = SingleTrainer(_tiny(), **base)
    b.train(sds)
    np.testing.assert_array_equal(a.get_history().losses(),
                                  b.get_history().losses())
    with pytest.raises(AttributeError):
        SingleTrainer(_tiny(), batch_size=4).train({"features": x,
                                                    "label": y})
    m = _tiny()
    mask = [{k: i != 0 for k in p} for i, p in enumerate(m.params)]
    opt = optimizers.adamw(learning_rate=1e-2, weight_decay=0.1)
    step = make_train_step(m.module, losses.get_loss(
        "sparse_categorical_crossentropy_from_logits"), opt,
        param_mask=mask)
    before = {k: v.clone() for k, v in m.params[0].items()}
    other = m.params[-1]["kernel"].clone()
    step(TrainCarry(m.params, opt.init(m.params)), (_t(x), _t(y)))
    for k, v in before.items():
        assert torch.equal(m.params[0][k], v)
    assert not torch.equal(m.params[-1]["kernel"], other)
