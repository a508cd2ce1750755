"""The rest of the port's Trainer surface against the JAX package: frozen
layers (``Layer.trainable``, ``models.core.trainable_mask``, the masked
train step), label smoothing and class weights, the precision, recall,
f1 and auc metrics, ``profile_dir``, ``StreamingPredictor`` and the
``telemetry`` option that stays refused: the cases of the JAX package's
``tests/test_trainers_single.py`` (:97-244) and
``tests/test_inference.py`` (:141, :182).

The same numpy inputs and seed-0 weights go to both packages. Losses and
metrics agree within 1e-6 (the same float32 formulas), trainer losses
within 1e-4 per step (only the order of sums differs), masks leaf for
leaf; a frozen leaf is bitwise unchanged.
"""

import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.data import Dataset as JaxDataset
from distkeras_tpu.models import Model as JaxModel
from distkeras_tpu.models import Sequential as JaxSequential
from distkeras_tpu.models import layers as jax_layers
from distkeras_tpu.models import zoo as jax_zoo
from distkeras_tpu.models.blocks import Residual as JaxResidual
from distkeras_tpu.models.core import trainable_mask as jax_trainable_mask
from distkeras_tpu.models.recurrent import Bidirectional as JaxBidirectional
from distkeras_tpu.models.recurrent import LSTM as JaxLSTM
from distkeras_tpu.ops import losses as jax_losses
from distkeras_tpu.ops import metrics as jax_metrics
from distkeras_tpu.parallel import SingleTrainer as JaxSingleTrainer

from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.inference import StreamingPredictor
from distkeras_tpu_torch.models import (Model, Sequential, from_jax_params,
                                        trainable_mask, zoo)
from distkeras_tpu_torch.models import layers
from distkeras_tpu_torch.models.blocks import Residual
from distkeras_tpu_torch.models.recurrent import LSTM, Bidirectional
from distkeras_tpu_torch.ops import losses, metrics
from distkeras_tpu_torch.parallel import (EnsembleTrainer, HostAsyncTrainer,
                                          SingleTrainer)

LOSS = "sparse_categorical_crossentropy_from_logits"
#: the same float32 formulas on both sides
FORMULA_TOL = 1e-6
#: trainer losses: float32, summation order apart
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_intraop_thread():
    """The tensors here are tiny: one intra-op thread runs them faster
    than a pool that contends with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _data(n=256, d=8, c=3, seed=0, shift=0.0):
    rs = np.random.RandomState(seed)
    X = (rs.randn(n, d) * (5.0 if shift else 1.0) + shift).astype(np.float32)
    return X, (X @ rs.randn(d, c)).argmax(-1)


# --- trainable_mask ---------------------------------------------------------

def _mask_pairs():
    """``(id, build(package), input shape, freeze(module))`` for each
    container kind: a TransformerBlock's attention, a whole block, a
    Residual's main branch (with a BatchNorm: state), a WideAndDeep's
    wide tower, a SeparableConv2D's pointwise part, a Bidirectional's
    backward copy, and nothing frozen."""
    def lm(pkg):
        return (jax_zoo if pkg == "jax" else zoo).transformer_lm(
            16, d_model=16, num_heads=2, num_layers=2, mlp_ratio=2)

    def res(pkg):
        L = jax_layers if pkg == "jax" else layers
        R = JaxResidual if pkg == "jax" else Residual
        S = JaxSequential if pkg == "jax" else Sequential
        return S([R(S([L.Dense(8), L.BatchNorm()]), L.Dense(8)),
                  L.Dense(3)])

    def wd(pkg):
        return (jax_zoo if pkg == "jax" else zoo).wide_and_deep(
            wide_dim=4, deep_hidden=(8,), num_classes=3)

    def sep(pkg):
        L = jax_layers if pkg == "jax" else layers
        S = JaxSequential if pkg == "jax" else Sequential
        return S([L.SeparableConv2D(4, 3), L.BatchNorm(), L.Flatten(),
                  L.Dense(2)])

    def bi(pkg):
        B, R = (JaxBidirectional, JaxLSTM) if pkg == "jax" else \
            (Bidirectional, LSTM)
        S = JaxSequential if pkg == "jax" else Sequential
        L = jax_layers if pkg == "jax" else layers
        return S([B(R(4, return_sequences=False)), L.Dense(2)])

    return [
        ("lm_attn", lm, (8,), lambda m: setattr(m.layers[1].attn,
                                                "trainable", False)),
        ("lm_block", lm, (8,), lambda m: setattr(m.layers[2], "trainable",
                                                 False)),
        ("residual", res, (8,), lambda m: setattr(m.layers[0].main,
                                                  "trainable", False)),
        ("wide_deep", wd, (12,), lambda m: setattr(m.layers[0].wide,
                                                   "trainable", False)),
        ("separable", sep, (6, 6, 2), lambda m: setattr(
            m.layers[0].pointwise, "trainable", False)),
        ("bilstm", bi, (5, 3), lambda m: setattr(
            m.layers[0].sub_layers()["backward"], "trainable", False)),
        ("nothing", lm, (8,), lambda m: None),
    ]


@pytest.mark.parametrize("case", _mask_pairs(), ids=lambda c: c[0])
def test_trainable_mask_equals_jax_leaf_for_leaf(case):
    _, spec, shape, freeze = case
    jmod, pmod = spec("jax"), spec("port")
    freeze(jmod)
    freeze(pmod)
    jm = JaxModel.build(jmod, shape, seed=0)
    pm = Model.build(pmod, shape, device="cpu")
    for tree in ("params", "state"):
        ref = jax_trainable_mask(jmod, getattr(jm, tree))
        got = trainable_mask(pmod, getattr(pm, tree))
        if ref is None or got is None:
            assert ref is None and got is None, (tree, ref, got)
            continue
        # compare by leaf path (JAX's state trees also hold empty dicts)
        flat_ref = {jax.tree_util.keystr(p): v for p, v in
                    jax.tree_util.tree_flatten_with_path(ref)[0]}
        leaves = jax.tree_util.tree_flatten_with_path(getattr(jm, tree))[0]
        keys = [jax.tree_util.keystr(p) for p, _ in leaves]
        flat_got = {jax.tree_util.keystr(p): v for p, v in
                    jax.tree_util.tree_flatten_with_path(got)[0]}
        assert sorted(flat_got) == sorted(flat_ref) == sorted(keys)
        assert flat_got == flat_ref, tree


# --- frozen layers in training ----------------------------------------------

def _frozen_pair(opt="adam", bn=False):
    """A two-Dense MLP (or Dense-BN-Dense) with the first layer frozen, in
    both packages, seed-0 weights."""
    def build(pkg):
        L = jax_layers if pkg == "jax" else layers
        S = JaxSequential if pkg == "jax" else Sequential
        first = L.BatchNorm() if bn else L.Dense(16, activation="relu")
        first.trainable = False
        seq = S(([L.Dense(16)] if bn else []) + [first, L.Dense(3)])
        return (JaxModel.build(seq, (8,), seed=0) if pkg == "jax" else
                Model.build(seq, (8,), device="cpu"))
    return build("jax"), build("port")


def _kw(opt="adam", num_epoch=4, **kw):
    return dict(batch_size=32, num_epoch=num_epoch, worker_optimizer=opt,
                optimizer_kwargs={"learning_rate": 1e-2}, loss=LOSS, **kw)


def test_layer_trainable_false_freezes_params_as_jax():
    X, y = _data(1024)
    jm, pm = _frozen_pair()
    frozen = {k: v.clone() for k, v in pm.params[0].items()}
    head = pm.params[1]["kernel"].clone()
    tr = SingleTrainer(pm, **_kw())
    trained = tr.train(Dataset({"features": X, "label": y}))
    for k, v in frozen.items():
        assert torch.equal(trained.params[0][k], v), k
    assert not torch.equal(trained.params[1]["kernel"], head)
    jt = JaxSingleTrainer(jm, **_kw())
    jt.train(JaxDataset({"features": X, "label": y}))
    np.testing.assert_allclose(tr.get_history().losses(),
                               jt.get_history().losses(), rtol=TOL)
    acc = float(metrics.accuracy(_t(y), _t(trained.predict(X))))
    assert acc > 0.6


@pytest.mark.parametrize("opt", ["adamw", "lars", "lamb"])
def test_frozen_layer_immune_to_weight_decay_optimizers(opt):
    X, y = _data()
    _, pm = _frozen_pair()
    before = {k: v.clone() for k, v in pm.params[0].items()}
    trained = SingleTrainer(pm, **_kw(opt, 2)).train(
        Dataset({"features": X, "label": y}))
    for k, v in before.items():
        assert torch.equal(trained.params[0][k], v), (opt, k)


def test_frozen_batchnorm_keeps_running_stats():
    X, y = _data(512, shift=3.0)
    jm, pm = _frozen_pair("sgd", bn=True)
    before = {k: v.clone() for k, v in pm.state[1].items()}
    kw = dict(batch_size=32, num_epoch=2, worker_optimizer="sgd",
              learning_rate=0.05, loss=LOSS)
    tr = SingleTrainer(pm, **kw)
    trained = tr.train(Dataset({"features": X, "label": y}))
    for k, v in before.items():
        assert torch.equal(trained.state[1][k], v), k
    jt = JaxSingleTrainer(jm, **kw)
    jt.train(JaxDataset({"features": X, "label": y}))
    np.testing.assert_allclose(tr.get_history().losses(),
                               jt.get_history().losses(), rtol=TOL)


def test_freeze_sublayer_inside_transformer_block_as_jax():
    rs = np.random.RandomState(0)
    toks = rs.randint(0, 16, (128, 8))
    spec = dict(d_model=16, num_heads=2, num_layers=1, mlp_ratio=2)
    jmod = jax_zoo.transformer_lm(16, attn_impl="xla", **spec)
    pmod = zoo.transformer_lm(16, **spec)
    i = next(i for i, l in enumerate(pmod.layers)
             if type(l).__name__ == "TransformerBlock")
    jmod.layers[i].attn.trainable = False
    pmod.layers[i].attn.trainable = False
    jm = JaxModel.build(jmod, (8,), seed=0)
    pm = Model.build(pmod, (8,), device="cpu")
    from_jax_params(pm, jax.device_get(jm.params), jax.device_get(jm.state))
    attn = {k: v.clone() for k, v in pm.params[i]["attn"].items()}
    w1 = pm.params[i]["mlp"]["w1"].clone()
    kw = _kw(num_epoch=2) | {"batch_size": 16}
    tr = SingleTrainer(pm, **kw)
    trained = tr.train(Dataset({"features": toks, "label": toks}))
    for k, v in attn.items():
        assert torch.equal(trained.params[i]["attn"][k], v), k
    assert not torch.equal(trained.params[i]["mlp"]["w1"], w1)
    jt = JaxSingleTrainer(jm, **kw)
    jt.train(JaxDataset({"features": toks, "label": toks}))
    np.testing.assert_allclose(tr.get_history().losses(),
                               jt.get_history().losses(), rtol=TOL)


def test_frozen_layers_in_ensemble_and_host_async():
    X, y = _data()
    _, pm = _frozen_pair("sgd")
    members = EnsembleTrainer(pm, num_models=2, **_kw("sgd", 1)).train(
        Dataset({"features": X, "label": y}))
    for m in members:
        # each member is a fresh seed + i build: its frozen layer stays
        fresh = Model.build(Sequential([layers.Dense(16, activation="relu"),
                                        layers.Dense(3)]), (8,),
                            seed=members.index(m), device="cpu")
        for k in ("kernel", "bias"):
            assert torch.equal(m.params[0][k], fresh.params[0][k])
    _, pm = _frozen_pair("sgd")
    before = {k: v.clone() for k, v in pm.params[0].items()}
    trained = HostAsyncTrainer(pm, num_workers=2, communication_window=2,
                               **_kw("sgd", 1)).train(
        Dataset({"features": X, "label": y}))
    for k, v in before.items():
        assert torch.equal(trained.params[0][k], v)


# --- label smoothing and class weights ---------------------------------------

def _logits_and_labels(loss, seed=0, n=16, k=5):
    rs = np.random.RandomState(seed)
    logits = rs.randn(n, k).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    if loss.startswith("binary"):
        y = rs.randint(0, 2, n)
        pred = logits[:, 0] if loss.endswith("logits") else \
            1.0 / (1.0 + np.exp(-logits[:, 0]))
        return y, pred.astype(np.float32), 2
    pred = logits if loss.endswith("logits") else probs
    y = rs.randint(0, k, n)
    if loss.startswith("categorical"):
        y = np.eye(k, dtype=np.float32)[y]
    return y, pred, k


@pytest.mark.parametrize("loss", [
    "categorical_crossentropy", "categorical_crossentropy_from_logits",
    "sparse_categorical_crossentropy",
    "sparse_categorical_crossentropy_from_logits"])
def test_label_smoothing_matches_jax(loss):
    y, pred, _ = _logits_and_labels(loss)
    got = losses.with_label_smoothing(loss, 0.1)(_t(y), _t(pred))
    ref = jax_losses.with_label_smoothing(loss, 0.1)(jnp.asarray(y),
                                                     jnp.asarray(pred))
    np.testing.assert_allclose(float(got), float(ref), rtol=FORMULA_TOL)
    with pytest.raises(ValueError, match="label_smoothing"):
        losses.with_label_smoothing(loss, 1.0)
    with pytest.raises(ValueError, match="categorical"):
        losses.with_label_smoothing("mse", 0.1)


@pytest.mark.parametrize("loss", sorted(losses._PER_SAMPLE))
def test_class_weight_matches_jax(loss):
    y, pred, k = _logits_and_labels(loss, seed=1)
    for cw in ({0: 2.0, 1: 0.5}, np.linspace(0.5, 2.0, k)):
        got = losses.with_class_weight(loss, cw)(_t(y), _t(pred))
        ref = jax_losses.with_class_weight(loss, cw)(jnp.asarray(y),
                                                     jnp.asarray(pred))
        np.testing.assert_allclose(float(got), float(ref), rtol=FORMULA_TOL)
    with pytest.raises(ValueError, match="classes"):
        losses.with_class_weight(loss, {k: 1.0})(_t(y), _t(pred))
    with pytest.raises(ValueError, match="entries"):
        losses.with_class_weight(loss, np.ones(k + 1))(_t(y), _t(pred))


def test_class_weight_trainer_matches_jax_and_validates_unweighted():
    X, y = _data(256, seed=2)
    kw = dict(batch_size=32, num_epoch=2, worker_optimizer="sgd",
              learning_rate=0.05, loss=LOSS, class_weight={0: 3.0, 2: 0.5},
              validation_data=(X[:64], y[:64]))
    pm = Model.build(Sequential([layers.Dense(3)]), (8,), device="cpu")
    tr = SingleTrainer(pm, **kw)
    tr.train(Dataset({"features": X, "label": y}))
    jm = JaxModel.build(JaxSequential([jax_layers.Dense(3)]), (8,), seed=0)
    jt = JaxSingleTrainer(jm, **kw)
    jt.train(JaxDataset({"features": X, "label": y}))
    np.testing.assert_allclose(tr.get_history().losses(),
                               jt.get_history().losses(), rtol=TOL)
    np.testing.assert_allclose(tr.get_history().metric("val_loss"),
                               jt.get_history().metric("val_loss"), rtol=TOL)
    with pytest.raises(ValueError, match="classification loss"):
        SingleTrainer(pm, loss="mse", class_weight={0: 1.0})


# --- precision, recall, f1, auc ---------------------------------------------

def _metric_cases():
    rs = np.random.RandomState(3)
    logits = rs.randn(40, 4).astype(np.float32)
    ints = rs.randint(0, 4, 40)
    onehot = np.eye(4, dtype=np.float32)[rs.randint(0, 4, 40)]
    scores = rs.rand(40).astype(np.float32)
    binary = rs.randint(0, 2, 40)
    ties = np.round(rs.rand(40) * 4).astype(np.float32)
    return [("int_vs_logits", ints, logits),
            ("onehot_vs_logits", onehot, logits),
            ("int_vs_int", ints, rs.randint(0, 5, 40)),
            ("binary_scores", binary, scores),
            ("binary_logit_pairs", binary, logits[:, :2]),
            ("absent_class", np.where(ints == 3, 0, ints), logits),
            ("tied_scores", binary, ties)]


@pytest.mark.parametrize("name", ["precision", "recall", "f1", "auc"])
@pytest.mark.parametrize("case", _metric_cases(), ids=lambda c: c[0])
def test_metrics_match_jax(name, case):
    _, yt, yp = case
    if name == "auc" and yp.ndim > 1 and yp.shape[-1] != 2:
        yp = yp[:, 1] - yp[:, 0]
    if name == "auc" and yt.ndim > 1:
        yt = yt.argmax(-1) % 2
    if name == "auc":
        yt = yt % 2
    got = metrics.get_metric(name)(_t(yt), _t(yp))
    ref = jax_metrics.get_metric(name)(jnp.asarray(yt), jnp.asarray(yp))
    np.testing.assert_allclose(float(got), float(ref), rtol=FORMULA_TOL,
                               atol=FORMULA_TOL)


def test_metric_class_count_checks_and_training_metrics():
    with pytest.raises(ValueError, match="class 4"):
        metrics.precision(_t(np.array([0, 4])), _t(np.eye(3)[[0, 1]]))
    np.testing.assert_allclose(float(metrics.auc(_t(np.ones(4)),
                                                 _t(np.arange(4.0)))), 0.5)
    X, y = _data(256)
    pm = Model.build(Sequential([layers.Dense(3)]), (8,), device="cpu")
    tr = SingleTrainer(pm, batch_size=32, num_epoch=1, loss=LOSS,
                       worker_optimizer="sgd", learning_rate=0.05,
                       metrics=["precision", "recall", "f1"],
                       validation_data=(X[:64], y[:64]))
    tr.train(Dataset({"features": X, "label": y}))
    jt = JaxSingleTrainer(JaxModel.build(JaxSequential(
        [jax_layers.Dense(3)]), (8,), seed=0), batch_size=32, num_epoch=1,
        loss=LOSS, worker_optimizer="sgd", learning_rate=0.05,
        metrics=["precision", "recall", "f1"],
        validation_data=(X[:64], y[:64]))
    jt.train(JaxDataset({"features": X, "label": y}))
    for m in ("precision", "recall", "f1", "val_f1"):
        np.testing.assert_allclose(tr.get_history().metric(m),
                                   jt.get_history().metric(m), rtol=TOL,
                                   atol=TOL, err_msg=m)
    res = pm.evaluate(X, y, loss=LOSS, metrics=("accuracy", "f1"))
    assert 0.0 <= res["f1"] <= 1.0


# --- profile_dir, StreamingPredictor, telemetry -----------------------------

def test_profile_dir_writes_trace(tmp_path):
    X, y = _data(128, d=4, c=2)
    pm = Model.build(Sequential([layers.Dense(2)]), (4,), device="cpu")
    pdir = str(tmp_path / "prof")
    SingleTrainer(pm, batch_size=32, num_epoch=1, loss=LOSS,
                  profile_dir=pdir).train(
        Dataset({"features": X, "label": y}))
    found = [os.path.join(r, f) for r, _, fs in os.walk(pdir) for f in fs]
    assert found and all(f.endswith(".json") for f in found)
    import json
    with open(found[0]) as f:
        assert json.load(f)["traceEvents"]


def test_streaming_predictor_ragged_and_early_break():
    model = Model.build(Sequential([layers.Dense(3)]), (8,), device="cpu")
    jm = JaxModel.build(JaxSequential([jax_layers.Dense(3)]), (8,), seed=0)
    pred = StreamingPredictor(model, batch_size=16)
    rs = np.random.RandomState(0)
    batches = [rs.randn(16, 8), rs.randn(7, 8), rs.randn(16, 8)]
    outs = list(pred.predict_stream(iter(batches)))
    assert [len(o) for o in outs] == [16, 7, 16]
    for o, b in zip(outs, batches):
        np.testing.assert_allclose(o, model.predict(b), rtol=1e-5)
        np.testing.assert_allclose(o, jm.predict(b), rtol=1e-5, atol=1e-6)

    def endless():
        while True:
            yield rs.randn(16, 8)

    gen = pred.predict_stream(endless())
    next(gen)
    gen.close()
    pred._stage_thread.join(timeout=5)
    assert not pred._stage_thread.is_alive()

    def bad():
        yield rs.randn(32, 8)  # exceeds batch_size

    with pytest.raises(ValueError, match="exceeds"):
        list(pred.predict_stream(bad()))


def test_streaming_predictor_close_midstream_terminates_producer():
    model = Model.build(Sequential([layers.Dense(3)]), (4,), device="cpu")
    pred = StreamingPredictor(model, batch_size=8)
    pulled = []

    def source(n=200):
        for i in range(n):
            pulled.append(i)
            yield np.full((8, 4), float(i))

    gen = pred.predict_stream(source())
    next(gen)
    next(gen)
    time.sleep(0.3)          # the staging thread fills the queue, blocks
    gen.close()
    t = pred._stage_thread
    t.join(timeout=5)
    assert not t.is_alive(), "staging thread survived close()"
    n_at_close = len(pulled)
    assert n_at_close < 200
    time.sleep(0.2)
    assert len(pulled) == n_at_close
    outs = list(pred.predict_stream(source(7)))
    assert len(outs) == 7
    for i, o in enumerate(outs):
        np.testing.assert_allclose(
            o, model.predict(np.full((8, 4), float(i))), rtol=1e-5)
    assert not any(th is t for th in threading.enumerate())


def test_telemetry_still_raises_naming_item_11():
    pm = Model.build(Sequential([layers.Dense(2)]), (4,), device="cpu")
    for tape in (object(), True):
        with pytest.raises(NotImplementedError, match="item 11"):
            SingleTrainer(pm, loss=LOSS, telemetry=tape)
    SingleTrainer(pm, loss=LOSS, telemetry=False)  # off is accepted
