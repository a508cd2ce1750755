"""The port's inference entry points against the JAX package:
``Model.predict`` (batched, the last batch padded), ``Model.evaluate``,
``get_weights``/``set_weights`` across the two packages, ``Model.fit``
carrying BatchNorm state, and ``inference``'s ``Predictor``,
``ModelPredictor``, ``Evaluator`` and ``AccuracyEvaluator`` (the cases of
the JAX package's ``tests/test_inference.py``).

The same numpy inputs go to both packages; weights cross with
``from_jax_params`` or ``set_weights``. Float32 on both sides: outputs
within 1e-4 of the reference's largest magnitude (summation order
apart).
"""

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.data import Dataset as JaxDataset
from distkeras_tpu.data import LabelIndexTransformer
from distkeras_tpu.inference import AccuracyEvaluator as JaxAccuracyEvaluator
from distkeras_tpu.inference import ModelPredictor as JaxModelPredictor
from distkeras_tpu.models import Model as JaxModel
from distkeras_tpu.models import Sequential as JaxSequential
from distkeras_tpu.models import layers as jax_layers
from distkeras_tpu.models import zoo as jax_zoo

from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.inference import (AccuracyEvaluator, Evaluator,
                                           ModelPredictor, Predictor)
from distkeras_tpu_torch.models import (Model, Sequential, from_jax_params,
                                        to_jax_state, zoo)
from distkeras_tpu_torch.models import layers

TOL = 1e-4
LOSS = "sparse_categorical_crossentropy_from_logits"


@pytest.fixture(autouse=True, scope="module")
def _one_intraop_thread():
    """The tensors here are tiny: one intra-op thread runs them faster
    than a pool that contends with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _cnn(pkg):
    """A small BatchNorm CNN: the state matters to every eval forward."""
    L = jax_layers if pkg == "jax" else layers
    seq = JaxSequential if pkg == "jax" else Sequential
    return seq([L.Conv2D(4, 3, strides=2), L.BatchNorm(),
                L.Activation("relu"), L.MaxPooling2D(3, strides=2,
                                                     padding="SAME"),
                L.Flatten(), L.Dense(3)])


SHAPE = (8, 8, 2)


def _trained_state_pair():
    """The CNN in both packages with JAX's weights and a trained (moved)
    BN state: the JAX training-mode forward's new state."""
    jm = JaxModel.build(_cnn("jax"), SHAPE, seed=0)
    x = np.random.RandomState(5).randn(16, *SHAPE).astype(np.float32) * 3
    _, state = jm.apply(jm.params, jm.state, x + 1.0, training=True)
    jm = jm.replace(state=state)
    pm = Model.build(_cnn("port"), SHAPE, seed=0, device="cpu")
    return jm, from_jax_params(pm, jax.device_get(jm.params),
                               jax.device_get(jm.state))


@pytest.fixture(scope="module")
def cnn_pair():
    return _trained_state_pair()


def _images(n, seed=0):
    return np.random.RandomState(seed).randn(n, *SHAPE).astype(np.float32)


def test_predict_pads_the_ragged_last_batch_like_jax(cnn_pair):
    jm, pm = cnn_pair
    x = _images(37)
    ref = jm.predict(x, batch_size=8)
    got = pm.predict(x, batch_size=8)
    assert got.shape == (37, 3) and got.dtype == np.float32
    assert _rel(got, ref) <= TOL
    assert _rel(pm.predict(x), ref) <= TOL      # one batch: the same rows
    # the module keeps its mode, and predicting moves no statistics
    assert not pm.module.training
    np.testing.assert_array_equal(to_jax_state(pm)[1]["mean"],
                                  np.asarray(jm.state[1]["mean"]))


def test_predict_returns_float32_for_a_bf16_model():
    pm = Model.build(zoo.mlp((8,), num_classes=3, dtype="bfloat16"), (5,),
                     device="cpu")
    out = pm.predict(np.ones((3, 5)), batch_size=2)
    assert out.dtype == np.float32 and out.shape == (3, 3)


def test_evaluate_matches_jax(cnn_pair):
    jm, pm = cnn_pair
    x = _images(40, seed=1)
    y = np.random.RandomState(2).randint(0, 3, 40)
    ref = jm.evaluate(x, y, loss=LOSS, metrics=("accuracy",), batch_size=16)
    got = pm.evaluate(x, y, loss=LOSS, metrics=("accuracy",), batch_size=16)
    assert set(got) == set(ref) == {"loss", "accuracy"}
    assert got["loss"] == pytest.approx(ref["loss"], rel=TOL)
    assert got["accuracy"] == pytest.approx(ref["accuracy"], abs=1e-6)
    ds = Dataset({"features": x, "label": y})
    assert pm.evaluate(ds, loss=LOSS) == got
    with pytest.raises(ValueError, match="label column"):
        pm.evaluate(Dataset({"features": x}), loss=LOSS)
    with pytest.raises(ValueError, match="y is required"):
        pm.evaluate(x)


def test_weights_cross_packages_both_ways(cnn_pair):
    """A JAX model's ``get_weights()`` (params then state, JAX's leaf
    order) loads into the port's ``set_weights()`` and predicts the same;
    the port's list loads back into JAX."""
    jm, _ = cnn_pair
    fresh = Model.build(_cnn("port"), SHAPE, seed=9, device="cpu")
    jw = jm.get_weights()
    fresh.set_weights(jw)
    x = _images(6, seed=3)
    assert _rel(fresh.predict(x), jm.predict(x)) <= TOL
    pw = fresh.get_weights()
    assert [w.shape for w in pw] == [w.shape for w in jw]
    for a, b in zip(pw, jw):
        np.testing.assert_array_equal(a, b)
    jm2 = JaxModel.build(_cnn("jax"), SHAPE, seed=4)
    jm2.set_weights(pw)
    assert _rel(jm2.predict(x), jm.predict(x)) <= TOL
    with pytest.raises(ValueError, match="arrays"):
        fresh.set_weights(pw[:-1])
    with pytest.raises(ValueError, match="shape"):
        fresh.set_weights([np.zeros((1,))] + pw[1:])


def test_fit_trains_bn_state_in_place_like_jax():
    jm = JaxModel.build(_cnn("jax"), SHAPE, seed=0)
    pm = from_jax_params(Model.build(_cnn("port"), SHAPE, device="cpu"),
                         jax.device_get(jm.params),
                         jax.device_get(jm.state))
    x = _images(48, seed=4) * 2 + 1
    y = np.random.RandomState(6).randint(0, 3, 48)
    kw = dict(optimizer="sgd", learning_rate=0.05, loss=LOSS,
              batch_size=16, epochs=2, validation_split=0.25,
              metrics=["accuracy"])
    jh = jm.fit(x, y, **kw)
    ph = pm.fit(x, y, **kw)
    for je, pe in zip(jh.epochs, ph.epochs, strict=True):
        for key in je:
            assert _rel(pe[key], np.asarray(je[key])) <= TOL, key
    for got, ref in zip(jax.tree_util.tree_leaves(to_jax_state(pm)),
                        jax.tree_util.tree_leaves(jm.state)):
        assert _rel(got, ref) <= TOL


def test_predictor_appends_a_column_like_jax():
    """``test_inference.py::test_predictor_appends_column_and_matches_host``
    and the JAX predictor's own output."""
    jm = JaxModel.build(jax_zoo.mlp((32,), num_classes=3), (8,), seed=0)
    pm = from_jax_params(
        Model.build(zoo.mlp((32,), num_classes=3), (8,), device="cpu"),
        jax.device_get(jm.params))
    X = np.random.RandomState(0).randn(100, 8).astype(np.float32)
    out = ModelPredictor(pm, batch_size_per_device=4).predict(
        Dataset({"features": X}))
    assert out.columns == ["features", "prediction"]
    assert out["prediction"].shape == (100, 3)
    np.testing.assert_allclose(out["prediction"], pm.predict(X), atol=1e-5)
    ref = JaxModelPredictor(jm, batch_size_per_device=4).predict(
        JaxDataset({"features": X}))
    assert _rel(out["prediction"], ref["prediction"]) <= TOL


def test_predictor_ragged_final_batch_and_bn_state(cnn_pair):
    jm, pm = cnn_pair
    ds = Dataset({"features": _images(37, seed=7)})
    out = Predictor(pm, batch_size_per_device=2,
                    output_col="scores").predict(ds)
    assert out["scores"].shape == (37, 3)
    assert _rel(out["scores"], jm.predict(ds["features"])) <= TOL
    m = Model.build(zoo.mlp((16,), num_classes=2), (4,), device="cpu")
    out = Predictor(m, batch_size_per_device=2).predict(
        Dataset({"features": np.ones((37, 4), np.float32)}))
    assert out["prediction"].shape == (37, 2)


def test_reference_pipeline_predict_index_evaluate_like_jax():
    """``test_full_reference_pipeline_predict_index_evaluate``: a linear
    model with the generating weights scores 1.0, in both packages."""
    rs = np.random.RandomState(1)
    X = rs.randn(256, 10).astype(np.float32)
    W = rs.randn(10, 4)
    y = np.argmax(X @ W, axis=1)
    cheat = [{"kernel": W.astype(np.float32),
              "bias": np.zeros(4, np.float32)}]
    pm = from_jax_params(
        Model.build(zoo.mlp((), num_classes=4), (10,), device="cpu"), cheat)
    ds = ModelPredictor(pm).predict(Dataset({"features": X, "label": y}))
    ds = ds.with_column("predicted_index",
                        np.argmax(ds["prediction"], axis=1))
    acc = AccuracyEvaluator(label_col="label",
                            prediction_col="predicted_index").evaluate(ds)
    jm = JaxModel.build(jax_zoo.mlp((), num_classes=4), (10,)).replace(
        params=cheat)
    jds = JaxModelPredictor(jm).predict(JaxDataset({"features": X,
                                                    "label": y}))
    jds = LabelIndexTransformer(4).transform(jds)
    ref = JaxAccuracyEvaluator(label_col="label",
                               prediction_col="predicted_index").evaluate(jds)
    assert acc == ref == pytest.approx(1.0)
    # a probability column gives the same score through the argmax rule
    assert AccuracyEvaluator(prediction_col="prediction").evaluate(ds) == acc


def test_evaluator_with_custom_metric():
    ds = Dataset({"label": np.array([0., 1.]),
                  "prediction": np.array([0.5, 0.5])})
    ev = Evaluator("mse", label_col="label", prediction_col="prediction")
    assert ev.evaluate(ds) == pytest.approx(0.25)
    assert Evaluator(lambda t, p: (t - p).abs().max()).evaluate(ds) == 0.5


def test_predictor_mesh_options_raise_naming_the_roadmap():
    m = Model.build(zoo.mlp((4,), num_classes=2), (3,), device="cpu")
    for kw in (dict(mesh=object()), dict(tp_axis="model"),
               dict(ep_axis="expert")):
        with pytest.raises(NotImplementedError, match="item 10"):
            Predictor(m, **kw)
