"""The port's Keras-style callbacks against the JAX package: early
stopping (and the best weights restored), model-file export, CSV and
TensorBoard logging, NaN termination, the weight average, on the single
and distributed trainers and ``Model.fit``: the cases of the JAX
package's ``tests/test_callbacks.py``.

The same numpy data and the same seed-0 weights go to both packages.
Per-step losses, the CSV rows and the averaged weights agree within
1e-4 (float32 on both sides: only the order of sums differs); the epoch
at which a callback stops training is the same.
"""

import csv
import glob
import os

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.data import Dataset as JaxDataset
from distkeras_tpu.models import Dense as JaxDense
from distkeras_tpu.models import Model as JaxModel
from distkeras_tpu.models import Sequential as JaxSequential
from distkeras_tpu.models.serialization import load_model as jax_load_model
from distkeras_tpu.parallel import SingleTrainer as JaxSingleTrainer
from distkeras_tpu.utils import CSVLogger as JaxCSVLogger
from distkeras_tpu.utils import EMAWeights as JaxEMAWeights
from distkeras_tpu.utils import EarlyStopping as JaxEarlyStopping

from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.models import Model, Sequential, load_model
from distkeras_tpu_torch.models.core import sorted_leaves
from distkeras_tpu_torch.models.layers import Dense
from distkeras_tpu_torch.parallel import (DOWNPOUR, EnsembleTrainer,
                                          HostAsyncTrainer, SingleTrainer)
from distkeras_tpu_torch.utils import (CSVLogger, EarlyStopping, EMAWeights,
                                       LambdaCallback, ModelCheckpoint,
                                       TensorBoardLogger, TerminateOnNaN)
from distkeras_tpu_torch.utils.tree import tree_leaves

D, C = 8, 3
LOSS = "sparse_categorical_crossentropy_from_logits"
#: the port against JAX: float32 on both sides, summation order apart
TOL = 1e-4

pytestmark = pytest.mark.filterwarnings(
    "ignore:amortized two-level scan auto-enabled")


@pytest.fixture(autouse=True, scope="module")
def _one_intraop_thread():
    """The tensors here are tiny: one intra-op thread runs them faster
    than a pool that contends with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_data(n=256, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, D).astype(np.float32)
    y = np.argmax(X @ rs.randn(D, C), axis=1)
    return X, y


def ds(n=256, seed=0):
    X, y = make_data(n, seed)
    return Dataset({"features": X, "label": y})


def mlp(seed=0):
    return Model.build(Sequential([Dense(32, activation="relu"), Dense(C)]),
                       (D,), seed=seed, device="cpu")


def jax_mlp(seed=0):
    return JaxModel.build(JaxSequential([JaxDense(32, activation="relu"),
                                         JaxDense(C)]), (D,), seed=seed)


def kwargs(num_epoch=10, **kw):
    kw.setdefault("worker_optimizer", "sgd")
    kw.setdefault("learning_rate", 0.05)
    kw.setdefault("loss", LOSS)
    return dict(batch_size=32, num_epoch=num_epoch, **kw)


def trainer(model, callbacks, num_epoch=10, **kw):
    return SingleTrainer(model, callbacks=callbacks,
                         **kwargs(num_epoch, **kw))


def test_early_stopping_stops_and_restores_best():
    # min_delta so large nothing improves: the best is epoch 0 and the
    # run stops once `patience` epochs did not improve
    es = EarlyStopping(monitor="loss", min_delta=1e9, patience=2,
                       restore_best_weights=True)
    first = {}
    grab = LambdaCallback(on_epoch_end=lambda e, logs: first.setdefault(
        "w", es.trainer.get_weights()))
    tr = trainer(mlp(), [es, grab], num_epoch=50)
    trained = tr.train(ds())
    assert len(tr.get_history().epochs) == 3
    assert es.stopped_epoch == 2 and es.best_epoch == 0
    for a, b in zip(tree_leaves(trained.params), tree_leaves(first["w"][0])):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    # JAX's run stops at the same epoch with the same losses
    jes = JaxEarlyStopping(monitor="loss", min_delta=1e9, patience=2,
                           restore_best_weights=True)
    jt = JaxSingleTrainer(jax_mlp(), callbacks=[jes], **kwargs(50))
    jtrained = jt.train(JaxDataset(dict(zip(("features", "label"),
                                            make_data()))))
    assert jes.stopped_epoch == es.stopped_epoch
    np.testing.assert_allclose(tr.get_history().losses(),
                               jt.get_history().losses(), rtol=TOL)
    for a, b in zip(sorted_leaves(trained.params),
                    jax.tree_util.tree_leaves(jtrained.params)):
        np.testing.assert_allclose(a.detach().numpy(), b, atol=TOL)


def test_early_stopping_monitors_validation():
    es = EarlyStopping(monitor="val_accuracy", min_delta=1e9, patience=0)
    tr = trainer(mlp(), [es], num_epoch=20, metrics=["accuracy"],
                 validation_data=ds(64, seed=1))
    tr.train(ds())
    assert len(tr.get_history().epochs) == 2  # epoch 0 best, stop at 1
    assert es.mode == "max"  # inferred from the accuracy-like name


def test_early_stopping_unknown_monitor_raises():
    tr = trainer(mlp(), [EarlyStopping(monitor="val_loss")], num_epoch=2)
    with pytest.raises(KeyError, match="val_loss"):
        tr.train(ds())


def test_weight_accessors_invalid_after_train():
    tr = trainer(mlp(), [], num_epoch=1)
    tr.train(ds())
    with pytest.raises(RuntimeError, match="while"):
        tr.get_weights()


def test_callback_resources_closed_on_exception(tmp_path):
    logger = CSVLogger(str(tmp_path / "log.csv"))
    tr = trainer(mlp(), [logger, EarlyStopping(monitor="nope")],
                 num_epoch=3)
    with pytest.raises(KeyError):
        tr.train(ds())
    assert logger._file is None  # closed by train_end in finally


def test_model_checkpoint_exports_files_both_packages_load(tmp_path):
    pat = str(tmp_path / "m-{epoch:02d}.dkt")
    tr = trainer(mlp(), [ModelCheckpoint(pat)], num_epoch=3)
    trained = tr.train(ds())
    assert sorted(os.listdir(tmp_path)) == [
        "m-00.dkt.json", "m-00.dkt.npz", "m-01.dkt.json", "m-01.dkt.npz",
        "m-02.dkt.json", "m-02.dkt.npz"]
    X = make_data()[0]
    want = trained.predict(X)
    np.testing.assert_allclose(
        load_model(str(tmp_path / "m-02.dkt"), device="cpu").predict(X),
        want, atol=1e-6)
    np.testing.assert_allclose(
        jax_load_model(str(tmp_path / "m-02.dkt")).predict(X), want,
        atol=TOL)


def test_model_checkpoint_save_best_only(tmp_path):
    pat = str(tmp_path / "best.dkt")
    mc = ModelCheckpoint(pat, monitor="loss", save_best_only=True)
    trainer(mlp(), [mc], num_epoch=5).train(ds())
    assert os.path.exists(pat + ".json")  # written at least on epoch 0


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_csv_logger_rows_match_jax(tmp_path):
    path = str(tmp_path / "log.csv")
    trainer(mlp(), [CSVLogger(path)], num_epoch=3,
            metrics=["accuracy"]).train(ds())
    rows = _rows(path)
    assert [r[0] for r in rows[1:]] == ["0", "1", "2"]
    jpath = str(tmp_path / "jax.csv")
    JaxSingleTrainer(jax_mlp(), callbacks=[JaxCSVLogger(jpath)],
                     metrics=["accuracy"], **kwargs(3)).train(
        JaxDataset(dict(zip(("features", "label"), make_data()))))
    jrows = _rows(jpath)
    # both carry their telemetry tapes' columns: the same header
    assert rows[0] == jrows[0]
    assert {"accuracy", "loss", "examples_per_sec", "goodput"} \
        <= set(rows[0])
    # the tapes' columns are wall times: compare the training values
    for key in ("accuracy", "loss"):
        got = [float(r[rows[0].index(key)]) for r in rows[1:]]
        ref = [float(r[jrows[0].index(key)]) for r in jrows[1:]]
        np.testing.assert_allclose(got, ref, rtol=TOL, err_msg=key)


def test_csv_logger_append_no_duplicate_header(tmp_path):
    path = str(tmp_path / "log.csv")
    trainer(mlp(), [CSVLogger(path)], num_epoch=2).train(ds())
    trainer(mlp(), [CSVLogger(path, append=True)], num_epoch=2).train(ds())
    rows = _rows(path)
    assert rows[0][0] == "epoch" and "loss" in rows[0]
    assert sum(r[0] == "epoch" for r in rows) == 1  # ONE header
    assert [r[0] for r in rows[1:]] == ["0", "1", "0", "1"]


def test_terminate_on_nan():
    tr = trainer(mlp(), [TerminateOnNaN()], num_epoch=30,
                 learning_rate=1e9)  # guaranteed divergence
    tr.train(ds())
    assert len(tr.get_history().epochs) < 30


def test_callbacks_on_distributed_and_host_async_trainers():
    X, y = make_data(512)
    data = Dataset({"features": X, "label": y})
    es = EarlyStopping(monitor="loss", min_delta=1e9, patience=0)
    tr = DOWNPOUR(mlp(), num_workers=8, communication_window=2,
                  callbacks=[es], **kwargs(20))
    tr.train(data)
    assert len(tr.get_history().epochs) == 2
    seen = []
    ht = HostAsyncTrainer(mlp(), num_workers=2, communication_window=2,
                          callbacks=[LambdaCallback(
                              on_epoch_end=lambda e, logs: seen.append(
                                  (e, sorted(logs))))],
                          **kwargs(2))
    ht.train(data)
    assert seen == [(0, ["loss"]), (1, ["loss"])]


def test_ensemble_rejects_callbacks():
    tr = EnsembleTrainer(mlp(), num_models=2, callbacks=[TerminateOnNaN()],
                         **kwargs(1))
    with pytest.raises(ValueError, match="callbacks"):
        tr.train(ds())


def test_ema_and_restore_best_conflict_detected():
    tr = trainer(mlp(), [EarlyStopping(monitor="loss",
                                       restore_best_weights=True),
                         EMAWeights()], num_epoch=3)
    with pytest.raises(ValueError, match="whichever runs last"):
        tr.train(ds())


def test_ema_weights_installed_match_jax():
    ema = EMAWeights(decay=0.5)
    trained = trainer(mlp(), [ema], num_epoch=3).train(ds())
    jema = JaxEMAWeights(decay=0.5)
    jtrained = JaxSingleTrainer(jax_mlp(), callbacks=[jema],
                                **kwargs(3)).train(
        JaxDataset(dict(zip(("features", "label"), make_data()))))
    for a, b in zip(sorted_leaves(trained.params),
                    jax.tree_util.tree_leaves(jtrained.params)):
        np.testing.assert_allclose(a.detach().numpy(), b, atol=TOL)
    for a, b in zip(tree_leaves(trained.params),
                    tree_leaves(ema.ema_weights[0])):
        np.testing.assert_array_equal(a.detach().numpy(), b)


def test_fit_accepts_callbacks():
    hist = mlp().fit(ds(), optimizer="sgd", loss=LOSS, batch_size=32,
                     epochs=10, callbacks=[EarlyStopping(
                         monitor="loss", min_delta=1e9, patience=0)])
    assert len(hist.epochs) == 2


def test_tensorboard_logger_writes_event_files(tmp_path):
    pytest.importorskip("tensorboard")
    logdir = str(tmp_path / "tb")
    trainer(mlp(), [TensorBoardLogger(logdir)], num_epoch=2).train(ds())
    events = glob.glob(logdir + "/events.out.tfevents.*")
    assert events, "no TensorBoard event file written"
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    acc = EventAccumulator(events[0])
    acc.Reload()
    assert "loss" in acc.Tags()["scalars"]
    assert [e.step for e in acc.Scalars("loss")] == [0, 1]
