"""The port's out-of-core training against the JAX package:
``ShardedDataset`` (npz/csv files, loader thunks, ``write``, the shard
order and the flat epoch items) through ``SingleTrainer``, ``Model.fit``
and ``Model.evaluate``, and the ``Prefetcher`` that streams the shards:
the one-device cases of the JAX package's ``tests/test_sharded.py``.

The same numpy shards go to both packages. The shard orders and epoch
items are JAX's exactly; per-step losses agree within 1e-4 (float32 on
both sides: only the order of sums differs), and an unshuffled sharded
run is bitwise the in-memory one.
"""

import threading

import numpy as np
import pytest
import torch

from distkeras_tpu.data import Dataset as JaxDataset
from distkeras_tpu.data import ShardedDataset as JaxShardedDataset
from distkeras_tpu.models import Dense as JaxDense
from distkeras_tpu.models import Model as JaxModel
from distkeras_tpu.models import Sequential as JaxSequential
from distkeras_tpu.parallel import SingleTrainer as JaxSingleTrainer

from distkeras_tpu_torch.data import Dataset, ShardedDataset
from distkeras_tpu_torch.models import Model, Sequential
from distkeras_tpu_torch.models.layers import Dense
from distkeras_tpu_torch.ops.metrics import accuracy
from distkeras_tpu_torch.parallel import DOWNPOUR, SingleTrainer
from distkeras_tpu_torch.utils import EarlyStopping, Prefetcher

D, C = 8, 3
LOSS = "sparse_categorical_crossentropy_from_logits"
#: the port against JAX: float32 on both sides, summation order apart
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_intraop_thread():
    """The tensors here are tiny: one intra-op thread runs them faster
    than a pool that contends with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_arrays(n, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, D).astype(np.float32)
    y = np.argmax(X @ rs.randn(D, C), axis=1)
    return X, y


def mlp(seed=0):
    return Model.build(Sequential([Dense(32, activation="relu"), Dense(C)]),
                       (D,), seed=seed, device="cpu")


def jax_mlp(seed=0):
    return JaxModel.build(JaxSequential([JaxDense(32, activation="relu"),
                                         JaxDense(C)]), (D,), seed=seed)


def as_shards(X, y, k, cls=ShardedDataset, ds=Dataset):
    n = len(X) // k
    return cls.from_datasets([ds({"features": X[i * n:(i + 1) * n],
                                  "label": y[i * n:(i + 1) * n]})
                              for i in range(k)])


def test_sharded_single_trainer_learns():
    X, y = make_arrays(512)
    tr = SingleTrainer(mlp(), worker_optimizer="sgd", learning_rate=0.05,
                       loss=LOSS, batch_size=32, num_epoch=8)
    trained = tr.train(as_shards(X, y, 4))
    acc = float(accuracy(torch.from_numpy(y),
                         torch.from_numpy(trained.predict(X))))
    assert acc > 0.85, acc
    # the per-epoch history covers every shard: 512 / 32 = 16 steps
    assert len(tr.get_history().epochs) == 8
    assert len(tr.get_history().losses()) == 8 * 16


def test_sharded_matches_inmemory_when_unshuffled():
    """Shards visited in order without shuffling give the in-memory
    run's batches, so its losses bit for bit."""
    X, y = make_arrays(256, seed=1)
    kw = dict(worker_optimizer="sgd", learning_rate=0.05, loss=LOSS,
              batch_size=32, num_epoch=3, shuffle_each_epoch=False)
    t1 = SingleTrainer(mlp(seed=5), **kw)
    t1.train(Dataset({"features": X, "label": y}))
    t2 = SingleTrainer(mlp(seed=5), **kw)
    t2.train(as_shards(X, y, 4))
    np.testing.assert_array_equal(t1.get_history().losses(),
                                  t2.get_history().losses())
    assert t2.loader.wait_s >= 0.0


def test_sharded_shuffled_losses_match_jax():
    """Shuffled shard orders and per-shard row permutations are JAX's
    formulas: the per-step losses of both packages' sharded runs agree."""
    X, y = make_arrays(256, seed=4)
    kw = dict(worker_optimizer="adam", learning_rate=0.01, loss=LOSS,
              batch_size=32, num_epoch=3, seed=3)
    pt = SingleTrainer(mlp(), **kw)
    pt.train(as_shards(X, y, 4))
    jt = JaxSingleTrainer(jax_mlp(), **kw)
    jt.train(as_shards(X, y, 4, JaxShardedDataset, JaxDataset))
    np.testing.assert_allclose(pt.get_history().losses(),
                               jt.get_history().losses(), rtol=TOL)


def test_sharded_from_npz_and_csv_files(tmp_path):
    X, y = make_arrays(128, seed=2)
    paths = []
    for i in range(2):
        p = str(tmp_path / f"shard-{i}.npz")
        sl = slice(i * 64, (i + 1) * 64)
        np.savez(p, features=X[sl], label=y[sl])
        paths.append(p)
    sds = ShardedDataset.from_files(paths)
    assert sds.num_shards == 2
    np.testing.assert_array_equal(sds.load_shard(1)["features"], X[64:])
    with pytest.raises(FileNotFoundError):
        ShardedDataset.from_files([str(tmp_path / "missing.npz")])
    # csv: the label column by index, as JAX reads it
    cp = str(tmp_path / "shard.csv")
    np.savetxt(cp, np.column_stack([X[:5], y[:5]]), delimiter=",",
               header="h", comments="")
    kw = dict(label_col_index=D, skip_header=True)
    got = ShardedDataset.from_files([cp], **kw).load_shard(0)
    ref = JaxShardedDataset.from_files([cp], **kw).load_shard(0)
    np.testing.assert_array_equal(got["features"], ref["features"])
    np.testing.assert_array_equal(got["label"], ref["label"])
    assert got["label"].dtype == ref["label"].dtype == np.int64


def test_sharded_loader_thunks_and_shard_order_match_jax():
    X, y = make_arrays(128, seed=3)
    calls = []

    def loader(i):
        def f():
            calls.append(i)
            sl = slice(i * 64, (i + 1) * 64)
            return Dataset({"features": X[sl], "label": y[sl]})
        return f

    sds = ShardedDataset([loader(0), loader(1)])
    assert sds.shard_order(0, seed=0, shuffle=False) == [0, 1]
    sds.load_shard(0)
    assert calls == [0]  # lazy: only the requested shard loads
    port = ShardedDataset([object()] * 7)
    ref = JaxShardedDataset([object()] * 7)
    for epoch in range(6):
        for seed in (0, 3, 11):
            assert port.shard_order(epoch, seed, True) == \
                ref.shard_order(epoch, seed, True)
    assert port.epoch_items(2, 6, 5, True) == ref.epoch_items(2, 6, 5, True)
    assert port.epoch_items(0, 2, 5, False) == \
        ref.epoch_items(0, 2, 5, False)


def test_sharded_rejected_by_engine_trainers():
    X, y = make_arrays(128)
    tr = DOWNPOUR(mlp(), num_workers=8, batch_size=16,
                  communication_window=2, num_epoch=1, loss=LOSS)
    with pytest.raises(ValueError, match="ShardedDataset"):
        tr.train(as_shards(X, y, 2))


def test_sharded_is_truthy_and_len_raises():
    X, y = make_arrays(64)
    sds = as_shards(X, y, 2)
    assert bool(sds)
    with pytest.raises(TypeError):
        len(sds)


def test_sharded_evaluate_matches_inmemory_and_jax():
    X, y = make_arrays(128)
    m = mlp()
    kw = dict(loss=LOSS, metrics=("accuracy",))
    full = m.evaluate(Dataset({"features": X, "label": y}), **kw)
    sharded = m.evaluate(as_shards(X, y, 4), **kw)
    ref = jax_mlp().evaluate(as_shards(X, y, 4, JaxShardedDataset,
                                       JaxDataset), **kw)
    for k in full:
        np.testing.assert_allclose(sharded[k], full[k], rtol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(sharded[k], ref[k], rtol=TOL, err_msg=k)
    with pytest.raises(ValueError, match="decomposable"):
        m.evaluate(as_shards(X, y, 2), metrics=("precision",))


def test_sharded_write_roundtrip_matches_jax(tmp_path):
    X, y = make_arrays(100, seed=7)
    sds = ShardedDataset.write(Dataset({"features": X, "label": y}),
                               str(tmp_path / "out"), num_shards=3)
    ref = JaxShardedDataset.write(JaxDataset({"features": X, "label": y}),
                                  str(tmp_path / "jax"), num_shards=3)
    assert [p.split("/")[-1] for p in sds.sources] == \
        [p.split("/")[-1] for p in ref.sources]
    back = sds.load_shard(0)
    for i in range(1, 3):
        assert len(sds.load_shard(i)) == len(ref.load_shard(i))
        back = back.concat(sds.load_shard(i))
    np.testing.assert_array_equal(back["features"], X)  # uneven split
    np.testing.assert_array_equal(back["label"], y)
    with pytest.raises(ValueError, match="shards"):
        ShardedDataset.write(Dataset({"features": X}), str(tmp_path / "o2"),
                             num_shards=0)


def test_sharded_fit_and_callbacks():
    X, y = make_arrays(256, seed=6)
    hist = mlp().fit(as_shards(X, y, 2), optimizer="sgd", loss=LOSS,
                     batch_size=32, epochs=20,
                     callbacks=[EarlyStopping(monitor="loss", min_delta=1e9,
                                              patience=1)])
    assert len(hist.epochs) == 2  # epoch 0 best, stop after 1 bad epoch
    with pytest.raises(ValueError, match="in-memory"):
        mlp().fit(as_shards(X, y, 2), loss=LOSS, validation_split=0.2)


def test_prefetcher_order_errors_and_shutdown():
    """Items come back in order; an error in ``fn`` or in the source
    re-raises with its own type; an early break ends the producer."""
    out = list(Prefetcher(lambda i: i * i, range(10), depth=2))
    assert out == [(i, i * i) for i in range(10)]

    def bad(i):
        if i == 3:
            raise KeyError("boom")
        return i

    with pytest.raises(KeyError, match="boom"):
        list(Prefetcher(bad, range(10)))

    def source():
        yield 1
        raise OSError("source")

    with pytest.raises(OSError, match="source"):
        list(Prefetcher(lambda i: i, source()))
    with pytest.raises(ValueError, match="depth"):
        Prefetcher(lambda i: i, [], depth=0)
    pf = Prefetcher(lambda i: i, iter(range(10 ** 6)), depth=2)
    for _ in pf:
        break
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive()
    assert not any(t is pf._thread for t in threading.enumerate())
