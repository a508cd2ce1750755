"""The port's checkpoints against the JAX package: ``CheckpointManager``
(the same ``step_<N>/manifest.json`` + ``arrays.npz`` format, leaf keys,
crc32s and atomic publish), ``SingleTrainer``'s full-carry checkpoint
and resume, the center-only checkpoints of the distributed and
host-async trainers, and the profiling helpers: the non-sharded cases of
the JAX package's ``tests/test_checkpoint.py``.

Checkpoints cross both ways: one that JAX's ``SingleTrainer`` wrote
after epoch 1 of 3 is resumed by the port, and ends within 1e-4 of JAX's
uninterrupted run (float32 on both sides: only the order of sums
differs); one the port wrote restores in JAX's ``CheckpointManager``
byte for byte, leaf for leaf. The port's own resume is bitwise its
uninterrupted run.
"""

import os

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.data import Dataset as JaxDataset
from distkeras_tpu.models import Dense as JaxDense
from distkeras_tpu.models import Dropout as JaxDropout
from distkeras_tpu.models import Model as JaxModel
from distkeras_tpu.models import Sequential as JaxSequential
from distkeras_tpu.ops import get_optimizer as jax_get_optimizer
from distkeras_tpu.parallel import SingleTrainer as JaxSingleTrainer
from distkeras_tpu.utils import CheckpointManager as JaxCheckpointManager

from distkeras_tpu_torch.data import Dataset, ShardedDataset
from distkeras_tpu_torch.models import Model, Sequential
from distkeras_tpu_torch.models.core import sorted_leaves
from distkeras_tpu_torch.models.layers import Dense, Dropout
from distkeras_tpu_torch.parallel import (DOWNPOUR, HostAsyncTrainer,
                                          SingleTrainer)
from distkeras_tpu_torch.utils import CheckpointManager
from distkeras_tpu_torch.utils.profiling import (StepTimer,
                                                 device_memory_stats,
                                                 percentiles)
from distkeras_tpu_torch.utils.tree import tree_leaves

LOSS = "sparse_categorical_crossentropy_from_logits"
#: the port against JAX: float32 on both sides, summation order apart
TOL = 1e-4

# the auto-amortized engine warns that staggered commits batch at block
# boundaries; the DOWNPOUR case takes that path
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


def test_manager_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": np.ones(4)}}
    mgr.save(0, tree, metadata={"epoch": 0})
    restored = mgr.restore({"a": torch.zeros(2, 3),
                            "b": {"c": np.zeros(4)}})
    np.testing.assert_array_equal(restored["a"], tree["a"].numpy())
    assert mgr.metadata() == {"epoch": 0}
    # the snapshot is the tensor's value at save(), not a view of it
    tree["a"] += 1
    np.testing.assert_array_equal(mgr.restore(restored)["a"],
                                  np.arange(6.0).reshape(2, 3))


def test_manager_gc_keeps_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in range(5):
        mgr.save(step, {"x": np.full(3, step)})
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    np.testing.assert_array_equal(
        mgr.restore({"x": np.zeros(3, np.int64)})["x"], [4, 4, 4])


def test_manager_restore_empty_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore({"x": np.zeros(2)})


def test_manager_format_crosses_both_ways(tmp_path):
    """A step written by either manager reads in the other: the same
    keys, manifest, crc32s and values; a corrupt payload fails its
    crc32 check by name; a crash's ``.tmp`` directory is swept."""
    tree = {"params": [{"kernel": np.arange(12, dtype=np.float32)
                        .reshape(3, 4)}, {}],
            "rng": np.array([0, 7], np.uint32)}
    port = CheckpointManager(str(tmp_path / "port"))
    port.save(3, {"params": [{"kernel": torch.from_numpy(
        tree["params"][0]["kernel"])}, {}], "rng": tree["rng"]},
        metadata={"epoch": 3})
    jaxm = JaxCheckpointManager(str(tmp_path / "jax"))
    jaxm.save(3, tree, metadata={"epoch": 3})
    assert port.keys() == jaxm.keys() == ["params/0/kernel", "rng"]
    a = JaxCheckpointManager(str(tmp_path / "port")).restore(tree)
    b = CheckpointManager(str(tmp_path / "jax")).restore(tree)
    for x, z, r in zip(tree_leaves(a), tree_leaves(b), tree_leaves(tree)):
        assert x.dtype == z.dtype == r.dtype
        assert x.tobytes() == z.tobytes() == r.tobytes()
    with open(tmp_path / "port" / "step_3" / "manifest.json") as f1, \
            open(tmp_path / "jax" / "step_3" / "manifest.json") as f2:
        assert f1.read() == f2.read()
    # corrupt one leaf's bytes: the crc32 names it
    with np.load(tmp_path / "port" / "step_3" / "arrays.npz") as z:
        flat = {k: z[k] for k in z.files}
    flat["rng"] = flat["rng"] + 1
    np.savez(tmp_path / "port" / "step_3" / "arrays.npz", **flat)
    with pytest.raises(ValueError, match="'rng' failed its crc32"):
        port.restore(tree)
    os.makedirs(tmp_path / "port" / "step_9.tmp")
    assert CheckpointManager(str(tmp_path / "port")).all_steps() == [3]
    assert not os.path.exists(tmp_path / "port" / "step_9.tmp")


def _ds(n=512):
    rs = np.random.RandomState(0)
    X = rs.randn(n, 8).astype(np.float32)
    y = (X.sum(axis=1) > 0).astype(np.int64)
    return X, y


def _mlp(dropout=0.0):
    layers = [Dense(16, activation="relu")]
    layers += [Dropout(dropout)] if dropout else []
    return Model.build(Sequential(layers + [Dense(2)]), (8,), seed=0,
                       device="cpu")


def _jax_mlp(dropout=0.0):
    layers = [JaxDense(16, activation="relu")]
    layers += [JaxDropout(dropout)] if dropout else []
    return JaxModel.build(JaxSequential(layers + [JaxDense(2)]), (8,),
                          seed=0)


def _kw(**kw):
    return dict(batch_size=32, worker_optimizer="adam", learning_rate=0.01,
                loss=LOSS, **kw)


def test_port_single_trainer_checkpoints_and_resumes(tmp_path):
    X, y = _ds()
    ckpt = str(tmp_path / "ck")
    SingleTrainer(_mlp(), num_epoch=3, checkpoint_dir=ckpt,
                  **_kw()).train(Dataset({"features": X, "label": y}))
    mgr = CheckpointManager(ckpt)
    assert mgr.latest_step() == 2  # 3 epochs: the last epoch index is 2
    # the whole carry (an MLP's state tree holds no leaf)
    assert {k.split("/")[0] for k in mgr.keys()} == {"params", "opt",
                                                     "rng"}
    # a trainer set for 5 epochs runs only epochs 3 and 4
    t2 = SingleTrainer(_mlp(), num_epoch=5, checkpoint_dir=ckpt,
                       resume=True, **_kw())
    t2.train(Dataset({"features": X, "label": y}))
    assert len(t2.get_history().epochs) == 2
    assert mgr.latest_step() == 4


@pytest.mark.parametrize("sharded", [False, True], ids=["memory", "shards"])
def test_port_resume_is_bitwise_uninterrupted(tmp_path, sharded):
    """The whole carry (weights, adam moments, the dropout key) is
    restored: a resumed run is bitwise an uninterrupted one, in memory
    and over shards (the same shard order and row permutations)."""
    X, y = _ds(256)
    ds = Dataset({"features": X, "label": y})
    if sharded:
        ds = ShardedDataset.from_datasets([Dataset(
            {"features": X[i * 64:(i + 1) * 64],
             "label": y[i * 64:(i + 1) * 64]}) for i in range(4)])
    whole = SingleTrainer(_mlp(0.25), num_epoch=4, **_kw()).train(ds)
    ckpt = str(tmp_path / "ck")
    SingleTrainer(_mlp(0.25), num_epoch=2, checkpoint_dir=ckpt,
                  **_kw()).train(ds)
    resumed = SingleTrainer(_mlp(0.25), num_epoch=4, checkpoint_dir=ckpt,
                            resume=True, **_kw()).train(ds)
    for a, b in zip(tree_leaves(whole.params), tree_leaves(resumed.params)):
        assert torch.equal(a, b)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """JAX's ``SingleTrainer`` checkpoints epochs 0-1 of 3 (a dropout
    MLP, adam): the port resumes it and finishes within 1e-4 of JAX's
    uninterrupted run, weights, moments and key taken from the file."""
    X, y = _ds(256)
    jkw = _kw()
    whole = JaxSingleTrainer(_jax_mlp(0.25), num_epoch=3, **jkw).train(
        JaxDataset({"features": X, "label": y}))
    ckpt = str(tmp_path / "ck")
    JaxSingleTrainer(_jax_mlp(0.25), num_epoch=2, checkpoint_dir=ckpt,
                     **jkw).train(JaxDataset({"features": X, "label": y}))
    pt = SingleTrainer(_mlp(0.25), num_epoch=3, checkpoint_dir=ckpt,
                       resume=True, **_kw())
    resumed = pt.train(Dataset({"features": X, "label": y}))
    assert len(pt.get_history().epochs) == 1
    ref = jax.tree_util.tree_leaves(jax.device_get(whole.params))
    got = [l.detach().numpy() for l in
           jax.tree_util.tree_leaves(resumed.params)]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=TOL * np.abs(r).max())


def test_port_checkpoint_restores_in_jax(tmp_path):
    """A port checkpoint restores in JAX's ``CheckpointManager`` byte for
    byte, leaf for leaf, with JAX's dtypes (the key as two uint32
    words), and JAX's ``SingleTrainer`` resumes it within 1e-4 of the
    port's uninterrupted run."""
    X, y = _ds(256)
    whole = SingleTrainer(_mlp(0.25), num_epoch=3, **_kw()).train(
        Dataset({"features": X, "label": y}))
    ckpt = str(tmp_path / "ck")
    pt = SingleTrainer(_mlp(0.25), num_epoch=2, checkpoint_dir=ckpt,
                       **_kw())
    pm = pt.train(Dataset({"features": X, "label": y}))
    jm = _jax_mlp(0.25)
    opt = jax_get_optimizer("adam", learning_rate=0.01)
    template = {"params": jm.params, "state": jm.state,
                "opt": opt.init(jm.params), "rng": jax.random.PRNGKey(0)}
    jtree = JaxCheckpointManager(ckpt).restore(template)
    ptree = CheckpointManager(ckpt).restore(template)
    for a, b in zip(jax.tree_util.tree_leaves(jtree),
                    jax.tree_util.tree_leaves(ptree)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert jtree["rng"].dtype == np.uint32
    for a, b in zip(jax.tree_util.tree_leaves(jtree["params"]),
                    jax.tree_util.tree_leaves(pm.params)):
        assert a.tobytes() == b.detach().numpy().tobytes()
    resumed = JaxSingleTrainer(_jax_mlp(0.25), num_epoch=3,
                               checkpoint_dir=ckpt, resume=True,
                               **_kw()).train(
        JaxDataset({"features": X, "label": y}))
    for r, g in zip(jax.tree_util.tree_leaves(whole.params),
                    jax.tree_util.tree_leaves(
                        jax.device_get(resumed.params))):
        r = r.detach().numpy()
        np.testing.assert_allclose(g, r, atol=TOL * np.abs(r).max())
    # JAX's own save of epoch 2 lists the port's keys, in the same order
    mgr = CheckpointManager(ckpt)
    assert mgr.all_steps()[-2:] == [1, 2] and mgr.keys(1) == mgr.keys(2)


def test_port_distributed_trainer_checkpoints_center(tmp_path):
    X, y = _ds()
    ckpt = str(tmp_path / "ck")
    tr = DOWNPOUR(_mlp(), num_workers=4, batch_size=16,
                  communication_window=2, num_epoch=2,
                  worker_optimizer="sgd", learning_rate=0.05, loss=LOSS,
                  checkpoint_dir=ckpt)
    model = tr.train(Dataset({"features": X, "label": y}))
    mgr = CheckpointManager(ckpt)
    assert mgr.latest_step() == 1
    restored = mgr.restore({"params": model.params, "state": model.state})
    for a, b in zip(tree_leaves(restored["params"]),
                    tree_leaves(model.params)):
        np.testing.assert_allclose(a, b.detach().numpy(), rtol=1e-6)
    # a resume restarts the workers from that center and runs epoch 2
    tr2 = DOWNPOUR(_mlp(), num_workers=4, batch_size=16,
                   communication_window=2, num_epoch=3,
                   worker_optimizer="sgd", learning_rate=0.05, loss=LOSS,
                   checkpoint_dir=ckpt, resume=True)
    tr2.train(Dataset({"features": X, "label": y}))
    assert len(tr2.get_history().epochs) == 1 and mgr.latest_step() == 2


def test_port_host_async_checkpoint_and_resume(tmp_path):
    X, y = _ds(256)
    ckpt = str(tmp_path / "ck")
    kw = dict(num_workers=2, communication_window=2, batch_size=16,
              worker_optimizer="sgd", learning_rate=0.05, loss=LOSS,
              checkpoint_dir=ckpt)
    m = HostAsyncTrainer(_mlp(), num_epoch=2, **kw).train(
        Dataset({"features": X, "label": y}))
    mgr = CheckpointManager(ckpt)
    assert mgr.latest_step() == 1
    restored = mgr.restore({"params": m.params, "state": m.state})
    for a, b in zip(tree_leaves(restored["params"]), tree_leaves(m.params)):
        np.testing.assert_array_equal(a, b.detach().numpy())
    tr = HostAsyncTrainer(_mlp(), num_epoch=3, resume=True, **kw)
    tr.train(Dataset({"features": X, "label": y}))
    assert len(tr.get_history().epochs) == 1 and mgr.latest_step() == 2


def test_invalid_checkpoint_cadence_rejected(tmp_path):
    with pytest.raises(ValueError, match="checkpoint_every"):
        SingleTrainer(_mlp(), checkpoint_dir=str(tmp_path),
                      checkpoint_every=0, loss=LOSS)
    with pytest.raises(ValueError, match="max_to_keep"):
        CheckpointManager(str(tmp_path), max_to_keep=0)


def test_step_timer_and_percentiles():
    t = StepTimer()
    with t.phase("train"):
        pass
    with t.phase("train"):
        pass
    s = t.summary()
    assert s["train"]["count"] == 2 and s["train"]["total_s"] >= 0
    t.reset()
    assert t.summary() == {}
    assert percentiles([]) is None
    assert percentiles([1.0, 2.0, 3.0, 4.0]) == {
        "p50": 2.5, "p99": pytest.approx(3.97)}


def test_device_memory_stats_no_crash():
    stats = device_memory_stats()
    assert stats is None or all(s["bytes_limit"] > 0 for s in stats)


def test_async_writes_durable_and_ordered(tmp_path):
    m = CheckpointManager(str(tmp_path), async_writes=True)
    w = np.arange(1000, dtype=np.float32)
    for step in range(3):
        m.save(step, {"w": torch.from_numpy(w + step)},
               metadata={"epoch": step})
    assert m.latest_step() == 2  # wait() inside makes queued writes visible
    got = m.restore({"w": np.zeros(1000, np.float32)})
    np.testing.assert_allclose(got["w"], w + 2)


def test_async_write_error_surfaces(tmp_path):
    import shutil
    m = CheckpointManager(str(tmp_path / "c"), async_writes=True)
    m.save(0, {"w": np.zeros(4, np.float32)})
    m.wait()
    # a FILE where the directory should be: the next write fails
    shutil.rmtree(str(tmp_path / "c"))
    os.mknod(str(tmp_path / "c"))
    m.save(1, {"w": np.zeros(4, np.float32)})
    with pytest.raises(Exception):
        m.wait()


def test_trainer_checkpoint_async_roundtrip(tmp_path):
    rs = np.random.RandomState(0)
    X = rs.randn(256, 4).astype(np.float32)
    y = rs.randint(0, 2, 256)
    ds = Dataset({"features": X, "label": y})
    cdir = str(tmp_path / "ck")
    kwargs = dict(batch_size=32, checkpoint_dir=cdir, checkpoint_async=True,
                  loss=LOSS, worker_optimizer="sgd",
                  optimizer_kwargs={"learning_rate": 0.1})
    SingleTrainer(Model.build(Sequential([Dense(2)]), (4,), device="cpu"),
                  num_epoch=2, **kwargs).train(ds)
    resumed = SingleTrainer(Model.build(Sequential([Dense(2)]), (4,),
                                        device="cpu"),
                            num_epoch=4, resume=True, **kwargs)
    resumed.train(ds)
    assert resumed.get_history().losses().shape[0] == 2 * (256 // 32)
    assert CheckpointManager(cdir).latest_step() == 3


def test_port_moe_checkpoint_restores_in_jax_template(tmp_path):
    """An MoE LM with a balance-loss weight: the port's checkpoint holds
    the zero ``__aux_loss__`` state leaf of JAX's tree, so JAX's
    ``CheckpointManager`` restores it into JAX's own template; the port
    resumes it into its own (which has no such leaf)."""
    from distkeras_tpu.models import zoo as jax_zoo
    from distkeras_tpu_torch.models import zoo
    spec = dict(d_model=16, num_heads=2, num_layers=2, mlp_ratio=2,
                moe_every=2, num_experts=4, moe_aux_loss_weight=0.01)
    rs = np.random.RandomState(0)
    toks = rs.randint(0, 16, (8, 9))
    ds = Dataset.from_arrays(toks[:, :-1], toks[:, 1:])
    kw = dict(_kw(), batch_size=4)
    ck = str(tmp_path / "ck")
    pm = SingleTrainer(Model.build(zoo.transformer_lm(16, **spec), (8,),
                                   device="cpu"), num_epoch=1,
                       checkpoint_dir=ck, **kw).train(ds)
    jm = JaxModel.build(jax_zoo.transformer_lm(16, **spec), (8,), seed=0)
    opt = jax_get_optimizer("adam", learning_rate=0.01)
    jtree = JaxCheckpointManager(ck).restore(
        {"params": jm.params, "state": jm.state,
         "opt": opt.init(jm.params), "rng": jax.random.PRNGKey(0)})
    aux = [l for p, l in jax.tree_util.tree_flatten_with_path(
        jtree["state"])[0] if "__aux_loss__" in jax.tree_util.keystr(p)]
    assert len(aux) == 1 and float(aux[0]) == 0.0
    for a, b in zip(jax.tree_util.tree_leaves(jtree["params"]),
                    sorted_leaves(pm.params)):
        assert a.tobytes() == b.detach().numpy().tobytes()
    tr = SingleTrainer(Model.build(zoo.transformer_lm(16, **spec), (8,),
                                   device="cpu"), num_epoch=2,
                       checkpoint_dir=ck, resume=True, **kw)
    tr.train(ds)
    assert len(tr.get_history().epochs) == 1
