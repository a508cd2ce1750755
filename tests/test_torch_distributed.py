"""The port's distributed-SGD family against the JAX package: DOWNPOUR,
EASGD, AEASGD, ADAG, DynSGD and AveragingTrainer with their workers
stacked on one device (``parallel.engine``), and ``EnsembleTrainer``.

Each JAX trainer runs on the conftest's 8 virtual CPU devices (one
worker a device, ``shard_map``); the port stacks the same 8 workers on
the CPU. The same numpy data and the same initial weights
(``from_jax_params``) go to both. Per-worker losses ``[S, W]`` of every
epoch must agree within 1e-4 relative, and the trained center within
1e-4 of each leaf's largest |value|: both sides compute in float32 and
differ only in summation order (JAX's psum may add in a tree order; the
port adds the committing workers in order).
"""

import functools
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.data import Dataset as JaxDataset
from distkeras_tpu.models import Dense as JaxDense
from distkeras_tpu.models import Dropout as JaxDropout
from distkeras_tpu.models import Model as JaxModel
from distkeras_tpu.models import Sequential as JaxSequential
import distkeras_tpu.parallel as jax_parallel
import distkeras_tpu.parallel.distributed as jax_distributed
from distkeras_tpu.parallel.engine import EngineConfig as JaxEngineConfig

from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.models import (Model, Sequential, from_jax_params,
                                        to_jax_params)
from distkeras_tpu_torch.models.layers import Dense, Dropout
from distkeras_tpu_torch import parallel
import distkeras_tpu_torch.parallel.distributed as port_distributed
from distkeras_tpu_torch.parallel.engine import (DistributedEngine,
                                                 DownpourAlgo, EngineConfig,
                                                 WorkerStack)
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.ops.optimizers import get_optimizer
from distkeras_tpu_torch.utils.tree import tree_leaves

N, D, C, W = 1024, 16, 4, 8
LOSS = "sparse_categorical_crossentropy_from_logits"
#: per-step losses and the center: float32 on both sides, summation
#: order apart
REL_TOL = 1e-4

# the auto-amortized engine warns that staggered commits batch at block
# boundaries; several cases here take that path on purpose
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


def _data(seed=0, n=N):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, D).astype(np.float32)
    w = rs.randn(D, C)
    y = np.argmax(X @ w + 0.1 * rs.randn(n, C), axis=1)
    return X, y


def _jax_model(dropout=False):
    mid = [JaxDropout(0.2)] if dropout else []
    return JaxModel.build(JaxSequential(
        [JaxDense(64, activation="relu")] + mid + [JaxDense(C)]), (D,),
        seed=0)


def _port_model(dropout=False):
    """The port's MLP, loaded with a fresh JAX build's weights."""
    mid = [Dropout(0.2)] if dropout else []
    m = Model.build(Sequential([Dense(64, activation="relu")] + mid
                               + [Dense(C)]), (D,), seed=0, device="cpu")
    return from_jax_params(m, jax.device_get(_jax_model(dropout).params))


def _assert_center_close(jax_params, port_model):
    ref = jax.tree_util.tree_leaves(jax.device_get(jax_params))
    got = jax.tree_util.tree_leaves(to_jax_params(port_model))
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert np.max(np.abs(r - g)) <= REL_TOL * np.max(np.abs(r))


def _assert_history_close(jt, pt):
    assert len(jt.history.epochs) == len(pt.history.epochs)
    for je, pe in zip(jt.history.epochs, pt.history.epochs):
        assert set(je) == set(pe)
        for key in je:
            np.testing.assert_allclose(pe[key], np.asarray(je[key]),
                                       rtol=REL_TOL, err_msg=key)


#: (trainer name, keywords, amortized, dropout, data rows): ``amortized``
#: None is both engines' auto rule; False forces the per-step path by
#: patching each package's ``distributed.EngineConfig`` (neither family
#: of trainers has such an option)
CASES = {
    "downpour_w4_amortized": ("DOWNPOUR", dict(communication_window=4),
                              None, False, N),
    "downpour_w4_perstep": ("DOWNPOUR", dict(communication_window=4),
                            False, False, N),
    # window 3 over 4 steps: a remainder block; commit_scale 1/8 commits
    # the workers' mean delta
    "downpour_remainder_block_mean_delta": ("DOWNPOUR", dict(
        communication_window=3, commit_scale=1 / 8), None, False, N),
    "downpour_dropout_adam": ("DOWNPOUR", dict(
        communication_window=2, worker_optimizer="adam",
        learning_rate=0.01, metrics=["accuracy"]), None, True, N),
    "downpour_parallelism_factor_2": ("DOWNPOUR", dict(
        communication_window=2, parallelism_factor=2), None, False, N),
    "easgd_sync": ("EASGD", dict(communication_window=2, rho=5.0,
                                 learning_rate=0.01,
                                 optimizer_kwargs={"learning_rate": 0.05}),
                   None, False, N),
    "aeasgd_amortized": ("AEASGD", dict(
        communication_window=4, rho=5.0, learning_rate=0.01,
        optimizer_kwargs={"learning_rate": 0.05}), None, False, N),
    "aeasgd_perstep_mean": ("AEASGD", dict(
        communication_window=4, rho=5.0, learning_rate=0.05,
        center_mode="mean", optimizer_kwargs={"learning_rate": 0.05}),
        False, False, N),
    "adag": ("ADAG", dict(communication_window=2, adag_learning_rate=0.1),
             None, False, N),
    "dynsgd_heterogeneous": ("DynSGD", dict(
        communication_window=[2, 2, 4, 4, 4, 4, 8, 8]), None, False, N),
    # 1000 rows: the remainder of the last global step is dropped
    "averaging_ragged_rows": ("AveragingTrainer", {}, None, False, 1000),
}


def _common(kw):
    out = dict(num_workers=W, batch_size=32, num_epoch=2,
               worker_optimizer="sgd", learning_rate=0.05, loss=LOSS)
    out.update(kw)
    if "optimizer_kwargs" in out:
        out.pop("learning_rate")
    return out


def _force_program(monkeypatch, amortized):
    """Pin both packages' trainers to one epoch program."""
    if amortized is None:
        return
    monkeypatch.setattr(jax_distributed, "EngineConfig",
                        functools.partial(JaxEngineConfig,
                                          amortized=amortized))
    monkeypatch.setattr(port_distributed, "EngineConfig",
                        functools.partial(EngineConfig, amortized=amortized))


def _train_both(name, kw, amortized, dropout, rows, monkeypatch,
                validation=False):
    X, y = _data(n=rows)
    kw = _common(kw)
    if validation:
        Xv, yv = _data(seed=1, n=256)
        kw["validation_data"] = (Xv, yv)
    _force_program(monkeypatch, amortized)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt = getattr(jax_parallel, name)(_jax_model(dropout), **kw)
        jm = jt.train(JaxDataset({"features": X, "label": y}))
        pt = getattr(parallel, name)(_port_model(dropout), **kw)
        pm = pt.train(Dataset({"features": X, "label": y}))
    return jt, jm, pt, pm


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_matches_jax(case, monkeypatch):
    name, kw, amortized, dropout, rows = CASES[case]
    jt, jm, pt, pm = _train_both(name, kw, amortized, dropout, rows,
                                 monkeypatch)
    losses = pt.get_history().losses()
    assert losses.ndim == 2 and losses.shape[1] == W
    _assert_history_close(jt, pt)
    _assert_center_close(jm.params, pm)


def test_center_validation_matches_jax(monkeypatch):
    jt, _, pt, _ = _train_both("DOWNPOUR", dict(communication_window=2),
                               None, False, N, monkeypatch, validation=True)
    assert "val_loss" in pt.history.epochs[-1]
    _assert_history_close(jt, pt)


@pytest.mark.parametrize("amortized", [None, False])
def test_server_updates_are_exact(amortized, monkeypatch):
    """Amortized: ``ceil(S / K)`` commits an epoch, every worker in each;
    per-step: one server update on each step where some worker's
    ``(t + 1 + offset) % K == 0``."""
    X, y = _data()
    ds = Dataset({"features": X, "label": y})
    S = N // (W * 32)  # 4
    window = 3
    _force_program(monkeypatch, amortized)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tr = parallel.DOWNPOUR(_port_model(),
                               **_common(dict(communication_window=window)))
        tr.train(ds)
    eng = tr.engine
    assert eng.amortized == (amortized is None)
    if eng.amortized:
        assert eng.server_updates == 2 * -(-S // window)
        assert eng.worker_commits == W * eng.server_updates
    else:
        offsets = (np.arange(W) * window) // W
        masks = [[(t + 1 + o) % window == 0 for o in offsets]
                 for t in range(2 * S)]
        assert eng.server_updates == sum(any(m) for m in masks)
        assert eng.worker_commits == sum(sum(m) for m in masks)


def test_history_shapes_and_time():
    X, y = _data()
    tr = parallel.DOWNPOUR(_port_model(), **_common(dict(
        batch_size=64, communication_window=2)))
    tr.train(Dataset({"features": X, "label": y}))
    S = N // (W * 64)
    assert tr.get_history().losses().shape == (2 * S, W)
    assert tr.get_averaged_history().shape == (2 * S,)
    assert tr.get_training_time() > 0


def test_family_is_exported_under_jax_names():
    for name in ("DOWNPOUR", "EASGD", "AEASGD", "ADAG", "DynSGD",
                 "AveragingTrainer", "DistributedTrainer",
                 "HostAsyncTrainer", "EnsembleTrainer", "SingleTrainer",
                 "Trainer", "ParameterServer", "DeltaParameterServer",
                 "ADAGParameterServer", "DynSGDParameterServer",
                 "EASGDParameterServer", "PSClient"):
        assert hasattr(jax_parallel, name) and hasattr(parallel, name), name


def test_mesh_raises_naming_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="item 10"):
        parallel.DOWNPOUR(_port_model(), mesh=object(), loss=LOSS)


def test_num_workers_default_and_no_device_limit():
    """``num_workers=None`` is the device count of the model's device
    type (1 on the CPU; JAX: its 8 devices). Workers are stacked, so an
    explicit count has no device limit (JAX refuses 16 on 8 devices)."""
    assert parallel.DOWNPOUR(_port_model(), loss=LOSS).num_workers == 1
    assert jax_parallel.DOWNPOUR(_jax_model(), loss=LOSS).num_workers == 8
    X, y = _data()
    ds = Dataset({"features": X, "label": y})
    tr = parallel.DOWNPOUR(_port_model(), **_common(dict(
        num_workers=16, batch_size=16, communication_window=2)))
    tr.train(ds)
    losses = tr.get_history().losses()
    assert losses.shape[1] == 16 and np.isfinite(losses).all()
    with pytest.raises(ValueError, match="exceeds available devices"):
        jax_parallel.DOWNPOUR(_jax_model(), num_workers=16,
                              loss=LOSS).train(
            JaxDataset({"features": X, "label": y}))


def test_rejects_tiny_dataset():
    ds = Dataset({"features": np.zeros((16, D), np.float32),
                  "label": np.zeros(16, np.int64)})
    with pytest.raises(ValueError, match="smaller than one global step"):
        parallel.DOWNPOUR(_port_model(), num_workers=8, batch_size=32,
                          loss=LOSS).train(ds)


def test_parallelism_factor_checks():
    with pytest.raises(ValueError, match="parallelism_factor"):
        parallel.AEASGD(_port_model(), num_workers=8, parallelism_factor=0)
    X, y = _data()
    tr = parallel.DOWNPOUR(_port_model(), **_common(dict(
        communication_window=1, parallelism_factor=3)))
    with pytest.warns(UserWarning, match="trailing 1 steps are dropped"):
        tr.train(Dataset({"features": X, "label": y}))
    assert tr.get_history().losses().shape == (2 * 3, W)


def test_easgd_alpha_and_stability_warning():
    tr = parallel.EASGD(_port_model(), num_workers=8, rho=5.0,
                        learning_rate=0.01, loss=LOSS)
    assert tr.alpha == pytest.approx(0.05)
    with pytest.warns(UserWarning, match="EASGD stability"):
        parallel.EASGD(_port_model(), num_workers=8, rho=5.0,
                       learning_rate=0.05, loss=LOSS).allocate_algorithm()


@pytest.mark.parametrize("option", ["checkpoint_dir", "resume", "callbacks",
                                    "profile_dir"])
def test_later_options_raise_naming_the_roadmap_item(option, tmp_path):
    """The options of ROADMAP Queue 1 item 9 are ported on the family
    (the name keeps the cases that raised): the stacked-worker engine and
    the host-async trainer checkpoint their center, resume from it, call
    callbacks each epoch and write a profile; ``EnsembleTrainer``
    refuses callbacks at ``train``, as JAX's does."""
    from distkeras_tpu_torch.utils import CheckpointManager, LambdaCallback
    X, y = _data(n=256)
    ds = Dataset({"features": X, "label": y})
    runs = ((parallel.DOWNPOUR, dict(num_workers=W)),
            (parallel.HostAsyncTrainer, dict(num_workers=2)))
    for cls, kw in runs:
        kw = dict(kw, batch_size=32, loss=LOSS, learning_rate=0.05,
                  communication_window=1)
        d = str(tmp_path / cls.__name__)
        if option in ("checkpoint_dir", "resume"):
            tr = cls(_port_model(), num_epoch=1, checkpoint_dir=d, **kw)
            m = tr.train(ds)
            mgr = CheckpointManager(d)
            assert mgr.latest_step() == 0
            center = mgr.restore({"params": m.params, "state": m.state})
            for a, b in zip(tree_leaves(center["params"]),
                            tree_leaves(m.params)):
                np.testing.assert_array_equal(a, b.detach().numpy())
            if option == "resume":
                tr = cls(_port_model(), num_epoch=2, checkpoint_dir=d,
                         resume=True, **kw)
                tr.train(ds)
                assert len(tr.get_history().epochs) == 1
                assert mgr.latest_step() == 1
        elif option == "callbacks":
            seen = []
            cb = LambdaCallback(on_epoch_end=lambda e, logs: seen.append(e))
            cls(_port_model(), num_epoch=2, callbacks=[cb], **kw).train(ds)
            assert seen == [0, 1], cls
        else:
            cls(_port_model(), num_epoch=1, profile_dir=d, **kw).train(ds)
            assert os.listdir(d), cls
    if option == "callbacks":
        with pytest.raises(ValueError, match="callbacks"):
            parallel.EnsembleTrainer(_port_model(), loss=LOSS,
                                     callbacks=[object()]).train(ds)


def test_step_options_are_refused():
    X, y = _data()
    ds = Dataset({"features": X, "label": y})
    for cls, kw in ((parallel.DOWNPOUR, dict(num_workers=8)),
                    (parallel.EnsembleTrainer, {}),
                    (parallel.HostAsyncTrainer, dict(num_workers=2))):
        with pytest.raises(ValueError, match="grad_accum_steps"):
            cls(_port_model(), loss=LOSS, grad_accum_steps=2,
                **kw).train(ds)


def test_averaged_history_matches_jax():
    losses = np.random.RandomState(0).rand(4, W)
    jt = jax_parallel.DOWNPOUR(_jax_model(), loss=LOSS)
    pt = parallel.DOWNPOUR(_port_model(), loss=LOSS)
    for tr in (jt, pt):
        tr.history.append_epoch(loss=losses)
    np.testing.assert_array_equal(pt.get_averaged_history(),
                                  jt.get_averaged_history())


def test_request_preempt_stops_after_the_epoch():
    X, y = _data()
    tr = parallel.DOWNPOUR(_port_model(), **_common(dict(
        communication_window=2)))
    tr.request_preempt()
    tr.train(Dataset({"features": X, "label": y}))
    assert len(tr.history.epochs) == 1 and tr.preempted
    tr.train(Dataset({"features": X, "label": y}))  # the notice is consumed
    assert len(tr.history.epochs) == 3 and not tr.preempted


def test_worker_step_writes_only_its_own_rows():
    """A worker's step updates its rows of the stacked parameters,
    optimizer state and keys in place, and no other worker's; the pull
    snapshots are the commit's alone."""
    from distkeras_tpu_torch.ops import prng
    pm = _port_model(dropout=True)
    opt = get_optimizer("adam", learning_rate=0.01)
    eng = DistributedEngine(pm.module, get_loss(LOSS), opt, DownpourAlgo(),
                            None, EngineConfig(num_workers=4, window=2))
    state = eng.init_state(pm.params, prng.key(0))
    worker = state["worker"]
    stack = WorkerStack(eng.train_step, worker["params"], worker["opt"],
                        worker["rng"])
    trained = {k: worker[k] for k in ("params", "opt", "rng")}
    before = [t.clone() for t in tree_leaves(trained)]
    pull = [t.clone() for t in tree_leaves(worker["pull"])]
    X, y = _data()
    stack.step(2, torch.from_numpy(X[:32]), torch.from_numpy(y[:32]))
    for b, a in zip(before, tree_leaves(trained)):
        assert not torch.equal(b[2], a[2]), b.shape
        for i in (0, 1, 3):
            assert torch.equal(b[i], a[i]), (i, b.shape)
    for b, a in zip(pull, tree_leaves(worker["pull"])):
        assert torch.equal(b, a)


def test_reset_workers_restores_the_center():
    pm = _port_model()
    eng = DistributedEngine(pm.module, get_loss(LOSS),
                            get_optimizer("sgd", learning_rate=0.05),
                            DownpourAlgo(), None,
                            EngineConfig(num_workers=8, window=2))
    from distkeras_tpu_torch.ops import prng
    state = eng.init_state(pm.params, prng.key(0))
    X, y = _data(n=128)
    Xs = X.reshape(4, 8, 4, D)
    Ys = y.reshape(4, 8, 4)
    state, _ = eng.run_epoch(state, Xs, Ys)
    with torch.no_grad():
        for t in tree_leaves(state["worker"]["params"]):
            t.add_(1.0)
    center = [t.clone() for t in tree_leaves(state["center"]["params"])]
    keys = state["worker"]["rng"].clone()
    eng.reset_workers(state)
    for s, c in zip(tree_leaves(state["worker"]["params"]), center):
        for i in range(8):
            assert torch.equal(s[i], c)
    for s, c in zip(tree_leaves(state["worker"]["pull"]), center):
        assert torch.equal(s, c.expand_as(s))
    for c0, c1 in zip(center, tree_leaves(state["center"]["params"])):
        assert torch.equal(c0, c1)
    assert torch.equal(keys, state["worker"]["rng"])
    assert state["server"]["t"] == 4


# --- EnsembleTrainer ---------------------------------------------------------

def test_ensemble_matches_jax():
    X, y = _data(n=384)
    kw = dict(num_models=3, batch_size=32, num_epoch=2,
              worker_optimizer="adam", learning_rate=0.01, loss=LOSS,
              metrics=["accuracy"])
    jt = jax_parallel.EnsembleTrainer(_jax_model(dropout=True), **kw)
    jmembers = jt.train(JaxDataset({"features": X, "label": y}))
    base = _port_model(dropout=True)
    base_before = [t.clone() for t in tree_leaves(base.params)]
    pt = parallel.EnsembleTrainer(base, **kw)
    members = pt.train(Dataset({"features": X, "label": y}))
    assert pt.get_history().losses().shape == (2 * 384 // 32, 3)
    _assert_history_close(jt, pt)
    assert len(members) == 3 and pt.models_ == members
    assert pt.master_model is members[0]
    for jm, pm in zip(jmembers, members):
        _assert_center_close(jm.params, pm)
    # the members are fresh builds (seed + i): the base stays as it was
    for b, a in zip(base_before, tree_leaves(base.params)):
        assert torch.equal(b, a)


def test_ensemble_refuses_validation_data_and_callbacks():
    X, y = _data()
    with pytest.raises(ValueError, match="validation_data"):
        parallel.EnsembleTrainer(_port_model(), loss=LOSS,
                                 validation_data=(X, y)).train(
            Dataset({"features": X, "label": y}))
    from distkeras_tpu_torch.utils import TerminateOnNaN
    with pytest.raises(ValueError, match="callbacks"):
        parallel.EnsembleTrainer(_port_model(), loss=LOSS,
                                 callbacks=[TerminateOnNaN()]).train(
            Dataset({"features": X, "label": y}))
