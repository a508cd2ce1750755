"""The port's resilience layer (``distkeras_tpu_torch.resilience``) against
the JAX package's: fault specs fire on the same calls, retry policies
back off on the same schedule, and a supervised ``SingleTrainer`` that
crashes at ``train.epoch`` or at any ``ckpt.*`` point resumes bitwise
to the port's uninterrupted run (which equals JAX's within the trainer
tolerance). A NaN at ``train.loss`` rolls back exactly once, SIGTERM in
a real process exits 0, and the telemetry tape's log keys are JAX's."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.data import Dataset as JaxDataset
from distkeras_tpu.models import Dense as JaxDense
from distkeras_tpu.models import Model as JaxModel
from distkeras_tpu.models import Sequential as JaxSequential
from distkeras_tpu.parallel import SingleTrainer as JaxSingleTrainer
from distkeras_tpu.resilience import faults as jfaults
from distkeras_tpu.resilience import retry as jretry
from distkeras_tpu.utils.callbacks import LambdaCallback as JaxLambda

from distkeras_tpu_torch.data import Dataset, ShardedDataset
from distkeras_tpu_torch.models import Model, Sequential
from distkeras_tpu_torch.models.core import sorted_leaves
from distkeras_tpu_torch.models.layers import Dense
from distkeras_tpu_torch.parallel import SingleTrainer
from distkeras_tpu_torch.resilience import (AnomalyDetected, AnomalyGuard,
                                            InjectedFault, RetryPolicy,
                                            TrainingSupervisor, faults,
                                            io_retry)
from distkeras_tpu_torch.utils import (CheckpointManager, LambdaCallback,
                                       Prefetcher)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS = "sparse_categorical_crossentropy_from_logits"
#: the trainers' float32 tolerance against JAX (tests/test_torch_callbacks)
TOL = 1e-4


@pytest.fixture(autouse=True)
def _disarm():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


@pytest.fixture(autouse=True, scope="module")
def _one_intraop_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- faults and retry ----------------------------------------------------------

SPECS = ["a=nth:3", "b=every:4", "c=prob:0.3,seed:7",
         "d=prob:0.5,seed:11,transient:true", "e=every:2,stall:0.0"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_specs_fire_on_the_same_calls_as_jax(spec):
    name = spec.split("=")[0]
    fired = []
    for mod in (faults, jfaults):
        mod.load_env(spec)
        calls = []
        for i in range(40):
            try:
                mod.point(name)
            except mod.InjectedFault as e:
                calls.append((i, e.transient))
        fired.append((calls, mod.fired(name), mod.active()))
    assert fired[0] == fired[1]
    assert fired[0][1] >= 1


def test_fault_corrupt_and_catalog_match_jax():
    for mod in (faults, jfaults):
        mod.inject("loss", nth=2, action="nan")
        assert mod.corrupt("loss", np.ones(3)) is not None
        out = mod.corrupt("loss", np.ones(3))
        assert np.isnan(out).all()
        with pytest.raises(ValueError, match="corrupt"):
            mod.inject("ctl", nth=1, action="nan")
            mod.point("ctl")
    # the live catalog names every site that ran (other tests in this
    # process add their own)
    for mod in (faults, jfaults):
        assert {"loss", "ctl"} <= set(mod.points())
    # a disarmed site hands the value back without touching it
    faults.reset()
    t = torch.ones(2)
    assert faults.corrupt("loss", t) is t
    with pytest.raises(ValueError, match="unknown option"):
        faults.load_env("x=bogus:1")


def _schedule(mod, seed, fail_times, **kw):
    sleeps, n = [], [0]

    def flaky():
        n[0] += 1
        if n[0] <= fail_times:
            raise OSError("blip")
        return n[0]

    pol = mod.RetryPolicy(seed=seed, sleep=sleeps.append, **kw)
    try:
        out = pol.call(flaky, op="test")
    except OSError:
        out = "raised"
    return out, sleeps


@pytest.mark.parametrize("kw", [dict(max_attempts=5),
                                dict(max_attempts=3),
                                dict(max_attempts=6, base_delay_s=0.5,
                                     max_delay_s=1.0)])
def test_retry_backoff_schedule_equals_jax(kw):
    for fail_times in (0, 2, 4):
        assert _schedule(sys.modules[RetryPolicy.__module__], 3,
                         fail_times, **kw) == \
            _schedule(jretry, 3, fail_times, **kw)
    assert io_retry().max_attempts == jretry.io_retry().max_attempts
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=0)
    pol = RetryPolicy(sleep=lambda s: None)
    with pytest.raises(InjectedFault):          # not transient: no retry
        pol.call(lambda: (_ for _ in ()).throw(InjectedFault("p")))


def test_checkpoint_and_prefetch_points(tmp_path):
    """A transient ``ckpt.write`` / ``ckpt.restore`` blip heals through
    the manager's retry; ``prefetch.produce`` re-raises at the consumer
    with its own type."""
    m = CheckpointManager(str(tmp_path))
    faults.inject("ckpt.write", nth=1, transient=True)
    m.save(0, {"w": np.arange(4.0)})
    faults.inject("ckpt.restore", nth=1, transient=True)
    np.testing.assert_array_equal(m.restore({"w": np.zeros(4)})["w"],
                                  np.arange(4.0))
    assert faults.fired("ckpt.write") == faults.fired("ckpt.restore") == 1
    faults.inject("prefetch.produce", nth=2)
    with pytest.raises(InjectedFault):
        list(Prefetcher(lambda i: i, range(5)))


# --- supervised training ----------------------------------------------------------

D, C = 8, 2


def _data(n=256):
    rs = np.random.RandomState(0)
    X = rs.randn(n, D).astype(np.float32)
    return X, (X.sum(axis=1) > 0).astype(np.int64)


def _ds():
    X, y = _data()
    return Dataset({"features": X, "label": y})


def _trainer(ckpt=None, resume=False, num_epoch=4, **kw):
    m = Model.build(Sequential([Dense(16, activation="relu"), Dense(C)]),
                    (D,), seed=0, device="cpu")
    return SingleTrainer(m, batch_size=32, num_epoch=num_epoch,
                         worker_optimizer="adam", learning_rate=0.01,
                         loss=LOSS, checkpoint_dir=ckpt, resume=resume, **kw)


def _leaves(model):
    return [p.detach().numpy().copy() for p in sorted_leaves(model.params)]


@pytest.fixture(scope="module")
def oracle():
    """The uninterrupted 4-epoch run: its final params, checked against
    JAX's same run within the trainer tolerance."""
    params = _leaves(_trainer().train(_ds()))
    jm = JaxModel.build(JaxSequential([JaxDense(16, activation="relu"),
                                       JaxDense(C)]), (D,), seed=0)
    X, y = _data()
    jt = JaxSingleTrainer(jm, batch_size=32, num_epoch=4,
                          worker_optimizer="adam", learning_rate=0.01,
                          loss=LOSS)
    jtrained = jt.train(JaxDataset({"features": X, "label": y}))
    for a, b in zip(params, jax.tree_util.tree_leaves(jtrained.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL)
    return params


@pytest.mark.parametrize("point", ["train.epoch", "ckpt.d2h", "ckpt.write",
                                   "ckpt.rename", "prefetch.produce"])
def test_crash_at_any_point_resumes_bitwise(tmp_path, oracle, point):
    """A hard fault at ``point`` (nth=2: after epoch 0 is durable) kills
    ``train()``; the supervisor resumes and the final params equal the
    uninterrupted run's bit for bit (carry, optimizer state and key all
    restored)."""
    faults.inject(point, nth=2)
    tr = _trainer(ckpt=str(tmp_path / "ck"))
    result = TrainingSupervisor(tr, max_restarts=2,
                                handle_signals=()).run(_ds())
    assert result.restarts == 1 and not result.preempted
    assert faults.fired(point) == 1
    for a, b in zip(_leaves(result.model), oracle):
        np.testing.assert_array_equal(a, b)
    assert not [p for p in (tmp_path / "ck").iterdir()
                if p.name.endswith(".tmp")]


def test_crash_at_restore_resumes_bitwise(tmp_path, oracle):
    """``ckpt.restore`` fires on the resumed run's read: the supervisor
    restarts again and lands on the same carry."""
    ck = str(tmp_path / "ck")
    faults.inject("train.epoch", nth=3)
    faults.inject("ckpt.restore", nth=1)
    result = TrainingSupervisor(_trainer(ckpt=ck), max_restarts=3,
                                handle_signals=()).run(_ds())
    assert result.restarts == 2
    for a, b in zip(_leaves(result.model), oracle):
        np.testing.assert_array_equal(a, b)


def test_nan_loss_rolls_back_exactly_once(tmp_path, oracle):
    faults.inject("train.loss", nth=3, action="nan")   # poison epoch 2
    tr = _trainer(ckpt=str(tmp_path / "ck"))
    sup = TrainingSupervisor(tr, anomaly_guard=AnomalyGuard(),
                             rollback_budget=1, max_restarts=0,
                             handle_signals=())
    result = sup.run(_ds())
    assert result.rollbacks == 1 and result.restarts == 0
    assert faults.fired("train.loss") == 1
    for a, b in zip(_leaves(result.model), oracle):
        np.testing.assert_array_equal(a, b)
    faults.inject("train.loss", every=1, action="nan")
    sup = TrainingSupervisor(_trainer(ckpt=str(tmp_path / "ck2")),
                             anomaly_guard=AnomalyGuard(),
                             rollback_budget=1, max_restarts=0,
                             handle_signals=())
    with pytest.raises(AnomalyDetected):
        sup.run(_ds())
    assert sup.rollbacks == 1


def test_supervisor_guards_and_spike_detection(tmp_path):
    with pytest.raises(ValueError, match="checkpoint_dir"):
        TrainingSupervisor(_trainer())
    with pytest.raises(ValueError, match="checkpoint_async"):
        TrainingSupervisor(_trainer(ckpt=str(tmp_path),
                                    checkpoint_async=True),
                           anomaly_guard=AnomalyGuard())
    g = AnomalyGuard(spike_factor=3.0)
    for e, v in enumerate((1.0, 1.1, 0.9)):
        g.on_epoch_end(e, {"loss": v})
    with pytest.raises(AnomalyDetected, match="spike"):
        g.on_epoch_end(3, {"loss": 10.0})
    faults.inject("train.epoch", every=1)
    sup = TrainingSupervisor(_trainer(ckpt=str(tmp_path / "x")),
                             max_restarts=1, handle_signals=())
    with pytest.raises(InjectedFault):
        sup.run(_ds())
    assert sup.restarts == 1


def test_sharded_fetch_transient_fault_heals(tmp_path):
    """``data.fetch`` fires on the loader thread; a transient blip costs
    a backoff and the run equals an unfaulted one."""
    X, y = _data()
    paths = []
    for i in range(2):
        p = str(tmp_path / f"s{i}.npz")
        np.savez(p, features=X[i::2], label=y[i::2])
        paths.append(p)
    sds = ShardedDataset(paths)
    clean = _leaves(_trainer(num_epoch=2).train(sds))
    faults.inject("data.fetch", nth=2, transient=True)
    healed = _leaves(_trainer(num_epoch=2).train(sds))
    assert faults.fired("data.fetch") == 1
    for a, b in zip(clean, healed):
        np.testing.assert_array_equal(a, b)


_PREEMPT_SCRIPT = """
import os, signal, sys
import numpy as np
from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.models import Model, Sequential
from distkeras_tpu_torch.models.layers import Dense
from distkeras_tpu_torch.parallel import SingleTrainer
from distkeras_tpu_torch.resilience import TrainingSupervisor
from distkeras_tpu_torch.utils.callbacks import Callback

class Kill(Callback):
    def on_epoch_end(self, epoch, logs=None):
        if epoch == 1:
            os.kill(os.getpid(), signal.SIGTERM)

rs = np.random.RandomState(0)
X = rs.randn(256, 8).astype("float32")
y = (X.sum(axis=1) > 0).astype("int64")
m = Model.build(Sequential([Dense(8, activation="relu"), Dense(2)]),
                (8,), seed=0, device="cpu")
tr = SingleTrainer(m, batch_size=32, num_epoch=50, worker_optimizer="sgd",
                   learning_rate=0.1,
                   loss="sparse_categorical_crossentropy_from_logits",
                   checkpoint_dir=sys.argv[1], callbacks=[Kill()])
TrainingSupervisor(tr, on_preempt="exit").run(
    Dataset({"features": X, "label": y}))
raise SystemExit("unreachable: preemption should have exited 0")
"""


def test_sigterm_subprocess_exits_zero(tmp_path):
    """SIGTERM mid-run in a real process: the supervisor's handler asks
    for a preemption, the epoch is checkpointed, the process exits 0."""
    proc = subprocess.run(
        [sys.executable, "-c", _PREEMPT_SCRIPT, str(tmp_path / "ck")],
        cwd=REPO, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == 1


def test_tape_log_keys_equal_jax():
    """The auto tape's columns merge into the callback logs under JAX's
    keys (no ``mfu`` on the CPU in either package)."""
    seen = []
    tr = _trainer(num_epoch=2, callbacks=[LambdaCallback(
        on_epoch_end=lambda e, logs: seen.append(sorted(logs)))])
    tr.train(_ds())
    jseen = []
    X, y = _data()
    JaxSingleTrainer(
        JaxModel.build(JaxSequential([JaxDense(16, activation="relu"),
                                      JaxDense(C)]), (D,), seed=0),
        batch_size=32, num_epoch=2, loss=LOSS, callbacks=[JaxLambda(
            on_epoch_end=lambda e, logs: jseen.append(sorted(logs)))]
    ).train(JaxDataset({"features": X, "label": y}))
    assert seen == jseen and "mfu" not in seen[0]
    snap = tr.tape.snapshot()
    assert set(snap) == {"unit", "epochs", "examples", "wall_s", "phases_s",
                         "compile_s", "goodput", "recompiles"}
    assert snap["examples"] == 2 * 256
