"""The port's two epoch programs against the JAX engine's
(``distkeras_tpu/parallel/engine.py``): the per-step masked path and the
two-level amortized path, on the same stacked workers, data and
weights.

JAX's ``tests/test_engine_amortized.py`` counts the param-sized psums in
the epoch's jaxpr and the all-reduce nesting in its HLO; the port has
no compiled program, so here the engine's own commit counts
(``server_updates``, ``worker_commits``) are held to those psum counts
and to the window arithmetic. Trajectories (per-step losses ``[S, W]``
and the extracted center) are held to JAX's within 1e-4 relative:
float32 on both sides, summation order apart.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import Dense as JaxDense
from distkeras_tpu.models import Model as JaxModel
from distkeras_tpu.models import Sequential as JaxSequential
from distkeras_tpu.ops.losses import get_loss as jax_get_loss
from distkeras_tpu.ops.optimizers import get_optimizer as jax_get_optimizer
from distkeras_tpu.parallel import engine as jax_engine
from distkeras_tpu.parallel.mesh import make_mesh

from distkeras_tpu_torch.models import Model, Sequential, from_jax_params
from distkeras_tpu_torch.models.layers import Dense
from distkeras_tpu_torch.ops import prng
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.ops.optimizers import get_optimizer
from distkeras_tpu_torch.parallel import engine

from test_engine_amortized import _psums_per_epoch

D, C, B, W = 16, 4, 4, 8
LOSS = "sparse_categorical_crossentropy_from_logits"
REL_TOL = 1e-4

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

ALGOS = {
    "downpour": ("DownpourAlgo", {}),
    "elastic_sync": ("ElasticAlgo", dict(alpha=0.05, synchronous=True)),
    "elastic_async": ("ElasticAlgo", dict(alpha=0.05)),
    "averaging": ("AveragingAlgo", {}),
    "adag": ("AdagAlgo", dict(adag_lr=0.1)),
    "dynsgd": ("DynSGDAlgo", {}),
}


def _jax_model():
    return JaxModel.build(JaxSequential([JaxDense(8, activation="relu"),
                                         JaxDense(C)]), (D,), seed=0)


def _engines(algo, window, amortized=None):
    """The JAX engine on the 8-device mesh and the port's over 8 stacked
    workers, for one algorithm, with the same initial weights."""
    cls, kw = ALGOS[algo]
    jm = _jax_model()
    je = jax_engine.DistributedEngine(
        jm.module, jax_get_loss(LOSS),
        jax_get_optimizer("sgd", learning_rate=0.05),
        getattr(jax_engine, cls)(**kw), make_mesh(W),
        jax_engine.EngineConfig(num_workers=W, window=window,
                                amortized=amortized))
    pm = from_jax_params(
        Model.build(Sequential([Dense(8, activation="relu"), Dense(C)]),
                    (D,), seed=0, device="cpu"),
        jax.device_get(jm.params))
    pe = engine.DistributedEngine(
        pm.module, get_loss(LOSS), get_optimizer("sgd", learning_rate=0.05),
        getattr(engine, cls)(**kw), None,
        engine.EngineConfig(num_workers=W, window=window,
                            amortized=amortized))
    return jm, je, pm, pe


def _epoch_data(S, seed=0):
    rs = np.random.RandomState(seed)
    Xf = rs.randn(S * W * B, D).astype(np.float32)
    yf = np.argmax(Xf @ rs.randn(D, C), axis=1)  # separable teacher
    return Xf.reshape(S, W, B, D), yf.reshape(S, W, B)


def _run_jax(jm, je, S, epochs):
    X, Y = _epoch_data(S)
    params = jax.tree_util.tree_map(jnp.array, jm.params)
    state = je.init_state(params, jm.state, jax.random.PRNGKey(0))
    state = jax.device_put(state, je.shardings())
    losses = []
    for _ in range(epochs):
        state, outs = je.run_epoch(state, jnp.asarray(X), jnp.asarray(Y))
        losses.append(np.asarray(jax.device_get(outs)))
    params, _ = je.extract_model(state)
    return losses, jax.device_get(params)


def _run_port(pm, pe, S, epochs):
    X, Y = _epoch_data(S)
    state = pe.init_state(pm.params, prng.key(0))
    losses = []
    for _ in range(epochs):
        state, outs = pe.run_epoch(state, X, Y)
        losses.append(outs.numpy())
    center, _ = pe.extract_model(state)
    return losses, center, state


def _assert_same_trajectory(jax_run, port_run):
    (jl, jp), (pl, pc) = jax_run, port_run[:2]
    for a, b in zip(jl, pl):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=REL_TOL)
    # jax's tree_leaves lists both trees' dict entries sorted
    ref = jax.tree_util.tree_leaves(jp)
    got = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.numpy(), pc))
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert np.max(np.abs(r - g)) <= REL_TOL * np.max(np.abs(r))


# -- commit counts: the S/K proportionality ------------------------------------

@pytest.mark.parametrize("window,S", [(4, 12), (8, 12), (5, 12), (16, 12)])
def test_commits_per_epoch_proportional_to_windows(window, S):
    """Amortized: ``ceil(S / K)`` commits an epoch (the remainder block
    flushes once), every worker in each: JAX's psum executions per epoch
    over its 5 per commit. Per-step: a server update on each step where
    some worker's ``(t + 1 + offset) % K == 0``."""
    per_commit = 5  # 4 param leaves + n_commits cross the mesh in JAX
    n_windows = -(-S // window)
    _, _, pm, pe = _engines("downpour", window, amortized=True)
    _run_port(pm, pe, S, 1)
    assert pe.server_updates == n_windows
    assert pe.worker_commits == W * n_windows
    assert pe.server_updates * per_commit == _psums_per_epoch(
        jax_engine.DownpourAlgo(), window, S, amortized=True)

    _, _, pm, pe = _engines("downpour", window, amortized=False)
    _run_port(pm, pe, S, 1)
    offsets = (np.arange(W) * window) // W
    masks = np.array([[(t + 1 + o) % window == 0 for o in offsets]
                      for t in range(S)])
    assert pe.server_updates == int(masks.any(axis=1).sum())
    assert pe.worker_commits == int(masks.sum())
    # the JAX per-step program reduces every step; the port skips the
    # steps where no worker commits (an exact no-op)
    assert _psums_per_epoch(jax_engine.DownpourAlgo(), window, S,
                            amortized=False) == S * per_commit
    if window <= W:
        assert pe.server_updates == S


def test_window_one_is_per_step_either_way():
    counts = []
    for amortized in (True, False):
        _, _, pm, pe = _engines("downpour", 1, amortized=amortized)
        _run_port(pm, pe, 16, 1)
        counts.append((pe.server_updates, pe.worker_commits))
    assert counts[0] == counts[1] == (16, 16 * W)


# -- trajectories against JAX ----------------------------------------------------

@pytest.mark.parametrize("algo,window,amortized,S", [
    ("downpour", 4, True, 16),
    ("downpour", 4, False, 16),
    ("downpour", 4, True, 10),     # a remainder block of 2
    ("elastic_sync", 4, True, 16),
    ("elastic_sync", 3, True, 10),  # sync + remainder: truncated window
    ("elastic_async", 4, None, 16),
    ("elastic_async", 4, False, 16),
    ("averaging", 16, None, 16),
    ("adag", 4, None, 16),
    ("dynsgd", [2, 2, 4, 4, 4, 4, 8, 8], None, 16),
    ("dynsgd", 5, False, 16),      # the window phase carries across epochs
])
def test_epoch_programs_match_jax(algo, window, amortized, S):
    jm, je, pm, pe = _engines(algo, window, amortized)
    assert pe.amortized == je.amortized
    _assert_same_trajectory(_run_jax(jm, je, S, 2), _run_port(pm, pe, S, 2))


def test_sync_elastic_amortized_equals_perstep():
    """Synchronous algorithms commit at the window's last step, where the
    amortized snapshot IS the live parameters: both programs give one
    trajectory."""
    runs = []
    for amortized in (True, False):
        _, _, pm, pe = _engines("elastic_sync", 4, amortized)
        runs.append(_run_port(pm, pe, 16, 2))
    for a, b in zip(runs[0][0], runs[1][0]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_staggered_programs_differ_by_design():
    """With nonzero offsets the amortized program commits every worker at
    block boundaries (its snapshot, plus the tail carry) where the
    per-step path serializes the commits: different trajectories, the
    same descent, as in JAX."""
    runs = []
    for amortized in (True, False):
        _, _, pm, pe = _engines("downpour", 4, amortized)
        runs.append(_run_port(pm, pe, 16, 3)[0])
    am, ps = np.concatenate(runs[0]), np.concatenate(runs[1])
    assert np.max(np.abs(am - ps) / np.abs(ps)) > 1e-3
    assert float(np.mean(am[-8:])) < 1.0 and float(np.mean(ps[-8:])) < 1.0


def test_window_phase_restarts_amortized_and_carries_perstep():
    for amortized, t in ((True, 20), (False, 20)):
        _, _, pm, pe = _engines("downpour", 3, amortized)
        state = _run_port(pm, pe, 10, 2)[2]
        assert state["server"]["t"] == t
    # amortized: 4 blocks an epoch (3 + 3 + 3 + 1), twice
    _, _, pm, pe = _engines("downpour", 3, True)
    _run_port(pm, pe, 10, 2)
    assert pe.server_updates == 8


# -- which program runs -------------------------------------------------------------

def test_heterogeneous_windows_use_perstep_path():
    assert _engines("downpour", [2] * 4 + [4] * 4)[3].amortized is False


def test_amortized_forced_with_heterogeneous_windows_raises():
    with pytest.raises(ValueError, match="uniform window"):
        _engines("downpour", [2] * 4 + [4] * 4, amortized=True)


def test_uniform_window_defaults_to_amortized():
    assert _engines("downpour", 8)[3].amortized is True
    assert _engines("downpour", [8] * W)[3].amortized is True


def test_non_amortizable_algorithms_stay_per_step():
    for algo in ("dynsgd", "adag"):
        assert _engines(algo, 8)[3].amortized is False, algo
        with pytest.raises(ValueError, match="not amortizable"):
            _engines(algo, 8, amortized=True)


def test_auto_amortize_warns_only_with_stagger_offsets():
    with pytest.warns(UserWarning, match="auto-enabled with nonzero"):
        engine.DistributedEngine(
            None, None, get_optimizer("sgd"), engine.DownpourAlgo(), None,
            engine.EngineConfig(num_workers=W, window=4))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for algo in (engine.ElasticAlgo(synchronous=True),
                     engine.AveragingAlgo()):
            engine.DistributedEngine(None, None, get_optimizer("sgd"),
                                     algo, None,
                                     engine.EngineConfig(num_workers=W,
                                                         window=4))
        engine.DistributedEngine(
            None, None, get_optimizer("sgd"), engine.DownpourAlgo(), None,
            engine.EngineConfig(num_workers=W, window=4, amortized=True))


def test_window_length_must_match_workers():
    with pytest.raises(ValueError, match="length-8"):
        _engines("downpour", [2, 4])
