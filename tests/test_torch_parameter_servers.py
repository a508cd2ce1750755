"""The port's host parameter-server path against the JAX package: the
framed networking, the parameter servers' update rules (bit for bit on
one commit sequence) and ``HostAsyncTrainer`` (one worker: JAX's
losses and center within 1e-4; several: convergence, as JAX's own
tests hold it).
"""

import threading

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.data import Dataset as JaxDataset
from distkeras_tpu.models import Dense as JaxDense
from distkeras_tpu.models import Model as JaxModel
from distkeras_tpu.models import Sequential as JaxSequential
import distkeras_tpu.parallel as jax_parallel
from distkeras_tpu.parallel import networking as jax_networking

from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.models import (Model, Sequential, from_jax_params,
                                        to_jax_params)
from distkeras_tpu_torch.models.layers import Dense
from distkeras_tpu_torch import parallel
from distkeras_tpu_torch.parallel import networking
from distkeras_tpu_torch.parallel import parameter_servers as ps_mod

LOSS = "sparse_categorical_crossentropy_from_logits"
REL_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_intraop_thread():
    """The tensors here are tiny: one intra-op thread runs them faster
    than a pool that contends with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# networking: framing
# ---------------------------------------------------------------------------

def _echo_server():
    server = networking.MessageServer(lambda msg: msg, host="127.0.0.1")
    server.start()
    return server


def test_framed_roundtrip_pickle_and_npy():
    server = _echo_server()
    try:
        sock = networking.connect("127.0.0.1", server.port)
        obj = {"action": "commit", "delta": [1, 2, 3], "s": "x"}
        assert networking.request(sock, obj) == obj
        arr = np.arange(12, dtype=np.float32).reshape(3, 4)
        out = networking.request(sock, arr)
        np.testing.assert_array_equal(out, arr)
        assert out.dtype == arr.dtype
        sock.close()
    finally:
        server.stop()


@pytest.mark.parametrize("obj", [
    {"action": "pull"}, np.arange(6, dtype=np.float32).reshape(2, 3),
    [np.ones(3, np.float32), 7]], ids=["pickle", "npy", "mixed"])
def test_frames_are_the_jax_packages_bytes(obj):
    """The header (magic, format tag, length) and payload are JAX's, so
    a port client can talk to a JAX server and back."""
    assert networking._encode(obj) == jax_networking._encode(obj)
    assert networking.MAGIC == jax_networking.MAGIC
    server = jax_networking.MessageServer(lambda msg: msg).start()
    try:
        sock = networking.connect("127.0.0.1", server.port)
        back = networking.request(sock, obj)
        sock.close()
    finally:
        server.stop()
    assert networking._encode(back) == networking._encode(obj)


def test_frame_rejects_bad_magic():
    server = _echo_server()
    try:
        sock = networking.connect("127.0.0.1", server.port)
        sock.sendall(b"JUNKJUNKJUNKJUNK")
        # the server drops that connection; a new one still works
        sock2 = networking.connect("127.0.0.1", server.port)
        assert networking.request(sock2, {"ok": 1}) == {"ok": 1}
        sock.close()
        sock2.close()
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# parameter servers: update rules, bit for bit against JAX's
# ---------------------------------------------------------------------------

def _center():
    # keys in sorted order: JAX's tree_flatten sorts them, the port keeps
    # insertion order, so both list the leaves [b, w]
    rs = np.random.RandomState(0)
    return {"b": rs.randn(3).astype(np.float32),
            "w": rs.randn(3, 2).astype(np.float32)}


@pytest.mark.parametrize("cls,kw", [
    ("DeltaParameterServer", {}),
    ("ADAGParameterServer", dict(learning_rate=0.1, epsilon=1e-8)),
    ("DynSGDParameterServer", {}),
    ("EASGDParameterServer", {}),
])
def test_ps_rule_equals_jax_bitwise(cls, kw):
    jps = getattr(jax_parallel, cls)(_center(), **kw)
    pps = getattr(ps_mod, cls)(_center(), **kw)
    rs = np.random.RandomState(1)
    for i in range(40):
        delta = [rs.randn(3).astype(np.float32),
                 rs.randn(3, 2).astype(np.float32)]
        clock = int(rs.randint(0, i + 1))  # a stale pull, DynSGD's case
        for ps in (jps, pps):
            ps.handle_commit({"delta": [d.copy() for d in delta],
                              "clock": clock})
    jm, pm = jps.get_model(), pps.get_model()
    assert jps.num_updates == pps.num_updates == 40
    for key in ("b", "w"):
        np.testing.assert_array_equal(pm[key], np.asarray(jm[key]))
    jl, jc = jps.handle_pull()
    pl, pc = pps.handle_pull()
    assert jc == pc
    for a, b in zip(jl, pl):
        np.testing.assert_array_equal(a, b)


def test_ps_takes_a_tree_of_tensors():
    pm = Model.build(Sequential([Dense(4), Dense(2)]), (3,), seed=0,
                     device="cpu")
    ps = parallel.DeltaParameterServer(pm.params)
    leaves, clock = ps.handle_pull()
    assert clock == 0 and all(isinstance(l, np.ndarray) for l in leaves)
    ps.handle_commit({"delta": [np.ones_like(l) for l in leaves]})
    got = ps.get_model()
    np.testing.assert_array_equal(got[0]["kernel"],
                                  pm.params[0]["kernel"].detach().numpy() + 1)


def test_ps_socket_transport_matches_inprocess():
    ps = parallel.DeltaParameterServer(_center())
    port = ps.start(host="127.0.0.1")
    client = parallel.PSClient(host="127.0.0.1", port=port)
    leaves, clock = client.pull()
    np.testing.assert_array_equal(leaves[1], _center()["w"])
    client.commit([np.zeros((3,), np.float32),
                   np.ones((3, 2), np.float32)])
    leaves2, clock2 = client.pull()
    np.testing.assert_array_equal(leaves2[1], _center()["w"] + 1)
    assert clock2 == 1
    client.close()
    ps.stop()


def test_ps_concurrent_commits_all_land():
    ps = parallel.DeltaParameterServer({"w": np.zeros((), np.float64)})
    n_threads, n_commits = 8, 25

    def worker():
        c = parallel.PSClient(ps=ps)
        for _ in range(n_commits):
            c.commit([np.asarray(1.0)])

    ts = [threading.Thread(target=worker) for _ in range(n_threads)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert ps.num_updates == n_threads * n_commits
    assert float(ps.get_model()["w"]) == n_threads * n_commits


def test_ps_socket_stress_interleaved_pull_commit():
    """Socket clients interleave pulls and distinct commits; the mutex
    serializes them, so the final center is the exact sum and no pull
    sees a torn value."""
    ps = parallel.DeltaParameterServer({"w": np.zeros((32,), np.float64)})
    port = ps.start(host="127.0.0.1")
    n_threads, n_commits = 8, 30
    torn = []

    def worker(widx):
        c = parallel.PSClient(host="127.0.0.1", port=port)
        try:
            for i in range(n_commits):
                c.commit([np.full((32,), float(widx * n_commits + i))])
                pulled, _ = c.pull()
                if not np.allclose(pulled[0], pulled[0][0]):
                    torn.append(pulled[0])
        finally:
            c.close()

    ts = [threading.Thread(target=worker, args=(i,))
          for i in range(n_threads)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    ps.stop()
    assert not torn
    assert ps.num_updates == n_threads * n_commits
    total = sum(float(w * n_commits + i)
                for w in range(n_threads) for i in range(n_commits))
    np.testing.assert_array_equal(ps.get_model()["w"], np.full((32,), total))


def test_ps_socket_handler_error_propagates():
    ps = parallel.DeltaParameterServer({"w": np.zeros((), np.float32)})
    port = ps.start()
    client = parallel.PSClient(host="127.0.0.1", port=port)
    with pytest.raises(RuntimeError, match="parameter server error"):
        client._checked(networking.request(client._sock,
                                           {"action": "commit"}))
    client.close()
    ps.stop()


def test_client_needs_exactly_one_transport():
    with pytest.raises(ValueError, match="exactly one"):
        parallel.PSClient()


# ---------------------------------------------------------------------------
# HostAsyncTrainer
# ---------------------------------------------------------------------------

def _problem(n=512, d=10, c=3, seed=0):
    rs = np.random.RandomState(seed)
    w = rs.randn(d, c)
    X = rs.randn(n, d).astype(np.float32)
    return X, (X @ w).argmax(-1)


def _models(hidden=32, d=10, c=3):
    jm = JaxModel.build(JaxSequential([JaxDense(hidden, activation="relu"),
                                       JaxDense(c)]), (d,), seed=1)
    pm = Model.build(Sequential([Dense(hidden, activation="relu"),
                                 Dense(c)]), (d,), seed=1, device="cpu")
    return jm, from_jax_params(pm, jax.device_get(jm.params))


def _accuracy(model, X, Y):
    with torch.no_grad():
        out = model.module.apply(model.params, torch.from_numpy(X))
    return float((out.argmax(-1).numpy() == Y).mean())


@pytest.mark.parametrize("algorithm", ["downpour", "easgd", "dynsgd",
                                       "adag"])
def test_one_worker_matches_jax(algorithm):
    """One worker races nobody: JAX's and the port's runs are the same
    sequence of steps, pulls and commits, so losses and the center agree
    within float32 summation order."""
    X, Y = _problem()
    jm, pm = _models()
    kw = dict(algorithm=algorithm, num_workers=1, batch_size=32,
              communication_window=3, num_epoch=2, worker_optimizer="adam",
              learning_rate=0.01, loss=LOSS, metrics=["accuracy"])
    jt = jax_parallel.HostAsyncTrainer(jm, **kw)
    jr = jt.train(JaxDataset({"features": X, "label": Y}))
    pt = parallel.HostAsyncTrainer(pm, **kw)
    pr = pt.train(Dataset({"features": X, "label": Y}))
    assert jt.parameter_server.num_updates == pt.parameter_server.num_updates
    for je, pe in zip(jt.history.epochs, pt.history.epochs):
        assert set(je) == set(pe)
        for key in je:
            np.testing.assert_allclose(pe[key], je[key], rtol=REL_TOL)
    ref = jax.tree_util.tree_leaves(jax.device_get(jr.params))
    got = jax.tree_util.tree_leaves(to_jax_params(pr))
    for r, g in zip(ref, got):
        assert np.max(np.abs(r - g)) <= REL_TOL * np.max(np.abs(r))


@pytest.mark.parametrize("algorithm,kw", [
    ("downpour", dict(num_workers=4, batch_size=16, communication_window=4,
                      num_epoch=4)),
    ("easgd", dict(num_workers=4, batch_size=16, communication_window=4,
                   num_epoch=10)),
    ("dynsgd", dict(num_workers=4, batch_size=16,
                    communication_window=[1, 2, 4, 8], num_epoch=3)),
    ("adag", dict(num_workers=4, batch_size=16, communication_window=4,
                  num_epoch=4)),
    # window 8 > 4 steps an epoch: progress lands by the epoch's flush
    ("downpour", dict(num_workers=4, batch_size=32, communication_window=8,
                      num_epoch=4)),
    ("downpour", dict(num_workers=2, batch_size=32, communication_window=2,
                      num_epoch=3, transport="socket")),
], ids=["downpour", "easgd", "dynsgd_heterogeneous", "adag",
        "window_past_epoch", "socket"])
def test_several_workers_converge(algorithm, kw):
    X, Y = _problem(seed=3)
    _, pm = _models(hidden=16)
    tr = parallel.HostAsyncTrainer(
        pm, algorithm=algorithm, worker_optimizer="sgd",
        optimizer_kwargs={"learning_rate": 0.1}, loss=LOSS, **kw)
    trained = tr.train(Dataset({"features": X, "label": Y}))
    losses = tr.get_history().losses()
    assert losses.shape[1] == kw["num_workers"]
    assert np.isfinite(losses).all()
    assert tr.parameter_server.num_updates > 0
    assert _accuracy(trained, X, Y) > 0.6, algorithm


def test_host_async_validation_evaluates_the_center():
    X, Y = _problem()
    _, pm = _models()
    tr = parallel.HostAsyncTrainer(
        pm, num_workers=2, batch_size=32, communication_window=2,
        num_epoch=2, worker_optimizer="sgd", learning_rate=0.1, loss=LOSS,
        validation_data=(X[:128], Y[:128]))
    tr.train(Dataset({"features": X, "label": Y}))
    assert all("val_loss" in e for e in tr.history.epochs)


def test_host_async_rejects_unknown_options():
    _, pm = _models()
    with pytest.raises(ValueError, match="algorithm"):
        parallel.HostAsyncTrainer(pm, algorithm="sparkle")
    with pytest.raises(ValueError, match="transport"):
        parallel.HostAsyncTrainer(pm, transport="carrier-pigeon")
    with pytest.raises(ValueError, match="communication_window"):
        parallel.HostAsyncTrainer(pm, num_workers=3, loss=LOSS,
                                  communication_window=[1, 2]).train(
            Dataset({"features": np.zeros((96, 10), np.float32),
                     "label": np.zeros(96, np.int64)}))


def test_host_async_worker_failure_surfaces():
    X, Y = _problem()
    _, pm = _models()
    tr = parallel.HostAsyncTrainer(pm, num_workers=2, batch_size=32,
                                   loss=LOSS)
    # float labels of the wrong shape fail inside the worker threads
    with pytest.raises(RuntimeError):
        tr.train(Dataset({"features": X, "label": np.zeros((len(X), 7))}))
    assert tr.parameter_server._server is None  # stopped on the way out
