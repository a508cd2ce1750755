"""SPMD training in the port against the JAX package: the sharding
rules' spec trees, the sharded forward, ``SPMDTrainer`` (against JAX's
on the same mesh shape and against single-process SGD), global BatchNorm
moments, dropout under a sharded batch, expert parallelism, the sharded
and dense resumes, the mesh predictors and the sharded checkpoint
files in both directions.

The spec trees need no world: the rules read only the mesh's axis sizes
(``parallel.mesh.AbstractMesh``). The rest runs in one 4-rank gloo world
on the CPU (``parallel.launch.World``, started once for the module, each
rank on one torch thread); its ranks import this module to run the
``_rank_*`` functions, so JAX is imported only inside the tests, which
run JAX's side on the conftest's virtual CPU devices (``make_mesh_2d``
takes the first ``prod(shape)`` of them). Both packages build the same
weights from the same seed (the threefry initialisers). Every
comparison states its tolerance.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.models import Dense, Model, Sequential, zoo
from distkeras_tpu_torch.models.attention import TransformerBlock
from distkeras_tpu_torch.models.layers import Embedding, Flatten, Reshape
from distkeras_tpu_torch.models.moe import MoE
from distkeras_tpu_torch.parallel import SPMDTrainer, SingleTrainer
from distkeras_tpu_torch.parallel.launch import World
from distkeras_tpu_torch.parallel.mesh import (AbstractMesh, P,
                                               make_mesh_2d)
from distkeras_tpu_torch.parallel.sharding import (gather_params,
                                                   named_shardings,
                                                   param_specs,
                                                   shard_params)
from distkeras_tpu_torch.utils.tree import tree_leaves

N = 4
LOSS = "sparse_categorical_crossentropy_from_logits"
#: the sharded forward against the replicated one (JAX's own, :110)
FWD_TOL = 2e-5
#: per-step losses against single-process SGD (JAX's own, :166)
RTOL, ATOL = 1e-4, 1e-5
#: a training run against JAX's: float32 summation orders apart
MODEL_TOL = 1e-4


# --- the world ---------------------------------------------------------------

class _Worlds:
    """One 4-rank world for the module, restarted if a failure broke it."""

    def __init__(self):
        self.world = None

    def run(self, fn, *args, **kwargs):
        if self.world is None or self.world.broken:
            self.world = World(N, threads=1, timeout=120)
        return self.world.run(fn, *args, **kwargs)

    def close(self):
        if self.world is not None:
            self.world.close()


@pytest.fixture(scope="module")
def world():
    w = _Worlds()
    yield w
    w.close()


_MESHES = {}


def _mesh(shape):
    """This rank's mesh of the given axes (made once a process: its
    groups are made collectively)."""
    key = tuple(shape.items())
    if key not in _MESHES:
        _MESHES[key] = make_mesh_2d(dict(shape), device="cpu")
    return _MESHES[key]


def _jax_mesh(shape):
    from distkeras_tpu.parallel import make_mesh_2d as jax_mesh_2d
    return jax_mesh_2d(dict(shape))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b), initial=0.0)
                 / max(float(np.max(np.abs(b), initial=0.0)), 1e-30))


def _np_leaves(tree):
    """The leaves in ``jax.tree_util`` order (dict keys sorted)."""
    from distkeras_tpu_torch.models.core import sorted_leaves
    return [t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)
            for t in sorted_leaves(tree)]


# --- the models (each package's, from the same seed) --------------------------

def _tiny_lm(pkg, vocab=32, d=16, heads=4, blocks=2, moe=False,
             dropout=0.0, kv_heads=None):
    mods = _pkg(pkg)
    layers = [mods.Embedding(vocab, d)]
    for _ in range(blocks):
        layers.append(mods.TransformerBlock(
            num_heads=heads, mlp_ratio=2, causal=True,
            dropout_rate=dropout, num_kv_heads=kv_heads,
            mlp_layer=mods.MoE(num_experts=8, hidden_dim=32, top_k=2)
            if moe else None))
    layers.append(mods.Dense(vocab, use_bias=False))
    return mods.Sequential(layers)


class _Port:
    Dense, Sequential, Embedding, MoE = Dense, Sequential, Embedding, MoE
    TransformerBlock, Reshape, Flatten = TransformerBlock, Reshape, Flatten
    Model, zoo = Model, zoo


def _pkg(pkg):
    if pkg == "port":
        return _Port
    import distkeras_tpu.models as jm
    from distkeras_tpu.models.attention import TransformerBlock as JTB
    from distkeras_tpu.models.layers import (Embedding as JE,
                                             Flatten as JF, Reshape as JR)
    from distkeras_tpu.models.moe import MoE as JMoE

    class _Jax:
        Dense, Sequential, Model, zoo = jm.Dense, jm.Sequential, jm.Model, \
            jm.zoo
        Embedding, MoE, TransformerBlock = JE, JMoE, JTB
        Reshape, Flatten = JR, JF
    return _Jax


def _build(pkg, module, shape, seed):
    m = _pkg(pkg)
    if pkg == "port":
        return m.Model.build(module, shape, seed=seed, device="cpu")
    return m.Model.build(module, shape, seed=seed)


# --- spec trees (no world) -----------------------------------------------------

def _spec_cases():
    """(name, the function making the module, input shape, mesh shape,
    rule keywords)."""
    def mlp(pkg):
        m = _pkg(pkg)
        return m.Sequential([m.Dense(6), m.Dense(3)])

    def wide(pkg):
        m = _pkg(pkg)
        return m.Sequential([m.Dense(512), m.Dense(10)])

    def gqa(pkg):
        return _pkg(pkg).zoo.transformer_lm(16, d_model=32, num_heads=8,
                                            num_kv_heads=2, num_layers=1,
                                            mlp_ratio=2)

    def cnn(pkg):
        return _pkg(pkg).zoo.lenet5(num_classes=8)

    def lstm(pkg):
        return _pkg(pkg).zoo.bilstm_classifier(units=8, num_classes=4)

    def remat_lm(pkg):
        return _pkg(pkg).zoo.transformer_lm(32, d_model=32, num_heads=4,
                                            num_layers=2, mlp_ratio=2,
                                            remat="dots", max_len=8,
                                            use_rope=False)

    return {
        "megatron": (lambda pkg: _tiny_lm(pkg), (8,),
                     {"workers": 2, "tp": 4}, dict(tp_axis="tp")),
        "indivisible": (mlp, (5,), {"tp": 8}, dict(tp_axis="tp")),
        "moe_ep": (lambda pkg: _tiny_lm(pkg, moe=True), (8,),
                   {"ep": 4, "tp": 2}, dict(tp_axis="tp", ep_axis="ep")),
        "fsdp": (wide, (256,), {"workers": 8},
                 dict(tp_axis=None, fsdp_axis="workers")),
        "gqa": (gqa, (8,), {"workers": 2, "tp": 4}, dict(tp_axis="tp")),
        "conv": (cnn, (28, 28, 1), {"workers": 2, "tp": 2},
                 dict(tp_axis="tp")),
        "lstm": (lstm, (6, 5), {"tp": 2}, dict(tp_axis="tp")),
        "remat_positional_fsdp_tp": (remat_lm, (8,),
                                     {"workers": 2, "tp": 2},
                                     dict(tp_axis="tp",
                                          fsdp_axis="workers")),
    }


@pytest.mark.parametrize("case", list(_spec_cases()))
def test_torch_param_specs_match_jax(case):
    """``param_specs`` of the port equals JAX's leaf for leaf, with the
    same tree structure, for every case of ``tests/test_sharding_spmd.py``
    (:39-95, :321) and the remaining rules (Conv2D, LSTM, Remat,
    PositionalEmbedding, FSDP beside TP)."""
    import jax
    from distkeras_tpu.parallel import param_specs as jax_param_specs
    build, shape, mesh_shape, kw = _spec_cases()[case]
    jmod, pmod = build("jax"), build("port")
    jm = _build("jax", jmod, shape, 0)
    pm = _build("port", pmod, shape, 0)
    want = jax_param_specs(jmod, jm.params, _jax_mesh(mesh_shape), **kw)
    got = param_specs(pmod, pm.params, AbstractMesh(mesh_shape), **kw)
    from jax.sharding import PartitionSpec as JP
    jpairs = [(jax.tree_util.keystr(p), tuple(s)) for p, s in
              jax.tree_util.tree_flatten_with_path(
                  want, is_leaf=lambda x: isinstance(x, JP))[0]]
    ppairs = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + f"[{k!r}]")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + f"[{i}]")
        else:
            ppairs.append((path, tuple(t)))
    walk(got, "")
    # the same tree (keys, list lengths) and the same spec at every leaf
    assert ppairs == jpairs


def test_torch_moe_expert_unroll_warns_at_spec_time():
    """JAX :208: expert_unroll with an expert-sharded axis warns."""
    pmod = Sequential([Reshape((3, 4)),
                       MoE(num_experts=4, hidden_dim=8, top_k=2,
                           expert_unroll=True), Flatten(), Dense(3)])
    pm = Model.build(pmod, (12,), device="cpu")
    with pytest.warns(UserWarning, match="expert_unroll"):
        param_specs(pmod, pm.params, AbstractMesh({"ep": 2}),
                    ep_axis="ep")


def test_torch_spmd_trainer_constructor_errors(tmp_path):
    """JAX :68-85, :108-115 (the unknown data axis is JAX's :237 test),
    and the port's refusal of norm-based updates over split leaves."""
    model = Model.build(Sequential([Dense(4)]), (8,), device="cpu")
    mesh = AbstractMesh({"workers": 8})
    with pytest.raises(ValueError, match="data_axes"):
        SPMDTrainer(model, mesh=mesh, data_axes=("worker",), batch_size=8)
    with pytest.raises(ValueError, match="must divide evenly"):
        SPMDTrainer(model, mesh=mesh, batch_size=12)
    t = SPMDTrainer(model, mesh=mesh, batch_size=8,
                    checkpoint_dir=str(tmp_path), checkpoint_async=True)
    with pytest.raises(ValueError, match="checkpoint_async"):
        t._checkpoint_manager()
    # a norm-based update over split leaves is refused, not approximated;
    # with data parallelism alone it is exact and allowed
    tp = SPMDTrainer(model, mesh=AbstractMesh({"workers": 2, "tp": 2}),
                     batch_size=8, clip_grad_norm=1.0)
    with pytest.raises(ValueError, match="whole-leaf norms"):
        tp._check_norms(tp.param_partition_specs())
    dp = SPMDTrainer(model, mesh=mesh, batch_size=8,
                     worker_optimizer="lamb")
    dp._check_norms(dp.param_partition_specs())


# --- the collectives the sharded step adds ---------------------------------------

def _rank_collectives(x, c):
    from distkeras_tpu_torch.parallel import collectives as C
    mesh = _mesh({"workers": N})
    with mesh:
        i = C.axis_index("workers")
        xi = torch.from_numpy(x[i]).requires_grad_()
        y = C.reduce_scatter(xi, "workers", 1)
        (y * torch.from_numpy(c[i])).sum().backward()
        a = torch.from_numpy(x[i]).requires_grad_()
        f = C.replicate_in(a, "workers")
        (f * float(i + 1)).sum().backward()
        b = torch.from_numpy(x[i]).requires_grad_()
        g = C.reduce_out(b, "workers")
        (g * float(i + 1)).sum().backward()
    return {"y": y.detach().numpy(), "dx": xi.grad.numpy(),
            "f": f.detach().numpy(), "df": a.grad.numpy(),
            "g": g.detach().numpy(), "dg": b.grad.numpy()}


def test_torch_reduce_scatter_and_megatron_pair_match_jax(world):
    """``reduce_scatter`` against ``lax.psum_scatter(tiled=True)`` in
    JAX's ``shard_map`` on 4 virtual devices, forward and gradient
    (exact: sums of 4 float32 values in one order); Megatron's pair:
    ``replicate_in`` is the identity whose gradient sums the ranks',
    ``reduce_out`` the sum whose gradient is each rank's own."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as JP

    from distkeras_tpu.compat import shard_map
    rs = np.random.RandomState(0)
    x = rs.randn(N, 3, 8).astype(np.float32)
    c = rs.randn(N, 3, 2).astype(np.float32)
    res = world.run(_rank_collectives, x, c)
    jmesh = Mesh(np.array(jax.devices()[:N]), ("workers",))

    def loss(xs, cs):
        y = lax.psum_scatter(xs[0], "workers", scatter_dimension=1,
                             tiled=True)
        return (y * cs[0]).sum()[None], y[None]

    def fwd_grad(xs, cs):
        (l, y), g = jax.value_and_grad(
            lambda v: (lambda o: (o[0].sum(), o[1]))(loss(v, cs)),
            has_aux=True)(xs)
        return y, g

    y, dx = jax.jit(shard_map(fwd_grad, mesh=jmesh,
                              in_specs=(JP("workers"), JP("workers")),
                              out_specs=(JP("workers"), JP("workers"))))(
        jnp.asarray(x), jnp.asarray(c))
    total = x.sum(0)
    for i, r in enumerate(res):
        np.testing.assert_allclose(r["y"], np.asarray(y)[i], rtol=1e-6)
        np.testing.assert_allclose(r["dx"], np.asarray(dx)[i], rtol=1e-6)
        np.testing.assert_array_equal(r["f"], x[i])
        np.testing.assert_allclose(r["df"], np.full_like(x[i], 10.0))
        np.testing.assert_allclose(r["g"], total, rtol=1e-6)
        np.testing.assert_allclose(r["dg"], np.full_like(x[i], i + 1.0))


# --- the sharded forward and the predictors ------------------------------------

def _rank_forward(x, mesh_shape, kv_heads):
    from distkeras_tpu_torch.inference import Predictor, StreamingPredictor
    from distkeras_tpu_torch.parallel.sharding import (Placement,
                                                       gather_rows, placed,
                                                       use_params, use_plan)
    from distkeras_tpu_torch.utils.tree import tree_unflatten
    mesh = _mesh(mesh_shape)
    module = _tiny_lm("port", kv_heads=kv_heads)
    model = Model.build(module, (8,), seed=3, device="cpu")
    specs = param_specs(module, model.params, mesh, tp_axis="tp")
    local = shard_params(model.params, specs, mesh)
    placement = Placement(mesh, "tp", ("workers",))
    row, rows = placement.data_block()
    n = x.shape[0] // rows
    c = torch.from_numpy(np.random.RandomState(1).randn(
        x.shape[0], 8, 32).astype(np.float32))
    with placed(placement):
        plan = use_plan(module, specs, tree_leaves(local), placement)
        use = tree_unflatten(local, use_params(plan, tree_leaves(local)))
        y = gather_rows(module.apply(use, torch.from_numpy(
            x[row * n:(row + 1) * n])))
        grads = torch.autograd.grad((y * c).sum(), tree_leaves(local))
    whole_grads = gather_params(tree_unflatten(local, list(grads)), specs,
                                mesh)
    ref = module.apply(model.params, torch.from_numpy(x))
    ref_grads = torch.autograd.grad((ref * c).sum(),
                                    tree_leaves(model.params))
    whole = gather_params(local, specs, mesh)
    same = all(torch.equal(a, b) for a, b in
               zip(tree_leaves(whole), tree_leaves(model.params)))
    X = np.random.RandomState(0).randint(0, 32, (40, 8))
    ds = Dataset({"features": X})
    tp = Predictor(model, mesh=mesh, tp_axis="tp",
                   batch_size_per_device=8).predict(ds)["prediction"]
    stream = StreamingPredictor(model, batch_size=8, mesh=mesh,
                                tp_axis="tp")
    streamed = np.concatenate(list(stream.predict_stream(
        iter([X[:8], X[8:13]]))))
    return {"y": y.detach().numpy(), "same": same, "tp": tp,
            "stream": streamed,
            "grad_rel": max(_rel(a.numpy(), b.numpy()) for a, b in
                            zip(tree_leaves(whole_grads), ref_grads)),
            "local_shapes": [tuple(t.shape) for t in tree_leaves(local)]}


@pytest.mark.parametrize("kv_heads", [None, 1, 2],
                         ids=["mha", "gqa_kv_whole", "gqa_kv_split"])
def test_torch_sharded_forward_and_predictors_match(world, kv_heads):
    """The tp-sharded forward (batch over ``workers``, Megatron heads and
    hidden over ``tp``; grouped K/V heads split with the query heads, or
    kept whole where ``tp`` does not divide them) against the replicated
    one and JAX's (JAX :96, ``FWD_TOL``), and the gradient of every
    parameter, gathered, against one process's (``FWD_TOL``);
    ``gather_params`` returns the whole tree bitwise; the tp-sharded
    ``Predictor`` and ``StreamingPredictor`` against JAX's replicated
    predictions (JAX :273)."""
    import jax
    from distkeras_tpu.data import Dataset as JaxDataset
    from distkeras_tpu.inference import Predictor as JaxPredictor
    shape = {"workers": 2, "tp": 2}
    x = np.random.RandomState(0).randint(0, 32, (4, 8))
    jmod = _tiny_lm("jax", kv_heads=kv_heads)
    jm = _build("jax", jmod, (8,), 3)
    y_ref = np.asarray(jax.jit(lambda p, s, b: jmod.apply(
        p, s, b, training=False)[0])(jm.params, jm.state, x))
    res = world.run(_rank_forward, x, shape, kv_heads)
    X = np.random.RandomState(0).randint(0, 32, (40, 8))
    ref = JaxPredictor(jm, batch_size_per_device=8).predict(
        JaxDataset({"features": X}))["prediction"]
    for r in res:
        assert r["same"]
        assert _rel(r["y"], y_ref) <= FWD_TOL
        assert r["grad_rel"] <= FWD_TOL
        assert r["tp"].shape == (40, 8, 32)
        assert _rel(r["tp"], ref) <= FWD_TOL
        assert _rel(r["stream"], ref[:13]) <= FWD_TOL
    # each rank holds its query heads and hidden units (wq [d, H/tp, Dh])
    assert (16, 2, 4) in res[0]["local_shapes"]


# --- SPMDTrainer ---------------------------------------------------------------

def _data(seed, n, d, c, learnable=False):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, d).astype(np.float32)
    y = np.argmax(X @ rs.randn(d, c), axis=1) if learnable \
        else rs.randint(0, c, n)
    return X, y


def _mlp(pkg, c, act="tanh", hidden=32):
    m = _pkg(pkg)
    return m.Sequential([m.Dense(hidden, activation=act), m.Dense(c)])


def _rank_spmd_vs_single(mesh_shape, kw):
    X, y = _data(1, 512, 8, 3)
    ds = Dataset({"features": X, "label": y})
    mesh = _mesh(mesh_shape)
    m = Model.build(_mlp("port", 3), (8,), seed=7, device="cpu")
    spmd = SPMDTrainer(m, mesh=mesh, **kw)
    trained = spmd.train(ds)
    out = {"losses": spmd.get_history().losses(),
           "params": _np_leaves(trained.params)}
    if mesh.axis_index("workers") == 0 and mesh.axis_index("tp") == 0:
        single = SingleTrainer(Model.build(_mlp("port", 3), (8,), seed=7,
                                           device="cpu"),
                               **{k: v for k, v in kw.items()
                                  if k != "tp_axis"})
        single.train(ds)
        out["single"] = single.get_history().losses()
    return out


def test_torch_spmd_trainer_matches_jax_and_single_sgd(world):
    """dp x tp sharding does not change the math (JAX :141-167): the
    same data order, no shuffling, plain SGD; per-step losses within
    JAX's ``rtol=1e-4, atol=1e-5`` of a single-process run and of JAX's
    ``SPMDTrainer`` on the same mesh shape, equal on every rank, and the
    returned model within ``MODEL_TOL`` of JAX's."""
    from distkeras_tpu.data import Dataset as JaxDataset
    from distkeras_tpu.parallel import SPMDTrainer as JaxSPMD
    shape = {"workers": 2, "tp": 2}
    kw = dict(batch_size=64, num_epoch=2, worker_optimizer="sgd",
              optimizer_kwargs={"learning_rate": 0.05}, loss=LOSS,
              shuffle_each_epoch=False, tp_axis="tp")
    res = world.run(_rank_spmd_vs_single, shape, kw)
    X, y = _data(1, 512, 8, 3)
    jm = _build("jax", _mlp("jax", 3), (8,), 7)
    jt = JaxSPMD(jm, mesh=_jax_mesh(shape), **kw)
    jtrained = jt.train(JaxDataset({"features": X, "label": y}))
    import jax
    jparams = [np.asarray(a) for a in jax.tree_util.tree_leaves(
        jtrained.params)]
    for r in res:
        np.testing.assert_array_equal(r["losses"], res[0]["losses"])
        np.testing.assert_allclose(r["losses"], res[0]["single"],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(r["losses"], jt.get_history().losses(),
                                   rtol=RTOL, atol=ATOL)
        for a, b in zip(r["params"], jparams, strict=True):
            assert _rel(a, b) <= MODEL_TOL


def _rank_learns(mesh_shape, kw, case):
    from distkeras_tpu_torch.ops.metrics import accuracy
    mesh = _mesh(mesh_shape)
    if case == "dense":
        X, y = _data(0, 2048, 16, 4, learnable=True)
        m = Model.build(_mlp("port", 4, "relu", 64), (16,), seed=0,
                        device="cpu")
    else:
        X, y = _data(2, 1024, 12, 3, learnable=True)
        m = Model.build(Sequential([Reshape((3, 4)),
                                    MoE(num_experts=4, hidden_dim=16,
                                        top_k=2),
                                    Flatten(), Dense(3)]), (12,), seed=0,
                        device="cpu")
    trainer = SPMDTrainer(m, mesh=mesh, **kw)
    trained = trainer.train(Dataset({"features": X, "label": y}))
    acc = float(accuracy(torch.from_numpy(y),
                         torch.from_numpy(trained.predict(X))))
    return {"acc": acc, "losses": trainer.get_history().losses()}


@pytest.mark.parametrize("case", ["dense", "moe"])
def test_torch_spmd_trainer_learns_over_tp_and_ep(world, case):
    """JAX :117 (dp x tp, momentum: accuracy > 0.85 and the loss falls
    by 30%) and :170 (an MoE over dp x ep, adam: accuracy > 0.8, and the
    first epoch's losses within ``MODEL_TOL`` of JAX's on the same mesh
    shape: expert weights gathered for the step equal GSPMD's dense
    dispatch)."""
    if case == "dense":
        shape = {"workers": 2, "tp": 2}
        kw = dict(tp_axis="tp", batch_size=128, num_epoch=6,
                  worker_optimizer="momentum",
                  optimizer_kwargs={"learning_rate": 0.1}, loss=LOSS)
        res = world.run(_rank_learns, shape, kw, case)
        for r in res:
            assert r["acc"] > 0.85, r["acc"]
            losses = r["losses"]
            assert np.isfinite(losses).all()
            assert losses[-8:].mean() < losses[:8].mean() * 0.7
        return
    shape = {"workers": 2, "ep": 2}
    kw = dict(tp_axis="tp", ep_axis="ep", batch_size=128, num_epoch=8,
              worker_optimizer="adam",
              optimizer_kwargs={"learning_rate": 0.01}, loss=LOSS)
    res = world.run(_rank_learns, shape, kw, case)
    from distkeras_tpu.data import Dataset as JaxDataset
    from distkeras_tpu.parallel import SPMDTrainer as JaxSPMD
    jmods = _pkg("jax")
    X, y = _data(2, 1024, 12, 3, learnable=True)
    jm = _build("jax", jmods.Sequential([
        jmods.Reshape((3, 4)),
        jmods.MoE(num_experts=4, hidden_dim=16, top_k=2),
        jmods.Flatten(), jmods.Dense(3)]), (12,), 0)
    jt = JaxSPMD(jm, mesh=_jax_mesh(shape), **dict(kw, num_epoch=1))
    jt.train(JaxDataset({"features": X, "label": y}))
    steps = 1024 // 128
    for r in res:
        assert r["acc"] > 0.8, r["acc"]
        assert _rel(r["losses"][:steps], jt.get_history().losses()) \
            <= MODEL_TOL


def _rank_lm(mesh_shape, kw, toks):
    mesh = _mesh(mesh_shape)
    m = Model.build(_tiny_lm("port", dropout=0.1), (8,), seed=5,
                    device="cpu")
    t = SPMDTrainer(m, mesh=mesh, **kw)
    trained = t.train(Dataset({"features": toks[:, :-1],
                               "label": toks[:, 1:]}))
    return {"losses": t.get_history().losses(),
            "params": _np_leaves(trained.params)}


def test_torch_spmd_lm_with_dropout_matches_jax(world):
    """A transformer LM with dropout under dp x tp against JAX's
    ``SPMDTrainer`` on the same mesh shape (adam, two epochs): each
    rank's dropout mask is its rows of the global mask, so the per-step
    losses and the trained weights agree within ``MODEL_TOL``."""
    from distkeras_tpu.data import Dataset as JaxDataset
    from distkeras_tpu.parallel import SPMDTrainer as JaxSPMD
    shape = {"workers": 2, "tp": 2}
    toks = np.random.RandomState(6).randint(0, 32, (64, 9))
    kw = dict(tp_axis="tp", batch_size=16, num_epoch=2,
              worker_optimizer="adam",
              optimizer_kwargs={"learning_rate": 3e-3}, loss=LOSS)
    res = world.run(_rank_lm, shape, kw, toks)
    jm = _build("jax", _tiny_lm("jax", dropout=0.1), (8,), 5)
    jt = JaxSPMD(jm, mesh=_jax_mesh(shape), **kw)
    jtrained = jt.train(JaxDataset({"features": toks[:, :-1],
                                    "label": toks[:, 1:]}))
    import jax
    jparams = [np.asarray(a) for a in jax.tree_util.tree_leaves(
        jtrained.params)]
    for r in res:
        assert _rel(r["losses"], jt.get_history().losses()) <= MODEL_TOL
        for a, b in zip(r["params"], jparams, strict=True):
            assert _rel(a, b) <= MODEL_TOL


def _rank_fused(kw, toks):
    mesh = _mesh({"workers": 2, "tp": 2})
    out = []
    for fused in (False, True):
        m = Model.build(_tiny_lm("port"), (8,), seed=5, device="cpu")
        t = SPMDTrainer(m, mesh=mesh, fused_vocab_head=fused, **kw)
        t.train(Dataset({"features": toks[:, :-1], "label": toks[:, 1:]}))
        out.append(t.get_history().losses())
    return out


def test_torch_spmd_fused_vocab_head_matches_unfused(world):
    """``fused_vocab_head=True`` under dp x tp (the trunk's rows gathered,
    the head's split kernel gathered, the chunked loss on the global
    batch) against the same run unfused: per-step losses within
    ``MODEL_TOL`` (float32, chunked against whole sums)."""
    toks = np.random.RandomState(7).randint(0, 32, (32, 9))
    kw = dict(tp_axis="tp", batch_size=16, num_epoch=1,
              worker_optimizer="adam",
              optimizer_kwargs={"learning_rate": 3e-3},
              loss=LOSS, shuffle_each_epoch=False)
    for plain, fused in world.run(_rank_fused, kw, toks):
        assert _rel(fused, plain) <= MODEL_TOL


def _rank_fsdp(kw):
    X, y = _data(8, 256, 256, 10)
    ds = Dataset({"features": X, "label": y})
    mesh = _mesh({"workers": N})
    m = Model.build(_mlp("port", 10, "relu", 512), (256,), seed=1,
                    device="cpu")
    t = SPMDTrainer(m, mesh=mesh, **kw)
    specs = t.param_partition_specs()
    t.train(ds)
    out = {"losses": t.get_history().losses(),
           "kernel_spec": tuple(specs[0]["kernel"])}
    if mesh.axis_index("workers") == 0:
        s = SingleTrainer(Model.build(_mlp("port", 10, "relu", 512),
                                      (256,), seed=1, device="cpu"),
                          **{k: v for k, v in kw.items()
                             if k not in ("tp_axis", "fsdp_axis")})
        s.train(ds)
        out["single"] = s.get_history().losses()
    return out


def test_torch_spmd_trainer_fsdp_matches_single(world):
    """ZeRO/FSDP over ``workers``: the 256x512 kernel is split over the
    data axis (gathered for the step, its gradient reduce-scattered);
    per-step losses within JAX's ``rtol=1e-4, atol=1e-5`` of a
    single-process run."""
    kw = dict(tp_axis=None, fsdp_axis="workers", batch_size=64,
              num_epoch=2, worker_optimizer="adam",
              optimizer_kwargs={"learning_rate": 1e-3}, loss=LOSS,
              shuffle_each_epoch=False)
    res = world.run(_rank_fsdp, kw)
    assert "workers" in res[0]["kernel_spec"]
    for r in res:
        np.testing.assert_allclose(r["losses"], res[0]["single"],
                                   rtol=RTOL, atol=ATOL)


def _rank_resnet(kw, X, y):
    mesh = _mesh({"workers": N})
    m = Model.build(zoo.resnet18_thin(num_classes=4), (16, 16, 3), seed=0,
                    device="cpu")
    t = SPMDTrainer(m, mesh=mesh, **kw)
    trained = t.train(Dataset({"features": X, "label": y}))
    return {"losses": t.get_history().losses(),
            "acc": t.get_history().metric("accuracy"),
            "params": _np_leaves(trained.params),
            "state": _np_leaves(trained.state)}


def _ghost_bn(pkg):
    m = _pkg(pkg)
    if pkg == "port":
        from distkeras_tpu_torch.models.layers import BatchNorm
    else:
        from distkeras_tpu.models.layers import BatchNorm
    # no bias before the norm: its true gradient is zero, so it holds
    # float noise that no relative tolerance can compare
    return m.Sequential([m.Dense(8, use_bias=False),
                         BatchNorm(virtual_batch_size=4), m.Dense(3)])


def _rank_ghost(kw, X, y):
    mesh = _mesh({"workers": N})
    m = Model.build(_ghost_bn("port"), (6,), seed=0, device="cpu")
    t = SPMDTrainer(m, mesh=mesh, **kw)
    trained = t.train(Dataset({"features": X, "label": y}))
    return {"losses": t.get_history().losses(),
            "params": _np_leaves(trained.params),
            "state": _np_leaves(trained.state)}


def test_torch_spmd_ghost_batchnorm_matches_jax(world):
    """Ghost BatchNorm (``virtual_batch_size=4``) under ``{"workers":
    4}``: each rank's groups normalize by their own moments, and the
    running statistics move by the mean over every rank's groups; losses,
    parameters and state within ``MODEL_TOL`` of JAX's ``SPMDTrainer``."""
    from distkeras_tpu.data import Dataset as JaxDataset
    from distkeras_tpu.parallel import SPMDTrainer as JaxSPMD
    X, y = _data(9, 128, 6, 3)
    kw = dict(batch_size=32, num_epoch=2, worker_optimizer="sgd",
              optimizer_kwargs={"learning_rate": 0.1}, loss=LOSS,
              tp_axis=None)
    res = world.run(_rank_ghost, kw, X, y)
    jm = _build("jax", _ghost_bn("jax"), (6,), 0)
    jt = JaxSPMD(jm, mesh=_jax_mesh({"workers": N}), **kw)
    jtrained = jt.train(JaxDataset({"features": X, "label": y}))
    import jax
    for r in res:
        assert _rel(r["losses"], jt.get_history().losses()) <= MODEL_TOL
        for a, b in zip(r["params"] + r["state"],
                        jax.tree_util.tree_leaves(jtrained.params)
                        + [s for s in jax.tree_util.tree_leaves(
                            jtrained.state) if np.ndim(s)], strict=True):
            assert _rel(a, b) <= MODEL_TOL


def test_torch_spmd_resnet_global_batchnorm_matches_jax(world):
    """``resnet18_thin`` under ``{"workers": 4}``: BatchNorm's moments and
    its backward's two sums are the global batch's, as GSPMD's are; two
    SGD steps' losses and accuracies, the parameters and the running
    statistics within ``MODEL_TOL`` of JAX's ``SPMDTrainer`` on four
    virtual devices."""
    from distkeras_tpu.data import Dataset as JaxDataset
    from distkeras_tpu.models import Model as JaxModel
    from distkeras_tpu.models import zoo as jax_zoo
    from distkeras_tpu.parallel import SPMDTrainer as JaxSPMD
    rs = np.random.RandomState(0)
    X = rs.randn(32, 16, 16, 3).astype(np.float32)
    y = rs.randint(0, 4, 32)
    kw = dict(batch_size=16, num_epoch=1, worker_optimizer="sgd",
              optimizer_kwargs={"learning_rate": 0.05}, loss=LOSS,
              metrics=["accuracy"], tp_axis=None)
    res = world.run(_rank_resnet, kw, X, y)
    jm = JaxModel.build(jax_zoo.resnet18_thin(num_classes=4), (16, 16, 3),
                        seed=0)
    jt = JaxSPMD(jm, mesh=_jax_mesh({"workers": N}), **kw)
    jtrained = jt.train(JaxDataset({"features": X, "label": y}))
    import jax
    for r in res:
        assert _rel(r["losses"], jt.get_history().losses()) <= MODEL_TOL
        np.testing.assert_array_equal(r["acc"],
                                      jt.get_history().metric("accuracy"))
        for a, b in zip(r["params"], jax.tree_util.tree_leaves(
                jtrained.params), strict=True):
            assert _rel(a, b) <= MODEL_TOL
        jstate = [s for s in jax.tree_util.tree_leaves(jtrained.state)
                  if np.ndim(s)]
        for a, b in zip(r["state"], jstate, strict=True):
            assert _rel(a, b) <= MODEL_TOL


# --- resumes and checkpoint files ------------------------------------------------

def _rank_resume(cdir, kw):
    X, y = _data(3, 512, 8, 3)
    ds = Dataset({"features": X, "label": y})
    mesh = _mesh({"workers": 2, "tp": 2})

    def fresh():
        return Model.build(_mlp("port", 3, "relu"), (8,), seed=5,
                           device="cpu")

    ref = SPMDTrainer(fresh(), mesh=mesh, num_epoch=4, **kw)
    ref.train(ds)
    part = SPMDTrainer(fresh(), mesh=mesh, num_epoch=2,
                       checkpoint_dir=cdir, **kw)
    part.train(ds)
    resumed = SPMDTrainer(fresh(), mesh=mesh, num_epoch=4,
                          checkpoint_dir=cdir, resume=True, **kw)
    m2 = resumed.train(ds)
    return {"ref": ref.get_history().losses(),
            "resumed": resumed.get_history().losses(),
            "ref_params": _np_leaves(ref.master_model.params),
            "params": _np_leaves(m2.params),
            "files": sorted(os.listdir(os.path.join(cdir, "step_1")))}


@pytest.mark.parametrize("sharded", [True, False], ids=["sharded", "dense"])
def test_torch_spmd_trainer_resume_bitwise(world, tmp_path, sharded):
    """Full-carry checkpoints (JAX :200): interrupted and resumed equals
    uninterrupted, bitwise: the losses of the resumed epochs and the
    final parameters, from a sharded checkpoint (one ``arrays_p<rank>``
    file a rank) and from a dense one (``sharded_checkpoints=False``)."""
    kw = dict(tp_axis="tp", batch_size=64, worker_optimizer="adam",
              optimizer_kwargs={"learning_rate": 0.01}, loss=LOSS,
              sharded_checkpoints=sharded)
    res = world.run(_rank_resume, str(tmp_path / "ckpt"), kw)
    r = res[0]
    steps = 512 // 64
    np.testing.assert_array_equal(r["ref"][-2 * steps:], r["resumed"])
    for a, b in zip(r["ref_params"], r["params"], strict=True):
        np.testing.assert_array_equal(a, b)
    if sharded:
        assert r["files"] == ["arrays_p0.npz", "arrays_p1.npz",
                              "arrays_p2.npz", "arrays_p3.npz",
                              "manifest.json"]
    else:
        assert r["files"] == ["arrays.npz", "manifest.json"]


def _rank_old_format(cdir):
    X, y = _data(4, 256, 8, 3)
    mesh = _mesh({"workers": 2, "tp": 2})
    model = Model.build(_mlp("port", 3, "relu", 16), (8,), seed=0,
                        device="cpu")
    trainer = SPMDTrainer(
        model, mesh=mesh, tp_axis="tp", batch_size=64, num_epoch=3,
        checkpoint_dir=cdir, resume=True, worker_optimizer="adam",
        optimizer_kwargs={"learning_rate": 0.01}, loss=LOSS)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        trainer.train(Dataset({"features": X, "label": y}))
    return {"warned": any("full-carry" in str(w.message) for w in caught),
            "steps": int(trainer.get_history().losses().shape[0])}


def test_torch_spmd_trainer_resumes_params_only_checkpoint(world, tmp_path):
    """A checkpoint written before the full-carry format (params and
    state only, by JAX's dense manager) restores with JAX's warning and
    fresh moments (JAX :244): resumed at epoch 1, two epochs trained."""
    from distkeras_tpu.utils.checkpoint import CheckpointManager
    jm = _build("jax", _mlp("jax", 3, "relu", 16), (8,), 0)
    cdir = str(tmp_path / "old")
    CheckpointManager(cdir).save(
        0, {"params": jm.params, "state": jm.state},
        metadata={"epoch": 0})
    for r in world.run(_rank_old_format, cdir):
        assert r["warned"]
        assert r["steps"] == 2 * (256 // 64)


def _ckpt_tree(seed):
    rs = np.random.RandomState(seed)
    return {"a": rs.randn(8, 4).astype(np.float32),
            "b": {"c": rs.randn(4, 6).astype(np.float32),
                  "d": rs.randn(3).astype(np.float32)},
            "n": np.arange(2, dtype=np.uint32)}


def _ckpt_specs():
    return {"a": P("workers", "tp"), "b": {"c": P(None, "tp"), "d": P()},
            "n": P()}


def _rank_checkpoints(cdir_jax, cdir_port):
    from distkeras_tpu_torch.parallel.sharding import map_specs
    from distkeras_tpu_torch.utils.checkpoint import \
        ShardedCheckpointManager
    mesh = _mesh({"workers": 2, "tp": 2})
    other = _mesh({"workers": N})
    full = _ckpt_tree(0)
    specs = _ckpt_specs()
    # read JAX's step on this mesh and on a mesh of another shape
    got = ShardedCheckpointManager(cdir_jax).restore_sharded(
        named_shardings(specs, mesh))
    want = map_specs(lambda s, x: np.ascontiguousarray(
        x[tuple(slice(lo, hi) for lo, hi in _ranges(s, mesh, x.shape))]),
        specs, full)
    other_specs = {"a": P(None, "workers"), "b": {"c": P("workers"),
                                                  "d": P()}, "n": P()}
    got_other = ShardedCheckpointManager(cdir_jax).restore_sharded(
        named_shardings(other_specs, other))
    want_other = map_specs(lambda s, x: np.ascontiguousarray(
        x[tuple(slice(lo, hi) for lo, hi in _ranges(s, other, x.shape))]),
        other_specs, full)
    ok = all(np.array_equal(a, b) for a, b in
             zip(tree_leaves(got), tree_leaves(want))) and all(
        np.array_equal(a, b) for a, b in
        zip(tree_leaves(got_other), tree_leaves(want_other)))
    # write a step of the port's: each rank its blocks of tree 1
    mine = map_specs(lambda s, x: torch.from_numpy(np.ascontiguousarray(
        x[tuple(slice(lo, hi) for lo, hi in _ranges(s, mesh, x.shape))])),
        specs, _ckpt_tree(1))
    ShardedCheckpointManager(cdir_port).save(
        3, mine, metadata={"epoch": 3},
        shardings=named_shardings(specs, mesh))
    return ok


def _ranges(spec, mesh, shape):
    from distkeras_tpu_torch.parallel.sharding import block_ranges
    return block_ranges(spec, mesh, shape)


def test_torch_sharded_checkpoints_cross_both_ways(world, tmp_path):
    """JAX's ``ShardedCheckpointManager`` writes a step from a dp x tp
    mesh of virtual devices; each rank of the port's world restores its
    blocks on the same mesh shape and on a mesh of another shape
    (stitched), bitwise. The port's world writes a step (one file a
    rank, rank 0's manifest); JAX restores it on its mesh and whole,
    bitwise."""
    import jax
    from jax.sharding import NamedSharding as JNS
    from jax.sharding import PartitionSpec as JP
    from distkeras_tpu.utils.checkpoint import \
        ShardedCheckpointManager as JaxManager
    jmesh = _jax_mesh({"workers": 2, "tp": 2})
    jspecs = {"a": JP("workers", "tp"), "b": {"c": JP(None, "tp"),
                                              "d": JP()}, "n": JP()}
    jsh = jax.tree_util.tree_map(lambda s: JNS(jmesh, s), jspecs,
                                 is_leaf=lambda x: isinstance(x, JP))
    placed = jax.tree_util.tree_map(jax.device_put, _ckpt_tree(0), jsh)
    cdir_jax, cdir_port = str(tmp_path / "jax"), str(tmp_path / "port")
    JaxManager(cdir_jax).save(2, placed, metadata={"epoch": 2})
    assert all(world.run(_rank_checkpoints, cdir_jax, cdir_port))
    jmgr = JaxManager(cdir_port)
    assert jmgr.latest_step() == 3 and jmgr.metadata() == {"epoch": 3}
    want = _ckpt_tree(1)
    whole = jmgr.restore(want)
    back = jmgr.restore_sharded(jsh)
    for a, b, c in zip(jax.tree_util.tree_leaves(whole),
                       jax.tree_util.tree_leaves(back),
                       jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(np.asarray(b), c)
