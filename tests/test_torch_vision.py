"""The port's image and tabular models against the JAX package: the
layers (convolutions, pools, reshaping, BatchNorm with its state,
GroupNorm), ``bn_train_apply``'s backward, the zoo's BASELINE models
(``mlp``, ``lenet5``, ``resnet18_thin``, ``wide_and_deep``, ResNet-50's
tree) and their training with model state: ``SingleTrainer`` (with
gradient accumulation), AEASGD and ADAG over stacked workers, the rest
of the trainer family on a BatchNorm MLP, and ``Remat`` over BatchNorm.

The same numpy inputs go to both packages; weights cross with
``from_jax_params`` (the state too). Limits, float32 on both sides:
1e-5 of the reference's largest magnitude for a layer, 1e-4 for a model
or a training run (summation order apart: XLA's convolutions and
reductions against PyTorch's). The JAX models are run eagerly or
through the trainers' own jit, once each.
"""

import functools
import warnings
import zlib

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
from distkeras_tpu.ops.normalization import bn_train_apply as jax_bn_train
import distkeras_tpu.parallel as jax_parallel
import distkeras_tpu.parallel.distributed as jax_distributed
from distkeras_tpu.parallel.engine import EngineConfig as JaxEngineConfig

from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.models import (Model, Remat, Sequential,
                                        from_jax_params, to_jax_params,
                                        to_jax_state, zoo)
from distkeras_tpu_torch.models import blocks, layers
from distkeras_tpu_torch.ops import prng
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.ops.normalization import bn_train_apply
from distkeras_tpu_torch.ops.optimizers import get_optimizer
from distkeras_tpu_torch import parallel
import distkeras_tpu_torch.parallel.distributed as port_distributed
from distkeras_tpu_torch.parallel import TrainCarry, make_train_step
from distkeras_tpu_torch.parallel.engine import EngineConfig

#: a layer: float32 on both sides, summation order apart
LAYER_TOL = 1e-5
#: a model or a training run: the layers' differences compounded
MODEL_TOL = 1e-4
LOSS = "sparse_categorical_crossentropy_from_logits"

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


def _np(x):
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) \
        else np.asarray(x, np.float32)


def _rel(got, ref) -> float:
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref), initial=0.0)
                 / max(float(np.max(np.abs(ref), initial=0.0)), 1e-30))


def _assert_trees_close(got, ref, tol, what=""):
    """Same structure (keys, list lengths) and shapes; every leaf within
    ``tol`` of the reference leaf's largest magnitude."""
    got = jax.tree_util.tree_map(_np, got)
    ref = jax.device_get(ref)
    gs = jax.tree_util.tree_structure(got)
    assert gs == jax.tree_util.tree_structure(ref), (what, gs)
    for path_leaf, g in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                            jax.tree_util.tree_leaves(got)):
        path, r = path_leaf
        assert _rel(g, r) <= tol, (what, jax.tree_util.keystr(path),
                                   _rel(g, r))


def _torch_tree(tree):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

#: (layer class name, keywords, input shape without the batch, training)
LAYER_CASES = {
    "conv2d_same_s1_odd": ("Conv2D", dict(filters=4, kernel_size=3),
                           (7, 7, 3), False),
    "conv2d_same_s2_even": ("Conv2D", dict(filters=4, kernel_size=3,
                                           strides=2), (8, 8, 3), False),
    "conv2d_same_s2_odd": ("Conv2D", dict(filters=4, kernel_size=3,
                                          strides=2), (7, 7, 3), False),
    # ResNet's stem: 7x7/2 SAME at an even size pads (2, 3)
    "conv2d_stem_7x7_s2_even": ("Conv2D", dict(
        filters=8, kernel_size=7, strides=2, use_bias=False), (16, 16, 3),
        False),
    "conv2d_same_even_kernel": ("Conv2D", dict(filters=4, kernel_size=4),
                                (7, 7, 3), False),
    "conv2d_valid_s1_tanh": ("Conv2D", dict(
        filters=4, kernel_size=5, padding="VALID", activation="tanh"),
        (8, 8, 3), False),
    "conv2d_valid_s2_odd_relu": ("Conv2D", dict(
        filters=4, kernel_size=3, strides=2, padding="valid",
        activation="relu"), (9, 9, 3), False),
    "conv2d_rect_kernel_strides": ("Conv2D", dict(
        filters=4, kernel_size=(3, 1), strides=(2, 1)), (8, 7, 3), False),
    "conv1d_same_s2_even": ("Conv1D", dict(filters=4, kernel_size=3,
                                           strides=2), (10, 3), False),
    "conv1d_same_even_kernel_odd": ("Conv1D", dict(filters=4,
                                                   kernel_size=4),
                                    (9, 3), False),
    "conv1d_valid_s2_odd": ("Conv1D", dict(filters=4, kernel_size=3,
                                           strides=2, padding="VALID"),
                            (9, 3), False),
    "maxpool_2_valid_odd": ("MaxPooling2D", dict(pool_size=2), (7, 7, 3),
                            False),
    # ResNet's 3x3/2 SAME max pool: (0, 1) at an even size
    "maxpool_3s2_same_even": ("MaxPooling2D", dict(
        pool_size=3, strides=2, padding="SAME"), (8, 8, 3), False),
    "maxpool_3s2_same_odd": ("MaxPooling2D", dict(
        pool_size=3, strides=2, padding="SAME"), (7, 7, 3), False),
    "avgpool_2_valid_odd": ("AveragePooling2D", dict(pool_size=2),
                            (7, 7, 3), False),
    "avgpool_3s2_same_even": ("AveragePooling2D", dict(
        pool_size=3, strides=2, padding="SAME"), (8, 8, 3), False),
    "avgpool_3s1_same_odd": ("AveragePooling2D", dict(
        pool_size=3, strides=1, padding="SAME"), (5, 5, 3), False),
    "global_avgpool_2d": ("GlobalAveragePooling2D", {}, (5, 6, 3), False),
    "global_avgpool_1d": ("GlobalAveragePooling1D", {}, (6, 4), False),
    "flatten_nhwc": ("Flatten", {}, (3, 4, 5), False),
    "reshape": ("Reshape", dict(target_shape=(6, 10)), (3, 4, 5), False),
    "activation_relu6": ("Activation", dict(activation="relu6"), (4, 6),
                         False),
    "activation_softmax": ("Activation", dict(activation="softmax"),
                           (4, 6), False),
    "activation_elu": ("Activation", dict(activation="elu"), (4, 6), False),
    "batchnorm_train_nhwc": ("BatchNorm", {}, (4, 4, 6), True),
    "batchnorm_train_2d_momentum": ("BatchNorm", dict(momentum=0.9),
                                    (6,), True),
    "batchnorm_eval": ("BatchNorm", {}, (4, 4, 6), False),
    "batchnorm_ghost_train": ("BatchNorm", dict(virtual_batch_size=2),
                              (4, 4, 6), True),
    "groupnorm": ("GroupNorm", dict(groups=2), (4, 4, 6), True),
    "groupnorm_2d": ("GroupNorm", dict(groups=3, epsilon=1e-3), (6,),
                     False),
}


def _perturbed(tree, rs):
    """The tree with every leaf replaced by seeded normals (scale and
    offset away from 1 and 0; variances positive)."""
    def leaf(path, a):
        v = rs.randn(*np.shape(a)).astype(np.float32)
        name = jax.tree_util.keystr(path)
        return np.abs(v) + 0.5 if "var" in name or "scale" in name else v
    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(tree))


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_vision_layer_matches_jax(case):
    """Init (the same key gives JAX's weights), forward, the new state
    and the gradients of a seeded projection of the output with respect
    to the input and the parameters."""
    name, kw, shape, training = LAYER_CASES[case]
    rs = np.random.RandomState(zlib.crc32(case.encode()))
    jl = getattr(jax_layers, name)(**kw)
    pl = getattr(layers, name)(**kw)
    jp, js, jout = jl.init(jax.random.PRNGKey(7), shape)
    pout = pl.build(shape, prng.key(7))
    assert tuple(pout) == tuple(jout)
    # init: structure, shapes and JAX's draws
    _assert_trees_close(pl.param_tree(), jp, 1.0, "init params")
    for got, ref in zip(jax.tree_util.tree_leaves(pl.param_tree()),
                        jax.tree_util.tree_leaves(jp)):
        assert float(prng.ulps(got.detach(), np.array(ref)).max()) \
            <= prng.NORMAL_ULPS
    _assert_trees_close(pl.state_tree(), js, 0.0, "init state")

    jp, js = _perturbed(jp, rs), _perturbed(js, rs)
    x = rs.randn(4, *shape).astype(np.float32)
    r = rs.randn(4, *jout).astype(np.float32)

    @jax.jit
    def jax_side(params, state, xin, cot):
        (y, new), vjp = jax.vjp(
            lambda p, xx: jl.apply(p, state, xx, training=training),
            params, xin)
        return y, new, vjp((cot, jax.tree_util.tree_map(jnp.zeros_like,
                                                         new)))

    jy, jnew, (jgp, jgx) = jax_side(jp, js, x, r)

    pp = jax.tree_util.tree_map(lambda a: a.requires_grad_(True),
                                _torch_tree(jp))
    ps = _torch_tree(js)
    xt = torch.from_numpy(x).requires_grad_(True)
    pl.train(training)
    kw_state = {"state": ps} if pl.has_state else {}
    py = pl.apply(pp, xt, **kw_state)
    assert _rel(py, jy) <= LAYER_TOL
    _assert_trees_close(ps, jnew, LAYER_TOL, "new state")
    leaves = jax.tree_util.tree_leaves(pp)
    grads = torch.autograd.grad((py * torch.from_numpy(r)).sum(),
                                [xt] + leaves, allow_unused=True)
    assert _rel(grads[0], jgx) <= LAYER_TOL
    for g, ref in zip(grads[1:], jax.tree_util.tree_leaves(jgp)):
        assert _rel(g, ref) <= LAYER_TOL


#: the cases of the JAX package's own custom-VJP oracle
#: (``tests/test_layers.py`` ``test_batchnorm_custom_vjp_matches_autodiff``)
BN_GRAD_CASES = {"nhwc_float32": ((8, 5, 5, 16), "float32", 1e-5),
                 "nhwc_bfloat16": ((8, 5, 5, 16), "bfloat16", 2e-2),
                 "2d_float32": ((32, 10), "float32", 1e-5)}


@pytest.mark.parametrize("case", list(BN_GRAD_CASES))
def test_bn_train_apply_grads_match_jax_custom_vjp(case):
    shape, dt, tol = BN_GRAD_CASES[case]
    rs = np.random.RandomState(0)
    x = rs.randn(*shape).astype(np.float32)
    s = (rs.rand(shape[-1]) + 0.5).astype(np.float32)
    b = rs.randn(shape[-1]).astype(np.float32)
    g = rs.randn(*shape).astype(np.float32)
    axes = tuple(range(len(shape) - 1))
    jdt = jnp.dtype(dt)

    def jax_fn(xx, ss, bb):
        xf = xx.astype(jnp.float32)
        mean = jnp.mean(xf, axis=axes)
        var = jnp.mean(jnp.square(xf), axis=axes) - jnp.square(mean)
        y = jax_bn_train(xx, ss, bb, mean, var, 1e-3, axes, None)
        return jnp.sum(y.astype(jnp.float32)
                       * jnp.asarray(g).astype(jdt).astype(jnp.float32)), y

    (_, jy), jg = jax.jit(jax.value_and_grad(jax_fn, argnums=(0, 1, 2),
                                             has_aux=True))(
        jnp.asarray(x, jdt), jnp.asarray(s), jnp.asarray(b))

    tdt = getattr(torch, dt)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    st = torch.from_numpy(s).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    xf = xt.detach().float()
    mean = xf.mean(dim=axes)
    var = xf.square().mean(dim=axes) - mean.square()
    y = bn_train_apply(xt, st, bt, mean, var, 1e-3, axes)
    assert y.dtype == tdt
    gt = torch.from_numpy(g).to(tdt).float()
    got = torch.autograd.grad((y.float() * gt).sum(), [xt, st, bt])
    assert _rel(y, np.asarray(jy, np.float32)) <= tol
    for a, ref in zip(got, jg):
        assert a.dtype == (tdt if a.shape == xt.shape else torch.float32)
        assert _rel(a, np.asarray(ref, np.float32)) <= tol


def test_vision_layer_options_raise_or_refuse():
    with pytest.raises(NotImplementedError, match="item 10"):
        layers.BatchNorm(axis_name="dp")
    with pytest.raises(ValueError, match="padding"):
        layers.Conv2D(4, 3, padding="FULL")
    with pytest.raises(ValueError, match="spatial"):
        layers.Conv1D(4, (3, 3))
    with pytest.raises(ValueError, match="groups"):
        layers.GroupNorm(groups=4).build((6,), prng.key(0))
    bn = layers.BatchNorm(virtual_batch_size=3)
    bn.build((2,), prng.key(0))
    bn.train()
    with pytest.raises(ValueError, match="virtual_batch_size"):
        bn.apply(bn.param_tree(), torch.zeros(4, 2))
    with pytest.raises(ValueError, match="branch shapes differ"):
        Model.build(Sequential([blocks.Residual(
            Sequential([layers.Dense(3)]))]), (4,), device="cpu")


# ---------------------------------------------------------------------------
# the zoo
# ---------------------------------------------------------------------------

#: (zoo function, arguments, input shape)
ZOO_CASES = {
    "mlp": ("mlp", dict(hidden=(32, 16), num_classes=5, dropout=0.1), (20,)),
    "lenet5": ("lenet5", dict(num_classes=10), (16, 16, 3)),
    "resnet18_thin": ("resnet18_thin", dict(num_classes=4), (16, 16, 3)),
    "wide_and_deep": ("wide_and_deep", dict(wide_dim=5, deep_hidden=(16, 8),
                                            num_classes=3), (12,)),
}


@pytest.mark.parametrize("case", list(ZOO_CASES))
def test_zoo_builds_and_runs_like_jax(case):
    """The trees equal JAX's in keys and shapes, a seed draws JAX's
    weights (within ``prng``'s normal-family ulps), and on JAX's weights
    the eval forward (running statistics) and the training forward with
    its new state agree."""
    fn, kw, shape = ZOO_CASES[case]
    jm = JaxModel.build(getattr(jax_zoo, fn)(**kw), shape, seed=1)
    pm = Model.build(getattr(zoo, fn)(**kw), shape, seed=1, device="cpu")
    assert pm.output_shape == jm.output_shape
    assert pm.num_params() == jm.num_params()
    _assert_trees_close(pm.params, jm.params, 1.0, "params")
    for got, ref in zip(jax.tree_util.tree_leaves(pm.params),
                        jax.tree_util.tree_leaves(jm.params)):
        assert float(prng.ulps(got.detach(), np.array(ref)).max()) \
            <= prng.NORMAL_ULPS
    _assert_trees_close(pm.state, jm.state, 0.0, "state")

    from_jax_params(pm, jax.device_get(jm.params), jax.device_get(jm.state))
    rs = np.random.RandomState(3)
    x = rs.randn(4, *shape).astype(np.float32)
    @jax.jit
    def jax_side(params, state, xin):
        y, new = jm.apply(params, state, xin, training=True)
        return y, new, jm.apply(params, new, xin)[0]

    jy, jnew, jy_eval = jax_side(jm.params, jm.state, x)
    pm.module.train()
    with torch.no_grad():
        py = pm.module.apply(pm.params, torch.from_numpy(x))
    pm.module.eval()
    assert _rel(py, jy) <= MODEL_TOL
    _assert_trees_close(pm.state, jnew, MODEL_TOL, "trained state")
    # eval mode on the moved statistics
    py_eval = pm.predict(x)
    assert py_eval.dtype == np.float32
    assert _rel(py_eval, jy_eval) <= MODEL_TOL


def test_resnet50_tree_and_summary_match_jax_without_draws():
    """ResNet-50 built on the ``meta`` device (shapes, no draws) has JAX's
    parameter and state trees (``jax.eval_shape`` of its init), the
    canonical 25,557,032 parameters, and ``summary`` rows with JAX's
    per-layer counts."""
    spec = jax_zoo.resnet50(1000)
    jp, js, jout = jax.eval_shape(
        lambda rng: spec.init(rng, (224, 224, 3)), jax.random.PRNGKey(0))
    pm = Model.build(zoo.resnet50(1000), (224, 224, 3), device="meta")
    assert pm.output_shape == (1000,)
    for got, ref in ((pm.params, jp), (pm.state, js)):
        shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), got)
        ref_shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), ref)
        assert shapes == ref_shapes
    assert pm.num_params() == 25_557_032
    rows = [sum(int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(p))
            for p in jp]
    text = pm.summary()
    counts = [int(line.split()[-1].replace(",", ""))
              for line in text.splitlines()[2:-2]]
    assert counts == rows
    assert text.splitlines()[-1].split()[-1] == "25,557,032"


# ---------------------------------------------------------------------------
# training with model state
# ---------------------------------------------------------------------------

def _image_data(n, shape, classes, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, *shape).astype(np.float32)
    y = rs.randint(0, classes, n)
    return X, y


def _pair(fn, kw, shape, seed=0):
    """A fresh JAX model and the port's loaded with its weights and state
    (a JAX trainer donates its model's buffers: build one per run)."""
    jm = JaxModel.build(getattr(jax_zoo, fn)(**kw), shape, seed=seed)
    pm = Model.build(getattr(zoo, fn)(**kw), shape, seed=seed, device="cpu")
    return jm, from_jax_params(pm, jax.device_get(jm.params),
                               jax.device_get(jm.state))


def _assert_runs_close(jt, pt, jtrained, pm, tol=MODEL_TOL):
    for je, pe in zip(jt.history.epochs, pt.history.epochs, strict=True):
        assert set(je) == set(pe)
        for key in je:
            assert _rel(pe[key], np.asarray(je[key])) <= tol, key
    _assert_trees_close(pm.params, jtrained.params, tol, "params")
    _assert_trees_close(pm.state, jtrained.state, tol, "state")


def _run_spread(jt, jtrained, rerun) -> float:
    """The largest relative difference between two JAX runs: the per-epoch
    histories, the trained parameters and the state."""
    jt2, jtrained2 = rerun()
    spread = 0.0
    for a, b in zip(jt.history.epochs, jt2.history.epochs, strict=True):
        spread = max([spread] + [_rel(b[k], np.asarray(a[k])) for k in a])
    for a, b in ((jtrained.params, jtrained2.params),
                 (jtrained.state, jtrained2.state)):
        spread = max([spread] + [
            _rel(y, x) for x, y in zip(jax.tree_util.tree_leaves(a),
                                       jax.tree_util.tree_leaves(b))])
    return spread


#: the row orders of the spread runs: reversed, then three seeded shuffles
ROW_ORDERS = ("reversed", 0, 1, 2)


def _rows_permuted_in_each_step(monkeypatch, order, accum):
    """Make the JAX trainer's steps see their rows in another order
    (``ROW_ORDERS``) within each of the ``accum`` strided microbatches
    (row ``j + accum * k`` stays in microbatch ``j``): the same
    microbatches, only the order of every batch reduction changes."""
    import distkeras_tpu.parallel.trainers as jax_trainers
    stack = jax_trainers.stack_batches

    def permuted(*args, **kwargs):
        Xs, Ys, S = stack(*args, **kwargs)
        m = Xs.shape[1] // accum
        ks = np.arange(m)[::-1] if order == "reversed" \
            else np.random.RandomState(order).permutation(m)
        perm = (np.arange(accum)[None, :] + accum * ks[:, None]).ravel()
        return (np.ascontiguousarray(Xs[:, perm]),
                np.ascontiguousarray(Ys[:, perm]), S)

    monkeypatch.setattr(jax_trainers, "stack_batches", permuted)


#: (zoo function, keywords, input shape, gradient accumulation, validation);
#: plain SGD: adam's update of a gradient within float32 noise of its eps
#: magnifies summation-order differences
SINGLE_CASES = {
    "resnet18_thin_validation": ("resnet18_thin", dict(num_classes=4),
                                 (16, 16, 3), 1, True),
    "resnet18_thin_accum2": ("resnet18_thin", dict(num_classes=4),
                             (16, 16, 3), 2, False),
    "lenet5": ("lenet5", dict(num_classes=4), (16, 16, 3), 1, False),
}


@pytest.mark.parametrize("case", list(SINGLE_CASES))
def test_single_trainer_bn_state_matches_jax(case, monkeypatch):
    """Per-step losses and accuracies, the validator's scores (eval mode
    on the running statistics), the final parameters and the BN state,
    within ``MODEL_TOL``, or within twice the JAX package's own spread
    where that is larger: JAX's run against itself with the rows of
    every step in another order (``ROW_ORDERS``; the same mathematics,
    another order of each batch sum; the yardstick of
    ``tests/test_torch_zoo.py``'s ``_train_tol``). ``resnet18_thin_validation`` needs it: its sixth
    step's gradient is sensitive to the row order (BatchNorm's backward
    is a small residual of large terms; no ReLU input changes sign), and
    under two of the four orders JAX's runs part from there on (the
    test prints the spread and the limit)."""
    fn, kw, shape, accum, validation = SINGLE_CASES[case]
    X, y = _image_data(64, shape, kw["num_classes"])
    tkw = dict(worker_optimizer="sgd", learning_rate=0.05, loss=LOSS,
               batch_size=16, num_epoch=2, grad_accum_steps=accum,
               metrics=["accuracy"])
    if validation:
        tkw["validation_data"] = _image_data(32, shape, kw["num_classes"],
                                             seed=1)

    def jax_run():
        jm = JaxModel.build(getattr(jax_zoo, fn)(**kw), shape, seed=0)
        jt = jax_parallel.SingleTrainer(jm, **tkw)
        return jt, jt.train(JaxDataset({"features": X, "label": y}))

    jm, pm = _pair(fn, kw, shape)
    jt = jax_parallel.SingleTrainer(jm, **tkw)
    jtrained = jt.train(JaxDataset({"features": X, "label": y}))
    pt = parallel.SingleTrainer(pm, **tkw)
    assert pt.train(Dataset({"features": X, "label": y})) is pm
    spread = 0.0
    for order in ROW_ORDERS:
        with monkeypatch.context() as m:
            _rows_permuted_in_each_step(m, order, accum)
            spread = max(spread, _run_spread(jt, jtrained, jax_run))
    tol = max(MODEL_TOL, 2.0 * spread)
    print(f"{case}: JAX's own spread over the row orders {spread:.3e}, "
          f"limit {tol:.3e}")
    _assert_runs_close(jt, pt, jtrained, pm, tol)
    if validation:
        assert "val_loss" in pt.history.epochs[-1]


def _force_program(monkeypatch, amortized):
    monkeypatch.setattr(jax_distributed, "EngineConfig", functools.partial(
        JaxEngineConfig, amortized=amortized))
    monkeypatch.setattr(port_distributed, "EngineConfig", functools.partial(
        EngineConfig, amortized=amortized))


#: (trainer, keywords, amortized): AEASGD (BASELINE config 3) on the
#: per-step path, ADAG (config 2) on its own. ADAG's first commit moves a
#: weight by ``lr * t / (|t| + epsilon)``: with the default epsilon 1e-8
#: that is ``lr * sign(t)`` for a delta ``t`` of float32 noise (weights
#: the two steps barely moved), so the two packages' summation orders
#: decide the sign; epsilon 1e-4 makes the step proportional there
DIST_CASES = {
    "aeasgd_perstep": ("AEASGD", dict(communication_window=2, rho=5.0,
                                      learning_rate=0.01,
                                      optimizer_kwargs={
                                          "learning_rate": 0.05}), False),
    "adag": ("ADAG", dict(communication_window=2, adag_learning_rate=0.05,
                          epsilon=1e-4,
                          learning_rate=0.05), None),
}


@pytest.mark.parametrize("case", list(DIST_CASES))
def test_stacked_workers_carry_bn_state_like_jax(case, monkeypatch):
    """``resnet18_thin`` over 2 stacked workers against JAX's trainer on 2
    virtual devices: per-worker losses, the center and the extracted
    state (the mean of the workers' statistics)."""
    name, kw, amortized = DIST_CASES[case]
    if amortized is not None:
        _force_program(monkeypatch, amortized)
    shape = (16, 16, 3)
    X, y = _image_data(64, shape, 4)
    tkw = dict(num_workers=2, batch_size=8, num_epoch=1, loss=LOSS,
               worker_optimizer="sgd", **kw)
    jm, pm = _pair("resnet18_thin", dict(num_classes=4), shape)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt = getattr(jax_parallel, name)(jm, **tkw)
        jtrained = jt.train(JaxDataset({"features": X, "label": y}))
        pt = getattr(parallel, name)(pm, **tkw)
        pt.train(Dataset({"features": X, "label": y}))
    assert pt.get_history().losses().shape == (4, 2)
    _assert_runs_close(jt, pt, jtrained, pm)
    # the extracted state is the mean of the workers' rows
    eng = pt.engine
    assert eng.server_updates > 0


def _bn_mlp(pkg, classes=3):
    L = jax_layers if pkg == "jax" else layers
    seq = JaxSequential if pkg == "jax" else Sequential
    return seq([L.BatchNorm(momentum=0.9), L.Dense(16, activation="relu"),
                L.BatchNorm(), L.Dense(classes)])


def _bn_mlp_pair(seed=0):
    jm = JaxModel.build(_bn_mlp("jax"), (6,), seed=seed)
    pm = Model.build(_bn_mlp("port"), (6,), seed=seed, device="cpu")
    return jm, from_jax_params(pm, jax.device_get(jm.params),
                               jax.device_get(jm.state))


def _bn_mlp_data(n, seed=0):
    """Features far from the initial statistics (mean 0, var 1), so a
    validator that ignored the trained state would score differently."""
    rs = np.random.RandomState(seed)
    X = (rs.randn(n, 6) * 10.0 + 3.0).astype(np.float32)
    y = np.argmax(X[:, :3] + rs.randn(n, 3), axis=1)
    return X, y


#: the rest of the family on the BN MLP: (trainer, keywords)
FAMILY_CASES = {
    "downpour_validation": ("DOWNPOUR", dict(num_workers=8,
                                             communication_window=2,
                                             commit_scale=1 / 8)),
    "easgd_sync": ("EASGD", dict(num_workers=4, communication_window=2,
                                 optimizer_kwargs={"learning_rate": 0.05})),
    "dynsgd": ("DynSGD", dict(num_workers=4,
                              communication_window=[1, 2, 2, 4])),
    "averaging": ("AveragingTrainer", dict(num_workers=4)),
    "host_async_one_worker": ("HostAsyncTrainer", dict(
        num_workers=1, communication_window=2)),
    "ensemble": ("EnsembleTrainer", dict(num_models=2)),
}


@pytest.mark.parametrize("case", list(FAMILY_CASES))
def test_trainer_family_bn_state_matches_jax(case):
    """Every other trainer carries the BN state as JAX's: losses, the
    validator on the averaged state (the oracle of JAX's
    ``test_distributed_validation_uses_trained_bn_state``), the final
    parameters and state (an ensemble: every member's)."""
    name, kw = FAMILY_CASES[case]
    X, y = _bn_mlp_data(512)
    tkw = dict(batch_size=16, num_epoch=2, loss=LOSS,
               worker_optimizer="sgd", learning_rate=0.05,
               metrics=["accuracy"], **kw)
    if "optimizer_kwargs" in tkw:
        tkw.pop("learning_rate")
    if name != "EnsembleTrainer":   # it refuses validation data
        tkw["validation_data"] = _bn_mlp_data(128, seed=1)
    jm, pm = _bn_mlp_pair()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt = getattr(jax_parallel, name)(jm, **tkw)
        jout = jt.train(JaxDataset({"features": X, "label": y}))
        pt = getattr(parallel, name)(pm, **tkw)
        pout = pt.train(Dataset({"features": X, "label": y}))
    if name == "EnsembleTrainer":
        for je, pe in zip(jt.history.epochs, pt.history.epochs, strict=True):
            for key in je:
                assert _rel(pe[key], np.asarray(je[key])) <= MODEL_TOL, key
        for jmember, pmember in zip(jout, pout, strict=True):
            _assert_trees_close(pmember.params, jmember.params, MODEL_TOL)
            _assert_trees_close(pmember.state, jmember.state, MODEL_TOL)
        return
    _assert_runs_close(jt, pt, jout, pm)
    moved = to_jax_state(pm)[0]["mean"]
    assert np.abs(moved).max() > 0.1     # the statistics moved
    if "validation_data" in tkw:
        assert pt.history.epochs[-1]["val_accuracy"][0] > 0.5


def test_engine_extract_model_averages_worker_state():
    """``extract_model``: the mean of each float state leaf over the
    workers, worker 0's value of an integer leaf."""
    pm = Model.build(_bn_mlp("port"), (6,), device="cpu")
    eng = parallel.DistributedEngine(
        pm.module, get_loss(LOSS), get_optimizer("sgd", learning_rate=0.05),
        parallel.engine.DownpourAlgo(), None,
        EngineConfig(num_workers=3, window=2))
    state = eng.init_state(pm.params, prng.key(0), pm.state)
    X, y = _bn_mlp_data(3 * 2 * 8)
    state, _ = eng.run_epoch(state, X.reshape(2, 3, 8, 6),
                             y.reshape(2, 3, 8))
    rows = state["worker"]["state"]
    assert not torch.equal(rows[0]["mean"][0], rows[0]["mean"][1])
    _, mean = eng.extract_model(state)
    torch.testing.assert_close(mean[0]["mean"], rows[0]["mean"].mean(0))
    counter = torch.tensor([[5, 6], [7, 8], [9, 1]])
    assert torch.equal(parallel.engine.mean_state({"n": counter})["n"],
                       counter[0])


def test_remat_bn_step_leaves_state_bitwise():
    """``Remat`` over BatchNorm blocks: the recompute writes no running
    statistics, so a step leaves the state (and the weights) bitwise the
    bare step's."""
    def build(remat):
        spec = zoo.resnet18_thin(4)
        if remat:
            spec = Sequential([Remat(l) if isinstance(l, blocks.Residual)
                               else l for l in spec.layers])
        return Model.build(spec, (16, 16, 3), seed=2, device="cpu")

    X, y = _image_data(8, (16, 16, 3), 4)
    out = []
    for remat in (False, True):
        m = build(remat)
        opt = get_optimizer("sgd", learning_rate=0.1)
        step = make_train_step(m.module, get_loss(LOSS), opt)
        carry = TrainCarry(m.params, opt.init(m.params), None, m.state)
        for _ in range(2):
            carry, loss = step(carry, (torch.from_numpy(X),
                                       torch.from_numpy(y)))
        out.append((loss, to_jax_params(m), to_jax_state(m)))
    (l0, p0, s0), (l1, p1, s1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(jax.tree_util.tree_leaves((p0, s0)),
                    jax.tree_util.tree_leaves((p1, s1))):
        np.testing.assert_array_equal(a, b)
    assert np.abs(s0[1]["mean"]).max() > 0      # the stem's BN moved
