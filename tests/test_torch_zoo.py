"""The rest of the port's model zoo against the JAX package: the
remaining convolutions (``DepthwiseConv2D``, ``SeparableConv2D``,
``Conv2DTranspose``, ``UpSampling2D``), ``vit``, ``mobilenet`` and
``bilstm_classifier`` (BASELINE config 5) at small widths, one
``SingleTrainer`` step of each, and config 5 through ``ModelPredictor``.

The same numpy inputs go to both packages; weights cross with
``from_jax_params``, and the same key must also draw JAX's weights
(``prng``'s normal-family ulps). Limits, float32 on both sides: 1e-5 of
the reference's largest magnitude for a layer, 1e-4 for a model or a
training step (XLA's convolutions, reductions and attention against
PyTorch's, summation order apart). ViT on the CPU runs the flash
kernels' plain versions without the causal mask; JAX runs its XLA
attention there.
"""

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
import distkeras_tpu.parallel as jax_parallel

from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.inference import ModelPredictor
from distkeras_tpu_torch.models import (Model, Sequential, from_jax_params,
                                        layers, zoo)
from distkeras_tpu_torch.ops import prng
from distkeras_tpu_torch import parallel

LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
LOSS = "sparse_categorical_crossentropy_from_logits"


@pytest.fixture(autouse=True, scope="module")
def _one_intraop_thread():
    """Tiny tensors: one intra-op thread runs them faster than a pool
    that contends with the other test processes."""
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
    got = jax.tree_util.tree_map(_np, got)
    ref = jax.device_get(ref)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(ref), what
    for (path, r), g in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                            jax.tree_util.tree_leaves(got)):
        assert _rel(g, r) <= tol, (what, jax.tree_util.keystr(path),
                                   _rel(g, r))


def _assert_leaves_close(got, ref, tol, what=""):
    """State trees: JAX keeps an empty dict per stateless sub-layer (a
    transformer block's ``{"attn": {}, ...}``) where the port keeps
    ``{}``; the leaves and their order must agree."""
    got = [_np(g) for g in jax.tree_util.tree_leaves(got)]
    ref = jax.tree_util.tree_leaves(jax.device_get(ref))
    assert len(got) == len(ref), what
    for g, r in zip(got, ref):
        assert _rel(g, r) <= tol, what


def _assert_jax_draws(got_tree, ref_tree):
    for got, ref in zip(jax.tree_util.tree_leaves(got_tree),
                        jax.tree_util.tree_leaves(ref_tree), strict=True):
        assert float(prng.ulps(got.detach(), np.array(ref)).max()) \
            <= prng.NORMAL_ULPS


# ---------------------------------------------------------------------------
# the remaining convolutions
# ---------------------------------------------------------------------------

#: (layer class, keywords, input shape without the batch)
CONV_CASES = {
    "depthwise_m1_same_s1_odd": ("DepthwiseConv2D", dict(kernel_size=3),
                                 (7, 7, 3)),
    "depthwise_m2_same_s2_even": ("DepthwiseConv2D", dict(
        kernel_size=3, strides=2, depth_multiplier=2), (8, 8, 3)),
    "depthwise_m2_valid_s2_odd_relu": ("DepthwiseConv2D", dict(
        kernel_size=3, strides=2, padding="VALID", depth_multiplier=2,
        activation="relu"), (9, 9, 3)),
    "depthwise_m1_same_s2_odd_nobias": ("DepthwiseConv2D", dict(
        kernel_size=3, strides=2, use_bias=False), (7, 7, 4)),
    "separable_same_s1": ("SeparableConv2D", dict(filters=5, kernel_size=3),
                          (6, 6, 3)),
    "separable_m2_s2_odd_tanh": ("SeparableConv2D", dict(
        filters=4, kernel_size=3, strides=2, depth_multiplier=2,
        activation="tanh"), (7, 7, 3)),
    "transpose_same_s1_odd": ("Conv2DTranspose", dict(filters=4,
                                                      kernel_size=3),
                              (5, 5, 3)),
    "transpose_same_s2_odd": ("Conv2DTranspose", dict(
        filters=4, kernel_size=3, strides=2), (5, 5, 3)),
    "transpose_same_s2_even": ("Conv2DTranspose", dict(
        filters=4, kernel_size=4, strides=2), (6, 6, 3)),
    "transpose_valid_s1_even": ("Conv2DTranspose", dict(
        filters=4, kernel_size=4, padding="VALID"), (6, 6, 3)),
    "transpose_valid_s2_odd": ("Conv2DTranspose", dict(
        filters=4, kernel_size=3, strides=2, padding="VALID"), (5, 5, 3)),
    "transpose_valid_s2_even_k2": ("Conv2DTranspose", dict(
        filters=4, kernel_size=2, strides=2, padding="VALID",
        activation="relu"), (4, 6, 3)),
    "transpose_same_rect_strides": ("Conv2DTranspose", dict(
        filters=3, kernel_size=(3, 2), strides=(2, 1)), (5, 4, 2)),
    "upsampling_2": ("UpSampling2D", dict(size=2), (3, 4, 2)),
    "upsampling_3x2": ("UpSampling2D", dict(size=(3, 2)), (2, 3, 2)),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv_layer_matches_jax(case):
    """Init (JAX's draws from the same key), the output shape, the
    forward and the gradients of a seeded projection of the output with
    respect to the input and the parameters; ``get_config`` is JAX's."""
    name, kw, shape = CONV_CASES[case]
    rs = np.random.RandomState(zlib.crc32(case.encode()))
    jl = getattr(jax_layers, name)(**kw)
    pl = getattr(layers, name)(**kw)
    assert pl.get_config() == jl.get_config()
    jp, _, jout = jl.init(jax.random.PRNGKey(5), shape)
    pout = pl.build(shape, prng.key(5))
    assert tuple(pout) == tuple(jout)
    _assert_trees_close(pl.param_tree(), jp, 1.0, "init params")
    _assert_jax_draws(pl.param_tree(), jp)

    jp = jax.tree_util.tree_map(
        lambda a: rs.randn(*np.shape(a)).astype(np.float32),
        jax.device_get(jp))
    x = rs.randn(2, *shape).astype(np.float32)
    r = rs.randn(2, *jout).astype(np.float32)

    @jax.jit
    def jax_side(params, xin):
        y, vjp = jax.vjp(lambda p, xx: jl.apply(p, {}, xx)[0], params, xin)
        return y, vjp(r)

    jy, (jgp, jgx) = jax_side(jp, x)
    pp = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)).requires_grad_(True), jp)
    xt = torch.from_numpy(x).requires_grad_(True)
    py = pl.apply(pp, xt)
    assert _rel(py, jy) <= LAYER_TOL
    leaves = jax.tree_util.tree_leaves(pp)
    grads = torch.autograd.grad((py * torch.from_numpy(r)).sum(),
                                [xt] + leaves)
    for g, ref in zip(grads, [jgx] + jax.tree_util.tree_leaves(jgp)):
        assert _rel(g, ref) <= LAYER_TOL


def test_conv_stride2_then_transpose_restores_the_size():
    """JAX's own round trip (``tests/test_layers.py:355-366``): a stride-2
    ``Conv2DTranspose`` doubles the size, and a stride-2 ``Conv2D``
    followed by one restores it; the stack's forward equals JAX's."""
    m = Model.build(Sequential([layers.Conv2DTranspose(3, 4, strides=2)]),
                    (5, 5, 2), device="cpu")
    assert m.output_shape == (10, 10, 3)
    assert m.predict(np.ones((2, 5, 5, 2), np.float32)).shape == \
        (2, 10, 10, 3)
    jm = JaxModel.build(JaxSequential([
        jax_layers.Conv2D(4, 3, strides=2),
        jax_layers.Conv2DTranspose(1, 3, strides=2)]), (8, 8, 1), seed=2)
    pm = Model.build(Sequential([layers.Conv2D(4, 3, strides=2),
                                 layers.Conv2DTranspose(1, 3, strides=2)]),
                     (8, 8, 1), seed=2, device="cpu")
    assert pm.output_shape == jm.output_shape == (8, 8, 1)
    from_jax_params(pm, jax.device_get(jm.params))
    x = np.random.RandomState(4).randn(3, 8, 8, 1).astype(np.float32)
    assert _rel(pm.predict(x), jm.predict(x)) <= LAYER_TOL


def test_depthwise_channels_stay_independent():
    """Perturbing input channel 0 moves only its own ``depth_multiplier``
    outputs (JAX ``tests/test_layers.py:340-351``)."""
    m = Model.build(Sequential([layers.DepthwiseConv2D(
        3, depth_multiplier=2, use_bias=False)]), (5, 5, 4), device="cpu")
    assert m.output_shape == (5, 5, 8)
    x = np.random.RandomState(10).randn(1, 5, 5, 4).astype(np.float32)
    x2 = x.copy()
    x2[..., 0] += 1.0
    diff = np.abs(m.predict(x2) - m.predict(x)).reshape(-1, 8).max(axis=0)
    assert (diff[:2] > 0).all() and np.allclose(diff[2:], 0.0)


# ---------------------------------------------------------------------------
# the zoo
# ---------------------------------------------------------------------------

VIT_KW = dict(image_size=16, patch_size=4, d_model=32, num_heads=4,
              num_layers=2, num_classes=5)
#: (zoo function, keywords, input shape)
ZOO_CASES = {
    "vit": ("vit", VIT_KW, (16, 16, 3)),
    "vit_dropout": ("vit", dict(VIT_KW, dropout_rate=0.1), (16, 16, 3)),
    "mobilenet_0125": ("mobilenet", dict(num_classes=5, width_mult=0.125),
                       (64, 64, 3)),
    "bilstm_classifier": ("bilstm_classifier", dict(units=8,
                                                    num_classes=2),
                          (7, 6)),
}


def _pair(fn, kw, shape, seed=1):
    """A fresh JAX model and the port's built from the same seed, then
    loaded with JAX's weights and state."""
    jm = JaxModel.build(getattr(jax_zoo, fn)(**kw), shape, seed=seed)
    pm = Model.build(getattr(zoo, fn)(**kw), shape, seed=seed, device="cpu")
    return jm, pm


def _spread(a, b) -> float:
    """The largest per-leaf relative difference of two trees."""
    return max(_rel(x, y) for x, y in zip(jax.tree_util.tree_leaves(a),
                                          jax.tree_util.tree_leaves(b),
                                          strict=True))


def _train_tol(jax_run, x) -> float:
    """The limit of a training-mode comparison: ``MODEL_TOL``, or twice
    the JAX package's own float32 spread on the same batch with its rows
    in reverse order (the same mathematics), where that is larger.

    A random-init MobileNet is that ill-conditioned in training mode:
    each BatchNorm's moments come from ``E[x^2] - E[x]^2`` and its
    backward is a small residual of large terms, so JAX's own step moves
    by up to ~10-30% of a gradient leaf when only the order of the rows
    changes. No float32 implementation can meet 1e-4 against it there;
    the port is held within that spread. Everywhere else (ViT, the
    BiLSTM) the spread is ~1e-7 and the limit stays ``MODEL_TOL``."""
    return max(MODEL_TOL, 2.0 * _spread(jax_run(x, False),
                                        jax_run(x, True)))


@pytest.mark.parametrize("case", list(ZOO_CASES))
def test_zoo_model_matches_jax(case):
    """The trees, the seed's draws, ``get_config``, the eval forward and,
    for BatchNorm models, the training forward's new state."""
    fn, kw, shape = ZOO_CASES[case]
    jm, pm = _pair(fn, kw, shape)
    assert pm.output_shape == jm.output_shape
    assert pm.num_params() == jm.num_params()
    assert pm.module.get_config() == jm.module.get_config()
    _assert_trees_close(pm.params, jm.params, 1.0, "params")
    _assert_jax_draws(pm.params, jm.params)
    _assert_leaves_close(pm.state, jm.state, 0.0, "state")
    from_jax_params(pm, jax.device_get(jm.params), jax.device_get(jm.state))
    x = np.random.RandomState(3).randn(4, *shape).astype(np.float32)
    assert _rel(pm.predict(x), jm.predict(x)) <= MODEL_TOL
    if jax.tree_util.tree_leaves(jm.state):
        fwd = jax.jit(lambda p, s, xx: jm.apply(p, s, xx, training=True))

        def jax_run(xx, reverse):
            y, new = fwd(jm.params, jm.state, xx[::-1] if reverse else xx)
            return [np.asarray(y)[::-1] if reverse else y, new]

        tol = _train_tol(jax_run, x)
        jy, jnew = jax_run(x, False)
        pm.module.train()
        with torch.no_grad():
            py = pm.module.apply(pm.params, torch.from_numpy(x))
        pm.module.eval()
        assert _rel(py, jy) <= tol
        _assert_leaves_close(pm.state, jnew, tol, "trained state")


@pytest.mark.parametrize("case", list(ZOO_CASES))
def test_zoo_model_single_trainer_step_matches_jax(case):
    """One ``SingleTrainer`` step (SGD) from JAX's weights: the loss, the
    new weights and state; with a dropout rate the trainer's key draws
    JAX's masks (the ported threefry)."""
    fn, kw, shape = ZOO_CASES[case]
    rs = np.random.RandomState(7)
    X = rs.randn(8, *shape).astype(np.float32)
    tkw = dict(worker_optimizer="sgd", learning_rate=0.05, loss=LOSS,
               batch_size=8, num_epoch=1, seed=3)
    runs = {}

    def jax_run(xx, reverse):
        jm = JaxModel.build(getattr(jax_zoo, fn)(**kw), shape, seed=1)
        y = np.random.RandomState(8).randint(0, jm.output_shape[-1], 8)
        order = slice(None, None, -1) if reverse else slice(None)
        jt = jax_parallel.SingleTrainer(jm, **tkw)
        trained = jt.train(JaxDataset({"features": xx[order],
                                       "label": y[order]}))
        runs[reverse] = (jt, y)
        return [trained.params, trained.state]

    tol = _train_tol(jax_run, X) if "dropout" not in case else MODEL_TOL
    jtrained_params, jtrained_state = jax_run(X, False)
    jt, y = runs[False]
    jm, pm = _pair(fn, kw, shape)
    from_jax_params(pm, jax.device_get(jm.params), jax.device_get(jm.state))
    pt = parallel.SingleTrainer(pm, **tkw)
    pt.train(Dataset({"features": X, "label": y}))
    jl = np.asarray(jt.history.epochs[0]["loss"], np.float32)
    pl = np.asarray(pt.history.epochs[0]["loss"], np.float32)
    assert _rel(pl, jl) <= MODEL_TOL
    _assert_trees_close(pm.params, jtrained_params, tol, "params")
    _assert_leaves_close(pm.state, jtrained_state, tol, "state")


#: a MobileNet whose last blocks normalise over 5 x 5 pixels of 8 rows
#: (200 values a channel): JAX's own training-mode spread falls to ~2e-5,
#: so the port is held to ``MODEL_TOL`` there, not to ``_train_tol``
MOBILENET_WIDE = (dict(num_classes=5, width_mult=0.125), (160, 160, 3), 8)


@pytest.fixture(scope="module")
def mobilenet_wide():
    """The JAX MobileNet, the port's loaded with its weights and state,
    and the input rows of ``MOBILENET_WIDE``."""
    kw, shape, rows = MOBILENET_WIDE
    jm, pm = _pair("mobilenet", kw, shape)
    from_jax_params(pm, jax.device_get(jm.params), jax.device_get(jm.state))
    x = np.random.RandomState(3).randn(rows, *shape).astype(np.float32)
    return jm, pm, x


def test_mobilenet_normalising_over_many_values_held_to_model_tol(
        mobilenet_wide):
    """Beside ``_train_tol``'s case: with 200 values a channel in the
    last BatchNorms the JAX package's own spread (rows reversed) is under
    ``MODEL_TOL``, and the port's eval forward, training forward and new
    BatchNorm state are held to ``MODEL_TOL`` itself."""
    jm, pm, x = mobilenet_wide
    fwd = jax.jit(lambda p, s, xx: jm.apply(p, s, xx, training=True))

    def jax_run(xx, reverse):
        y, new = fwd(jm.params, jm.state, xx[::-1] if reverse else xx)
        return [np.asarray(y)[::-1] if reverse else y, new]

    jy, jnew = jax_run(x, False)
    assert _spread([jy, jnew], jax_run(x, True)) < MODEL_TOL
    assert _rel(pm.predict(x), jm.predict(x)) <= MODEL_TOL
    state = [{k: v.clone() for k, v in layer.state_tree().items()}
             if layer.has_state else None for layer in pm.module.layers]
    pm.module.train()
    try:
        with torch.no_grad():
            py = pm.module.apply(pm.params, torch.from_numpy(x),
                                 state=state)
    finally:
        pm.module.eval()
    assert _rel(py, jy) <= MODEL_TOL
    _assert_leaves_close([s for s in state if s is not None],
                         [s for s in jnew if s], MODEL_TOL, "trained state")


def test_mobilenet_blocks_match_jax_forward_and_gradients(mobilenet_wide):
    """Block by block (the stem, then each depthwise-separable block:
    DepthwiseConv2D, BatchNorm, ReLU, 1x1 Conv2D, BatchNorm, ReLU), in
    training mode on the JAX block's own input, with a seeded cotangent
    at the block's output:

    * the forward chain's output within ``LAYER_TOL`` of JAX's;
    * each layer on JAX's own input to that layer, with JAX's own
      cotangent at its output (both from one ``jax.vjp`` of the block):
      its input gradient and parameter gradients within ``LAYER_TOL``;
    * the whole block's input and parameter gradients within
      ``LAYER_TOL``, for every block whose ReLUs see inputs of the same
      sign on both sides. An element within rounding of zero may take
      the other branch of the kink, which no tolerance bounds; the test
      names the blocks it leaves to the per-layer check."""
    jm, pm, x = mobilenet_wide
    jl, pl = jm.module.layers, pm.module.layers
    bounds = [(0, 3)] + [(3 + 6 * i, 9 + 6 * i) for i in range(13)]
    assert bounds[-1][1] == len(jl) - 2          # then pooling and the head

    def jax_block(params, xx, eps, lo, hi):
        """The block with ``eps[j]`` added to layer ``lo + j``'s output
        (zeros: the gradient for ``eps[j]`` is the cotangent there);
        returns the output and every layer's input."""
        ins = []
        for i in range(lo, hi):
            ins.append(xx)
            xx, _ = jl[i].apply(params[i - lo], jm.state[i], xx,
                                training=True)
            xx = xx + eps[i - lo]
        return xx, ins

    def port_layer(i, params, xx):
        kw = {}
        if pl[i].has_state:
            kw["state"] = {k: v.clone() for k, v in
                           pl[i].state_tree().items()}
        return pl[i].apply(params, xx, **kw)

    def torch_params(i):
        return {k: torch.tensor(np.asarray(v), requires_grad=True)
                for k, v in jm.params[i].items()}

    relu = {i for i, layer in enumerate(jl)
            if type(layer).__name__ == "Activation"}
    left = []
    h = jnp.asarray(x)
    pm.module.train()
    try:
        for lo, hi in bounds:
            where = f"layers {lo}-{hi}"
            jp = jm.params[lo:hi]
            shapes = []
            xx = h
            for i in range(lo, hi):
                xx, _ = jl[i].apply(jp[i - lo], jm.state[i], xx,
                                    training=True)
                shapes.append(xx.shape)
            eps = [jnp.zeros(sh, jnp.float32) for sh in shapes]
            out, vjp, ins = jax.vjp(
                lambda p, xx, e: jax_block(p, xx, e, lo, hi), jp, h, eps,
                has_aux=True)
            ct = np.random.RandomState(lo).randn(*out.shape).astype(
                np.float32)
            jgp, jgx, jge = vjp(jnp.asarray(ct))
            # the chain's forward on the port's own activations
            pp = [torch_params(i) for i in range(lo, hi)]
            px = torch.tensor(np.asarray(h), requires_grad=True)
            y, branch_same = px, True
            for i in range(lo, hi):
                if i in relu:
                    branch_same &= bool(np.array_equal(
                        y.detach().numpy() > 0, np.asarray(ins[i - lo]) > 0))
                y = port_layer(i, pp[i - lo], y)
            assert _rel(y, out) <= LAYER_TOL, where
            # each layer on JAX's input to it, with JAX's cotangent there
            for i in range(lo, hi):
                j = i - lo
                lp = torch_params(i)
                lx = torch.tensor(np.asarray(ins[j]), requires_grad=True)
                ly = port_layer(i, lp, lx)
                lct = torch.from_numpy(np.asarray(jge[j]))
                leaves = list(lp.values())
                grads = torch.autograd.grad((ly * lct).sum(), leaves + [lx])
                jdx = jgx if j == 0 else jge[j - 1]
                at = f"{where}, layer {i} ({type(pl[i]).__name__})"
                assert _rel(grads[-1], jdx) <= LAYER_TOL, at
                for g, r in zip(grads[:-1], jgp[j].values()):
                    assert _rel(g, r) <= LAYER_TOL, at
            if branch_same:
                leaves = [v for p in pp for v in p.values()]
                grads = torch.autograd.grad(
                    (y * torch.from_numpy(ct)).sum(), leaves + [px])
                assert _rel(grads[-1], jgx) <= LAYER_TOL, where
                jleaves = [v for p in jgp for v in p.values()]
                assert len(jleaves) == len(leaves)
                for g, r in zip(grads[:-1], jleaves):
                    assert _rel(g, r) <= LAYER_TOL, where
            else:
                left.append(where)
            h = out
    finally:
        pm.module.eval()
    if left:
        print("ReLU inputs of differing sign; whole-block gradients left "
              f"to the per-layer check: {', '.join(left)}")
    assert len(left) < len(bounds), "no block was checked whole"


def test_vit_dropout_trains_apart_from_eval():
    """A dropout ViT's training forward draws (its output differs from
    the eval forward's) and a training forward without a key does not."""
    pm = Model.build(zoo.vit(**dict(VIT_KW, dropout_rate=0.5)), (16, 16, 3),
                     device="cpu")
    x = torch.from_numpy(np.random.RandomState(1).randn(
        2, 16, 16, 3).astype(np.float32))
    with torch.no_grad():
        ev = pm.module.apply(pm.params, x)
        pm.module.train()
        no_key = pm.module.apply(pm.params, x)
        drawn = pm.module.apply(pm.params, x, rng=prng.key(4))
        pm.module.eval()
    assert torch.equal(ev, no_key)
    assert not torch.equal(ev, drawn)


def test_zoo_options_raise_naming_their_item():
    with pytest.raises(NotImplementedError, match="item 10"):
        zoo.mobilenet(bn_axis_name="dp")
    with pytest.raises(ValueError, match="not divisible"):
        zoo.vit(image_size=30, patch_size=16)


def test_bilstm_config5_predictor_equals_predict():
    """BASELINE config 5 (JAX ``tests/test_inference.py:225-241``):
    ``ModelPredictor`` over 301 rows, a ragged last batch, equals
    ``Model.predict`` and JAX's forward on the same weights."""
    jm, pm = _pair("bilstm_classifier", dict(units=16, num_classes=2),
                   (12, 4), seed=0)
    from_jax_params(pm, jax.device_get(jm.params))
    X = np.random.RandomState(0).randn(301, 12, 4).astype(np.float32)
    out = ModelPredictor(pm, batch_size_per_device=16).predict(
        Dataset({"features": X}))
    assert out["prediction"].shape == (301, 2)
    assert np.array_equal(out["prediction"], pm.predict(X, batch_size=16))
    assert _rel(out["prediction"], jm.predict(X)) <= MODEL_TOL
