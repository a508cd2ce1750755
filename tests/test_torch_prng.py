"""The port's threefry PRNG (``distkeras_tpu_torch.ops.prng``) against
``jax.random`` on the CPU: keys, splits, raw bits, uniforms and Bernoulli
masks bitwise; Gumbel and normal fields within the stated ulps
(``prng.GUMBEL_ULPS``, ``prng.NORMAL_ULPS``: ``log`` and ``erfinv`` are
not bitwise between XLA and torch); categorical draws equal. Then the
consumers: the initializers and ``Model.build`` against JAX's, and the
dropout mask of ``Dropout`` and of a training ``TransformerBlock``.

The K7 kernel (the same draws on the card) is held against this plain
version in ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from distkeras_tpu.models import Model as JaxModel
from distkeras_tpu.models import zoo as jax_zoo
from distkeras_tpu.models.layers import Dropout as JaxDropout
from distkeras_tpu.models.layers import init_weights as jax_init_weights

from distkeras_tpu_torch.models import Model, to_jax_params, zoo
from distkeras_tpu_torch.models.layers import Dropout, init_weights
from distkeras_tpu_torch.ops import prng

#: seeds that exercise JAX's narrowing: 0, a word boundary past 2^32, a
#: negative seed, the high bit, a 40-bit seed
SEEDS = [0, 1, 42, 2 ** 32 + 1, -1, 2 ** 31, 2 ** 40 + 7]
SHAPES = [(7,), (3, 5), (2, 3, 4), (4, 29), (1, 1000)]
FLOATS = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
          (torch.float16, jnp.float16)]


def _jkey(k):
    return jnp.asarray(k.numpy(), jnp.uint32)


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_bitwise(seed):
    jk = jax.random.PRNGKey(seed)
    k = prng.key(seed)
    np.testing.assert_array_equal(k.numpy(), _np(jk))
    for num in (2, 3, 7):
        np.testing.assert_array_equal(prng.split(k, num).numpy(),
                                      _np(jax.random.split(jk, num)))
    # a batch of keys splits row by row (JAX's vmap(split))
    ks = prng.split(k, 4)
    np.testing.assert_array_equal(
        prng.split(ks).numpy(), _np(jax.vmap(jax.random.split)(_jkey(ks))))
    np.testing.assert_array_equal(prng.as_key(np.asarray(jk)).numpy(),
                                  k.numpy())


def test_threefry2x32_known_answer():
    """The hash itself against JAX's ``threefry_2x32`` on counters that
    straddle both words."""
    from jax._src import prng as jprng
    key = np.array([0x13198A2E, 0x03707344], np.uint32)
    count = np.array([0, 1, 0xFFFFFFFF, 0x243F6A88, 7, 0x85A308D3],
                     np.uint32)
    want = np.asarray(jprng.threefry_2x32(jnp.asarray(key),
                                          jnp.asarray(count)))
    x1, x2 = np.split(count.astype(np.int64), 2)
    k = torch.from_numpy(key.astype(np.int64))
    o1, o2 = prng.threefry2x32(k[0], k[1], torch.from_numpy(x1),
                               torch.from_numpy(x2))
    np.testing.assert_array_equal(np.concatenate([o1.numpy(), o2.numpy()]),
                                  want.astype(np.int64))


def _float16_candidates(k, shape, lo, hi):
    """The two float16 uniforms XLA may compute from the same 16-bit
    words: ``floats * (hi - lo) + lo`` with one rounding (the fused
    multiply-add), or with the product and the sum each rounded to
    float16; each floored at ``lo``."""
    bits = prng.random_bits(k, shape, 16).numpy().astype(np.uint16)
    floats = ((bits >> 6) | np.uint16(0x3C00)).view(np.float16) \
        - np.float16(1.0)
    lo16, hi16 = np.float16(lo), np.float16(hi)
    span = hi16 - lo16
    fused = (floats.astype(np.float64) * np.float64(span)
             + np.float64(lo16)).astype(np.float16)
    product = (floats * span).astype(np.float16)
    stepwise = product + lo16
    return (np.maximum(lo16, fused), np.maximum(lo16, stepwise),
            np.abs(product))


def _check_float16_uniform(k, shape, lo, hi, got, want):
    """The port computes float16 uniforms with one rounding (the fused
    multiply-add) on every device. XLA's float16 lowering differs from
    host to host: JAX's output must equal one of the two candidates
    bitwise, the port the fused one; where the host took the stepwise
    lowering, the port lies within one float16 ulp of JAX, the ulp of
    the larger of the rounded product and the result (the stepwise
    result carries half an ulp of each rounding)."""
    fused, stepwise, product = _float16_candidates(k, shape, lo, hi)
    want = np.asarray(want).astype(np.float16)
    got = got.numpy()
    if np.array_equal(want, fused):
        lowering = "fused"
    elif np.array_equal(want, stepwise):
        lowering = "stepwise"
    else:
        raise AssertionError(
            f"JAX's float16 uniform on [{lo}, {hi}) is neither the fused "
            "nor the stepwise candidate computed from the same bits")
    np.testing.assert_array_equal(got, fused)
    if lowering == "stepwise":
        ulp = np.spacing(np.maximum(product, np.maximum(np.abs(want),
                                                        np.abs(got))))
        far = np.abs(got.astype(np.float32) - want.astype(np.float32)) \
            > ulp.astype(np.float32)
        assert not far.any(), (
            "XLA on this host rounds the float16 multiply and add one at "
            f"a time (stepwise lowering): {int(far.sum())} element(s) lie "
            "more than one float16 ulp from the port's fused result")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:5])
def test_bits_uniform_bernoulli_bitwise(seed, shape):
    """One key over the whole shape (the partitionable counters: ``[B,
    V]`` under one key is not B draws over ``[V]``)."""
    jk = jax.random.PRNGKey(seed)
    k = prng.key(seed)
    np.testing.assert_array_equal(prng.random_bits(k, shape).numpy(),
                                  _np(jax.random.bits(jk, shape)))
    for width, jdt in ((8, jnp.uint8), (16, jnp.uint16)):
        np.testing.assert_array_equal(
            prng.random_bits(k, shape, width).numpy(),
            _np(jax.random.bits(jk, shape, jdt)))
    for dt, jdt in FLOATS:
        for lo, hi in ((0.0, 1.0), (-0.3, 0.7), (-0.3, 0.3), (-2.7, 5.1)):
            got = prng.uniform(k, shape, dt, lo, hi)
            want = jax.random.uniform(jk, shape, jdt, lo, hi)
            assert got.dtype == dt
            if dt == torch.float16:
                _check_float16_uniform(k, shape, lo, hi, got, want)
                continue
            np.testing.assert_array_equal(
                got.float().numpy(), np.asarray(want).astype(np.float32))
    for p in (0.1, 0.5, 0.9):
        np.testing.assert_array_equal(
            prng.bernoulli(k, p, shape).numpy(),
            np.asarray(jax.random.bernoulli(jk, p, shape)))


@pytest.mark.parametrize("seed", [0, 5, 2 ** 32 + 1])
def test_gumbel_normal_within_stated_ulps(seed):
    jk = jax.random.PRNGKey(seed)
    k = prng.key(seed)
    shape = (64, 4096)
    for fn, bound in ((prng.gumbel, prng.GUMBEL_ULPS),
                      (prng.normal, prng.NORMAL_ULPS)):
        got = fn(k, shape)
        want = torch.from_numpy(np.asarray(
            getattr(jax.random, fn.__name__)(jk, shape)))
        assert got.dtype == torch.float32
        err = prng.ulps(got, want)
        assert err.max() <= bound, (fn.__name__, float(err.max()))
    # bfloat16 fields: float32 math rounded to bf16 on both sides
    for name in ("gumbel", "normal"):
        got = getattr(prng, name)(k, (4096,), torch.bfloat16).float()
        want = np.asarray(getattr(jax.random, name)(
            jk, (4096,), jnp.bfloat16)).astype(np.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=2 ** -7,
                                   atol=2 ** -7)


def test_batched_keys_match_vmap():
    """``[R, 2]`` keys draw ``[R, *shape]``, each row over its own
    counters: JAX's ``vmap`` over the keys."""
    ks = prng.split(prng.key(3), 5)
    jks = _jkey(ks)
    np.testing.assert_array_equal(
        prng.uniform(ks, (33,)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (33,)))(jks)))
    np.testing.assert_array_equal(
        prng.random_bits(ks, (2, 9)).numpy(),
        _np(jax.vmap(lambda k: jax.random.bits(k, (2, 9)))(jks)))
    g = prng.gumbel(ks, (33,))
    jg = jax.vmap(lambda k: jax.random.gumbel(k, (33,)))(jks)
    assert prng.ulps(g, torch.from_numpy(np.asarray(jg))).max() \
        <= prng.GUMBEL_ULPS


@pytest.mark.parametrize("seed", [0, 9, 123])
def test_categorical_equals_jax(seed):
    rs = np.random.RandomState(seed)
    logits = (rs.randn(6, 40) * 3).astype(np.float32)
    for i in range(10):
        k = prng.key(seed * 100 + i)
        got = prng.categorical(k, torch.from_numpy(logits))
        want = jax.random.categorical(_jkey(k), jnp.asarray(logits))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(-2 ** 63, 2 ** 63 - 1),
       shape=st.lists(st.integers(1, 9), min_size=1, max_size=3))
def test_hypothesis_bits_and_uniform_bitwise(seed, shape):
    jk = jax.random.PRNGKey(seed)
    k = prng.key(seed)
    np.testing.assert_array_equal(k.numpy(), _np(jk))
    np.testing.assert_array_equal(prng.random_bits(k, shape).numpy(),
                                  _np(jax.random.bits(jk, tuple(shape))))
    np.testing.assert_array_equal(
        prng.uniform(k, shape).numpy(),
        np.asarray(jax.random.uniform(jk, tuple(shape))))
    np.testing.assert_array_equal(prng.split(k, 3).numpy(),
                                  _np(jax.random.split(jk, 3)))


def test_ulps_measure():
    one = torch.tensor([1.0, 2.0, 0.0, -3.0])
    nxt = torch.nextafter(one, torch.tensor(float("inf")))
    np.testing.assert_array_equal(prng.ulps(nxt, one).numpy(),
                                  [1.0, 1.0, 2.0 ** -149 / 2.0 ** -23,
                                   1.0])


# --- the consumers: initializers, Model.build, dropout -----------------------

INITS = ["glorot_uniform", "he_uniform", "uniform_scaling", "glorot_normal",
         "he_normal", "lecun_normal", "zeros", "ones"]


@pytest.mark.parametrize("name", INITS)
def test_init_weights_match_jax(name):
    """Eager draws: the uniform families bitwise JAX's, the normal ones
    within ``NORMAL_ULPS``."""
    for seed, shape in ((0, (16, 24)), (7, (3, 3, 4, 8)), (2, (50,))):
        jk = jax.random.PRNGKey(seed)
        want = np.asarray(jax_init_weights(name, jk, shape))
        got = init_weights(name, prng.key(seed), shape)
        if name.endswith("normal"):
            assert prng.ulps(got, torch.from_numpy(want)).max() \
                <= prng.NORMAL_ULPS
        else:
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", [{}, {"num_kv_heads": 2},
                                {"moe_every": 1, "num_experts": 4,
                                 "mlp_ratio": 2},
                                {"use_rope": False, "max_len": 16}],
                         ids=["mha", "gqa", "moe", "posemb"])
def test_build_seed_matches_jax_model_build(kw):
    """``Model.build(seed=)`` against JAX's ``Model.build``: every weight
    bitwise (the LM's initializers are uniform), and ``rng=`` a JAX key
    gives the same model."""
    spec = dict(d_model=32, num_heads=4, num_layers=2, **kw)
    jm = JaxModel.build(jax_zoo.transformer_lm(29, **spec), (12,), seed=5)
    pm = Model.build(zoo.transformer_lm(29, **spec), (12,), seed=5,
                     device="cpu")
    jl = jax.tree_util.tree_leaves(jm.params)
    pl = jax.tree_util.tree_leaves(to_jax_params(pm))
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    km = Model.build(zoo.transformer_lm(29, **spec), (12,),
                     jax.random.PRNGKey(5), device="cpu")
    for x, y in zip(km.module.parameters(), pm.module.parameters()):
        assert torch.equal(x, y)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_mask_matches_jax(rate):
    rs = np.random.RandomState(0)
    x = rs.randn(4, 6, 8).astype(np.float32)
    jk = jax.random.PRNGKey(11)
    want, _ = JaxDropout(rate).apply({}, {}, jnp.asarray(x), training=True,
                                     rng=jk)
    layer = Dropout(rate)
    layer.train()
    got = layer.apply({}, torch.from_numpy(x), rng=prng.key(11))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    layer.eval()
    assert torch.equal(layer.apply({}, torch.from_numpy(x),
                                   rng=prng.key(11)), torch.from_numpy(x))
