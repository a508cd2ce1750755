"""The port's recurrent layers (``models/recurrent.py``: ``LSTM``,
``GRU``, ``Bidirectional``) against the JAX package's.

The same key must give JAX's weights (``glorot_uniform`` is a uniform
draw: bitwise), and on the same seeded numpy inputs and weights the
forward and the gradients (of a seeded projection of the output, with
respect to the input and every parameter) must agree: float32 within
1e-5 of the reference's largest magnitude (outputs) and 1e-4
(gradients, which sum over every step of the time loop); bfloat16
within 2e-2 (both packages round the carry to bf16 after every step,
XLA may keep some elementwise chains in float32).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import Sequential as JaxSequential
from distkeras_tpu.models import recurrent as jax_recurrent

from distkeras_tpu_torch.models import Sequential, recurrent
from distkeras_tpu_torch.ops import prng

OUT_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 2e-2


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


def _layer(pkg, spec):
    """A layer (or a two-layer stack, for ``stacked``) of ``pkg``."""
    cls, kw, stacked = spec
    if cls == "Bidirectional":
        inner = getattr(pkg, kw["inner"])(**kw["inner_kw"])
        layer = pkg.Bidirectional(inner)
        if stacked:
            top = pkg.Bidirectional(getattr(pkg, kw["inner"])(
                **dict(kw["inner_kw"], return_sequences=False)))
            seq = JaxSequential if pkg is jax_recurrent else Sequential
            return seq([layer, top])
        return layer
    return getattr(pkg, cls)(**kw)


#: (class, keywords, stacked); units 6 over 5 steps of 4 features
CASES = {
    "lstm_last": ("LSTM", dict(units=6), False),
    "lstm_sequences": ("LSTM", dict(units=6, return_sequences=True), False),
    "lstm_reverse_last": ("LSTM", dict(units=6, reverse=True), False),
    "lstm_reverse_sequences": ("LSTM", dict(units=6, reverse=True,
                                            return_sequences=True), False),
    "gru_last": ("GRU", dict(units=6), False),
    "gru_sequences": ("GRU", dict(units=6, return_sequences=True), False),
    "gru_reverse_sequences": ("GRU", dict(units=6, reverse=True,
                                          return_sequences=True), False),
    "gru_he_uniform": ("GRU", dict(units=6, kernel_init="he_uniform"),
                       False),
    "bidirectional_lstm_stacked": ("Bidirectional", dict(
        inner="LSTM", inner_kw=dict(units=6, return_sequences=True)), True),
    "bidirectional_gru": ("Bidirectional", dict(
        inner="GRU", inner_kw=dict(units=6)), False),
}


def _run_pair(case, dtype):
    spec = CASES[case]
    if dtype != "float32":
        cls, kw, stacked = spec
        if cls == "Bidirectional":
            kw = dict(kw, inner_kw=dict(kw["inner_kw"], dtype=dtype))
        else:
            kw = dict(kw, dtype=dtype)
        spec = (cls, kw, stacked)
    jl, pl = _layer(jax_recurrent, spec), _layer(recurrent, spec)
    shape = (5, 4)
    jp, js, jout = jl.init(jax.random.PRNGKey(3), shape)
    pout = pl.build(shape, prng.key(3))
    assert tuple(pout) == tuple(jout)
    # the same key draws JAX's weights, bitwise (uniform families)
    pleaves = jax.tree_util.tree_leaves(pl.param_tree())
    jleaves = jax.tree_util.tree_leaves(jp)
    assert len(pleaves) == len(jleaves)
    for got, ref in zip(pleaves, jleaves):
        assert np.array_equal(_np(got), np.asarray(ref)), case

    rs = np.random.RandomState(zlib.crc32(case.encode()))
    x = rs.randn(3, *shape).astype(np.float32)
    r = rs.randn(3, *jout).astype(np.float32)

    @jax.jit
    def jax_side(params, xin):
        y, vjp = jax.vjp(lambda p, xx: jl.apply(p, js, xx)[0], params,
                         xin)
        return y, vjp(jnp.asarray(r).astype(y.dtype))

    jy, (jgp, jgx) = jax_side(jp, x)
    pp = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32))
        .requires_grad_(True), jax.device_get(jp))
    xt = torch.from_numpy(x).requires_grad_(True)
    py = pl.apply(pp, xt)
    assert py.dtype == getattr(torch, dtype)
    leaves = jax.tree_util.tree_leaves(pp)
    grads = torch.autograd.grad((py.float() * torch.from_numpy(r)
                                 .to(py.dtype).float()).sum(),
                                [xt] + leaves)
    return (py, jy), list(zip(grads, [jgx] + jax.tree_util.tree_leaves(jgp)))


@pytest.mark.parametrize("case", list(CASES))
def test_recurrent_layer_matches_jax(case):
    (py, jy), grads = _run_pair(case, "float32")
    assert _rel(py, jy) <= OUT_TOL
    for got, ref in grads:
        assert _rel(got, ref) <= GRAD_TOL


@pytest.mark.parametrize("case", ["lstm_sequences", "gru_last"])
def test_recurrent_layer_bf16_matches_jax(case):
    (py, jy), grads = _run_pair(case, "bfloat16")
    assert _rel(py, np.asarray(jy, np.float32)) <= BF16_TOL
    got, ref = grads[0]                      # the input's gradient
    assert _rel(got, np.asarray(ref, np.float32)) <= BF16_TOL


def test_recurrent_configs_and_specs_match_jax():
    """``get_config`` is JAX's dict; a spec rebuilds the layer (the
    backward copy reversed, the forward one as given)."""
    from distkeras_tpu.models.core import layer_spec as jax_spec
    from distkeras_tpu_torch.models import layer_from_spec, layer_spec
    for case, spec in CASES.items():
        jl, pl = _layer(jax_recurrent, spec), _layer(recurrent, spec)
        assert layer_spec(pl) == jax_spec(jl), case
        again = layer_from_spec(jax_spec(jl))
        assert layer_spec(again) == jax_spec(jl), case
    bi = recurrent.Bidirectional(recurrent.LSTM(4, reverse=False))
    assert bi.fwd.reverse is False and bi.bwd.reverse is True
    assert set(bi.param_tree()) == {"forward", "backward"}
