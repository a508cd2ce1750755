"""MoE serving in the port against the JAX package: the dispatch plan and
its inversion, the K6a plain version against the Pallas kernel in
interpret mode, the ``MoE`` layer's three dispatches and
``decode_apply``, the MoE LM (parameter tree, full-stack logits, the
weight bridge), ``generate()`` and the paged ``ServingEngine`` on the
memorized all-MoE LM (token-identical to JAX ``generate()``), the
expert telemetry and admission headroom, and every refusal of the
unported MoE options (training through MoE is held in
``tests/test_torch_moe_training.py``).

JAX's K6a runs as its own tests run it on the CPU: under
``moe_kernels.force_interpret()``. Inputs are made with numpy from a
seed; weights cross with ``from_jax_params``. Float32 tolerance 1e-5
(the JAX suite's own): reassociated float32 sums over <= 64 terms."""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distkeras_tpu.models import Model as JaxModel
from distkeras_tpu.models import zoo as jax_zoo
from distkeras_tpu.models.decoding import _moe_route_stats as jax_stats
from distkeras_tpu.models.decoding import generate
from distkeras_tpu.models.moe import MoE as JaxMoE
from distkeras_tpu.models.moe import _dispatch_plan as jax_plan
from distkeras_tpu.ops import moe_kernels as jmk

from distkeras_tpu_torch import kernels
from distkeras_tpu_torch.models import (Model, collect_aux_losses,
                                        from_jax_params, to_jax_params, zoo)
from distkeras_tpu_torch.models import decoding as pd
from distkeras_tpu_torch.models.moe import MoE, _dispatch_plan, \
    moe_all_to_all
from distkeras_tpu_torch.ops import moe_kernels as mk
from distkeras_tpu_torch.ops import prng
from distkeras_tpu_torch.parallel import make_train_step
from distkeras_tpu_torch.serving import NgramDraft, Request, ServingEngine

TOL = 1e-5
V = 29
PATTERN = np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8])


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _tree(p):
    return {k: _t(np.asarray(v)) for k, v in p.items()}


def _routing(rs, n, e, k):
    """[N, K] distinct expert ids and gates per token."""
    ex = np.stack([rs.permutation(e)[:k] for _ in range(n)]).astype(np.int32)
    return ex, rs.rand(n, k).astype(np.float32)


# --- the plan and its inversion ----------------------------------------------


@pytest.mark.parametrize("capacity", [1, 3, 5, 24],
                         ids=["cap1", "odd-drops", "odd", "no-drops"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_dispatch_plan_matches_jax(k, capacity):
    """dest, token, gate and keep equal JAX's exactly, also under
    capacity drops (unique out-of-range sentinels)."""
    ex, g = _routing(np.random.RandomState(k * 7 + capacity), 12, 8, k)
    want = jax_plan(jnp.asarray(ex), jnp.asarray(g), 8, capacity)
    got = _dispatch_plan(_t(ex), _t(g), 8, capacity)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _plan_case(kind, rs):
    """``(experts [N, K], gates, capacity)`` of a realistic plan: 4096
    tokens over 8 experts (the capacity ``MoE._capacity`` gives at the
    factor) routed by logits whose per-expert offsets make some experts
    popular, every token's first choice on one expert, or top-4."""
    n, e = 4096, 8
    if kind == "one-expert":
        ex = np.stack([np.full(n, 5), rs.randint(0, 5, n)], 1)
        k, cf = 2, 1.25
    else:
        k, cf = (4, 1.0) if kind == "top4" else (2, float(kind[2:]))
        logits = rs.randn(n, e) + np.linspace(0.0, 1.0, e)
        ex = np.argsort(-logits, axis=1)[:, :k]
    per = -(-k * n // e)
    return (ex.astype(np.int32), rs.rand(n, k).astype(np.float32),
            max(1, int(per * cf)))


@pytest.mark.parametrize("kind", ["cf1.0", "cf1.25", "one-expert", "top4"])
def test_dispatch_plan_matches_jax_at_scale(kind):
    """At a training batch's size (N 4096, K 2 or 4, E 8): the plan's
    scan gives JAX's dest, token, gate and keep exactly, with slots
    dropped past capacity (every one past it when all first choices
    pick one expert)."""
    ex, g, capacity = _plan_case(kind, np.random.RandomState(len(kind)))
    want = jax_plan(jnp.asarray(ex), jnp.asarray(g), 8, capacity)
    got = _dispatch_plan(_t(ex), _t(g), 8, capacity)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    keep = got[3].numpy()
    assert 0 < keep.sum() < keep.size
    if kind == "one-expert":
        assert keep[:4096].sum() == capacity


def _layer_pair(e=8, d=16, hid=32, seed=0, **kw):
    jm = JaxMoE(e, hid, **kw)
    params, _, _ = jm.init(jax.random.PRNGKey(seed), (4, d))
    pm = MoE(e, hid, **kw)
    pm.build((4, d), prng.key(seed))
    pm.eval()
    return jm, params, pm, _tree(params)


def test_tied_router_logits_take_the_lower_expert():
    """Tied logits (two identical gate columns): the top-k goes to the
    lower expert id, as ``lax.top_k`` orders it, so the plans agree."""
    jm, params, pm, tp = _layer_pair(top_k=2, dispatch="tokens")
    gate = np.array(params["gate"])
    gate[:, 5] = gate[:, 2]
    params = dict(params, gate=jnp.asarray(gate))
    tp["gate"] = _t(gate)
    x = np.random.RandomState(1).randn(2, 6, 16).astype(np.float32)
    _, jtopi, _, _ = jm._route(jnp.asarray(x), params["gate"])
    _, ptopi, _, _ = pm._route(_t(x), tp["gate"])
    np.testing.assert_array_equal(ptopi.numpy(), np.asarray(jtopi))
    want, _ = jm.apply(params, {}, jnp.asarray(x))
    np.testing.assert_allclose(pm.apply(tp, _t(x)).numpy(),
                               np.asarray(want), atol=TOL)


@pytest.mark.parametrize("capacity", [1, 3, 8])
def test_plan_inversion_matches_jax(capacity):
    """``src_tokens`` and ``row_gates`` equal the inversion of JAX's
    fused forward (its first ``capacity`` rows per expert: JAX pads the
    capacity to a multiple of 8)."""
    rs = np.random.RandomState(capacity)
    n, e, k, d, hid = 10, 8, 2, 8, 16
    ex, g = _routing(rs, n, e, k)
    dest, _, sg, keep = jax_plan(jnp.asarray(ex), jnp.asarray(g), e,
                                 capacity)
    xt = rs.randn(n, d).astype(np.float32)
    w1 = rs.randn(e, d, hid).astype(np.float32)
    w2 = rs.randn(e, hid, d).astype(np.float32)
    z = np.zeros((e, hid), np.float32)
    ck = jmk.kernel_capacity(capacity)
    _, res = jmk._fused_fwd("gelu", capacity, jmk.choose_block_c(ck), True,
                            jnp.asarray(xt), w1, z, w2, z[:, :d], sg, dest,
                            keep)
    src_j = np.asarray(res[8]).reshape(e, ck)[:, :capacity].reshape(-1)
    gate_j = np.asarray(res[9]).reshape(e, ck)[:, :capacity].reshape(-1)
    pdest, pkeep, psg = (_t(np.asarray(a)) for a in (dest, keep, sg))
    src = mk.src_tokens(pdest, n, e, capacity)
    assert src.dtype == torch.int32
    np.testing.assert_array_equal(src.numpy(), src_j)
    np.testing.assert_array_equal(
        mk.row_gates(pdest, pkeep, psg, e, capacity).numpy(), gate_j)


# --- K6a's plain version -------------------------------------------------------


@pytest.mark.parametrize("activation", ["gelu", "relu", "silu"])
@pytest.mark.parametrize("n,capacity,d,hid", [(4, 4, 16, 32), (15, 7, 24, 40),
                                              (40, 13, 32, 24)])
def test_gather_gemm1_reference_matches_pallas_kernel(n, capacity, d, hid,
                                                      activation):
    """The plain version of K6a against JAX ``_gather_gemm1`` in
    interpret mode on the same ``src_tok`` (JAX's capacity padded to a
    multiple of 8, its first C rows compared); rows of -1 equal
    ``act(b1)``."""
    rs = np.random.RandomState(n + capacity)
    e = 4
    xt = rs.randn(n, d).astype(np.float32)
    src = rs.randint(-1, n, (e, capacity)).astype(np.int32)
    src[1] = -1                                 # an expert no slot reached
    w1 = (rs.randn(e, d, hid) * 0.3).astype(np.float32)
    b1 = rs.randn(e, hid).astype(np.float32)
    ck = jmk.kernel_capacity(capacity)
    src_k = np.full((e, ck), -1, np.int32)
    src_k[:, :capacity] = src
    want = jmk._gather_gemm1(jnp.asarray(xt), jnp.asarray(src_k.reshape(-1)),
                             jnp.asarray(w1), jnp.asarray(b1), capacity=ck,
                             block_c=jmk.choose_block_c(ck),
                             act_name=activation, interpret=True)
    before = kernels.launch_counts()["moe_gather_gemm1"]
    got = mk.gather_gemm1(_t(xt), _t(src.reshape(-1)), _t(w1), _t(b1),
                          capacity, activation)
    assert kernels.launch_counts()["moe_gather_gemm1"] == before
    assert got.shape == (e, capacity, hid)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want)[:, :capacity], atol=TOL)
    act = pd.get_activation(activation)
    empty = src < 0
    np.testing.assert_array_equal(
        got.numpy()[empty],
        np.broadcast_to(act(_t(b1))[:, None].numpy(),
                        (e, capacity, hid))[empty])


def test_gather_gemm1_plan_validation():
    with pytest.raises(ValueError, match="activation"):
        mk.fused_moe_apply(*([None] * 8), capacity=2, activation="bogus")
    assert mk.split_plan(4, 1024, 2048, 8, 132) == (4, 5, 208)
    assert mk.split_plan(640, 1024, 2048, 8, 132)[1:] == (1, 1024)


def test_gather_gemm1_launch_plan():
    """bf16 takes the tensor-core kernel at every width, one warpgroup
    a block up to 64 capacity rows (decode, verify), two above (tree,
    prefill, training); float32 the CUDA-core kernel's split plan. A
    function of the shapes and the SM count alone."""
    for c, wg in ((4, 1), (64, 1), (72, 2), (80, 2), (640, 2), (2048, 2)):
        assert mk.gemm1_plan(c, 1024, 2048, 8, 132, True) == (wg, 1, 1,
                                                              1024)
    assert mk.gemm1_plan(33, 1000, 136, 8, 132, True)[0] == 1
    assert mk.gemm1_plan(90, 70, 136, 8, 132, True) == (2, 1, 1, 70)
    assert mk.gemm1_plan(3, 40, 99, 8, 132, True) == (1, 1, 1, 40)
    assert mk.gemm1_plan(4, 1024, 2048, 8, 132, False) == (0, 4, 5, 208)
    assert mk.gemm1_plan(640, 1024, 2048, 8, 132, False) == (
        (0,) + mk.split_plan(640, 1024, 2048, 8, 132))


# --- the MoE layer -------------------------------------------------------------


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("dispatch", ["dense", "tokens", "fused"])
def test_moe_apply_matches_jax(dispatch, top_k):
    """Each dispatch against JAX's (``fused`` under ``force_interpret``
    and against JAX ``tokens``), and against the dense oracle at a
    capacity that drops nothing."""
    jm, params, pm, tp = _layer_pair(top_k=top_k, dispatch=dispatch,
                                     capacity_factor=8.0)
    x = np.random.RandomState(top_k).randn(3, 5, 16).astype(np.float32)
    got = pm.apply(tp, _t(x)).numpy()
    ctx = jmk.force_interpret() if dispatch == "fused" \
        else contextlib.nullcontext()
    with ctx:
        want, _ = jm.apply(params, {}, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL)
    dense, _ = JaxMoE(8, 32, top_k=top_k).apply(params, {}, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(dense), atol=TOL)
    if dispatch == "fused":
        tokens, _ = JaxMoE(8, 32, top_k=top_k, dispatch="tokens",
                           capacity_factor=8.0).apply(params, {},
                                                      jnp.asarray(x))
        np.testing.assert_allclose(got, np.asarray(tokens), atol=TOL)


@pytest.mark.parametrize("dispatch", ["tokens", "fused"])
def test_capacity_drops_match_jax(dispatch):
    """At capacity factor 1.0 with skewed routing slots are dropped; the
    port drops the same ones (JAX ``tokens`` as the reference)."""
    jm, params, pm, tp = _layer_pair(top_k=2, dispatch=dispatch,
                                     capacity_factor=1.0)
    gate = np.array(params["gate"])
    gate[:, 0] += 0.5
    params = dict(params, gate=jnp.asarray(gate))
    tp["gate"] = _t(gate)
    x = np.random.RandomState(3).randn(2, 8, 16).astype(np.float32)
    want, _ = JaxMoE(8, 32, top_k=2, dispatch="tokens",
                     capacity_factor=1.0).apply(params, {}, jnp.asarray(x))
    dense, _ = JaxMoE(8, 32, top_k=2).apply(params, {}, jnp.asarray(x))
    got = pm.apply(tp, _t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL)
    assert not np.allclose(got, np.asarray(dense), atol=1e-3)


@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_decode_apply_matches_jax(top_k):
    jm, params, pm, tp = _layer_pair(top_k=top_k)
    x = np.random.RandomState(5).randn(3, 5, 16).astype(np.float32)
    want = jm.decode_apply(params, jnp.asarray(x))
    dense, _ = jm.apply(params, {}, jnp.asarray(x))
    got = pm.decode_apply(tp, _t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL)
    np.testing.assert_allclose(got, np.asarray(dense), atol=TOL)


def test_decode_apply_drop_free_under_concentrated_routing():
    """A gate sending every token to expert 0 (and every second choice
    to expert 1): the decode capacity drops nothing, so the output equals
    dense routing, where the training capacity would drop."""
    jm, params, pm, tp = _layer_pair(e=4, d=8, hid=16, seed=2, top_k=2)
    gate = np.zeros((8, 4), np.float32)
    gate[:, 0], gate[:, 1] = 50.0, 25.0
    params = dict(params, gate=jnp.asarray(gate))
    tp["gate"] = _t(gate)
    x = np.random.RandomState(3).randn(2, 6, 8).astype(np.float32)
    dense, _ = jm.apply(params, {}, jnp.asarray(x))
    got = pm.decode_apply(tp, _t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(dense), atol=TOL)
    droppy = MoE(4, 16, top_k=2, dispatch="tokens", capacity_factor=1.0)
    droppy.eval()
    assert not np.allclose(droppy.apply(tp, _t(x)).numpy(),
                           np.asarray(dense))


def test_decode_apply_routing_shapes_match_jax():
    jm, params, pm, tp = _layer_pair(top_k=2, seed=4)
    x = np.random.RandomState(6).randn(3, 5, 16).astype(np.float32)
    out, (topi, full) = pm.decode_apply(tp, _t(x), return_routing=True)
    _, (jtopi, jfull) = jm.decode_apply(params, jnp.asarray(x),
                                        return_routing=True)
    assert out.shape == (3, 5, 16)
    assert topi.shape == (3, 5, 2) and full.shape == (3, 5, 8)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(jtopi))
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), atol=1e-6)


def test_moe_route_stats_match_jax():
    """The step's expert load and router entropy over live slots (a
    sentinel slot's routing must not count)."""
    rs = np.random.RandomState(7)
    routing_j, routing_p = [], []
    for _ in range(2):
        topi = np.stack([[rs.permutation(8)[:2] for _ in range(3)]
                         for _ in range(4)]).astype(np.int64)
        full = rs.dirichlet(np.ones(8), (4, 3)).astype(np.float32)
        routing_j.append((8, (jnp.asarray(topi), jnp.asarray(full))))
        routing_p.append((8, (_t(topi), _t(full))))
    t = np.array([3, 40, 0, 17], np.int32)
    want = jax_stats(routing_j, jnp.asarray(t), 3, 32)
    got = pd._moe_route_stats(routing_p, _t(t), 3, 32)
    np.testing.assert_allclose(got["expert_load"].numpy(),
                               np.asarray(want["expert_load"]), atol=TOL)
    np.testing.assert_allclose(float(got["router_entropy"]),
                               float(want["router_entropy"]), rtol=TOL)
    assert pd._moe_route_stats([], _t(t), 3, 32) is None


def test_fused_gradient_raises_naming_the_roadmap():
    """The fused block's gradient, which waited for ROADMAP Queue 1 item
    2, now flows (the plain versions of K6b and K6c on the CPU, no kernel
    launch) and equals the ``tokens`` dispatch's on the same plan."""
    jm, params, pm, tp = _layer_pair(top_k=2, dispatch="fused")
    tokens = MoE(8, 32, top_k=2, dispatch="tokens")
    x = _t(np.random.RandomState(4).randn(1, 3, 16).astype(np.float32))
    grads = []
    for layer in (pm, tokens):
        leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        before = kernels.launch_counts()
        layer.apply(leaves, x).square().sum().backward()
        assert kernels.launch_counts() == before
        grads.append({k: v.grad for k, v in leaves.items()})
    for k in tp:
        torch.testing.assert_close(grads[0][k], grads[1][k], rtol=TOL,
                                   atol=TOL)
    assert grads[0]["w1"].abs().sum() > 0 and grads[0]["gate"].abs().sum() > 0


def test_unported_moe_options_raise_naming_the_roadmap():
    with pytest.raises(NotImplementedError, match="item 10"):
        MoE(8, 32, expert_axis_name="expert")
    with pytest.raises(NotImplementedError, match="item 10"):
        zoo.transformer_lm(V, d_model=16, num_heads=2, num_layers=1,
                           moe_every=1, num_experts=4,
                           moe_expert_axis="expert")
    with pytest.raises(NotImplementedError, match="item 10"):
        moe_all_to_all(MoE(8, 32), {}, None, axis_name="expert")
    # training through MoE (ROADMAP Queue 1 item 2) is ported: the layer
    # in training mode publishes its balance loss, an MoE LM gets a step
    pm = MoE(8, 32, aux_loss_weight=0.01)
    pm.build((4, 16), prng.key(0))
    pm.train()
    out = pm.apply(pm.param_tree(), torch.zeros(1, 2, 16))
    assert out.shape == (1, 2, 16) and collect_aux_losses(pm).item() > 0
    lm = zoo.transformer_lm(V, d_model=16, num_heads=2, num_layers=1,
                            moe_every=1, num_experts=4)
    assert callable(make_train_step(lm, lambda y, p: p.sum(), None))
    with pytest.raises(ValueError, match="dispatch"):
        MoE(8, 32, dispatch="bogus")


# --- the MoE LM and the weight bridge -------------------------------------------


def _lm_pair(moe_every, dispatch="dense", aux=0.0, unroll=False, seed=3):
    kw = dict(d_model=32, num_heads=4, num_layers=2, mlp_ratio=2,
              moe_every=moe_every, num_experts=4, moe_dispatch=dispatch,
              moe_aux_loss_weight=aux, moe_expert_unroll=unroll,
              moe_capacity_factor=4.0)
    jm = JaxModel.build(jax_zoo.transformer_lm(V, **kw), (8,), seed=seed)
    pm = Model.build(zoo.transformer_lm(V, **kw), (8,), seed=seed,
                     device="cpu")
    return jm, pm


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}[{i}]")
    else:
        yield prefix, tuple(np.shape(tree))


@pytest.mark.parametrize("moe_every,dispatch,unroll", [
    (1, "dense", False), (2, "dense", False), (1, "tokens", True),
    (2, "fused", False)])
def test_moe_lm_params_and_logits_match_jax(moe_every, dispatch, unroll):
    """The parameter tree's keys and shapes equal JAX's; full-stack
    logits within 1e-5 relative (JAX's fused dispatch in interpret
    mode)."""
    jm, pm = _lm_pair(moe_every, dispatch, unroll=unroll)
    assert dict(_flat(pm.params)) == dict(_flat(jm.params))
    from_jax_params(pm, jm.params, jm.state)
    x = np.random.RandomState(0).randint(0, V, (2, 8)).astype(np.int32)
    ctx = jmk.force_interpret() if dispatch == "fused" \
        else contextlib.nullcontext()
    with ctx:
        want = np.asarray(jm.predict(x))
    got = pm.apply(x).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= TOL * scale


def test_bridge_skips_only_the_aux_loss_state():
    """A JAX MoE LM built with a balance-loss weight carries its aux-loss
    scalar in the state: the bridge skips that key, still refuses any
    other state leaf, and ``to_jax_params`` round-trips the tree."""
    jm, pm = _lm_pair(1, aux=0.01)
    assert any("__aux_loss__" in k for k, _ in _flat(jm.state))
    from_jax_params(pm, jm.params, jm.state)
    back = to_jax_params(pm)
    assert dict(_flat(back)) == dict(_flat(jm.params))
    np.testing.assert_array_equal(back[1]["mlp"]["w1"],
                                  np.asarray(jm.params[1]["mlp"]["w1"]))
    bad = [dict(s) for s in jm.state]
    bad[1] = {"mlp": {"running_mean": np.zeros(3)}}
    with pytest.raises(ValueError, match="state"):
        from_jax_params(pm, jm.params, bad)


# --- generate() and the engine on the memorized all-MoE LM -------------------


@pytest.fixture(scope="module")
def moe_lms(pattern_moe_lm):
    pm = Model.build(zoo.transformer_lm(V, d_model=32, num_heads=4,
                                        num_layers=2, mlp_ratio=2,
                                        moe_every=1, num_experts=8),
                     (12,), device="cpu")
    from_jax_params(pm, pattern_moe_lm.params, pattern_moe_lm.state)
    return pattern_moe_lm, pm


def _ref(jm, prompt, n, **kw):
    return generate(jm, np.asarray(prompt)[None], max_new_tokens=n,
                    temperature=0.0, **kw)[0]


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_generate_matches_jax(moe_lms, cache_dtype):
    jm, pm = moe_lms
    prompts = np.stack([PATTERN[:5], PATTERN[3:8]]).astype(np.int32)
    want = generate(jm, prompts, 9, temperature=0.0,
                    cache_dtype=cache_dtype)
    np.testing.assert_array_equal(
        pm.generate(prompts, 9, cache_dtype=cache_dtype), want)


@pytest.mark.parametrize("weights_dtype", ["int8", "int4"])
def test_quantized_weights_on_moe_raise_naming_the_roadmap(moe_lms,
                                                           weights_dtype):
    """Quantized weights on an MoE model, refused until the stacked
    expert leaves were ported, now run: ``generate(weights_dtype=)`` is
    token-identical to JAX's, and ``ServingEngine(weight_quant=)`` keeps
    int8/int4 expert leaves resident and serves a request."""
    jm, pm = moe_lms
    prompts = np.stack([PATTERN[:5], PATTERN[3:8]]).astype(np.int32)
    want = generate(jm, prompts, 9, temperature=0.0,
                    weights_dtype=weights_dtype)
    np.testing.assert_array_equal(
        pm.generate(prompts, 9, weights_dtype=weights_dtype), want)
    eng = ServingEngine(pm, device="cpu", weight_quant=weights_dtype,
                        num_slots=2, max_len=32)
    w1 = next(p["mlp"]["w1"] for p in eng._params
              if isinstance(p, dict) and "mlp" in p)
    assert ("q4" if weights_dtype == "int4" else "q") in w1
    rid = eng.submit(PATTERN[:4], 6)
    assert eng.run(max_steps=100)[rid].size == 10


def _engine(pm, **kw):
    base = dict(num_slots=3, max_len=32, device="cpu")
    base.update(kw)
    return ServingEngine(pm, **base)


def _jax_engine(jm, **kw):
    from distkeras_tpu.serving.engine import ServingEngine as JaxEngine
    return JaxEngine(jm, **kw)


MOE_WQ_PROMPTS = [PATTERN[:4], np.tile(PATTERN, 2)[:14], PATTERN[:7],
                  PATTERN[:5]]
MOE_WQ_BUDGETS = [7, 9, 6, 8]


def _moe_streams(eng):
    rids = [eng.submit(p, b) for p, b in zip(MOE_WQ_PROMPTS[:3],
                                             MOE_WQ_BUDGETS[:3])]
    eng.step()
    rids.append(eng.submit(MOE_WQ_PROMPTS[3], MOE_WQ_BUDGETS[3]))
    out = eng.run(max_steps=500)
    return [out[r] for r in rids]


@pytest.mark.parametrize("layout", ["paged", "slab"])
@pytest.mark.parametrize("wq", ["int8", "int4"])
def test_moe_weight_quant_engine_matches_jax_engine(moe_lms, wq, layout):
    """The MoE engine under ``weight_quant``, paged and slab: the stacked
    expert leaves quantized as JAX quantizes them and dequantized per
    layer, greedy streams token-identical to the JAX engine with the same
    ``weight_quant``; ``weight_quant_error`` has JAX's path keys (the
    expert leaves among them) with values within 1e-6; the resident
    bytes are the quantized tree's."""
    jm, pm = moe_lms
    kw = dict(num_slots=3, max_len=32, prefill_chunk=4, weight_quant=wq,
              **({"kv_layout": "slab"} if layout == "slab"
                 else {"page_len": 4}))
    eng = _engine(pm, **kw)
    jeng = _jax_engine(jm, **kw)
    for g, w in zip(_moe_streams(eng), _moe_streams(jeng)):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert sorted(eng.weight_quant_error) == sorted(jeng.weight_quant_error)
    assert any(k.endswith("mlp/w1") for k in eng.weight_quant_error)
    for key, want in jeng.weight_quant_error.items():
        for name, v in want.items():
            assert abs(eng.weight_quant_error[key][name] - v) <= 1e-6
    want_bytes = sum(np.asarray(x).nbytes for x in
                     jax.tree_util.tree_leaves(jeng._params))
    assert eng.param_bytes() == want_bytes


@pytest.mark.parametrize("moe_decode", ["dispatched", "dense"])
def test_slab_moe_engine_matches_jax_engine(moe_lms, moe_decode):
    """The all-MoE LM on the slab engine (JAX
    ``tests/test_moe_serving.py`` :123): greedy streams token-identical
    to JAX ``generate()`` and to the JAX slab engine, through the
    dispatched decode and the dense baseline, with an n-gram verify."""
    from distkeras_tpu.serving import NgramDraft as JaxNgramDraft
    jm, pm = moe_lms
    kw = dict(num_slots=3, max_len=32, kv_layout="slab",
              moe_decode=moe_decode)
    got = _moe_streams(_engine(pm, **kw))
    want = _moe_streams(_jax_engine(jm, **kw))
    for g, w, p, n in zip(got, want, MOE_WQ_PROMPTS, MOE_WQ_BUDGETS):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, _ref(jm, p, n))
    eng = _engine(pm, max_len=48, draft=NgramDraft(), spec_k=3, **{
        k: v for k, v in kw.items() if k != "max_len"})
    jeng = _jax_engine(jm, max_len=48, draft=JaxNgramDraft(), spec_k=3,
                       **{k: v for k, v in kw.items() if k != "max_len"})
    prompt = np.tile(PATTERN, 3)[:14]
    r, jr = eng.submit(prompt, 12), jeng.submit(prompt, 12)
    np.testing.assert_array_equal(eng.run(max_steps=300)[r],
                                  np.asarray(jeng.run(max_steps=300)[jr]))


def test_engine_staggered_arrivals_match_generate(moe_lms):
    """Dispatched MoE decode under staggered arrivals with slot reuse:
    every stream token-identical to its own JAX ``generate()``."""
    jm, pm = moe_lms
    eng = _engine(pm)
    assert eng.moe_decode == "dispatched" and len(eng._moe) == 2
    prompts = [PATTERN[:4], PATTERN[:6], PATTERN[:3], PATTERN[:5]]
    budgets = [7, 5, 9, 6]
    rids = [eng.submit(prompts[i], budgets[i]) for i in range(2)]
    eng.step()
    eng.step()
    rids += [eng.submit(prompts[i], budgets[i]) for i in range(2, 4)]
    out = eng.run(max_steps=500)
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(out[rid],
                                      _ref(jm, prompts[i], budgets[i]))


@pytest.mark.parametrize("cache_dtype", ["int8", "int4"])
def test_engine_quantized_pages_match_generate(moe_lms, cache_dtype):
    jm, pm = moe_lms
    eng = _engine(pm, num_slots=2, page_len=4, cache_dtype=cache_dtype)
    rids = [eng.submit(PATTERN[:4], 7), eng.submit(PATTERN[:7], 6)]
    out = eng.run(max_steps=300)
    for rid, p, n in zip(rids, (PATTERN[:4], PATTERN[:7]), (7, 6)):
        np.testing.assert_array_equal(
            out[rid], _ref(jm, p, n, cache_dtype=cache_dtype))


def test_engine_dense_baseline_matches_generate(moe_lms):
    """``moe_decode="dense"`` is oracle-exact too and records no MoE
    telemetry."""
    jm, pm = moe_lms
    eng = _engine(pm, num_slots=2, moe_decode="dense")
    rid = eng.submit(PATTERN[:5], 6)
    out = eng.run(max_steps=300)
    np.testing.assert_array_equal(out[rid], _ref(jm, PATTERN[:5], 6))
    assert eng.metrics.summary()["moe"] is None
    assert eng._moe_iter == 0
    assert eng.health()["moe"]["decode"] == "dense"


@pytest.mark.parametrize("kw", [{}, {"spec_tree": True, "spec_width": 2}],
                         ids=["linear", "tree"])
def test_engine_ngram_verify_windows_match_generate(moe_lms, kw):
    """The [S, W] verify window (a token tree too) runs MoE blocks
    through the drop-free dispatch: greedy streams stay token-identical
    with drafts in play."""
    jm, pm = moe_lms
    eng = _engine(pm, num_slots=2, max_len=48, page_len=4,
                  draft=NgramDraft(), spec_k=3, **kw)
    prompts = [np.tile(PATTERN, 2)[:10], np.tile(PATTERN, 2)[:14]]
    rids = [eng.submit(p, 12) for p in prompts]
    out = eng.run(max_steps=500)
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(out[rid], _ref(jm, p, 12))
    assert eng.metrics.spec_proposed > 0
    assert eng.metrics.summary()["moe"] is not None


def test_engine_preempt_resume_matches_generate(moe_lms):
    jm, pm = moe_lms
    eng = _engine(pm, num_slots=2, page_len=4, num_pages=8,
                  prefix_cache=False)
    r0 = eng.submit(PATTERN[:5], 16)
    eng.step()
    eng.step()
    r1 = eng.submit(PATTERN[:6], 15)
    out = eng.run(max_steps=2000)
    assert eng.metrics.requests_preempted >= 1
    np.testing.assert_array_equal(out[r0], _ref(jm, PATTERN[:5], 16))
    np.testing.assert_array_equal(out[r1], _ref(jm, PATTERN[:6], 15))


def test_engine_chunked_prefill_with_prefix_cache_matches_generate(moe_lms):
    jm, pm = moe_lms
    eng = _engine(pm, num_slots=2, max_len=48, page_len=4, prefill_chunk=4)
    a = np.tile(PATTERN, 2)[:14]
    r0 = eng.submit(a, 6)
    out = eng.run(max_steps=300)
    r1 = eng.submit(a, 8)
    out.update(eng.run(max_steps=300))
    assert eng.metrics.prefix_hits >= 1
    for rid, n in ((r0, 6), (r1, 8)):
        np.testing.assert_array_equal(out[rid],
                                      _ref(jm, a, n, prefill_chunk=4))


@pytest.mark.parametrize("kw", [{"overlap": True},
                                {"overlap": True, "fuse_steps": 4}],
                         ids=["overlap", "fused"])
def test_engine_zero_bubble_loop_matches_generate(moe_lms, monkeypatch, kw):
    """Dispatched MoE decode under the pipelined loop and under fused
    windows: staggered greedy streams equal JAX ``generate()``, and the
    routing stats, read with the unit they belong to, reach the
    gauges."""
    import distkeras_tpu_torch.serving.engine as eng_mod
    jm, pm = moe_lms
    windows = []
    orig = eng_mod.decode_fused_slots

    def counted(*args, **fkw):
        windows.append(fkw.get("moe_stats"))
        return orig(*args, **fkw)

    monkeypatch.setattr(eng_mod, "decode_fused_slots", counted)
    eng = _engine(pm, num_slots=2, **kw)
    prompts = [PATTERN[:5], PATTERN[:4], PATTERN[:6]]
    budgets = [14, 10, 9]
    rids = [eng.submit(prompts[0], budgets[0])]
    eng.step()
    rids += [eng.submit(p, b) for p, b in zip(prompts[1:], budgets[1:])]
    out = eng.run(max_steps=500)
    for rid, p, b in zip(rids, prompts, budgets):
        np.testing.assert_array_equal(out[rid], _ref(jm, p, b))
    moe = eng.metrics.summary()["moe"]
    assert moe is not None and sum(moe["expert_load"]) > 0
    assert bool(windows) == ("fuse_steps" in kw)


@pytest.mark.parametrize("kw", [{}, {"fuse_steps": 4}],
                         ids=["overlap", "fuse4"])
def test_engine_sampled_dispatched_matches_jax_engine(moe_lms, kw):
    """Sampled requests through the dispatched MoE decode (and a greedy
    neighbour): every stream equals the JAX engine's with the same seeds
    and knobs, byte for byte (JAX's threefry key chain)."""
    from distkeras_tpu.serving.engine import ServingEngine as JaxEngine
    jm, pm = moe_lms
    reqs = [(PATTERN[:4], dict(temperature=1.1, top_k=5, seed=3)),
            (PATTERN[:5], {}),
            (PATTERN[:6], dict(temperature=2.5, top_p=0.95, seed=8))]

    def streams(eng):
        rids = [eng.submit(p, 10, **k) for p, k in reqs]
        out = eng.run(max_steps=400)
        return [np.asarray(out[r]) for r in rids]

    got = streams(_engine(pm, num_slots=2, **kw))
    want = streams(JaxEngine(jm, num_slots=2, max_len=32, **kw))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1], _ref(jm, PATTERN[:5], 10))


# --- telemetry, admission, validation ---------------------------------------


def test_moe_metrics_gauges_and_summary(moe_lms):
    _, pm = moe_lms
    eng = _engine(pm, num_slots=2)
    eng.submit(PATTERN[:4], 8)
    eng.run(max_steps=300)
    moe = eng.metrics.summary()["moe"]
    assert moe is not None
    load = moe["expert_load"]
    # one read decode step: 2 MoE layers x 1 live token x top-2
    assert len(load) == 8 and sum(load) == 4.0
    assert moe["router_entropy"] >= 0.0
    assert 0.0 <= moe["concentration"] <= 1.0
    assert eng.metrics.moe_expert_load == load
    h = eng.health()["moe"]
    assert h["decode"] == "dispatched" and h["layers"] == 2
    assert h["expert_parallel"] is None


@pytest.mark.parametrize("overlap", [False, True])
def test_moe_stats_throttled_and_first_step_reports(moe_lms, monkeypatch,
                                                    overlap):
    """The stats are computed and read on every ``_MOE_STATS_EVERY``-th
    launched decode step only, the first one included. The pipelined
    loop launches one step more per request (the step in flight when
    its last token is read)."""
    _, pm = moe_lms
    eng = _engine(pm, num_slots=1, overlap=overlap)
    seen = []
    orig = pd._moe_route_stats

    def spy(*args):
        seen.append(eng._moe_iter - 1)
        return orig(*args)

    monkeypatch.setattr(pd, "_moe_route_stats", spy)
    eng.submit(PATTERN[:4], 2)             # one decode step
    eng.run(max_steps=100)
    assert eng.metrics.summary()["moe"] is not None and seen == [0]
    eng.submit(PATTERN[:4], 20)            # 19 more decode steps
    eng.run(max_steps=100)
    assert eng._moe_iter == (22 if overlap else 20) and seen == [0, 16]


def test_moe_admit_extra_scales_and_caps(moe_lms):
    _, pm = moe_lms
    eng = _engine(pm, num_slots=2, page_len=4)
    req = Request(rid=0, prompt=PATTERN[:8].astype(np.int32),
                  max_new_tokens=8)
    n_logical = eng.pool.pages_for(len(req.prompt) + 1)
    assert eng._moe_admit_extra(req, n_logical) == 0
    eng._moe_conc = 0.5
    half = eng._moe_admit_extra(req, n_logical)
    eng._moe_conc = 1.0
    extra = eng._moe_admit_extra(req, n_logical)
    assert 1 <= half <= extra == int(np.ceil(0.5 * n_logical))
    worst = eng.pool.pages_for(len(req.prompt) + req.max_new_tokens)
    assert worst + extra <= eng.pool.num_pages
    tight = _engine(pm, num_slots=2, page_len=4, num_pages=5)
    tight._moe_conc = 1.0
    assert tight._moe_admit_extra(req, n_logical) == 5 - worst
    dense = _engine(pm, num_slots=2, page_len=4, moe_decode="dense")
    dense._moe_conc = 1.0
    assert dense._moe_admit_extra(req, n_logical) == 0


def test_concentration_defers_admission_under_page_pressure(moe_lms):
    _, pm = moe_lms
    eng = _engine(pm, num_slots=2, page_len=4, num_pages=8,
                  prefix_cache=False)
    req = Request(rid=99, prompt=PATTERN[:8].astype(np.int32),
                  max_new_tokens=4)
    n_logical = eng.pool.pages_for(len(req.prompt) + 1)
    held = [eng.pool.alloc_page()
            for _ in range(eng.pool.free_pages - n_logical)]
    assert eng.pool.free_pages == n_logical
    eng._moe_conc = 1.0
    assert eng._page_plan(req) is None
    eng._moe_conc = 0.0
    plan = eng._page_plan(req)
    assert plan is not None and len(plan["priv"]) == n_logical
    for pid in plan["priv"] + held:
        eng.pool.decref(pid)


def test_moe_decode_validation(moe_lms):
    _, pm = moe_lms
    with pytest.raises(ValueError, match="moe_decode"):
        _engine(pm, moe_decode="bogus")
