"""The port's ``generate()`` over the slab KV cache against the JAX
package's: greedy streams token-identical for MHA, GQA and GQA+SWA with
float, int8 and int4 caches, one-pass and chunked prefill; one
``decode_step`` (logits and the cache it writes, quantized payloads and
scales included); the quantization helpers bit for bit; stop-token
padding, per-sequence knobs, ``max_new_tokens=0`` and the sampler's
candidate set.

The JAX side runs its CPU path (the einsum decode readout that
``generate()`` takes off the TPU); the port runs its plain PyTorch
versions. Weights cross with ``from_jax_params``; every input is made
with numpy from a seed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distkeras_tpu.models import Model as JaxModel
from distkeras_tpu.models import decoding as jd
from distkeras_tpu.models import zoo as jax_zoo

from distkeras_tpu_torch.models import Model, decoding as pd, \
    from_jax_params, zoo
from distkeras_tpu_torch.ops import prng
from distkeras_tpu_torch.ops.attention import NEG_INF

V = 41
#: float32 reassociation of attention and matmul sums over <= 20 keys
TOL = 1e-4
CONFIGS = [{}, {"num_kv_heads": 2}, {"num_kv_heads": 2, "attn_window": 5}]
IDS = ["mha", "gqa", "gqa-swa"]
_PAIRS = {}


def _pair(cfg_id):
    """One JAX model and its port twin per configuration (built once per
    worker process)."""
    if cfg_id not in _PAIRS:
        kw = dict(d_model=32, num_heads=4, num_layers=2, mlp_ratio=2)
        kw.update(CONFIGS[IDS.index(cfg_id)])
        jm = JaxModel.build(jax_zoo.transformer_lm(V, **kw), (8,), seed=3)
        pm = Model.build(zoo.transformer_lm(V, **kw), (8,), seed=3,
                         device="cpu")
        from_jax_params(pm, jm.params, jm.state)
        jd._resolve_head_dims(jm.module, jm.params)
        _PAIRS[cfg_id] = (jm, pm)
    return _PAIRS[cfg_id]


def _prompts(seed=0, b=2, p=11):
    return np.random.RandomState(seed).randint(0, V, (b, p)).astype(np.int32)


@pytest.mark.parametrize("prefill_chunk", [None, 4])
@pytest.mark.parametrize("cache_dtype", [None, "int8", "int4"])
@pytest.mark.parametrize("cfg", IDS)
def test_greedy_generate_matches_jax(cfg, cache_dtype, prefill_chunk):
    jm, pm = _pair(cfg)
    prompts = _prompts()
    ref = jd.generate(jm, prompts, 9, cache_dtype=cache_dtype,
                      prefill_chunk=prefill_chunk)
    got = pm.generate(prompts, 9, cache_dtype=cache_dtype,
                      prefill_chunk=prefill_chunk)
    assert got.shape == (2, 20) and got.dtype == prompts.dtype
    np.testing.assert_array_equal(got, ref)


def test_generate_with_cast_fused_weights_matches_jax():
    """``weights_dtype`` float32 forces the cast-and-fused ``wqkv`` tree
    (cached on the model, rebuilt after a weight update)."""
    jm, pm = _pair("gqa")
    prompts = _prompts(1)
    ref = jd.generate(jm, prompts, 7, weights_dtype=jnp.float32)
    got = pm.generate(prompts, 7, weights_dtype=torch.float32)
    np.testing.assert_array_equal(got, ref)
    cached = pm._serving_params_cache[torch.float32][1]
    assert any("wqkv" in lp.get("attn", {}) for lp in cached)
    assert pd._generate_params(pm, torch.float32, None) is cached
    p = next(pm.module.parameters())
    with torch.no_grad():
        p.add_(0.0)                      # an in-place update: new version
    assert pd._generate_params(pm, torch.float32, None) is not cached


@pytest.mark.parametrize("cache_dtype", [None, "int8", "int4"])
@pytest.mark.parametrize("cfg", IDS)
def test_decode_step_matches_jax(cfg, cache_dtype):
    """The same prefilled cache on both sides, then one step at t=13:
    logits, and every plane of the cache it wrote."""
    jm, pm = _pair(cfg)
    prompt = _prompts(2, 1, 13)
    jc = jd.init_cache(jm.module, 1, 20,
                       jnp.float32 if cache_dtype is None else cache_dtype)
    pc = pd.init_cache(pm.module, 1, 20,
                       torch.float32 if cache_dtype is None else cache_dtype,
                       "cpu")
    jl, jc = jd.prefill(jm.module, jm.params, jm.state, jc,
                        jnp.asarray(prompt))
    pl, pc = pd.prefill(pm.module, pm.params, pc, torch.from_numpy(prompt))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=TOL)
    tok = np.asarray(jnp.argmax(jl, axis=-1))
    jl, jc = jd.decode_step(jm.module, jm.params, jm.state, jc,
                            jnp.asarray(tok), 13)
    pl, pc = pd.decode_step(pm.module, pm.params, pc,
                            torch.from_numpy(tok.astype(np.int64)), 13)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=TOL)
    for jkv, pkv in zip(jc, pc):
        if jkv is None:
            assert pkv is None
            continue
        assert ("q4" in pkv) == ("q4" in jkv)
        for key in ("k", "v", "k_scale", "v_scale"):
            assert (key in pkv) == (key in jkv)
            if key in pkv:
                np.testing.assert_allclose(pkv[key].numpy(),
                                           np.asarray(jkv[key]), atol=TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_kv_is_bitwise_jax(bits):
    rs = np.random.RandomState(4)
    x = rs.randn(3, 5, 16).astype(np.float32) * rs.rand(3, 5, 1) * 4
    x[1, 2] = 0.0                                # a zero vector: scale 0
    x[2, 0, :4] = [0.5, -0.5, 1.5, 2.5]          # half-way ties
    x[2, 0, 4] = 127.0 if bits == 8 else 7.0     # scale exactly 1
    jq, js = jd._quantize_kv(jnp.asarray(x), bits)
    pq, ps = pd._quantize_kv(torch.from_numpy(x), bits)
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


def test_pack_unpack_int4_is_bitwise_jax():
    rs = np.random.RandomState(5)
    q = rs.randint(-7, 8, size=(3, 2, 64, 16)).astype(np.int8)
    jp = np.asarray(jd.pack_int4(jnp.asarray(q)))
    pp = pd.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(pp.numpy(), jp)
    np.testing.assert_array_equal(pd.unpack_int4(pp).numpy(), q)
    raw = rs.randint(-128, 128, size=(2, 3, 8, 16)).astype(np.int8)
    np.testing.assert_array_equal(
        pd.unpack_int4(torch.from_numpy(raw)).numpy(),
        np.asarray(jd.unpack_int4(jnp.asarray(raw))))


def test_stop_token_pads_like_jax():
    jm, pm = _pair("mha")
    prompts = _prompts(6)
    free = jd.generate(jm, prompts, 9)
    stop = int(free[0, 13])                      # row 0's third new token
    for stop_token in (stop, [stop, -1]):
        ref = jd.generate(jm, prompts, 9, stop_token=stop_token)
        got = pm.generate(prompts, 9, stop_token=stop_token)
        np.testing.assert_array_equal(got, ref)
    assert (got[0, 13:] == stop).all()


def test_per_sequence_knobs_match_jax_on_greedy_rows():
    """Per-sequence arrays: all-greedy rows (whatever their top-k/top-p)
    are token-identical to JAX; in a mixed batch the greedy row still is
    and the sampled row stays in the vocabulary, repeatably per seed."""
    jm, pm = _pair("gqa")
    prompts = _prompts(7)
    kw = dict(temperature=[0.0, 0.0], top_k=[0, 3], top_p=[1.0, 0.9])
    np.testing.assert_array_equal(pm.generate(prompts, 8, **kw),
                                  jd.generate(jm, prompts, 8, **kw))
    mixed = dict(temperature=np.array([0.0, 0.8]), top_k=[0, 5], seed=4)
    got = pm.generate(prompts, 8, **mixed)
    np.testing.assert_array_equal(got[0],
                                  jd.generate(jm, prompts, 8, **mixed)[0])
    assert ((got >= 0) & (got < V)).all()
    np.testing.assert_array_equal(got, pm.generate(prompts, 8, **mixed))
    with pytest.raises(ValueError, match="per-sequence"):
        pm.generate(prompts, 4, temperature=[0.5, 0.5, 0.5])
    with pytest.raises(ValueError, match="top_p"):
        pm.generate(prompts, 4, top_p=[0.5, 0.0])


def test_max_new_tokens_zero_and_validation():
    jm, pm = _pair("mha")
    prompts = _prompts(8)
    np.testing.assert_array_equal(pm.generate(prompts, 0),
                                  jd.generate(jm, prompts, 0))
    np.testing.assert_array_equal(pm.generate(prompts, 0), prompts)
    as_tensor = pm.generate(prompts, 3, as_numpy=False)
    assert torch.is_tensor(as_tensor) and as_tensor.shape == (2, 14)
    np.testing.assert_array_equal(as_tensor.numpy(),
                                  jd.generate(jm, prompts, 3))
    with pytest.raises(ValueError, match="max_new_tokens"):
        pm.generate(prompts, -1)
    with pytest.raises(ValueError, match=r"\[B, P\]"):
        pm.generate(prompts[0], 3)
    with pytest.raises(ValueError, match="top_p"):
        pm.generate(prompts, 3, top_p=1.5)
    with pytest.raises(ValueError, match="prefill_chunk"):
        pm.generate(prompts, 3, prefill_chunk=0)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 5, None), (0.7, None, 0.6), (1.3, 8, 0.9), (1.0, 1, None)])
def test_sampled_draw_lies_in_jax_candidate_set(monkeypatch, temperature,
                                                top_k, top_p):
    """JAX's ``_sample`` hands its masked logits to
    ``jax.random.categorical``; capturing them gives JAX's exact
    candidate set, and every port draw must lie in it. With the real
    ``categorical`` back, each draw equals JAX's on the same key."""
    rs = np.random.RandomState(9)
    logits = rs.randint(-4, 4, (3, 50)).astype(np.float32)    # many ties
    seen = {}

    def capture(key, lf, axis=-1):
        seen["lf"] = np.asarray(lf)
        return jnp.argmax(lf, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jd._sample(jnp.asarray(logits), temperature, top_k,
               jax.random.PRNGKey(0), top_p)
    cand = seen["lf"] > NEG_INF / 2
    monkeypatch.undo()
    keys = prng.split(prng.key(11), 40)
    draws = torch.stack([pd._sample(torch.from_numpy(logits), temperature,
                                    top_k, k, top_p) for k in keys])
    for k, d in zip(keys, draws):
        want = jd._sample(jnp.asarray(logits), temperature, top_k,
                          jnp.asarray(k.numpy(), jnp.uint32), top_p)
        np.testing.assert_array_equal(d.numpy(), np.asarray(want))
    for row in range(3):
        assert cand[row, draws[:, row].numpy()].all()
    if top_k == 1:
        assert cand.sum(axis=-1).tolist() == [1, 1, 1]
    else:
        assert len(set(draws[:, 0].tolist())) > 1       # it does sample


def test_non_float_weights_dtype_raises():
    _, pm = _pair("mha")
    with pytest.raises(ValueError, match="float dtype"):
        pm.generate(_prompts(), 2, weights_dtype=torch.int32)
