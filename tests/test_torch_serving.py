"""The port's ``ServingEngine`` against the JAX package's ``generate()``:
the oracle contract — greedy streams under continuous batching are
token-identical per request to a standalone ``generate()`` on the same
weights — under staggered arrivals, chunked prefill, a prefix-cache hit
and a pool so tight that streams are preempted and resumed.

Uses the session's memorized ``pattern_lm`` (huge argmax margins keep
token identity robust to float reassociation across batch shapes); its
JAX weights cross to the port with ``from_jax_params``."""

import numpy as np
import pytest
import torch

from distkeras_tpu.models.decoding import generate

from distkeras_tpu_torch.models import Model, from_jax_params, zoo
from distkeras_tpu_torch.serving import (AdmissionRejected, RequestState,
                                         ServingEngine)

V = 29
PATTERN = np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8])


@pytest.fixture(scope="module")
def lms(pattern_lm):
    pm = Model.build(zoo.transformer_lm(V, d_model=32, num_heads=4,
                                        num_layers=2, mlp_ratio=2),
                     (12,), device="cpu")
    from_jax_params(pm, pattern_lm.params, pattern_lm.state)
    return pattern_lm, pm


def _ref(jm, prompt, n, **kw):
    return generate(jm, np.asarray(prompt)[None], max_new_tokens=n,
                    temperature=0.0, **kw)[0]


def test_staggered_arrivals_match_generate(lms):
    jm, pm = lms
    seen = []
    eng = ServingEngine(pm, num_slots=3, max_len=32, device="cpu",
                        on_logits=lambda kind, logits, slots: seen.append(
                            (kind, bool(torch.isfinite(logits[slots])
                                        .all()))))
    prompts = [PATTERN[:4], PATTERN[:6], PATTERN[:3], PATTERN[:5],
               PATTERN[:4], PATTERN[:7]]
    budgets = [7, 5, 9, 6, 8, 4]
    rids = [eng.submit(prompts[i], budgets[i]) for i in range(2)]
    eng.step()
    eng.step()                     # in-flight work before later arrivals
    rids += [eng.submit(prompts[i], budgets[i]) for i in range(2, 6)]
    out = eng.run(max_steps=500)
    assert sorted(out) == sorted(rids)
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(out[rid],
                                      _ref(jm, prompts[i], budgets[i]))
    assert eng.metrics.summary()["requests_finished"] == 6
    assert eng.health()["slots"]["occupied"] == 0
    assert sum(kind == "prefill" for kind, _ in seen) == 6
    assert all(finite for _, finite in seen)


def test_chunked_prefill_matches_generate(lms):
    jm, pm = lms
    eng = ServingEngine(pm, num_slots=2, max_len=48, prefill_chunk=4,
                        page_len=4, device="cpu")
    prompt = np.tile(PATTERN, 3)[:26]
    rid = eng.submit(prompt, 6)
    out = eng.run(max_steps=300)
    np.testing.assert_array_equal(out[rid],
                                  _ref(jm, prompt, 6, prefill_chunk=4))
    assert eng.metrics.prefill_chunks == 7


def test_prefix_cache_hit_matches_generate(lms):
    """The second request with the same 3-page prompt reuses the first's
    registered pages: one prefill chunk (the recomputed last position)
    instead of three, and both outputs equal generate()."""
    jm, pm = lms
    eng = ServingEngine(pm, num_slots=2, max_len=48, page_len=4,
                        prefill_chunk=4, device="cpu")
    prompt = np.tile(PATTERN, 2)[:12]
    r0 = eng.submit(prompt, 5)
    out0 = eng.run(max_steps=300)
    chunks = eng.metrics.prefill_chunks
    r1 = eng.submit(prompt, 5)
    out1 = eng.run(max_steps=300)
    ref = _ref(jm, prompt, 5, prefill_chunk=4)
    np.testing.assert_array_equal(out0[r0], ref)
    np.testing.assert_array_equal(out1[r1], ref)
    s = eng.metrics.summary()
    assert s["prefix_cache"]["hits"] == 1
    assert eng.metrics.prefill_chunks - chunks == 1


@pytest.mark.parametrize("granularity,hit_tokens", [(1, 10 + 11),
                                                    (4, 8 + 8)])
def test_copy_on_write_partial_page_match(lms, granularity, hit_tokens):
    """b diverges inside a's third page: it shares a's two full pages
    plus, copy-on-write, the two matching tokens of the third; a re-run
    of a shares 11 of its 12 positions (the last is always recomputed).
    Rounded to whole pages (granularity 4) both partial matches drop to
    the two full pages."""
    jm, pm = lms
    eng = ServingEngine(pm, num_slots=2, max_len=48, page_len=4,
                        prefix_granularity=granularity, device="cpu")
    a = np.tile(PATTERN, 2)[:12]
    b = a.copy()
    b[10] = (a[10] + 1) % V                      # diverge inside page 2
    ra = eng.submit(a, 5)
    out_a = eng.run(max_steps=300)
    rb = eng.submit(b, 5)
    out_b = eng.run(max_steps=300)
    ra2 = eng.submit(a, 5)
    out_a2 = eng.run(max_steps=300)
    np.testing.assert_array_equal(out_a[ra], _ref(jm, a, 5))
    np.testing.assert_array_equal(out_b[rb], _ref(jm, b, 5))
    np.testing.assert_array_equal(out_a2[ra2], _ref(jm, a, 5))
    assert eng.metrics.prefix_hits == 2
    assert eng.metrics.prefix_hit_tokens == hit_tokens


def test_tight_pool_preempts_and_stays_token_identical(lms):
    """Two streams outgrow an 8-page pool: the younger is preempted
    mid-decode, re-prefills its context on re-admission and both stay
    token-identical to generate()."""
    jm, pm = lms
    eng = ServingEngine(pm, num_slots=2, max_len=32, page_len=4,
                        num_pages=8, prefix_cache=False, device="cpu")
    r0 = eng.submit(PATTERN[:5], 16)
    eng.step()
    eng.step()
    r1 = eng.submit(PATTERN[:6], 15)
    out = eng.run(max_steps=2000)
    assert eng.metrics.requests_preempted >= 1
    np.testing.assert_array_equal(out[r0], _ref(jm, PATTERN[:5], 16))
    np.testing.assert_array_equal(out[r1], _ref(jm, PATTERN[:6], 15))
    assert eng.pool.free_pages == 8


def test_sampled_stream_is_schedule_independent(lms):
    """A sampled request draws from its own generator: preempted or not,
    its tokens are the same; a greedy neighbour stays exact."""
    jm, pm = lms

    def run(num_pages):
        eng = ServingEngine(pm, num_slots=2, max_len=32, page_len=4,
                            num_pages=num_pages, prefix_cache=False,
                            device="cpu")
        g = eng.submit(PATTERN[:5], 16)
        s = eng.submit(PATTERN[:4], 14, temperature=0.9, top_k=6,
                       top_p=0.95, seed=7)
        out = eng.run(max_steps=3000)
        return out[g], out[s], eng.metrics.requests_preempted

    g_ample, s_ample, p_ample = run(16)
    g_tight, s_tight, p_tight = run(8)
    assert p_ample == 0 and p_tight >= 1
    np.testing.assert_array_equal(s_ample, s_tight)
    np.testing.assert_array_equal(g_ample, _ref(jm, PATTERN[:5], 16))
    np.testing.assert_array_equal(g_tight, g_ample)
    assert ((s_ample >= 0) & (s_ample < V)).all()


def test_stop_token_and_validation(lms):
    jm, pm = lms
    eng = ServingEngine(pm, num_slots=1, max_len=16, max_queue=1,
                        device="cpu")
    ref = _ref(jm, PATTERN[:4], 8)
    stop = int(ref[6])                           # the 3rd generated token
    rid = eng.submit(PATTERN[:4], 8, stop_token=stop)
    with pytest.raises(AdmissionRejected):
        eng.submit(PATTERN[:4], 2)
    assert eng[rid].state is RequestState.QUEUED
    out = eng.run(max_steps=100)
    np.testing.assert_array_equal(out[rid], ref[:7])
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit(PATTERN[:10], 8)
    with pytest.raises(ValueError, match="top_p"):
        eng.submit(PATTERN[:4], 2, top_p=0.0)
    assert eng.health()["requests"]["rejected"] == 1


@pytest.mark.parametrize("cache_dtype", ["int8", "int4"])
def test_quantized_kv_engine_matches_generate(lms, cache_dtype):
    """int8 and int4 (nibble-packed) pages: staggered greedy streams with
    chunked prefill, then a prefix-cache hit that loads (and for int4
    unpacks) the registered pages, all token-identical to JAX
    ``generate()`` at the same cache dtype."""
    jm, pm = lms
    eng = ServingEngine(pm, num_slots=2, max_len=48, page_len=4,
                        prefill_chunk=4, cache_dtype=cache_dtype,
                        device="cpu")
    kv = next(kv for kv in eng.pool.cache if kv is not None)
    assert kv["k"].dtype == torch.int8 and "k_scale" in kv
    assert kv["k"].shape[2] == (2 if cache_dtype == "int4" else 4)
    a = np.tile(PATTERN, 2)[:12]
    r0 = eng.submit(a, 6)
    eng.step()
    r1 = eng.submit(PATTERN[:5], 9)
    out = eng.run(max_steps=500)
    r2 = eng.submit(a, 6)
    out.update(eng.run(max_steps=500))
    assert eng.metrics.prefix_hits >= 1
    for rid, prompt, n in ((r0, a, 6), (r1, PATTERN[:5], 9), (r2, a, 6)):
        np.testing.assert_array_equal(
            out[rid], _ref(jm, prompt, n, cache_dtype=cache_dtype,
                           prefill_chunk=4))


@pytest.mark.parametrize("kw", [{"overlap": True}, {"fuse_steps": 4},
                                {"weight_quant": "int8"},
                                {"fused_sampling": True},
                                {"kv_layout": "slab"},
                                {"host_kv_pages": 8},
                                {"ep_mesh": "expert"}])
def test_later_slices_raise_naming_the_roadmap(lms, kw):
    _, pm = lms
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServingEngine(pm, device="cpu", **kw)
