"""The port's ``ServingEngine`` against the JAX package's ``generate()``:
the oracle contract — greedy streams under continuous batching are
token-identical per request to a standalone ``generate()`` on the same
weights — under staggered arrivals, chunked prefill, a prefix-cache hit
and a pool so tight that streams are preempted and resumed; then the
same contract under speculative decoding (n-gram and draft-model
drafts, linear and tree verify, int8/int4 pages, preemption, a stop
token inside a verify window), the sampled speculative stream against
the plain one, and the acceptance EMA's kill switch and re-probe.

Uses the session's memorized ``pattern_lm`` (huge argmax margins keep
token identity robust to float reassociation across batch shapes); its
JAX weights cross to the port with ``from_jax_params``."""

import numpy as np
import pytest
import torch

from distkeras_tpu.models.decoding import generate

from distkeras_tpu_torch.models import Model, from_jax_params, zoo
from distkeras_tpu_torch.serving import (AdmissionRejected, DraftModel,
                                         DraftSource, FIFOScheduler,
                                         KVPool, NgramDraft, PagedKVPool,
                                         PriorityScheduler, RequestState,
                                         ServingEngine, ServingMetrics)

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


@pytest.mark.parametrize("kw", [{"kv_layout": "slab"},
                                {"host_kv_pages": 8},
                                {"ep_mesh": "expert"},
                                {"hbm_budget": 1 << 30},
                                {"weights_dtype": "bfloat16"},
                                {"decode_kernel": "off"},
                                {"engine_id": "e0"},
                                {"tracer": "tracer"}, {"slo": "slo"},
                                {"timeseries": 0.0}])
def test_later_slices_raise_naming_the_roadmap(lms, kw):
    """The options of later slices raise naming their ROADMAP item
    (``ep_mesh``, item 10); the ones ported since (``kv_layout="slab"``,
    ``host_kv_pages``, ``hbm_budget``, ``weights_dtype``,
    ``decode_kernel``, ``engine_id``, and ``tracer``, ``slo`` and
    ``timeseries`` of the obs layer) take effect and serve a request."""
    from distkeras_tpu_torch.obs import RequestTracer
    from distkeras_tpu_torch.obs.slo import availability, ttft_p99
    _, pm = lms
    (name, value), = kw.items()
    if name == "tracer":
        kw = {"tracer": RequestTracer()}
    elif name == "slo":
        kw = {"slo": [ttft_p99(60.0), availability(0.5)]}
    if name == "ep_mesh":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ServingEngine(pm, device="cpu", **kw)
        return
    eng = ServingEngine(pm, device="cpu",
                        **({} if name == "kv_layout" else {"page_len": 4}),
                        **kw)
    if name == "kv_layout":
        assert isinstance(eng.pool, KVPool) and eng.page_len is None
    elif name == "host_kv_pages":
        assert eng.pool.host_pages == value
        assert eng.health()["pages"]["host"]["free"] == value
    elif name == "hbm_budget":
        assert eng.pool.num_pages == (value - eng.param_bytes()) \
            // eng.pool.page_bytes
    elif name == "weights_dtype":
        assert eng._params[1]["attn"]["wqkv"].dtype == torch.bfloat16
    elif name == "decode_kernel":
        assert eng.decode_kernel == "off" and not eng._paged_kernel
    elif name == "engine_id":
        assert eng.engine_id == "e0" and eng.health()["engine_id"] == "e0"
    elif name == "tracer":
        assert eng.tracer is kw["tracer"]
        assert eng.scheduler.tracer is eng.tracer
    elif name == "slo":
        assert [o.name for o in eng.slo.objectives] == ["ttft_p99",
                                                         "availability"]
    else:
        assert eng.timeseries.interval_s == value
    rid = eng.submit(PATTERN[:4], 3)
    assert eng.run(max_steps=50)[rid].size == 7
    if name == "tracer":
        durs = eng.tracer.summaries()[rid]["durations"]
        assert durs["queued_s"] + durs["prefill_s"] + durs["decode_s"] \
            == pytest.approx(durs["total_s"])
    elif name == "slo":
        health = eng.health()
        assert health["status"] == "ok" and not any(
            st["breach"] for st in health["slo"].values())
    elif name == "timeseries":
        assert eng.timeseries.series("serving.requests_finished",
                                     field="value")[-1][1] == 1.0


@pytest.mark.parametrize("kw,item", [
    ({"host_pages": 8}, "ROADMAP, Queue 1 item 8"),
    ({"hbm_budget": 1 << 30}, "ROADMAP, Queue 1 item 4"),
    ({"reserve_bytes": 1 << 20}, "ROADMAP, Queue 1 item 4"),
])
def test_pool_options_of_later_slices_raise_naming_the_roadmap(lms, kw,
                                                                item):
    """The JAX pool's options are all ported: the host tier holds
    ``host_pages`` pages of every plane in host memory and takes a swap;
    the byte budget sizes whole pages of ``hbm_budget - reserve_bytes``
    (``reserve_bytes`` alone changes nothing). The "off" values stay
    accepted. (The ids keep the ROADMAP items the options waited for.)"""
    _, pm = lms
    (name, value), = kw.items()
    if name == "host_pages":
        pool = PagedKVPool(pm.module, 2, 32, page_len=4, device="cpu", **kw)
        kv = next(kv for kv in pool.host_cache if kv is not None)
        assert kv["k"].shape[0] == value and pool.host_free_pages == value
        pid = pool.alloc_page()
        hids = pool.offload_pages([pid])
        assert len(hids) == 1 and pool.host_free_pages == value - 1
        assert pool.offload_bytes == pool.page_bytes
        with pytest.raises(ValueError, match="host_pages"):
            PagedKVPool(pm.module, 2, 32, page_len=4, device="cpu",
                        host_pages=-1)
    else:
        pool = PagedKVPool(pm.module, 2, 32, page_len=4, device="cpu",
                           **kw)
        want = (value // pool.page_bytes if name == "hbm_budget"
                else 2 * 8)
        assert pool.num_pages == want
        assert pool.allocated_bytes() == (want + 1) * pool.page_bytes
    pool = PagedKVPool(pm.module, 2, 32, page_len=4, device="cpu",
                       host_pages=0, hbm_budget=None, reserve_bytes=0)
    assert pool.num_pages == 2 * 8


def test_build_with_a_jax_key_raises_naming_the_roadmap():
    """``Model.build(rng=)`` takes a JAX key (item 5 is ported): the key
    ``PRNGKey(3)`` gives the weights of ``seed=3``, and ``rng=None`` is
    the seeded build."""
    spec = zoo.transformer_lm(V, d_model=32, num_heads=4, num_layers=1)
    k = Model.build(spec, (12,), np.array([0, 3], np.uint32), device="cpu")
    a = Model.build(zoo.transformer_lm(V, d_model=32, num_heads=4,
                                       num_layers=1), (12,), None, seed=3,
                    device="cpu")
    b = Model.build(zoo.transformer_lm(V, d_model=32, num_heads=4,
                                       num_layers=1), (12,), seed=3,
                    device="cpu")
    for x, y, z in zip(k.module.parameters(), a.module.parameters(),
                       b.module.parameters()):
        assert torch.equal(x, y) and torch.equal(y, z)


@pytest.mark.parametrize("call", ["submit-deadline", "run-on-degraded",
                                  "cancel"])
def test_later_slice_calls_raise_naming_the_roadmap(lms, call):
    """The JAX engine's per-call options (ROADMAP Queue 1 item 4, now
    ported): a deadline ends its request TIMED_OUT, an unknown
    ``on_degraded`` raises ``ValueError``, ``cancel`` ends a request
    CANCELLED; the "off" values stay accepted."""
    _, pm = lms
    box = [0.0]
    eng = ServingEngine(pm, num_slots=1, max_len=32, device="cpu",
                        hbm_budget=None, weights_dtype="auto",
                        decode_kernel="auto", engine_id=None, tracer=None,
                        slo=None, timeseries=None,
                        metrics=ServingMetrics(clock=lambda: box[0]))
    rid = eng.submit(PATTERN[:4], 2, deadline_s=None)
    if call == "submit-deadline":
        late = eng.submit(PATTERN[:4], 2, deadline_s=1.0)
        box[0] = 5.0
        out = eng.run(max_steps=50, on_degraded="return")
        np.testing.assert_array_equal(out[late], PATTERN[:4])
        assert eng.metrics.requests_timed_out == 1
    else:
        if call == "run-on-degraded":
            with pytest.raises(ValueError, match="on_degraded"):
                eng.run(on_degraded="skip")
        else:
            gone = eng.submit(PATTERN[:5], 2)
            assert eng.cancel(gone).state is RequestState.CANCELLED
            assert eng.metrics.requests_cancelled == 1
        out = eng.run(max_steps=50, on_degraded="raise")
    assert out[rid].size == 6


# --- GQA and sliding-window models through the engine -------------------------

COVERAGE = {"gqa1": {"num_kv_heads": 1}, "gqa2": {"num_kv_heads": 2},
            "swa5": {"num_kv_heads": 2, "attn_window": 5},
            "swa8": {"attn_window": 8}}


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
@pytest.mark.parametrize("cfg", sorted(COVERAGE))
def test_gqa_swa_engine_matches_generate(cfg, cache_dtype):
    """Random seed-3 float32 models with grouped queries (1 and 2 kv
    heads) and sliding windows (5 and 8) through the engine under
    chunked prefill, 4-position pages, float and int8 pages and a
    prefix-cache hit: every stream token-identical to JAX
    ``generate()``."""
    from distkeras_tpu.models import Model as JaxModel
    from distkeras_tpu.models import zoo as jax_zoo
    kw = dict(d_model=32, num_heads=4, num_layers=2, mlp_ratio=2)
    kw.update(COVERAGE[cfg])
    jm = JaxModel.build(jax_zoo.transformer_lm(V, **kw), (8,), seed=3)
    pm = Model.build(zoo.transformer_lm(V, **kw), (8,), device="cpu")
    from_jax_params(pm, jm.params, jm.state)
    rs = np.random.RandomState(3)
    shared = rs.randint(0, V, 8)
    prompts = [np.concatenate([shared, rs.randint(0, V, n)])
               for n in (5, 3, 7)] + [rs.randint(0, V, 9)]
    eng = ServingEngine(pm, num_slots=2, max_len=40, page_len=4,
                        prefill_chunk=4, cache_dtype=cache_dtype,
                        device="cpu")
    rids = [eng.submit(p, 10) for p in prompts]
    out = eng.run(max_steps=500)
    assert eng.metrics.prefix_hits >= 1
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(
            out[rid], _ref(jm, p, 10, cache_dtype=cache_dtype,
                           prefill_chunk=4))


# --- quantized weights and the fused sampling epilogue -----------------------

WQ_PROMPTS = [PATTERN[:4], np.tile(PATTERN, 2)[:14], PATTERN[:7]]
WQ_BUDGETS = [7, 9, 6]


def _wq_streams(eng):
    rids = [eng.submit(p, b) for p, b in zip(WQ_PROMPTS, WQ_BUDGETS)]
    eng.step()
    rids.append(eng.submit(PATTERN[:5], 8))      # a later arrival
    out = eng.run(max_steps=500)
    return [out[r] for r in rids]


@pytest.mark.parametrize("interpret", [False, True],
                         ids=["jax-reference", "jax-kernel-interpret"])
@pytest.mark.parametrize("wq", ["int8", "int4"])
def test_weight_quant_matches_jax_engine_and_float(lms, wq, interpret):
    """The port's quantized engine against the JAX engine with the same
    ``weight_quant`` (its in-graph dequant, or under ``force_interpret``
    the Pallas kernel for the attention projections) and against the
    port's unquantized engine: token-identical streams."""
    from distkeras_tpu.ops import quant_matmul as jqm
    from distkeras_tpu.serving.engine import ServingEngine as JaxEngine
    jm, pm = lms
    kw = dict(num_slots=2, max_len=32, page_len=4, prefill_chunk=4)
    if interpret:
        with jqm.force_interpret():
            jeng = JaxEngine(jm, weight_quant=wq, **kw)
            assert jeng._wq_keep_attn
            want = _wq_streams(jeng)
    else:
        want = _wq_streams(JaxEngine(jm, weight_quant=wq, **kw))
    eng = ServingEngine(pm, weight_quant=wq, device="cpu", **kw)
    got = _wq_streams(eng)
    plain = _wq_streams(ServingEngine(pm, device="cpu", **kw))
    for a, b, c in zip(got, want, plain):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("wq", ["int8", "int4"])
def test_weight_quant_error_and_bytes(lms, wq):
    from distkeras_tpu.serving.engine import ServingEngine as JaxEngine
    jm, pm = lms
    eng = ServingEngine(pm, num_slots=1, max_len=32, weight_quant=wq,
                        device="cpu")
    jerr = JaxEngine(jm, num_slots=1, max_len=32,
                     weight_quant=wq).weight_quant_error
    assert eng.weight_quant == wq and set(eng.weight_quant_error) == set(jerr)
    for key, e in jerr.items():
        for metric in ("max_abs_err", "rel_rms"):
            assert abs(eng.weight_quant_error[key][metric]
                       - e[metric]) <= 1e-6
    assert all(v["rel_rms"] < (0.25 if wq == "int4" else 0.05)
               for v in eng.weight_quant_error.values())
    attn = eng._params[1]["attn"]
    assert "wqkv" not in attn and attn["wq"][
        "q4" if wq == "int4" else "q"].dtype == torch.int8
    float_bytes = ServingEngine(pm, num_slots=1, max_len=32,
                                device="cpu").param_bytes()
    assert eng.param_bytes() < float_bytes / (5 if wq == "int4" else 3)


@pytest.mark.parametrize("case", ["int4-pages", "ngram-linear",
                                  "ngram-tree"])
def test_weight_quant_composes_with_pages_and_drafts(lms, case):
    """int4 weights over int4 pages, and int8 weights under linear and
    tree n-gram speculation: greedy streams equal JAX ``generate()``."""
    jm, pm = lms
    if case == "int4-pages":
        eng = ServingEngine(pm, num_slots=2, max_len=48, page_len=4,
                            weight_quant="int4", cache_dtype="int4",
                            device="cpu")
    else:
        kw = {"spec_tree": True, "spec_width": 2} if case == "ngram-tree" \
            else {}
        eng = _spec_engine(pm, "ngram", weight_quant="int8", **kw)
    rids = [eng.submit(p, b) for p, b in zip(SPEC_PROMPTS, SPEC_BUDGETS)]
    out = eng.run(max_steps=500)
    kw = {"cache_dtype": "int4"} if case == "int4-pages" else {}
    for rid, p, b in zip(rids, SPEC_PROMPTS, SPEC_BUDGETS):
        np.testing.assert_array_equal(out[rid], _ref(jm, p, b, **kw))
    if case != "int4-pages":
        assert eng.metrics.summary()["speculation"]["accepted"] > 0


def test_weight_quant_validates(lms):
    _, pm = lms
    with pytest.raises(ValueError, match="weight_quant"):
        ServingEngine(pm, device="cpu", weight_quant="fp8")


@pytest.mark.parametrize("weight_quant", [None, "int8"])
def test_fused_sampling_streams_byte_identical(lms, weight_quant):
    """``fused_sampling=True`` changes no byte of a sampled request's
    stream (same seeds and knobs) and leaves greedy streams alone."""
    _, pm = lms
    reqs = [(PATTERN[:4], dict(temperature=0.9, top_k=6, top_p=0.9,
                               seed=7)),
            (PATTERN[:6], dict(temperature=1.3, seed=3)),
            (PATTERN[:5], dict(temperature=0.7, top_p=0.5, seed=5)),
            (PATTERN[:3], {})]

    def streams(fused):
        eng = ServingEngine(pm, num_slots=3, max_len=32, device="cpu",
                            fused_sampling=fused, weight_quant=weight_quant)
        rids = [eng.submit(p, 9, **kw) for p, kw in reqs]
        out = eng.run(max_steps=300)
        return [out[r] for r in rids]

    for a, b in zip(streams(True), streams(False)):
        np.testing.assert_array_equal(a, b)


# --- speculative decoding ----------------------------------------------------

SPEC_PROMPTS = [np.tile(PATTERN, 2)[:10], np.tile(PATTERN, 2)[:14],
                PATTERN[:6]]
SPEC_BUDGETS = [12, 9, 14]


def _spec_engine(pm, draft, **kw):
    base = dict(num_slots=3, max_len=48, page_len=4, device="cpu",
                spec_k=3)
    base.update(kw)
    if draft == "ngram":
        draft = NgramDraft()
    elif draft == "self":
        draft = DraftModel(pm, page_len=4)
    return ServingEngine(pm, draft=draft, **base)


def _drain_counting(eng):
    """Drain through ``step()``; returns ``({rid: tokens}, steps)``."""
    out, steps = {}, 0
    while eng.scheduler.pending:
        for r in eng.step():
            out[r.rid] = r.tokens
        steps += 1
        assert steps < 1000
    return out, steps


@pytest.mark.parametrize("draft,kw", [
    ("ngram", {}),
    ("ngram", {"spec_tree": True, "spec_width": 2}),
    ("self", {}),
    ("self", {"spec_tree": True, "spec_width": 2}),
], ids=["ngram-linear", "ngram-tree", "self-draft-linear",
        "self-draft-tree"])
def test_speculative_engine_matches_generate(lms, draft, kw):
    """n-gram drafts (linear and width-2 trees) and the self-draft (the
    perfect-drafter limit): every greedy stream token-identical to JAX
    ``generate()``, drafts accepted, fewer iterations than tokens."""
    jm, pm = lms
    eng = _spec_engine(pm, draft, **kw)
    rids = [eng.submit(p, b) for p, b in zip(SPEC_PROMPTS, SPEC_BUDGETS)]
    out, steps = _drain_counting(eng)
    for rid, p, b in zip(rids, SPEC_PROMPTS, SPEC_BUDGETS):
        np.testing.assert_array_equal(out[rid], _ref(jm, p, b))
    s = eng.metrics.summary()
    assert s["speculation"]["accepted"] > 0
    assert steps < sum(SPEC_BUDGETS)
    if draft == "self":
        assert s["acceptance_rate"] > (0.4 if kw else 0.9)
    if kw:
        assert s["speculation"]["tree_width"]["p50"] >= 1
        assert s["speculation"]["accepted_path_len"] is not None


@pytest.mark.parametrize("cache_dtype", ["int8", "int4"])
def test_tree_speculation_with_quantized_pages_matches_generate(
        lms, cache_dtype):
    """int8 and packed int4 pages under width-2 n-gram trees (verify
    windows of 7 columns write byte rows two columns share in int4):
    token-identical to JAX ``generate()`` at the same cache dtype."""
    jm, pm = lms
    eng = _spec_engine(pm, "ngram", cache_dtype=cache_dtype, spec_tree=True,
                       spec_width=2, num_slots=2)
    rids = [eng.submit(p, b) for p, b in zip(SPEC_PROMPTS[:2],
                                              SPEC_BUDGETS[:2])]
    out = eng.run(max_steps=500)
    for rid, p, b in zip(rids, SPEC_PROMPTS[:2], SPEC_BUDGETS[:2]):
        np.testing.assert_array_equal(
            out[rid], _ref(jm, p, b, cache_dtype=cache_dtype))
    assert eng.metrics.summary()["speculation"]["accepted"] > 0


@pytest.mark.parametrize("kw", [{}, {"spec_tree": True, "spec_width": 2}],
                         ids=["linear", "tree"])
def test_speculation_in_a_tight_pool_preempts_and_matches(lms, kw):
    """Two speculating streams outgrow an 8-page pool (the verify window
    asks for lookahead pages): one is preempted, its draft slot ended,
    and both stay token-identical to JAX ``generate()``."""
    jm, pm = lms
    eng = _spec_engine(pm, "self", num_slots=2, max_len=32, num_pages=8,
                       prefix_cache=False, **kw)
    r0 = eng.submit(PATTERN[:5], 16)
    eng.step()
    eng.step()
    r1 = eng.submit(PATTERN[:6], 15)
    out = eng.run(max_steps=2000)
    assert eng.metrics.requests_preempted >= 1
    np.testing.assert_array_equal(out[r0], _ref(jm, PATTERN[:5], 16))
    np.testing.assert_array_equal(out[r1], _ref(jm, PATTERN[:6], 15))
    assert eng.pool.free_pages == 8
    assert not eng._draft._active and eng._draft.pool.free_pages == \
        eng._draft.pool.num_pages


def test_stop_token_mid_window(lms):
    """A stop token accepted inside a verify window ends the stream
    there: the tokens after it in the window are dropped."""
    jm, pm = lms
    ref = _ref(jm, SPEC_PROMPTS[0], 12)
    gen = list(ref[10:])
    # the first generated token (past the prefill's) not seen before it
    first = next(i for i in range(2, 12) if gen[i] not in gen[:i])
    stop = int(gen[first])
    eng = _spec_engine(pm, "self")
    rid = eng.submit(SPEC_PROMPTS[0], 12, stop_token=stop)
    out = eng.run(max_steps=200)
    np.testing.assert_array_equal(out[rid], ref[:10 + first + 1])
    assert eng.metrics.summary()["speculation"]["accepted"] > 0


@pytest.mark.parametrize("kw", [{}, {"spec_tree": True, "spec_width": 2}],
                         ids=["linear", "tree"])
def test_sampled_speculative_stream_equals_plain(lms, kw):
    """A seeded sampled request draws once per emitted token from its own
    generator: with speculation (linear or tree) its tokens are exactly
    the plain engine's; a greedy neighbour stays exact."""
    _, pm = lms

    def run(draft, **extra):
        eng = ServingEngine(pm, num_slots=2, max_len=48, device="cpu",
                            draft=draft, **extra)
        g = eng.submit(np.tile(PATTERN, 2)[:10], 10)
        s = eng.submit(PATTERN[:5], 12, temperature=0.9, top_p=0.95,
                       seed=7)
        out = eng.run(max_steps=800)
        return out[g], out[s], eng

    g_plain, s_plain, _ = run(None)
    g_spec, s_spec, eng = run(NgramDraft(), spec_k=3, **kw)
    np.testing.assert_array_equal(g_plain, g_spec)
    np.testing.assert_array_equal(s_plain, s_spec)
    assert eng.metrics.summary()["speculation"]["accepted"] > 0


class WrongDraft(DraftSource):
    """Always proposes token 0, which PATTERN never holds."""

    def propose(self, requests, tok, t, out, active):
        out[:] = 0


class HealingDraft(DraftSource):
    """Wrong for its first ``bad`` proposals, then an n-gram draft."""

    def __init__(self, bad):
        self.bad = bad
        self.calls = 0
        self.ngram = NgramDraft()

    def propose(self, requests, tok, t, out, active):
        self.calls += 1
        if self.calls <= self.bad:
            out[:] = 0
        else:
            self.ngram.propose(requests, tok, t, out, active)


def test_adversarial_draft_is_disabled_after_warmup(lms):
    """A draft that is always wrong: after ``spec_warmup`` verifies the
    stream's acceptance EMA is under the floor, speculation stops for it
    and it still decodes exactly."""
    jm, pm = lms
    eng = _spec_engine(pm, WrongDraft(), spec_warmup=3)
    rid = eng.submit(SPEC_PROMPTS[0], 12)
    eng.step()
    req = eng[rid]
    checks = []
    while not req.spec_disabled:
        eng.step()
        checks.append(req.spec_checks)
    assert req.spec_checks == 3 and req.spec_ema == 0.0
    eng.health()                      # the deferred samples land first
    proposed = eng.metrics.spec_proposed
    out = eng.run(max_steps=100)
    np.testing.assert_array_equal(out[rid], _ref(jm, SPEC_PROMPTS[0], 12))
    s = eng.metrics.summary()["speculation"]
    assert s["disabled_streams"] == 1 and s["accepted"] == 0
    assert eng.metrics.spec_proposed == proposed    # no more proposals


def test_spec_reprobe_reenables_a_healed_draft(lms):
    """With ``spec_reprobe`` a disabled stream re-probes (a crc32 coin
    per position) and wins speculation back once the draft predicts
    again; the stream stays token-identical."""
    jm, pm = lms
    prompt = np.tile(PATTERN, 2)[:8]
    eng = _spec_engine(pm, HealingDraft(bad=3), spec_warmup=3,
                       spec_reprobe=2, max_len=64)
    rid = eng.submit(prompt, 40)
    out = eng.run(max_steps=400)
    np.testing.assert_array_equal(out[rid], _ref(jm, prompt, 40))
    s = eng.metrics.summary()["speculation"]
    assert s["disabled_streams"] >= 1 and s["reenabled_streams"] >= 1
    assert s["accepted"] > 0


def test_speculation_knob_validation(lms):
    _, pm = lms
    bad = [dict(draft=NgramDraft(), spec_k=0),
           dict(draft=NgramDraft(), spec_disable_below=1.5),
           dict(draft=NgramDraft(), spec_reprobe=0),
           dict(spec_tree=True),
           dict(draft=NgramDraft(), spec_width=2),
           dict(draft=NgramDraft(), spec_tree=True, spec_width=0)]
    for kw in bad:
        with pytest.raises(ValueError):
            ServingEngine(pm, device="cpu", **kw)
    with pytest.raises(TypeError, match="DraftSource"):
        ServingEngine(pm, device="cpu", draft=object())
    eng = ServingEngine(pm, device="cpu")
    with pytest.raises(ValueError, match="speculate=True"):
        eng.submit(PATTERN[:4], 3, speculate=True)
    spec = ServingEngine(pm, device="cpu", draft=NgramDraft(), spec_k=3,
                         spec_tree=True, spec_width=2)
    assert spec.spec_window == 7
    rid = spec.submit(PATTERN[:4], 3, speculate=False)
    assert not spec[rid].speculate
    assert spec.submit(PATTERN[:4], 3) != rid
    s = spec.metrics.summary()
    assert s["acceptance_rate"] is None
    assert s["speculation"]["proposed"] == 0


def test_draft_model_heals_kv_after_side_branch_acceptance(lms):
    """A tree verify can accept a token the draft's greedy chain did not
    propose; the draft KV there then holds the wrong token's K/V. The
    heal pass must rewrite the divergent positions with the committed
    tokens before the next round: byte-identical to a fresh draft fed
    those tokens step by step."""
    _, pm = lms

    class Stub:
        num_slots, max_len, device = 1, 32, torch.device("cpu")

    class Req:
        pass

    def begun(ctx):
        d = DraftModel(pm, page_len=4)
        d.bind(Stub())
        assert d.begin_slot(0, ctx)
        return d

    prompt = PATTERN[:6]
    f = int(PATTERN[6])
    draft = begun(prompt)
    req = Req()
    req.prompt, req.generated = prompt, [f]
    toks = np.zeros((1, 7), np.int64)
    toks[0, 0] = f
    parents = np.full((1, 7), -1, np.int64)
    with torch.inference_mode():
        draft.propose_tree({0: req}, np.array([f]), np.array([6], np.int32),
                           toks, parents, np.array([True]),
                           np.array([3], np.int32), np.array([2], np.int32),
                           np.array([6], np.int32))
        g1 = draft._written[0][1][1]         # the chain token at position 7
        a, b = int((g1 + 3) % V), int((g1 + 5) % V)
        req.generated = [f, a, b, 1]         # committed f, a, b; 1 pends
        draft.propose({0: req}, np.array([1]), np.array([9], np.int32),
                      np.zeros((1, 3), np.int32), np.array([True]))
        oracle = begun(prompt)
        tables = oracle.pool.device_tables()
        for pos, tokv in ((6, f), (7, a), (8, b)):
            oracle._step(torch.tensor([tokv]), torch.tensor([pos],
                                                            dtype=torch.int32),
                         tables, 1)
    for kv_d, kv_o in zip(draft.pool.cache, oracle.pool.cache):
        if kv_d is None:
            continue
        for key in ("k", "v"):
            # slot 0 holds physical pages 0..7 in order: position 7 is
            # page 1 row 3, position 8 page 2 row 0
            assert torch.equal(kv_d[key][1, :, 3], kv_o[key][1, :, 3])
            assert torch.equal(kv_d[key][2, :, 0], kv_o[key][2, :, 0])


@pytest.mark.parametrize("kw", [{}, {"spec_tree": True, "spec_width": 2}],
                         ids=["linear", "tree"])
def test_decode_time_covers_the_draft_proposals(lms, kw):
    """Decode tokens/s prices speculation whole: the decode time a
    speculative iteration records includes its draft's proposal (a hand
    clock that the draft advances by one second per proposal)."""
    _, pm = lms
    box = [0.0]

    class SlowDraft(NgramDraft):
        def propose(self, *a):
            box[0] += 1.0
            return super().propose(*a)

        def propose_tree(self, *a):
            box[0] += 1.0
            return super().propose_tree(*a)

    eng = _spec_engine(pm, SlowDraft(),
                       metrics=ServingMetrics(clock=lambda: box[0]), **kw)
    eng.submit(SPEC_PROMPTS[0], 12)
    eng.run(max_steps=200)
    proposals = box[0]
    assert proposals >= 2
    decode_s = sum(a[1] for a in eng.metrics._decode_agg.values())
    assert decode_s == proposals


# --- the zero-bubble loop: overlap=True (the default) and fuse_steps ---------
#
# The cases of the JAX package's tests/test_serving_overlap.py on the paged
# layout: pipelined and fused streams token-identical to generate() (and to
# the JAX engine with the same knobs), sampled ones byte-identical to the
# synchronous loop's.

OVERLAP_POOL = dict(page_len=4, num_pages=24, prefix_cache=False)


def _drive(eng, subs, stagger=0):
    """Submit ``subs`` (``submit`` keywords), stepping ``stagger``
    iterations after each, then drain; returns ``({rid: tokens}, rids)``."""
    out = {}

    def tick():
        for r in eng.step():
            out[r.rid] = np.asarray(r.tokens)

    rids = []
    for kw in subs:
        rids.append(eng.submit(**kw))
        for _ in range(stagger):
            tick()
    steps = 0
    while eng.scheduler.pending:
        tick()
        steps += 1
        assert steps < 5000, "engine failed to drain"
    return out, rids


class _CountFused:
    """Counts the engine's fused windows while installed."""

    def __init__(self, monkeypatch):
        import distkeras_tpu_torch.serving.engine as eng_mod
        self.n = 0
        orig = eng_mod.decode_fused_slots

        def counted(*args, **kw):
            self.n += 1
            return orig(*args, **kw)

        monkeypatch.setattr(eng_mod, "decode_fused_slots", counted)


def test_pipelined_staggered_arrivals_match_generate(lms):
    """Staggered arrivals with mixed prompt lengths and budgets through
    the default pipelined engine (slots recycle while a step is in
    flight): every greedy stream equals generate()."""
    jm, pm = lms
    eng = ServingEngine(pm, num_slots=3, max_len=32, device="cpu",
                        **OVERLAP_POOL)
    assert eng.overlap and eng.fuse_steps == 0
    prompts = [PATTERN[:4], PATTERN[:6], PATTERN[:3], PATTERN[:5],
               PATTERN[:7]]
    budgets = [7, 5, 9, 6, 4]
    out, rids = _drive(eng, [dict(prompt=p, max_new_tokens=b)
                             for p, b in zip(prompts, budgets)], stagger=2)
    for rid, p, b in zip(rids, prompts, budgets):
        np.testing.assert_array_equal(out[rid], _ref(jm, p, b))
    assert eng.pool.free_pages == 24
    assert eng.metrics.summary()["requests_finished"] == 5


def test_pipelined_stop_token_mid_stream_matches_generate(lms):
    """A stop token read while the next step is already in flight: the
    stream was stepped once past it and that token is never consumed."""
    jm, pm = lms
    prompt = PATTERN[:5]
    ref = _ref(jm, prompt, 16, stop_token=9)
    assert 9 in ref[len(prompt):]
    eng = ServingEngine(pm, num_slots=2, max_len=32, device="cpu",
                        **OVERLAP_POOL)
    out, rids = _drive(eng, [
        dict(prompt=prompt, max_new_tokens=16, stop_token=9),
        dict(prompt=PATTERN[:4], max_new_tokens=8)])
    got = out[rids[0]]
    assert got[-1] == 9 and len(got) < len(prompt) + 16
    np.testing.assert_array_equal(got, ref[:len(got)])
    assert (ref[len(got):] == 9).all()               # generate()'s pad
    np.testing.assert_array_equal(out[rids[1]], _ref(jm, PATTERN[:4], 8))


SAMPLED_SUBS = [dict(prompt=PATTERN[:5], max_new_tokens=10,
                     temperature=0.9, top_p=0.95, seed=7),
                dict(prompt=PATTERN[:4], max_new_tokens=12,
                     temperature=0.7, top_k=8, seed=11),
                dict(prompt=PATTERN[:6], max_new_tokens=8)]  # greedy rider


@pytest.mark.parametrize("fused_sampling", [False, True])
def test_pipelined_sampled_streams_byte_identical_to_synchronous(
        lms, fused_sampling):
    """Sampled streams: each row draws once a step from its request's
    generator in the same order, so the pipelined loop's tokens are the
    synchronous loop's, byte for byte; the greedy rider equals
    generate()."""
    jm, pm = lms
    outs = {}
    for overlap in (False, True):
        eng = ServingEngine(pm, num_slots=2, max_len=32, device="cpu",
                            overlap=overlap, fused_sampling=fused_sampling,
                            **OVERLAP_POOL)
        outs[overlap], rids = _drive(eng, SAMPLED_SUBS, stagger=1)
    for rid in rids:
        np.testing.assert_array_equal(outs[False][rid], outs[True][rid])
    np.testing.assert_array_equal(outs[True][rids[2]],
                                  _ref(jm, PATTERN[:6], 8))


@pytest.mark.parametrize("cache_dtype", ["int8", "int4"])
def test_pipelined_quantized_pages_match_generate(lms, cache_dtype):
    jm, pm = lms
    eng = ServingEngine(pm, num_slots=2, max_len=32, cache_dtype=cache_dtype,
                        device="cpu", **OVERLAP_POOL)
    out, rids = _drive(eng, [dict(prompt=PATTERN[:6], max_new_tokens=8),
                             dict(prompt=PATTERN[:4], max_new_tokens=6)])
    for rid, p, b in zip(rids, (PATTERN[:6], PATTERN[:4]), (8, 6)):
        np.testing.assert_array_equal(
            out[rid], _ref(jm, p, b, cache_dtype=cache_dtype))


def test_spec_decode_with_pipelined_plain_iterations(lms):
    """A drafted engine: speculative iterations drain the pipeline and
    stay synchronous, the plain iterations around them pipeline; both
    streams equal generate()."""
    jm, pm = lms
    eng = ServingEngine(pm, num_slots=2, max_len=48, device="cpu",
                        draft=NgramDraft(), spec_k=3, page_len=4)
    prompt = np.tile(PATTERN, 3)[:10]
    out, rids = _drive(eng, [
        dict(prompt=prompt, max_new_tokens=16),
        dict(prompt=PATTERN[:5], max_new_tokens=8, speculate=False)])
    np.testing.assert_array_equal(out[rids[0]], _ref(jm, prompt, 16))
    np.testing.assert_array_equal(out[rids[1]], _ref(jm, PATTERN[:5], 8))
    assert eng.metrics.spec_proposed > 0


def test_fused_steady_state_matches_jax_engine_and_generate(lms,
                                                           monkeypatch):
    """A quiescent batch on a ``fuse_steps=4`` engine: fused windows
    engage after the prefill ramp, and each stream equals the JAX
    engine's with the same knobs and generate()."""
    from distkeras_tpu.serving import ServingEngine as JaxEngine
    jm, pm = lms
    fused = _CountFused(monkeypatch)
    subs = [dict(prompt=PATTERN[:5], max_new_tokens=14),
            dict(prompt=PATTERN[:4], max_new_tokens=11)]
    knobs = dict(num_slots=2, max_len=32, overlap=True, fuse_steps=4,
                 **OVERLAP_POOL)
    out, rids = _drive(ServingEngine(pm, device="cpu", **knobs), subs)
    assert fused.n >= 2, "the fused window never engaged"
    jout, jrids = _drive(JaxEngine(jm, **knobs), subs)
    for rid, jrid, kw in zip(rids, jrids, subs):
        np.testing.assert_array_equal(out[rid], jout[jrid])
        np.testing.assert_array_equal(
            out[rid], _ref(jm, kw["prompt"], kw["max_new_tokens"]))


def test_fused_stop_token_mid_window(lms, monkeypatch):
    """A stop token inside a fused window: the device mask pads the rest
    of the window with it and the host cuts there."""
    jm, pm = lms
    fused = _CountFused(monkeypatch)
    prompt = PATTERN[:5]
    ref = _ref(jm, prompt, 16, stop_token=9)
    eng = ServingEngine(pm, num_slots=2, max_len=40, device="cpu",
                        fuse_steps=4, **OVERLAP_POOL)
    out, rids = _drive(eng, [
        dict(prompt=prompt, max_new_tokens=16, stop_token=9),
        dict(prompt=PATTERN[:4], max_new_tokens=16)])
    got = out[rids[0]]
    assert got[-1] == 9 and len(got) < len(prompt) + 16
    np.testing.assert_array_equal(got, ref[:len(got)])
    np.testing.assert_array_equal(out[rids[1]], _ref(jm, PATTERN[:4], 16))
    assert fused.n >= 1


@pytest.mark.parametrize("fused_sampling", [False, True])
def test_fused_sampled_streams_byte_identical_to_synchronous(
        lms, monkeypatch, fused_sampling):
    """Sampled fused windows draw once per window step per row, so they
    replay the synchronous loop's draws exactly."""
    _, pm = lms
    fused = _CountFused(monkeypatch)
    subs = [dict(prompt=PATTERN[:5], max_new_tokens=12, temperature=0.9,
                 top_p=0.95, seed=7),
            dict(prompt=PATTERN[:4], max_new_tokens=12, temperature=0.7,
                 top_k=8, seed=3)]
    outs = []
    for kw in (dict(overlap=False), dict(overlap=True, fuse_steps=4)):
        eng = ServingEngine(pm, num_slots=2, max_len=32, device="cpu",
                            fused_sampling=fused_sampling, **kw)
        outs.append(_drive(eng, subs))
    assert fused.n >= 1
    (out_s, rids_s), (out_f, rids_f) = outs
    for a, b in zip(rids_s, rids_f):
        np.testing.assert_array_equal(out_s[a], out_f[b])


def test_arrival_mid_fused_run_breaks_quiescence_and_matches(lms,
                                                            monkeypatch):
    """A request arriving while fused windows run: the next iteration
    sees the queue, runs single steps while it admits, and fuses again
    later; both streams equal generate()."""
    jm, pm = lms
    fused = _CountFused(monkeypatch)
    eng = ServingEngine(pm, num_slots=2, max_len=40, device="cpu",
                        fuse_steps=4)
    r0 = eng.submit(PATTERN[:5], 20)
    for _ in range(6):                          # into fused steady state
        eng.step()
    before = fused.n
    assert before >= 1
    r1 = eng.submit(PATTERN[:4], 10)
    out = eng.run(max_steps=2000)
    assert fused.n > before
    np.testing.assert_array_equal(out[r0], _ref(jm, PATTERN[:5], 20))
    np.testing.assert_array_equal(out[r1], _ref(jm, PATTERN[:4], 10))


def test_preemption_during_fused_run_falls_back_and_rejoins(lms,
                                                           monkeypatch):
    """Under page pressure funding a window (or an admission) preempts a
    stream: the iteration runs one step instead, the victim re-prefills,
    fused windows resume, and both streams equal generate()."""
    jm, pm = lms
    fused = _CountFused(monkeypatch)
    eng = ServingEngine(pm, num_slots=2, max_len=32, page_len=4,
                        num_pages=8, prefix_cache=False, device="cpu",
                        fuse_steps=4)
    r0 = eng.submit(PATTERN[:5], 16)
    eng.step()
    eng.step()
    r1 = eng.submit(PATTERN[:6], 15)
    out = eng.run(max_steps=2000)
    assert eng.metrics.requests_preempted >= 1
    assert fused.n >= 1, "the fused window never engaged"
    np.testing.assert_array_equal(out[r0], _ref(jm, PATTERN[:5], 16))
    np.testing.assert_array_equal(out[r1], _ref(jm, PATTERN[:6], 15))
    assert eng.pool.free_pages == 8


def test_fuse_steps_validation(lms):
    _, pm = lms
    with pytest.raises(ValueError, match="fuse_steps"):
        ServingEngine(pm, num_slots=1, max_len=16, device="cpu",
                      fuse_steps=-1)


def test_metrics_window_swap_drains_deferred_host_work(lms):
    """Swapping the metrics window mid-flight flushes the pipeline and
    the deferred samples into the OLD window: the decode tokens of the
    two windows add up to exactly those generated."""
    _, pm = lms
    eng = ServingEngine(pm, num_slots=2, max_len=32, device="cpu")
    r0 = eng.submit(PATTERN[:5], 12)
    for _ in range(5):
        eng.step()
    w0 = eng.metrics
    eng.metrics = ServingMetrics()
    out = eng.run(max_steps=2000)
    w1 = eng.metrics

    def toks(w):
        return sum(a[0] for a in w._decode_agg.values())

    # 12 budgeted: the prefill's first token, then 11 decoded
    assert toks(w0) + toks(w1) == 11
    assert toks(w0) > 0 and toks(w1) > 0
    assert len(out[r0]) == len(PATTERN[:5]) + 12


# --- degradation: deadlines, cancel, run(on_degraded=) ----------------------
#
# The JAX package's oracles (tests/test_resilience.py, the serving
# degradation section) rerun on the port under both loops, each against
# the JAX engine driven through the same scenario with the same loop.

LOOP_KW = [dict(overlap=True), dict(overlap=False)]
LOOP_IDS = ["overlap", "sync"]


def _jax_engine(jm, **kw):
    from distkeras_tpu.serving.engine import ServingEngine as JaxEngine
    return JaxEngine(jm, **kw)


def _drain_all(eng, max_steps=400):
    done = {}
    for _ in range(max_steps):
        for r in eng.step():
            done[r.rid] = r
        if not eng.scheduler.pending:
            return done
    raise AssertionError("engine failed to drain")


def _clocked(box):
    return ServingMetrics(clock=lambda: box[0])


def _jax_metrics(box):
    from distkeras_tpu.serving.metrics import ServingMetrics as JaxMetrics
    return JaxMetrics(clock=lambda: box[0])


@pytest.mark.parametrize("loop", LOOP_KW, ids=LOOP_IDS)
def test_deadline_expires_queued_request_to_timed_out(lms, loop):
    jm, pm = lms

    def scenario(eng, box):
        r1 = eng.submit(PATTERN[:4], 6)                   # no deadline
        r2 = eng.submit(PATTERN[:4], 6, deadline_s=5.0)   # will starve
        box[0] = 10.0                                     # r2 expired
        done = _drain_all(eng)
        return done[r1], done[r2]

    box = [0.0]
    eng = ServingEngine(pm, num_slots=1, max_len=32, device="cpu",
                        metrics=_clocked(box), **loop)
    r1, r2 = scenario(eng, box)
    assert r2.state is RequestState.TIMED_OUT
    assert r2.generated == []                             # never admitted
    assert r1.state is RequestState.FINISHED
    assert eng.metrics.requests_timed_out == 1
    assert eng.metrics.summary()["requests_timed_out"] == 1
    assert eng.health()["requests"]["timed_out"] == 1
    jbox = [0.0]
    j1, j2 = scenario(_jax_engine(jm, num_slots=1, max_len=32,
                                  metrics=_jax_metrics(jbox), **loop), jbox)
    np.testing.assert_array_equal(r1.tokens, j1.tokens)
    assert (r2.state.value, r2.generated) == (j2.state.value, j2.generated)
    with pytest.raises(ValueError, match="deadline_s"):
        eng.submit(PATTERN[:3], 2, deadline_s=0.0)


@pytest.mark.parametrize("loop", LOOP_KW, ids=LOOP_IDS)
def test_deadline_mid_decode_keeps_partial_tokens_frees_slot(lms, loop):
    """Expiry mid-decode lands the unit in flight first (under overlap a
    launched step holds the slot): the request keeps every token the
    flush lands, the JAX engine's, and the slot serves the next request
    exactly."""
    jm, pm = lms

    def scenario(eng, box):
        r1 = eng.submit(PATTERN[:4], 20, deadline_s=5.0)
        done = {}
        for _ in range(5):                     # prefill + a few decodes
            for r in eng.step():
                done[r.rid] = r
        assert eng[r1].state.value == "decoding"
        box[0] = 10.0                          # expire mid-decode
        r2 = eng.submit(PATTERN[:3], 3)        # next occupant
        done.update(_drain_all(eng))
        return done[r1], done[r2]

    box = [0.0]
    p1, p2 = scenario(ServingEngine(pm, num_slots=1, max_len=32,
                                    device="cpu", metrics=_clocked(box),
                                    **loop), box)
    assert p1.state is RequestState.TIMED_OUT
    assert 0 < len(p1.generated) < 20          # partial output kept
    assert p2.state is RequestState.FINISHED
    np.testing.assert_array_equal(p2.tokens, _ref(jm, PATTERN[:3], 3))
    jbox = [0.0]
    j1, j2 = scenario(_jax_engine(jm, num_slots=1, max_len=32,
                                  metrics=_jax_metrics(jbox), **loop), jbox)
    assert p1.generated == j1.generated
    np.testing.assert_array_equal(p2.tokens, j2.tokens)


@pytest.mark.parametrize("loop", LOOP_KW, ids=LOOP_IDS)
def test_run_raises_on_degraded_request(lms, loop):
    """``run()``'s plain ``{rid: tokens}`` never passes a degraded
    request off as a finished one; ``on_degraded="return"`` accepts the
    partial tokens."""
    from distkeras_tpu_torch.serving import DegradedRequest
    _, pm = lms
    box = [0.0]
    eng = ServingEngine(pm, num_slots=1, max_len=32, device="cpu",
                        metrics=_clocked(box), **loop)
    eng.submit(PATTERN[:4], 6, deadline_s=2.0)
    box[0] = 5.0
    with pytest.raises(DegradedRequest, match="timed_out") as err:
        eng.run(max_steps=50)
    assert err.value.request.state is RequestState.TIMED_OUT
    box2 = [0.0]
    eng2 = ServingEngine(pm, num_slots=1, max_len=32, device="cpu",
                         metrics=_clocked(box2), **loop)
    rid2 = eng2.submit(PATTERN[:4], 6, deadline_s=2.0)
    box2[0] = 5.0
    out = eng2.run(max_steps=50, on_degraded="return")
    np.testing.assert_array_equal(out[rid2], PATTERN[:4])  # prompt only
    with pytest.raises(ValueError, match="on_degraded"):
        eng2.run(on_degraded="bogus")


@pytest.mark.parametrize("loop", LOOP_KW, ids=LOOP_IDS)
def test_engine_cancel_api(lms, loop):
    """``cancel`` ends a decoding request CANCELLED with the tokens the
    flush lands (the JAX engine's), evicts it, and the survivor and the
    slot's next occupant stay exact; a request the flush finishes comes
    back FINISHED."""
    jm, pm = lms

    def scenario(eng):
        keep = eng.submit(PATTERN[:4], 5)
        drop = eng.submit(PATTERN[:5], 9)
        done = {}
        for i in range(6):       # both prefilled, `drop` a few steps in
            for r in eng.step():
                done[r.rid] = r
        req = eng.cancel(drop)
        with pytest.raises(KeyError):
            eng[drop]                          # evicted from the engine
        nxt = eng.submit(PATTERN[:6], 4)
        done.update(_drain_all(eng))
        return req, done[keep], done[nxt]

    req, keep, nxt = scenario(ServingEngine(pm, num_slots=2, max_len=32,
                                            device="cpu", **loop))
    assert req.state is RequestState.CANCELLED and req.generated
    assert keep.state is RequestState.FINISHED
    np.testing.assert_array_equal(keep.tokens, _ref(jm, PATTERN[:4], 5))
    np.testing.assert_array_equal(nxt.tokens, _ref(jm, PATTERN[:6], 4))
    jreq, _, _ = scenario(_jax_engine(jm, num_slots=2, max_len=32, **loop))
    assert req.generated == jreq.generated
    # under overlap, a request whose last token is in flight: the flush
    # finishes it, and the FINISHED record comes back
    eng = ServingEngine(pm, num_slots=1, max_len=32, device="cpu", **loop)
    rid = eng.submit(PATTERN[:4], 3)
    eng.step()                 # prefill, first token, one decode launched
    if loop["overlap"]:
        eng.step()             # the unit in flight holds the last token
        out = eng.cancel(rid)
        assert out.state is RequestState.FINISHED
        assert len(out.generated) == 3
        assert eng.metrics.requests_cancelled == 0
    else:
        out = eng.cancel(rid)
        assert out.state is RequestState.CANCELLED
        assert len(out.generated) == 2
    np.testing.assert_array_equal(
        out.tokens, _ref(jm, PATTERN[:4], 3)[:4 + len(out.generated)])
    assert not eng.scheduler.pending and not eng.step()


# --- the byte budget (hbm_budget) -------------------------------------------
#
# The JAX package's oracles (tests/test_kv_bytes.py): pages from a byte
# budget, the same count as the JAX pool and engine for the same budget.


def test_hbm_budget_sizes_pool(lms):
    from distkeras_tpu.models.decoding import _resolve_head_dims
    from distkeras_tpu.serving.kv_pool import PagedKVPool as JaxPool
    jm, pm = lms
    _resolve_head_dims(jm.module, jm.params)   # bare-module pool probes
    pb = PagedKVPool(pm.module, 2, 64, page_len=16, dtype="int4",
                     device="cpu").page_bytes
    assert pb == JaxPool(jm.module, 2, 64, page_len=16,
                         dtype="int4").page_bytes
    pool = PagedKVPool(pm.module, 2, 64, page_len=16, dtype="int4",
                       hbm_budget=10 * pb + pb // 2, reserve_bytes=pb,
                       device="cpu")
    assert pool.num_pages == 9        # (10.5 - 1) pages round down
    # the sink page is the one byte the pool holds beyond the budget
    assert pool.allocated_bytes() == 10 * pb
    with pytest.raises(ValueError, match="not both"):
        PagedKVPool(pm.module, 2, 64, page_len=16, num_pages=4,
                    hbm_budget=1 << 20, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        PagedKVPool(pm.module, 2, 64, page_len=16, hbm_budget=pb,
                    reserve_bytes=pb, device="cpu")
    with pytest.raises(ValueError, match="even"):
        PagedKVPool(pm.module, 2, 64, page_len=15, dtype="int4",
                    device="cpu")


def test_int4_kv_admits_more_streams_under_same_budget(lms):
    """Same budget, same weights: the int4-KV engine holds more decoding
    streams than the bf16 one, with the JAX engine's pages and
    occupancy."""
    import jax.numpy as jnp
    jm, pm = lms
    weight_bytes = ServingEngine(pm, num_slots=4, max_len=32, page_len=8,
                                 device="cpu").param_bytes()
    bf16_pb = PagedKVPool(pm.module, 1, 32, page_len=8,
                          dtype=torch.bfloat16, device="cpu").page_bytes
    budget = weight_bytes + 4 * bf16_pb

    def occupied(engine, model, cache_dtype, **kw):
        eng = engine(model, num_slots=4, max_len=32, page_len=8,
                     cache_dtype=cache_dtype, hbm_budget=budget, **kw)
        for _ in range(6):
            eng.submit(PATTERN[:8], 4)
        eng.step()
        return eng.pool.num_pages, eng.scheduler.occupied

    bf16 = occupied(ServingEngine, pm, torch.bfloat16, device="cpu")
    int4 = occupied(ServingEngine, pm, "int4", device="cpu")
    assert bf16 == (4, 2)
    assert int4[0] > bf16[0] and int4[1] > bf16[1]
    assert bf16 == occupied(_jax_engine, jm, jnp.bfloat16)
    assert int4 == occupied(_jax_engine, jm, "int4")


def test_quantized_weights_free_budget_for_pages(lms):
    """``weight_quant`` shrinks the reserve side of the same envelope:
    strictly more pages than float weights, as many as the JAX engine
    gets."""
    jm, pm = lms
    f32_w = sum(p.numel() * p.element_size() for p in pm.module.parameters())
    budget = f32_w + 6 * PagedKVPool(pm.module, 1, 32, page_len=8,
                                     dtype="int4",
                                     device="cpu").page_bytes
    kw = dict(num_slots=2, max_len=32, page_len=8, cache_dtype="int4",
              hbm_budget=budget)
    base = ServingEngine(pm, device="cpu", **kw)
    quant = ServingEngine(pm, device="cpu", weight_quant="int4", **kw)
    assert base.pool.num_pages == 6
    assert quant.pool.num_pages > base.pool.num_pages
    assert quant.pool.num_pages == _jax_engine(
        jm, weight_quant="int4", **kw).pool.num_pages
    rid = quant.submit(PATTERN[:4], 5)
    np.testing.assert_array_equal(quant.run(max_steps=100)[rid],
                                  _ref(jm, PATTERN[:4], 5))


# --- weights_dtype, decode_kernel, engine_id ---------------------------------


def test_weights_dtype_and_validation(lms):
    """``weights_dtype``: "auto" is the compute dtype (float32 here), a
    float dtype casts the served matrices, ``weight_quant`` wins;
    anything else raises, as do a bad ``decode_kernel`` and the paged-only
    options on a slab engine."""
    jm, pm = lms
    assert ServingEngine(pm, device="cpu")._params[1]["attn"][
        "wqkv"].dtype == torch.float32
    for wd in (None, torch.float32):
        eng = ServingEngine(pm, num_slots=1, max_len=32, device="cpu",
                            weights_dtype=wd)
        rid = eng.submit(PATTERN[:5], 6)
        np.testing.assert_array_equal(eng.run(max_steps=50)[rid],
                                      _ref(jm, PATTERN[:5], 6))
    q = ServingEngine(pm, device="cpu", weights_dtype="bfloat16",
                      weight_quant="int8")
    assert q._params[1]["attn"]["wq"]["q"].dtype == torch.int8
    with pytest.raises(ValueError, match="weights_dtype"):
        ServingEngine(pm, device="cpu", weights_dtype=torch.int32)
    with pytest.raises(ValueError, match="decode_kernel"):
        ServingEngine(pm, device="cpu", decode_kernel="pallas")
    with pytest.raises(ValueError, match="decode_kernel"):
        ServingEngine(pm, device="cpu", kv_layout="slab",
                      decode_kernel="off")
    with pytest.raises(ValueError, match="hbm_budget"):
        ServingEngine(pm, device="cpu", kv_layout="slab", hbm_budget=1 << 30)
    with pytest.raises(ValueError, match="kv_layout"):
        ServingEngine(pm, device="cpu", kv_layout="ring")


@pytest.mark.parametrize("case", ["plain", "int8", "int4", "tree"])
def test_decode_kernel_paths_give_equal_streams(lms, case):
    """``decode_kernel`` "auto", "paged" (the kernel's plain version on
    the CPU) and "off" (the gather readout) give the same greedy and
    sampled streams, equal to JAX ``generate()`` where greedy."""
    jm, pm = lms
    kw = dict(num_slots=3, max_len=48, page_len=4, device="cpu")
    if case in ("int8", "int4"):
        kw["cache_dtype"] = case
    if case == "tree":
        kw.update(spec_k=3, spec_tree=True, spec_width=2)
    reqs = [(np.tile(PATTERN, 2)[:10], 9, {}),
            (PATTERN[:5], 10, dict(temperature=1.7, top_k=5, seed=3)),
            (PATTERN[:6], 8, {})]
    outs = {}
    for dk in ("auto", "paged", "off"):
        extra = {"draft": NgramDraft()} if case == "tree" else {}
        eng = ServingEngine(pm, decode_kernel=dk, **kw, **extra)
        rids = [eng.submit(p, n, **k) for p, n, k in reqs]
        out = eng.run(max_steps=500)
        outs[dk] = [out[r] for r in rids]
    for dk in ("paged", "off"):
        for a, b in zip(outs["auto"], outs[dk]):
            np.testing.assert_array_equal(a, b)
    cache = kw.get("cache_dtype")
    for (p, n, k), got in zip(reqs, outs["off"]):
        if not k:
            np.testing.assert_array_equal(got, _ref(
                jm, p, n, **({"cache_dtype": cache, "prefill_chunk": None}
                             if cache else {})))


def test_engine_id_names_and_disambiguates(lms):
    """The first live engine is "serving", later ones "serving[<hex>]";
    an id a live engine holds gets a "#<hex>" suffix."""
    import gc
    from distkeras_tpu_torch import obs
    _, pm = lms
    gc.collect()
    live = obs.components()
    a = ServingEngine(pm, num_slots=1, max_len=16, device="cpu",
                      engine_id="replica-7")
    b = ServingEngine(pm, num_slots=1, max_len=16, device="cpu",
                      engine_id="replica-7")
    assert a.engine_id == "replica-7"
    assert b.engine_id == f"replica-7#{id(b):x}"
    assert b.health()["engine_id"] == b.engine_id
    c = ServingEngine(pm, num_slots=1, max_len=16, device="cpu")
    assert c.engine_id == ("serving" if "serving" not in live
                           else f"serving[{id(c):x}]")
    d = ServingEngine(pm, num_slots=1, max_len=16, device="cpu")
    assert d.engine_id == f"serving[{id(d):x}]"


# --- sampled streams: JAX's threefry key chain --------------------------------

SAMPLED_REQS = [(PATTERN[:4], dict(temperature=0.9, top_k=6, top_p=0.9,
                                   seed=7)),
                (PATTERN[:6], dict(temperature=1.3, seed=3)),
                (PATTERN[:5], dict(temperature=0.7, top_p=0.5, seed=5)),
                (PATTERN[:3], {}),
                (PATTERN[:5], dict(temperature=2.5, seed=11)),
                (PATTERN[:2], dict(temperature=3.0, top_k=4, seed=2 ** 32 + 1))]
SAMPLED_LOOPS = {
    "overlap": {}, "sync": dict(overlap=False), "fuse4": dict(fuse_steps=4),
    "fused-sampler": dict(fused_sampling=True),
    "fuse4-fused-sampler": dict(fuse_steps=4, fused_sampling=True),
    "spec-linear": dict(spec_k=3), "spec-tree": dict(spec_k=3,
                                                      spec_tree=True,
                                                      spec_width=2)}


@pytest.mark.parametrize("loop", sorted(SAMPLED_LOOPS))
def test_sampled_streams_byte_identical_to_jax_engine(lms, loop):
    """Seeded sampled requests (per-request knobs, a seed past 2^32) with
    a greedy neighbour: every stream equals the JAX engine's with the
    same seeds and knobs, byte for byte, single-step, fused and
    speculative, with and without the fused sampler."""
    from distkeras_tpu.serving import NgramDraft as JaxNgramDraft
    jm, pm = lms
    kw = dict(SAMPLED_LOOPS[loop])

    def streams(engine, model, draft, **extra):
        if loop.startswith("spec"):
            extra["draft"] = draft()
        eng = engine(model, num_slots=3, max_len=32, **kw, **extra)
        rids = [eng.submit(p, 12, **k) for p, k in SAMPLED_REQS]
        out = eng.run(max_steps=400)
        return [out[r] for r in rids]

    got = streams(ServingEngine, pm, NgramDraft, device="cpu")
    want = streams(_jax_engine, jm, JaxNgramDraft)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    # the draws matter: a hot request leaves the greedy stream
    greedy = _ref(jm, PATTERN[:5], 12)
    assert not np.array_equal(got[4], greedy)


@pytest.mark.parametrize("knobs", [dict(temperature=0.9, top_k=6),
                                   dict(temperature=2.0, top_p=0.9),
                                   dict(temperature=2.5)],
                         ids=["topk", "topp", "plain"])
def test_sampled_engine_stream_equals_generate(lms, knobs):
    """One request's key chain is ``generate()``'s for a batch of one:
    ``PRNGKey(seed)``, a split per token. The engine's sampled stream
    equals JAX ``generate()`` and the port's ``generate()``."""
    jm, pm = lms
    eng = ServingEngine(pm, num_slots=2, max_len=32, device="cpu")
    rid = eng.submit(PATTERN[:5], 14, seed=21, **knobs)
    eng.submit(PATTERN[:3], 9)                      # a greedy neighbour
    got = eng.run(max_steps=200)[rid]
    want = generate(jm, PATTERN[None, :5], max_new_tokens=14, seed=21,
                    **knobs)[0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        pm.generate(PATTERN[None, :5], 14, seed=21, **knobs)[0], want)


# --- the slab engine (kv_layout="slab") --------------------------------------
#
# The JAX package's slab oracles (tests/test_serving.py :420, :452, :825,
# :849, tests/test_spec_decode.py :184) rerun on the port, each against
# the JAX slab engine on the same weights and workload.

SLAB_PROMPTS = [PATTERN[:4], np.tile(PATTERN, 2)[:13], PATTERN[:3],
                PATTERN[:6]]
SLAB_BUDGETS = [7, 6, 9, 5]


def _slab_streams(eng):
    """Staggered arrivals through three slots (one waits for a free
    one): the streams in submit order."""
    rids = [eng.submit(p, b) for p, b in zip(SLAB_PROMPTS[:2],
                                             SLAB_BUDGETS[:2])]
    eng.step()
    rids += [eng.submit(p, b) for p, b in zip(SLAB_PROMPTS[2:],
                                              SLAB_BUDGETS[2:])]
    out = eng.run(max_steps=500)
    return [out[r] for r in rids]


@pytest.mark.parametrize("cache_dtype", [None, "int8", "int4"])
def test_slab_engine_matches_generate_and_jax_engine(lms, cache_dtype):
    """Greedy slab streams (FCFS admission, a queued request, chunked
    prefill) are token-identical to JAX ``generate()`` and to JAX's slab
    engine at every cache dtype the JAX slab engine takes."""
    from distkeras_tpu.serving import KVPool as JaxKVPool
    jm, pm = lms
    kw = dict(num_slots=3, max_len=32, prefill_chunk=4,
              kv_layout="slab", cache_dtype=cache_dtype)
    eng = ServingEngine(pm, device="cpu", **kw)
    assert isinstance(eng.pool, KVPool) and eng.prefix is None
    assert isinstance(eng.scheduler, FIFOScheduler)
    assert not isinstance(eng.scheduler, PriorityScheduler)
    kv = next(kv for kv in eng.pool.cache if kv is not None)
    assert kv["k"].shape[:3] == (3, 4, 32)
    jeng = _jax_engine(jm, **kw)
    assert isinstance(jeng.pool, JaxKVPool)
    got, want = _slab_streams(eng), _slab_streams(jeng)
    for g, w, p, n in zip(got, want, SLAB_PROMPTS, SLAB_BUDGETS):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(
            g, _ref(jm, p, n, cache_dtype=cache_dtype, prefill_chunk=4))
    assert eng.metrics.requests_preempted == 0


SLAB_CASES = {
    "sync": dict(overlap=False),
    "fuse4": dict(fuse_steps=4),
    "ngram-linear": dict(spec_k=3),
    "ngram-tree": dict(spec_k=3, spec_tree=True, spec_width=2),
    "wq-int8": dict(weight_quant="int8"),
    "wq-int4": dict(weight_quant="int4"),
    "wq-int8-int4-pages-ngram": dict(weight_quant="int8",
                                     cache_dtype="int4", spec_k=3),
}


@pytest.mark.parametrize("case", sorted(SLAB_CASES))
def test_slab_engine_options_match_jax_engine(lms, case):
    """The slab engine's options as in JAX: the synchronous loop, fused
    windows, chain and tree speculation (token-tiled prompts the n-gram
    draft predicts) and quantized weights, each token-identical to the
    JAX slab engine and to ``generate()``."""
    from distkeras_tpu.serving import NgramDraft as JaxNgramDraft
    jm, pm = lms
    kw = dict(num_slots=3, max_len=48, kv_layout="slab", prefill_chunk=4,
              **SLAB_CASES[case])
    spec = "spec_k" in kw
    prompts = [np.tile(PATTERN, 3)[:14], PATTERN[:5], np.tile(PATTERN, 2)[:9]]
    budgets = [12, 9, 14]

    def streams(eng):
        rids = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
        n_steps = 0
        out = {}
        while eng.scheduler.pending:
            for r in eng.step():
                out[r.rid] = r.tokens
            n_steps += 1
        return [out[r] for r in rids], n_steps

    got, steps = streams(ServingEngine(
        pm, device="cpu", draft=NgramDraft() if spec else None, **kw))
    want, _ = streams(_jax_engine(
        jm, draft=JaxNgramDraft() if spec else None, **kw))
    for g, w, p, n in zip(got, want, prompts, budgets):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(
            g, _ref(jm, p, n, cache_dtype=kw.get("cache_dtype"),
                    prefill_chunk=4))
    if spec:
        # the drafts were accepted: fewer iterations than tokens
        assert steps < sum(budgets)


@pytest.mark.parametrize("loop", ["overlap", "fuse4", "spec-tree"])
def test_slab_sampled_streams_byte_identical_to_jax_engine(lms, loop):
    """Seeded sampled requests beside a greedy one on the slab engine:
    every stream equals the JAX slab engine's, byte for byte."""
    from distkeras_tpu.serving import NgramDraft as JaxNgramDraft
    jm, pm = lms
    kw = dict(SAMPLED_LOOPS[loop], kv_layout="slab")

    def streams(engine, model, draft, **extra):
        if loop.startswith("spec"):
            extra["draft"] = draft()
        eng = engine(model, num_slots=3, max_len=32, **kw, **extra)
        rids = [eng.submit(p, 12, **k) for p, k in SAMPLED_REQS]
        out = eng.run(max_steps=400)
        return [out[r] for r in rids]

    got = streams(ServingEngine, pm, NgramDraft, device="cpu")
    want = streams(_jax_engine, jm, JaxNgramDraft)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert not np.array_equal(got[4], _ref(jm, PATTERN[:5], 12))


def _slab_contents(module, rs, n_slots, length, dtype=np.float32):
    """Seeded content of every attention layer's slab rows: ``[{"k",
    "v"}]`` numpy ``[S, Hkv, L, Dh]`` (None for other layers)."""
    from distkeras_tpu_torch.models.decoding import init_cache
    shapes = init_cache(module, n_slots, length, torch.float32, "meta")
    return [None if kv is None else
            {key: rs.randn(*kv[key].shape).astype(dtype)
             for key in ("k", "v")} for kv in shapes]


def test_decode_step_slots_matches_jax_and_the_gather_readout(lms):
    """One slab decode step over seeded rows: logits within 1e-5 of JAX's
    ``decode_step_slots`` (float32), the rows written at each slot's
    position as JAX writes them, a free slot (t = L) writing nothing;
    and the logits bitwise equal to the gather-readout paged step over
    the same contents scattered across scrambled pages."""
    import jax.numpy as jnp
    from distkeras_tpu.models.decoding import (
        _resolve_head_dims, decode_step_slots as jax_step,
        init_cache as jax_init)
    from distkeras_tpu_torch.models import decoding as pd
    jm, pm = lms
    _resolve_head_dims(jm.module, jm.params)
    n_slots, length, page_len = 3, 12, 4
    rs = np.random.RandomState(5)
    rows = _slab_contents(pm.module, rs, n_slots, length)
    tok = np.array([3, 7, 11], np.int64)
    t = np.array([5, 11, length], np.int32)          # slot 2 is free
    pool = KVPool(pm.module, n_slots, length, device="cpu")
    for kv, r in zip(pool.cache, rows):
        if kv is not None:
            for key in ("k", "v"):
                kv[key].copy_(torch.from_numpy(r[key]))
    jcache = [None if r is None else
              {key: jnp.asarray(r[key]) for key in ("k", "v")}
              for r in rows]
    assert len(jcache) == len(jax_init(jm.module, n_slots, length))
    want, jnew = jax_step(jm.module, jm.params, jm.state, jcache,
                          jnp.asarray(tok.astype(np.int32)),
                          jnp.asarray(t))
    params = pm.params
    got, _ = pd.decode_step_slots(pm.module, params, pool.cache,
                                  torch.from_numpy(tok), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for kv, jkv, r in zip(pool.cache, jnew, rows):
        if kv is None:
            continue
        for key in ("k", "v"):
            np.testing.assert_allclose(kv[key].numpy(), np.asarray(jkv[key]),
                                       atol=1e-5, rtol=1e-5)
            np.testing.assert_array_equal(kv[key][2].numpy(), r[key][2])
    # the same contents scattered over pages: the gather readout is the
    # slab readout, bit for bit
    table = np.array([[5, 2, 0], [1, 4, 3], [8, 7, 6]], np.int32)
    paged = PagedKVPool(pm.module, n_slots, length, page_len=page_len,
                        num_pages=9, device="cpu")
    for kv, r in zip(paged.cache, rows):
        if kv is None:
            continue
        for key in ("k", "v"):
            pages = torch.from_numpy(r[key]).reshape(
                n_slots, -1, 3, page_len, r[key].shape[-1]).transpose(1, 2)
            kv[key][torch.from_numpy(table.astype(np.int64))] = pages
    got_p, _ = pd.decode_step_slots_paged(
        pm.module, params, paged.cache, torch.from_numpy(tok),
        torch.from_numpy(np.minimum(t, length - 1)),
        torch.from_numpy(table), page_len, paged_kernel=False)
    live = slice(0, 2)            # the free slot's sentinel differs
    np.testing.assert_array_equal(got_p[live].numpy(), got[live].numpy())


def test_slab_insert_writes_only_prompt_positions(lms):
    """``KVPool.insert`` writes the prompt's positions of one row and
    nothing else, as JAX's does (JAX :825)."""
    import jax
    import jax.numpy as jnp
    from distkeras_tpu.models.decoding import _resolve_head_dims
    from distkeras_tpu.serving import KVPool as JaxKVPool
    jm, pm = lms
    _resolve_head_dims(jm.module, jm.params)
    pool = KVPool(pm.module, num_slots=3, max_len=10, device="cpu")
    jpool = JaxKVPool(jm.module, num_slots=3, max_len=10)
    for kv in pool.cache:
        if kv is not None:
            for key in ("k", "v"):
                kv["sink"][key].fill_(9.0)
    jpool.cache = jax.tree_util.tree_map(lambda x: jnp.full_like(x, 9.0),
                                         jpool.cache)
    req = pool.make_request_cache()
    for kv in req:
        if kv is not None:
            for key in ("k", "v"):
                kv[key].fill_(7.0)
    jreq = jax.tree_util.tree_map(lambda x: jnp.full_like(x, 7.0),
                                  jpool.make_request_cache())
    pool.insert(req, 1, n_pos=3)
    jpool.insert(jreq, 1, n_pos=3)
    for kv, jkv in zip(pool.cache, jpool.cache):
        if kv is None:
            continue
        arr = kv["k"].numpy()
        np.testing.assert_array_equal(arr, np.asarray(jkv["k"]))
        assert (arr[1][:, :3] == 7.0).all()
        assert (arr[1][:, 3:] == 9.0).all()
        assert (arr[0] == 9.0).all() and (arr[2] == 9.0).all()
        assert (kv["sink"]["k"][3] == 9.0).all()       # the sink row
    with pytest.raises(ValueError, match="n_pos"):
        pool.insert(req, 1, n_pos=11)
    with pytest.raises(ValueError, match="slot"):
        pool.insert(req, 3, n_pos=2)


def test_slab_summary_and_health_match_jax(lms):
    """A slab engine reports no pages: ``summary()["pages"]`` is None and
    ``health()`` has no ``"pages"`` or ``"prefix_cache"`` key, as the
    JAX slab engine's (JAX :849-871); the paged engine's health carries
    both, with the host tier None when it is off."""
    jm, pm = lms
    slab = ServingEngine(pm, num_slots=1, max_len=16, kv_layout="slab",
                         device="cpu")
    jslab = _jax_engine(jm, num_slots=1, max_len=16, kv_layout="slab")
    for eng in (slab, jslab):
        eng.submit(PATTERN[:4], 3)
        eng.run(max_steps=200)
    assert slab.metrics.summary()["pages"] is None
    assert jslab.metrics.summary()["pages"] is None
    h = slab.health()
    assert "pages" not in h and "prefix_cache" not in h
    assert "pages" not in jslab.health()
    assert h["slots"] == jslab.health()["slots"]
    assert h["requests"]["finished"] == 1
    paged = ServingEngine(pm, num_slots=1, max_len=16, page_len=4,
                          device="cpu")
    assert paged.health()["pages"]["host"] is None


@pytest.mark.parametrize("kw,msg", [
    ({"host_kv_pages": 4}, "host_kv_pages"),
    ({"hbm_budget": 1 << 30}, "hbm_budget"),
    ({"decode_kernel": "off"}, "decode_kernel")])
def test_slab_refuses_paged_only_options(lms, kw, msg):
    """Paged-only options raise ``ValueError`` on a slab engine (JAX
    :441-455), as the JAX engine's do."""
    jm, pm = lms
    with pytest.raises(ValueError, match=msg):
        ServingEngine(pm, device="cpu", kv_layout="slab", **kw)
    with pytest.raises(ValueError, match=msg):
        _jax_engine(jm, kv_layout="slab", **kw)


def test_slab_priority_is_fcfs(lms):
    """The slab engine ignores priority classes: admission is FCFS, as
    JAX's ``FIFOScheduler``."""
    jm, pm = lms
    orders = []
    for eng in (ServingEngine(pm, num_slots=1, max_len=16,
                              kv_layout="slab", device="cpu"),
                _jax_engine(jm, num_slots=1, max_len=16, kv_layout="slab")):
        rids = [eng.submit(PATTERN[:3], 2, priority=2),
                eng.submit(PATTERN[:4], 2, priority=0)]
        order = []
        while eng.scheduler.pending:
            order += [r.rid for r in eng.step()]
        orders.append(order)
        assert order == rids
    assert orders[0] == orders[1]


# --- host KV offload (host_kv_pages) ------------------------------------------
#
# The JAX package's offload oracles (tests/test_serving.py :556, :589,
# :651, :712 and tests/test_swap_async.py) rerun on the port against the
# JAX engine or pool on the same workload: the streams, the counters and
# the laziness of the fence must match.


def _host_counters(pool):
    return (pool.pages_offloaded, pool.pages_restored, pool.offload_bytes,
            pool.host_fences, pool.host_swap_pending, pool.host_free_pages)


def _drain_tracking(eng):
    """Drain the engine; returns ``({rid: tokens}, max pending swap)``."""
    out, max_pending = {}, 0
    while eng.scheduler.pending:
        for r in eng.step():
            out[r.rid] = r.tokens
        max_pending = max(max_pending, eng.pool.host_swap_pending)
    return out, max_pending


@pytest.mark.parametrize("loop", LOOP_KW, ids=LOOP_IDS)
@pytest.mark.parametrize("host_pages", [0, 16])
def test_preemption_resume_matches_jax_engine(lms, host_pages, loop):
    """Two streams outgrow an 8-page pool: the younger is preempted and
    resumes by re-prefill (``host_kv_pages=0``) or by swapping its pages
    back (16). Streams equal ``generate()``; the swap traffic, the
    fences, the pending backlog and the metrics' offload counters equal
    the JAX engine's (JAX :556, ``tests/test_swap_async.py`` :119)."""
    jm, pm = lms
    kw = dict(num_slots=2, max_len=32, page_len=4, num_pages=8,
              prefix_cache=False, host_kv_pages=host_pages, **loop)
    runs = []
    for eng in (ServingEngine(pm, device="cpu", **kw), _jax_engine(jm, **kw)):
        r0 = eng.submit(PATTERN[:5], 16)
        eng.step()
        eng.step()
        r1 = eng.submit(PATTERN[:6], 15)
        out, max_pending = _drain_tracking(eng)
        np.testing.assert_array_equal(out[r0], _ref(jm, PATTERN[:5], 16))
        np.testing.assert_array_equal(out[r1], _ref(jm, PATTERN[:6], 15))
        off = eng.metrics.summary()["offload"]
        runs.append((_host_counters(eng.pool) if host_pages else None,
                     max_pending, eng.metrics.requests_preempted,
                     {k: off[k] for k in ("pages_offloaded",
                                          "pages_restored",
                                          "offload_bytes",
                                          "reprefill_tokens",
                                          "reprefill_tokens_avoided")},
                     off["resume_swap_s"] is None,
                     off["resume_reprefill_s"] is None))
    assert runs[0] == runs[1]
    assert runs[0][2] >= 1
    if host_pages:
        pool = eng.pool
        assert pool.pages_offloaded >= 1
        assert pool.pages_restored == pool.pages_offloaded
        assert runs[0][1] > 0                  # a fence was deferred
        assert pool.host_fences <= runs[0][2]
        assert runs[0][3]["reprefill_tokens_avoided"] > 0


@pytest.mark.parametrize("host_pages", [0, 16])
def test_preempted_sampled_request_resumes_key_stream(lms, host_pages):
    """A sampled request preempted mid-decode draws the tokens of an
    ample pool's run, by re-prefill or by swap-in, as the JAX engine's
    does (JAX :589)."""
    jm, pm = lms

    def run(engine, model, num_pages, host, **extra):
        eng = engine(model, num_slots=2, max_len=32, page_len=4,
                     num_pages=num_pages, prefix_cache=False,
                     host_kv_pages=host, **extra)
        eng.submit(PATTERN[:5], 16)              # a greedy page hog
        srid = eng.submit(PATTERN[:4], 14, temperature=0.9, top_p=0.95,
                          seed=7)
        out = eng.run(max_steps=3000)
        return (out[srid], eng.metrics.requests_preempted,
                eng.pool.pages_offloaded)

    ample, p_ample, _ = run(ServingEngine, pm, 16, 0, device="cpu")
    tight, p_tight, offloaded = run(ServingEngine, pm, 8, host_pages,
                                    device="cpu")
    jtight, jp, joff = run(_jax_engine, jm, 8, host_pages)
    assert p_ample == 0 and p_tight >= 1
    assert bool(offloaded) == bool(host_pages)
    np.testing.assert_array_equal(ample, tight)
    np.testing.assert_array_equal(tight, np.asarray(jtight))
    assert (p_tight, offloaded) == (jp, joff)


def test_prefix_cache_spills_to_host_and_restores(lms):
    """A full reclaim spills the cached chain to the host tier (the
    nodes stay), a same-prompt request restores it page by page and
    hits, token-identical; the traffic equals the JAX engine's (JAX
    :651)."""
    jm, pm = lms
    prompt = np.tile(PATTERN, 2)[:12]
    seen = []
    for eng in (ServingEngine(pm, num_slots=2, max_len=48, page_len=4,
                              host_kv_pages=32, device="cpu"),
                _jax_engine(jm, num_slots=2, max_len=48, page_len=4,
                            host_kv_pages=32)):
        ra = eng.submit(prompt, 5)
        np.testing.assert_array_equal(eng.run(max_steps=300)[ra],
                                      _ref(jm, prompt, 5))
        n_nodes = len(eng.prefix)
        assert n_nodes >= 3
        freed = eng.prefix.reclaim(eng.pool.num_pages)
        assert freed >= n_nodes and len(eng.prefix) == n_nodes
        assert eng.pool.pages_offloaded >= n_nodes
        restored = eng.pool.pages_restored
        rb = eng.submit(prompt, 5)
        np.testing.assert_array_equal(eng.run(max_steps=300)[rb],
                                      _ref(jm, prompt, 5))
        assert eng.pool.pages_restored > restored
        assert eng.metrics.summary()["prefix_cache"]["hits"] >= 1
        seen.append((freed, _host_counters(eng.pool), len(eng.prefix),
                     eng.prefix.evictable_pages()))
    assert seen[0] == seen[1]


def _fill_pages(pool, pids, seed):
    """Seeded content in physical pages ``pids`` of a port pool; returns
    the numpy values written, ``[layer][key] -> [len(pids), ...]``."""
    rs = np.random.RandomState(seed)
    vals = []
    for kv in pool.cache:
        if kv is None:
            vals.append(None)
            continue
        got = {}
        for key in ("k", "v"):
            x = rs.randn(len(pids), *kv[key].shape[1:]).astype(np.float32)
            kv[key][torch.as_tensor(pids)] = torch.from_numpy(x)
            got[key] = x
        vals.append(got)
    return vals


def _page_values(pool, pid):
    return [None if kv is None else
            {key: kv[key][pid].numpy().copy() for key in ("k", "v")}
            for kv in pool.cache]


@pytest.mark.parametrize("case", ["roundtrip", "lazy-fence", "unread-drop",
                                  "partial-free"])
def test_pool_host_tier_matches_jax(lms, case):
    """The host tier's contract, the same operations on the port's pool
    and JAX's: a byte-identical round trip onto other pages, capacity
    (None when full), a double free raises (JAX :712); the swap-out is
    lazy (a snapshot: later writes do not reach it) and the first
    restore fences it; a batch freed whole drops unfenced; a batch freed
    in part fences its other pages (``tests/test_swap_async.py``). The
    counters equal JAX's after every case."""
    import jax.numpy as jnp
    from distkeras_tpu.models.decoding import _resolve_head_dims
    from distkeras_tpu.serving import PagedKVPool as JaxPagedKVPool
    jm, pm = lms
    _resolve_head_dims(jm.module, jm.params)
    pool = PagedKVPool(pm.module, 2, 32, page_len=4, host_pages=3,
                       device="cpu")
    jpool = JaxPagedKVPool(jm.module, num_slots=2, max_len=32, page_len=4,
                           host_pages=3)

    def mirror():
        jpool.cache = [None if kv is None else
                       {key: jnp.asarray(kv[key].numpy())
                        for key in ("k", "v")} for kv in pool.cache]

    _fill_pages(pool, [0, 1, 2], 0)
    mirror()
    before = [_page_values(pool, p) for p in range(3)]
    if case in ("roundtrip", "lazy-fence"):
        ops = [("off", [0, 2])]
    else:
        ops = [("off", [0, 1])]
    hids = pool.offload_pages(ops[0][1])
    jhids = jpool.offload_pages(ops[0][1])
    assert hids == jhids and pool.host_free_pages == 1
    assert _host_counters(pool)[:5] == (2, 0, 2 * pool.page_bytes, 0, 2)
    if case == "roundtrip":
        assert pool.offload_pages([0, 1]) is None
        assert jpool.offload_pages([0, 1]) is None
    if case in ("roundtrip", "lazy-fence"):
        # overwrite the source pages: the snapshot keeps the old bytes
        _fill_pages(pool, [0, 2], 9)
        mirror()
        pool.restore_pages(hids, [5, 7])
        jpool.restore_pages(jhids, [5, 7])
        for src, dst in ((0, 5), (2, 7)):
            for got, want, jkv in zip(_page_values(pool, dst), before[src],
                                      jpool.cache):
                if got is not None:
                    for key in ("k", "v"):
                        np.testing.assert_array_equal(got[key], want[key])
                        np.testing.assert_array_equal(
                            np.asarray(jkv[key][dst]), want[key])
        pool.free_host(hids)
        jpool.free_host(jhids)
        with pytest.raises(RuntimeError, match="double-freed"):
            pool.free_host([hids[0]])
    elif case == "unread-drop":
        pool.free_host(hids)
        jpool.free_host(jhids)
        with pytest.raises(RuntimeError, match="double-freed"):
            pool.free_host(hids)
    else:
        pool.free_host(hids[:1])
        jpool.free_host(jhids[:1])
        pool.restore_pages(hids[1:], [6])
        jpool.restore_pages(jhids[1:], [6])
        for got, want in zip(_page_values(pool, 6), before[1]):
            if got is not None:
                for key in ("k", "v"):
                    np.testing.assert_array_equal(got[key], want[key])
        pool.free_host(hids[1:])
        jpool.free_host(jhids[1:])
    assert _host_counters(pool) == _host_counters(jpool)
    assert pool.host_free_pages == 3
    with pytest.raises(RuntimeError, match="no host page pool"):
        PagedKVPool(pm.module, 2, 32, page_len=4,
                    device="cpu").restore_pages([0], [0])


def _prefix_victim(eng, prompt):
    """Register ``prompt``'s pages, then bring a second request with the
    same prompt to decode and preempt it (on the port's engine or JAX's);
    returns ``(first rid, second rid, second request)``."""
    ra = eng.submit(prompt, 4)
    eng.run(max_steps=400)
    rb = eng.submit(prompt, 12)
    while eng[rb].state.value != "decoding":
        eng.step()
    eng.step()
    req = eng[rb]
    eng._preempt(req)
    return ra, rb, req


def _swap_of(req):
    return req.swap if hasattr(req, "swap") else getattr(req, "_swap", None)


@pytest.mark.parametrize("case", ["relink", "host-full", "cancel"])
def test_prefix_aware_swap_matches_jax_engine(lms, case):
    """The prefix-aware snapshot (``tests/test_swap_async.py`` :158-263),
    on the port and on the JAX engine: prefix-resident pages are held,
    not copied, and relinked at resume; with a host tier too small for
    the private pages the victim re-prefills and no hold leaks; a
    cancelled swapped victim drops its holds and its host pages
    unfenced. Streams, refcounts and host counters equal JAX's."""
    jm, pm = lms
    prompt = np.tile(PATTERN, 2)[:12]
    host = 1 if case == "host-full" else 16
    seen = []
    for eng in (ServingEngine(pm, num_slots=2, max_len=32, page_len=4,
                              host_kv_pages=host, device="cpu"),
                _jax_engine(jm, num_slots=2, max_len=32, page_len=4,
                            host_kv_pages=host)):
        _, rb, req = _prefix_victim(eng, prompt)
        swap = _swap_of(req)
        if case == "host-full":
            assert swap is None
            shared = [int(p) for p in list(eng.prefix._by_page)]
        else:
            assert swap is not None and len(swap["shared"]) >= 2
            shared = [int(pid) for _lp, pid in swap["shared"]]
            for pid in shared:
                assert eng.pool.ref[pid] >= 2 and eng.prefix.resident(pid)
        fences = eng.pool.host_fences
        if case == "cancel":
            eng.cancel(rb)
            assert eng.pool.host_fences == fences     # dropped unfenced
            out = None
        else:
            out = eng.run(max_steps=800)[rb]
            np.testing.assert_array_equal(out, _ref(jm, prompt, 12))
        for pid in shared:
            if eng.prefix.resident(pid):
                assert eng.pool.ref[pid] == 1         # cache-only again
        assert eng.pool.host_free_pages == eng.pool.host_pages
        seen.append((None if swap is None else
                     (list(swap["host"]), [int(x) for x in swap["logical"]],
                      [(int(a), int(b)) for a, b in swap["shared"]],
                      int(swap["t"])),
                     _host_counters(eng.pool), sorted(shared),
                     None if out is None else list(out)))
    assert seen[0] == seen[1]


def test_swapped_victim_preempted_before_its_swap_in(lms):
    """A swapped-out stream re-admitted for its swap-in and preempted
    again before its prefill turn keeps its snapshot: the slot's holds on
    the prefix-resident pages go back to the snapshot, the stream still
    resumes by a copy, token-identical, and every refcount and host page
    is back to the cache's alone after the drain."""
    jm, pm = lms
    prompt = np.tile(PATTERN, 2)[:12]
    eng = ServingEngine(pm, num_slots=2, max_len=32, page_len=4,
                        host_kv_pages=16, device="cpu")
    _, rb, req = _prefix_victim(eng, prompt)
    shared = [int(pid) for _lp, pid in req.swap["shared"]]
    holds = [int(eng.pool.ref[pid]) for pid in shared]
    eng._admit()
    assert req.state is RequestState.PREFILLING and req.swap is not None
    eng._preempt(req)
    assert req.state is RequestState.QUEUED and req.swap is not None
    assert [int(eng.pool.ref[pid]) for pid in shared] == holds
    restored = eng.pool.pages_restored
    out = eng.run(max_steps=800)
    np.testing.assert_array_equal(out[rb], _ref(jm, prompt, 12))
    assert eng.pool.pages_restored > restored
    assert eng.metrics.summary()["offload"]["resume_swap_s"] is not None
    for pid in shared:
        assert eng.pool.ref[pid] == 1
    assert eng.pool.host_free_pages == eng.pool.host_pages


# --- observability and per-request isolation, against the JAX engine ----------

OBS_SUBS = [dict(prompt=PATTERN[:6], max_new_tokens=9),
            dict(prompt=np.tile(PATTERN, 2)[:13], max_new_tokens=5),
            dict(prompt=PATTERN[:4], max_new_tokens=7),
            dict(prompt=np.tile(PATTERN, 2)[:13], max_new_tokens=6)]
OBS_KW = dict(num_slots=2, max_len=40, page_len=4, prefill_chunk=4)


def _obs_run(eng, box, subs=OBS_SUBS):
    """Staggered submits (two steps apart) on a hand-cranked clock, then
    a drain; returns ``(rids, {rid: terminal Request}, iterations)``."""
    done, rids, iters = {}, [], 0

    def step():
        nonlocal iters
        box[0] += 0.01
        iters += 1
        for r in eng.step():
            done[r.rid] = r

    for kw in subs:
        rids.append(eng.submit(**kw))
        step()
        step()
    while eng.scheduler.pending:
        step()
        assert iters < 400, "engine failed to drain"
    return rids, done, iters


def _timeline_view(eng):
    return {tl.rid: (tl.state, tl.n_tokens, tl.decode_iters, tl.slot,
                     [e["name"] for e in tl.events])
            for tl in eng.tracer.timelines()}


@pytest.mark.parametrize("loop", LOOP_KW, ids=LOOP_IDS)
def test_tracer_timelines_and_scrapes_match_jax_engine(lms, loop):
    """The same staggered submissions through the JAX and the port
    engine, tracer and time series on: every request ends in the same
    state with the same tokens, decode ticks and slot, its timeline has
    the same sequence of events, the phases partition its latency, and
    the time series scraped on the same iterations."""
    jm, pm = lms
    runs = {}
    for name, make in (("port", lambda **kw: ServingEngine(
            pm, device="cpu", **kw)), ("jax", lambda **kw: _jax_engine(
                jm, **kw))):
        box = [0.0]
        clocked = _clocked if name == "port" else _jax_metrics
        eng = make(metrics=clocked(box), **OBS_KW, **loop)
        rids, done, _ = _obs_run(eng, box)
        runs[name] = (eng, rids, done)
    (pe, prids, pdone), (je, jrids, jdone) = runs["port"], runs["jax"]
    for pr, jr in zip(prids, jrids):
        np.testing.assert_array_equal(pdone[pr].tokens, jdone[jr].tokens)
    assert _timeline_view(pe) == _timeline_view(je)
    for s in pe.tracer.summaries().values():
        d = s["durations"]
        assert d["queued_s"] + d["prefill_s"] + d["decode_s"] == \
            pytest.approx(d["total_s"])
        assert s["engine"] == pe.engine_id
    assert [s.get("iteration") for _, s in pe.timeseries.samples()] == \
        [s.get("iteration") for _, s in je.timeseries.samples()]
    assert any(e["name"] == "prefix_hit" for tl in pe.tracer.timelines()
               for e in tl.events)
    comp = pe._telemetry_summary()
    assert set(comp["requests"]) == set(prids)
    assert comp["timeseries"]["n_samples"] == len(pe.timeseries.samples())
    trace = pe.tracer.chrome_trace()["traceEvents"]
    assert sum(e["ph"] == "s" for e in trace) == len(prids)


def test_poisoned_prefill_isolated_like_jax_engine(lms, tmp_path):
    """``serving.prefill`` armed nth=2 in both packages poisons the same
    request: it ends CANCELLED with the injected fault as its error, and
    every other stream equals JAX's and an unfaulted run's. The fault
    dumps the flight recorder's ring, iteration entries included."""
    from distkeras_tpu.obs import recorder as jrec
    from distkeras_tpu.resilience import faults as jfaults
    from distkeras_tpu_torch.obs import recorder as prec
    from distkeras_tpu_torch.resilience import faults
    jm, pm = lms
    box = [0.0]
    _, clean, _ = _obs_run(ServingEngine(pm, device="cpu",
                                         metrics=_clocked(box), **OBS_KW),
                           box)
    outs = {}
    for name, mod, rec_mod, make in (
            ("port", faults, prec,
             lambda **kw: ServingEngine(pm, device="cpu", **kw)),
            ("jax", jfaults, jrec, lambda **kw: _jax_engine(jm, **kw))):
        rec_mod.reset_recorder()
        rec = rec_mod.get_recorder()
        rec.dump_dir = str(tmp_path / name)
        rec.min_auto_interval_s = 0.0
        mod.inject("serving.prefill", nth=2)
        try:
            box = [0.0]
            clocked = _clocked if name == "port" else _jax_metrics
            eng = make(metrics=clocked(box), **OBS_KW)
            rids, done, _ = _obs_run(eng, box)
        finally:
            mod.reset()
        outs[name] = (rids, done, list(rec.dumps))
        rec_mod.reset_recorder()
    (prids, pdone, pdumps), (jrids, jdone, _) = outs["port"], outs["jax"]
    states = [(pdone[r].state.value, jdone[j].state.value)
              for r, j in zip(prids, jrids)]
    assert [a for a, _ in states] == [b for _, b in states]
    assert sum(a == "cancelled" for a, _ in states) == 1
    for r, j, c in zip(prids, jrids, sorted(clean)):
        if pdone[r].state is RequestState.CANCELLED:
            assert isinstance(pdone[r].error, faults.InjectedFault)
            continue
        np.testing.assert_array_equal(pdone[r].tokens, jdone[j].tokens)
        np.testing.assert_array_equal(pdone[r].tokens, clean[c].tokens)
    (path,) = pdumps
    header, records = prec.read_flight_dump(path)
    assert header["reason"] == "fault:serving.prefill"
    kinds = [r["kind"] for r in records]
    assert "serving.iteration" in kinds and kinds[-1] == "fault.triggered"


def test_slo_breach_degrades_health_like_jax_engine(lms):
    """An unmeetable TTFT objective: both engines' ``health()`` report
    "degraded" while accepting, with the objective in breach; an easy
    one stays "ok"."""
    from distkeras_tpu.obs.slo import ttft_p99 as jttft
    from distkeras_tpu_torch.obs.slo import ttft_p99
    jm, pm = lms
    for obj, jobj, want in ((ttft_p99(1e-9), jttft(1e-9), "degraded"),
                            (ttft_p99(60.0), jttft(60.0), "ok")):
        hs = []
        for eng, box in ((ServingEngine(pm, device="cpu", slo=[obj],
                                        metrics=_clocked(b := [0.0]),
                                        **OBS_KW), b),
                         (_jax_engine(jm, slo=[jobj],
                                      metrics=_jax_metrics(c := [0.0]),
                                      **OBS_KW), c)):
            _obs_run(eng, box, OBS_SUBS[:2])
            h = eng.health()
            hs.append((h["status"], h["slo"]["ttft_p99"]["breach"],
                       h["slo"]["ttft_p99"]["n"]))
            assert "telemetry" in h
        assert hs[0] == hs[1] and hs[0][0] == want
