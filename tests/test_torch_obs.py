"""The port's observability layer (``distkeras_tpu_torch.obs``) against
the JAX package's ``distkeras_tpu.obs``: the same operations on the same
inputs and the same fake clock give equal registry snapshots, exporter
text, tracer summaries and Chrome traces, SLO status, time-series
samples, flight dumps (read both ways) and scenario reports. Also the
repaired ``ServingMetrics``: its percentiles come from the registry's
uniform reservoir, so they are JAX's past the reservoir's size."""

import json
import types
import warnings

import numpy as np
import pytest

from distkeras_tpu import obs as jobs
from distkeras_tpu.obs import exporters as jexp
from distkeras_tpu.obs import recorder as jrec
from distkeras_tpu.obs import report as jreport
from distkeras_tpu.obs import slo as jslo
from distkeras_tpu.serving.metrics import ServingMetrics as JaxMetrics

from distkeras_tpu_torch import obs as pobs
from distkeras_tpu_torch.obs import exporters as pexp
from distkeras_tpu_torch.obs import recorder as prec
from distkeras_tpu_torch.obs import report as preport
from distkeras_tpu_torch.obs import slo as pslo
from distkeras_tpu_torch.serving.metrics import ServingMetrics


class FakeClock:
    def __init__(self, t=100.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += float(dt)


def _common(port: dict, ref: dict, path=""):
    """``port`` restricted to the keys JAX's dict has too, recursively;
    returns ``(restricted, ref restricted)`` and the keys only one side
    has."""
    out_p, out_r, only = {}, {}, []
    for k in sorted(set(port) | set(ref)):
        if k not in port or k not in ref:
            only.append(path + k)
            continue
        a, b = port[k], ref[k]
        if isinstance(a, dict) and isinstance(b, dict):
            a, b, o = _common(a, b, path + k + ".")
            only += o
        out_p[k], out_r[k] = a, b
    return out_p, out_r, only


# --- the repair: ServingMetrics percentiles past the reservoir -----------------

def _feed_metrics(m, clock, n=5000, seed=0):
    """``n`` requests, one after another: the first half with TTFT from
    U(0.01, 0.02) s, the second from U(0.05, 0.08) s."""
    rs = np.random.RandomState(seed)
    for i in range(n):
        lo, hi = (0.01, 0.02) if i < n // 2 else (0.05, 0.08)
        m.record_submit(i)
        m.record_iteration(i % 7, i % 4, 4)
        clock.tick(rs.uniform(lo, hi))
        m.record_first_token(i)
        clock.tick(rs.uniform(0.1, 0.3))
        m.record_finish(i, 2 + i % 5)


def test_serving_metrics_percentiles_equal_jax_past_the_reservoir():
    """5000 requests on one fake clock, TTFT shifting upward halfway:
    ``summary()`` equals JAX's exactly (same reservoir algorithm, same
    crc32 seeds). A store of the first 2048 values would freeze the
    percentiles at the first phase's (p50 ~0.015 s)."""
    pc, jc = FakeClock(), FakeClock()
    pm, jm = ServingMetrics(clock=pc), JaxMetrics(clock=jc)
    _feed_metrics(pm, pc)
    _feed_metrics(jm, jc)
    ps, js = pm.summary(), jm.summary()
    got, want, only = _common(ps, js)
    assert got == want
    # the port's one extra key (requests_transferred is on both sides)
    assert sorted(only) == ["speculation.path_acceptance_rate"]
    assert ps["requests_transferred"] == js["requests_transferred"] == 0
    assert ps["ttft_s"]["p50"] > 0.05          # the second phase shows
    assert ps["ttft_s"]["p99"] > 0.075
    assert pm.registry.snapshot() == jm.registry.snapshot()


# --- registry and exporters ----------------------------------------------------

HOSTILE = ['a,b', 'x=y', '{brace}', 'quo"te', 'back\\slash', 'new\nline',
           'TPU_0(process=0,(0,0,0,0))']


def _drive_registry(reg):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # the overflow warns once
        return _drive_registry_ops(reg)


def _drive_registry_ops(reg):
    c = reg.counter("app.requests")
    g = reg.gauge("app.depth")
    h = reg.histogram("app.latency_s", reservoir_size=16)
    rs = np.random.RandomState(3)
    for i, lab in enumerate(HOSTILE):
        c.inc(i + 1, route=lab)
        g.set(i * 1.5, device=lab)
        g.set(i * 0.5, device=lab)
    for i in range(200):           # past the reservoir: algorithm R
        h.observe(float(rs.exponential(0.02)), op=HOSTILE[i % 3])
    over = reg.counter("app.overflow")
    for i in range(12):            # max_series=4: the overflow series
        over.inc(1, rid=str(i))
    c.inc(0.5)
    return reg


def test_registry_snapshot_and_exporters_equal_jax(tmp_path):
    p = _drive_registry(pobs.MetricsRegistry(max_series=4))
    j = _drive_registry(jobs.MetricsRegistry(max_series=4))
    assert p.snapshot() == j.snapshot()
    spans = [(("train", "epoch"), 1.25, 3), (("serve",), 0.5, 2)]
    assert pexp.prometheus_text(p.snapshot()) == \
        jexp.prometheus_text(j.snapshot())
    assert pexp.snapshot_lines(p.snapshot(), spans, seq=2) == \
        jexp.snapshot_lines(j.snapshot(), spans, seq=2)
    assert pexp.SCHEMA_VERSION == jexp.SCHEMA_VERSION
    # the JSONL log round-trips, and each package reads the other's file
    pe = pexp.JsonlExporter(str(tmp_path / "p.jsonl"))
    je = jexp.JsonlExporter(str(tmp_path / "j.jsonl"))
    pe.export(p.snapshot(), spans)
    je.export(j.snapshot(), spans)
    assert pexp.read_jsonl(str(tmp_path / "j.jsonl")) == \
        jexp.read_jsonl(str(tmp_path / "p.jsonl"))
    snap, sp = pexp.read_jsonl(str(tmp_path / "p.jsonl"))
    assert snap == json.loads(json.dumps(p.snapshot())) and len(sp) == 2
    # every Prometheus line carries the process label, escaped values
    text = pexp.prometheus_text(p.snapshot())
    for line in text.splitlines():
        if not line.startswith("#"):
            assert 'process_index="0"' in line
    assert 'route="quo\\"te"' in text


def test_spans_tree_and_process_label():
    pobs.reset_spans()
    with pobs.span("outer"):
        with pobs.span("inner"):
            pass
        with pobs.span("inner"):
            pass
    tree = pobs.span_summary()
    assert tree["outer"]["count"] == 1
    assert tree["outer"]["children"]["inner"]["count"] == 2
    assert pobs.registry.process_label() == ("process_index", "0")
    pobs.disable()
    try:
        with pobs.span("off"):
            pass
    finally:
        pobs.enable()
    assert "off" not in pobs.span_summary()
    pobs.reset_spans()


def test_spans_reach_the_torch_profiler_trace(tmp_path):
    """An obs span opens a ``torch.profiler.record_function`` range: it
    shows up by name in the Chrome trace ``utils.profiling.trace``
    writes."""
    import torch
    from distkeras_tpu_torch.utils.profiling import trace
    with trace(str(tmp_path)):
        with pobs.span("obs.span_in_trace"):
            torch.ones(4).sum()
    (path,) = list(tmp_path.iterdir())
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "obs.span_in_trace" for e in events)


def test_collectors_kernel_builds_and_recompiles():
    """Compile totals count what ``note_compile`` reports (the kernel
    builds); a watched cache that grows after ``mark_warm`` warns once,
    naming the function."""
    from distkeras_tpu_torch.obs import collectors
    before = collectors.compile_totals()
    collectors.note_compile(1.5, 2)
    after = collectors.compile_totals()
    assert after["count"] == before["count"] + 2
    assert after["seconds"] == pytest.approx(before["seconds"] + 1.5)

    class Cache:
        n = 1

        def _cache_size(self):
            return self.n

    fn = Cache()
    det = pobs.RecompileDetector(pobs.MetricsRegistry())
    det.watch("step", fn)
    with pytest.raises(TypeError):
        det.watch("bad", object())
    det.mark_warm()
    assert det.check() == {}
    fn.n = 3
    with pytest.warns(pobs.RecompileWarning, match="'step'"):
        assert det.check() == {"step": 2}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        det.check()                 # the same growth warns once
    assert det.counts() == {"step": 3}
    assert collectors.KERNEL_LIBRARIES._cache_size() >= 0
    assert pobs.memory_watermark(pobs.MetricsRegistry()) is None  # no card


# --- tracer, SLO, time series, recorder, report --------------------------------

def _drive_tracer(t, clock):
    """Two requests through every event kind, one shed, on ``clock``."""
    t.on_submit(0, 0)
    clock.tick(0.01)
    t.on_submit(1, 1)
    t.on_reject()
    clock.tick(0.01)
    t.on_admit(0, 0, 1)
    t.on_prefix_hit(0, 4)
    t.on_prefill_chunk(0, 4, 4)
    clock.tick(0.02)
    t.on_first_token(0)
    t.on_admit(1, 1, 0)
    t.on_prefill_chunk(1, 0, 6)
    clock.tick(0.02)
    t.on_first_token(1)
    for i in range(40):
        clock.tick(0.005)
        t.on_decode_batch({0: 1, 1: 2}, t0=clock() - 0.005)
        if i % 5 == 0:
            t.on_spec_verify([(0, 3, 2), (1, 3, 1, 2, 1)])
            t.on_moe_route([0, 1], 1.25 + 0.01 * i, 0.4)
    t.on_preempt(1, 20)
    t.on_swap_out(1, 3)
    clock.tick(0.01)
    t.on_admit(1, 1, 0)
    t.on_swap_in(1, 3)
    t.on_resume(1)
    clock.tick(0.01)
    t.on_terminal(0, "finished", 41)
    clock.tick(0.01)
    t.on_terminal(1, "cancelled", 62)
    t.on_submit(2, 0)                  # still in flight at export


def test_tracer_summaries_and_chrome_trace_equal_jax(tmp_path):
    pc, jc = FakeClock(), FakeClock()
    pt = pobs.RequestTracer(clock=pc, decode_agg=8)
    jt = jobs.RequestTracer(clock=jc, decode_agg=8)
    pt.engine = jt.engine = "e0"
    _drive_tracer(pt, pc)
    _drive_tracer(jt, jc)
    assert pt.summaries() == jt.summaries()
    assert [tl.events for tl in pt.timelines()] == \
        [tl.events for tl in jt.timelines()]
    assert pt.chrome_trace() == jt.chrome_trace()
    assert pt.rejected == jt.rejected == 1
    d = pt.summaries()[0]["durations"]
    assert d["queued_s"] + d["prefill_s"] + d["decode_s"] == \
        pytest.approx(d["total_s"])
    path = pt.dump_chrome_trace(str(tmp_path / "t.json"))
    ev = json.load(open(path))["traceEvents"]
    assert sum(e["ph"] == "s" for e in ev) == 3
    # the NULL tracer is the disabled path
    pobs.disable()
    try:
        assert pobs.resolve_tracer(None) is pobs.NULL_TRACER
    finally:
        pobs.enable()


def _window(mod_metrics, clock, ttfts, outcomes):
    m = mod_metrics(clock=clock)
    for i, v in enumerate(ttfts):
        m.record_submit(i)
        clock.tick(v)
        m.record_first_token(i)
        clock.tick(0.05)
        m.record_finish(i, 6)
    for o in outcomes:
        if o == "rejected":
            m.record_rejected()
        elif o == "timed_out":
            m.record_submit(1000)
            m.record_timeout(1000)
    return m


def _slo_run(slo_mod, metrics_cls, obs_mod):
    clock = FakeClock()
    reg = obs_mod.MetricsRegistry()
    eng = slo_mod.SLOEngine([slo_mod.ttft_p99(0.05), slo_mod.tpot_p99(0.02),
                             slo_mod.availability(0.9)],
                            window_s=1.0, clock=clock, registry=reg)
    rs = np.random.RandomState(5)
    out = []
    for step in range(6):
        ttfts = rs.uniform(0.01, 0.04 + 0.02 * step, size=10)
        m = _window(metrics_cls, clock, ttfts,
                    ["rejected"] * step + ["timed_out"] * (step % 2))
        out.append(eng.evaluate(m))
        out.append(eng.evaluate(m, record=False))
        clock.tick(0.3)
    return eng, reg, out


def test_slo_engine_status_equals_jax():
    pe, preg, pout = _slo_run(pslo, ServingMetrics, pobs)
    je, jreg, jout = _slo_run(jslo, JaxMetrics, jobs)
    assert pout == jout
    assert pe.status() == je.status()
    assert pe.breached() == je.breached()
    assert pe.burn_history() == je.burn_history()
    assert preg.snapshot() == jreg.snapshot()
    st = pe.status()["objectives"]["availability"]
    assert st["burn_rate"] == pytest.approx(
        (1 - st["good_fraction"]) / (1 - 0.9))


def _ts_run(obs_mod, metrics_cls):
    clock = FakeClock()
    m = metrics_cls(clock=clock)
    ts = obs_mod.TimeSeries(m.registry, clock=clock, interval_s=0.25,
                            capacity=8, tags={"engine": "e0"})
    rs = np.random.RandomState(9)
    rid = 0
    for it in range(40):
        for _ in range(rs.randint(0, 4)):
            m.record_submit(rid)
            clock.tick(0.01)
            m.record_first_token(rid)
            m.record_finish(rid, 3)
            rid += 1
        m.record_iteration(it % 5, it % 3, 4)
        clock.tick(0.05)
        ts.maybe_sample(iteration=it)
    return ts


def _mask_ts(text):
    return [" ".join(line.split()[:-1]) if not line.startswith("#")
            else line for line in text.splitlines()]


def test_timeseries_samples_equal_jax():
    pts, jts = _ts_run(pobs, ServingMetrics), _ts_run(jobs, JaxMetrics)
    assert pts.samples() == jts.samples()
    assert pts.summary() == jts.summary()
    assert pts.series("serving.ttft_s", field="p99") == \
        jts.series("serving.ttft_s", field="p99")
    assert pts.jsonl_lines(seq=1) == jts.jsonl_lines(seq=1)
    # the Prometheus form's trailing stamp is the wall clock: masked
    assert _mask_ts(pts.prometheus_text()) == _mask_ts(jts.prometheus_text())
    assert len(pts.samples()) == 8       # the ring's capacity
    ring = pobs.Ring(3)
    for i in range(5):
        ring.append(float(i), {"i": i})
    assert [t for t, _ in ring] == [2.0, 3.0, 4.0]
    assert ring.window(3.0) == [(3.0, {"i": 3}), (4.0, {"i": 4})]


def _drive_recorder(rec):
    for i in range(12):
        rec.record("serving.iteration", engine="e0", iter=i,
                   queue_depth=i % 3, decoding=[0, 1], prefilling=[])
    rec.record("serving.preempted", rid=3, slot=1, pages_freed=2)
    for i in range(3):
        rec.note_rejection(rid=100 + i, queue_depth=4, max_queue=4)


def _masked(records):
    return [{k: v for k, v in r.items() if k != "t"} for r in records]


def test_flight_recorder_equals_jax_and_dumps_cross(tmp_path):
    pr = pobs.FlightRecorder(capacity=8, dump_dir=str(tmp_path / "p"),
                             reject_storm=3, min_auto_interval_s=0.0)
    jr = jobs.FlightRecorder(capacity=8, dump_dir=str(tmp_path / "j"),
                             reject_storm=3, min_auto_interval_s=0.0)
    _drive_recorder(pr)
    _drive_recorder(jr)
    assert _masked(pr.records()) == _masked(jr.records())
    assert len(pr.dumps) == len(jr.dumps) == 1      # the shed storm
    p_path = pr.dump("manual")
    j_path = jr.dump("manual")
    ph, precs = jrec.read_flight_dump(p_path)       # port dump, JAX reader
    jh, jrecs = prec.read_flight_dump(j_path)       # JAX dump, port reader
    mask = lambda h: {k: v for k, v in h.items() if k != "dumped_at"}
    assert mask(ph) == mask(jh) and ph["reason"] == "manual"
    assert _masked(precs) == _masked(jrecs) == _masked(pr.records())
    assert pobs.NULL_RECORDER.dump() is None


def test_fault_trigger_dumps_the_global_recorder(tmp_path):
    from distkeras_tpu_torch.resilience import faults
    prec.reset_recorder()
    try:
        rec = pobs.get_recorder()
        rec.dump_dir = str(tmp_path)
        rec.min_auto_interval_s = 0.0
        rec.record("serving.iteration", iter=0)
        faults.inject("obs.test_point", nth=1)
        with pytest.raises(faults.InjectedFault):
            faults.point("obs.test_point")
        (path,) = rec.dumps
        header, records = prec.read_flight_dump(path)
        assert header["reason"] == "fault:obs.test_point"
        assert [r["kind"] for r in records] == ["serving.iteration",
                                                "fault.triggered"]
    finally:
        faults.reset()
        prec.reset_recorder()


class _Phase:
    def __init__(self, name, start, end, t0, t1, slo, summaries):
        self.name, self.start, self.end = name, start, end
        self.t0, self.t1 = t0, t1
        self.submitted, self.shed = end - start, (end - start) // 4
        self.slo, self.summaries = slo, summaries


def _replay_result(obs_mod, slo_mod, metrics_cls):
    """A two-phase, two-engine replay's join surface built from this
    package's SLO engines, time series and metrics windows."""
    clock = FakeClock(0.0)
    engines, phases = {}, []
    for eid in ("a", "b"):
        m = metrics_cls(clock=clock)
        engines[eid] = (m, slo_mod.SLOEngine(
            [slo_mod.ttft_p99(0.03), slo_mod.availability(0.9)],
            clock=clock, registry=obs_mod.MetricsRegistry()),
            obs_mod.TimeSeries(m.registry, clock=clock))
    rs = np.random.RandomState(1)
    rid = 0
    for pi, (name, hi) in enumerate((("steady", 0.02), ("flash", 0.06))):
        t0 = clock()
        sts, sums = {}, {}
        for it in range(6):
            for eid, (m, slo, ts) in engines.items():
                m.record_submit(rid)
                clock.tick(rs.uniform(0.005, hi))
                m.record_first_token(rid)
                m.record_finish(rid, 4)
                if pi and it % 2:
                    m.record_rejected()
                m.record_iteration(it + pi * 3, 2, 4)
                rid += 1
                ts.sample(iteration=rid)
                sts[eid] = slo.evaluate(m)
            clock.tick(0.01)
        for eid, (m, _, _) in engines.items():
            # the key only the port has (its path acceptance) stays out
            # of the comparison
            sums[eid] = m.summary()
            sums[eid]["speculation"].pop("path_acceptance_rate", None)
        phases.append(_Phase(name, pi * 12, pi * 12 + 12, t0, clock(),
                             sts, sums))
    trace = types.SimpleNamespace(
        meta={"seed": 7, "total_iterations": 24}, requests=list(range(24)),
        phases=[types.SimpleNamespace(name=p.name, start=p.start,
                                      end=p.end) for p in phases])
    return types.SimpleNamespace(
        trace=trace, phases=phases, fleet=True, engine_ids=["a", "b"],
        slo={e: v[1] for e, v in engines.items()},
        timeseries={e: v[2] for e, v in engines.items()}, dt=0.01,
        iterations=24, totals={"total": 24, "finished": 24},
        outcomes=[{"state": "finished"}] * 23 + [{"state": "timed_out"}],
        incidents=[{"t": 0.2, "point": "replica.die"}],
        fleet_timeline=[{"t": 0.0, "total": 2, "serving": 2, "dead": 0},
                        {"t": 0.2, "total": 2, "serving": 1, "dead": 1}],
        autoscale_events=[{"t": 0.25, "action": "scale_up"}])


def test_scenario_report_renderings_equal_jax(tmp_path):
    prep = preport.build_report(_replay_result(pobs, pslo, ServingMetrics))
    jrep = jreport.build_report(_replay_result(jobs, jslo, JaxMetrics))
    assert preport.to_json(prep) == jreport.to_json(jrep)
    assert preport.to_markdown(prep) == jreport.to_markdown(jrep)
    assert preport.to_html(prep) == jreport.to_html(jrep)
    assert prep["headline"]["worst_phase"] == "flash"
    paths = preport.save_report(prep, str(tmp_path))
    assert sorted(paths) == ["html", "json", "md"]
    errors = {"layers/1/attn/wq": {"rel_rms": 0.004, "max_abs_err": 0.01},
              "head": {"rel_rms": 0.007, "max_abs_err": 0.02}}
    pw = preport.weight_quant_report(errors, "int8")
    assert pw == jreport.weight_quant_report(errors, "int8")
    assert preport.weight_quant_markdown(pw) == \
        jreport.weight_quant_markdown(pw)


def test_telemetry_snapshot_and_components():
    """``attach`` joins a provider to the snapshot and detaches it with
    its owner; ``aggregate_serving`` sums the serving components."""
    import gc

    class Owner:
        def snap(self):
            return {"requests_finished": 3, "tokens_generated": 30}

    o = Owner()
    pobs.attach("serving[obs-test]", o.snap, owner=o)
    snap = pobs.telemetry_snapshot()
    assert snap["schema_version"] == 2
    assert snap["components"]["serving[obs-test]"]["tokens_generated"] == 30
    agg = pobs.aggregate_serving(snap)
    assert agg["totals"]["requests_finished"] >= 3
    del o
    gc.collect()
    assert "serving[obs-test]" not in pobs.components()


def test_tape_peak_table_and_cpu_mfu():
    """The tape's peaks are the H100's published bf16 figures; on the
    CPU there is none, so the logs carry no ``mfu``, as in JAX for an
    unknown device."""
    from distkeras_tpu_torch.obs import tape as ptape
    assert dict(ptape.BF16_PEAK_FLOPS) == {"h100 pcie": 756e12,
                                           "h100": 989e12}
    assert pobs.detect_peak_flops() == (None, "cpu")
    t = pobs.TrainingTape(name="cpu", flops_per_example=1e9,
                          registry=pobs.MetricsRegistry())
    t.train_begin()
    with t.phase("device"):
        pass
    logs = t.epoch_end(64)
    assert "mfu" not in logs and logs["examples_per_sec"] > 0
    assert "mfu" not in t.snapshot()


def test_jsonl_round_trip_keeps_metrics_with_no_series(tmp_path):
    """A metric registered and never set (an SLO engine's ``slo.breach``
    before any breach) comes back from the port's JSONL log as an empty
    series; JAX's reader skips the record it does not know."""
    p = pobs.MetricsRegistry()
    p.counter("slo.breach")
    p.gauge("slo.burn_rate")
    p.histogram("app.latency_s")
    p.counter("app.requests").inc(2, route="a")
    path = str(tmp_path / "p.jsonl")
    pexp.JsonlExporter(path).export(p.snapshot(), [])
    snap, _ = pexp.read_jsonl(path)
    assert snap == json.loads(json.dumps(p.snapshot()))
    assert snap["counters"]["slo.breach"] == {}
    jsnap, _ = jexp.read_jsonl(path)
    assert "slo.breach" not in jsnap["counters"]
    assert jsnap["counters"]["app.requests"] == \
        snap["counters"]["app.requests"]
