"""The port's serving tier (``distkeras_tpu_torch.serving.router``, the
engine's ``transfer_out``/``transfer_in``, ``loadgen.replay``) against
the JAX package's on the same weights: every case drives the JAX object
and the port's through the same calls and compares what comes out.

The oracle: streams scattered across replicas, handed from a prefill
replica to a decode replica, rebalanced off a draining replica or failed
over after a replica's death (greedy and sampled; plain, fused-window
and tree-speculative engines) equal JAX's router's streams and a single
port engine's, token for token (sampled: byte for byte). The fleet's
counters, events, controller decisions and ``requests_transferred``
equal JAX's, the failover key replay equals JAX's, and a replay through
a router (and the chaos replay through an autoscaled fleet) gives JAX's
outcomes and ``build_report`` and repeats itself.

Uses the memorized ``pattern_lm`` fixture (huge argmax margins keep
token identity robust to float reassociation across batch shapes); its
JAX weights cross to the port with ``from_jax_params``."""

import copy
import gc
import types
import weakref

import numpy as np
import pytest
import torch

import distkeras_tpu.serving as jsv
from distkeras_tpu.obs import report as jreport
from distkeras_tpu.obs import slo as jslo
from distkeras_tpu.resilience import faults as jfaults
from distkeras_tpu.serving.router.router import _replay_key as j_replay_key

import distkeras_tpu_torch.serving as psv
from distkeras_tpu_torch.models import Model, from_jax_params, zoo
from distkeras_tpu_torch.obs import report as preport
from distkeras_tpu_torch.obs import slo as pslo
from distkeras_tpu_torch.resilience import faults as pfaults
from distkeras_tpu_torch.serving.router.router import _replay_key

V = 29
PATTERN = np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8])
PROMPTS = [PATTERN[:4], PATTERN[:6], PATTERN[:3], PATTERN[:5],
           PATTERN[:7], PATTERN[:5]]
BUDGETS = [7, 5, 9, 6, 4, 8]
SAMPLED = dict(temperature=0.9, top_p=0.95, seed=5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lms(pattern_lm):
    pm = Model.build(zoo.transformer_lm(V, d_model=32, num_heads=4,
                                        num_layers=2, mlp_ratio=2),
                     (12,), device="cpu")
    from_jax_params(pm, pattern_lm.params, pattern_lm.state)
    return pattern_lm, pm


def _sides(lms):
    """The two packages as namespaces: the serving names, the fault
    table, the SLO helpers, the report and an engine factory at the JAX
    tests' size (2 slots, ``max_len`` 32)."""
    jm, pm = lms

    def build(sv, m, extra):
        def engine(eid, **kw):
            kw.setdefault("num_slots", 2)
            kw.setdefault("max_len", 32)
            return sv.ServingEngine(m, engine_id=eid, **extra, **kw)
        return engine

    jax_side = types.SimpleNamespace(
        sv=jsv, faults=jfaults, slo=jslo, report=jreport,
        engine=build(jsv, jm, {}))
    port_side = types.SimpleNamespace(
        sv=psv, faults=pfaults, slo=pslo, report=preport,
        engine=build(psv, pm, {"device": "cpu"}))
    return jax_side, port_side


def _drive(router):
    """``{grid: Request}`` of a full drain."""
    out = {}
    steps = 0
    while router.pending:
        for g, req in router.step().items():
            out[g] = req
        steps += 1
        assert steps < 2000, "the fleet did not drain"
    return out


def _tokens(done):
    return {g: [int(t) for t in req.tokens] for g, req in done.items()}


#: engine options of the oracle cases (a fresh draft per engine)
OPTIONS = {
    "plain": lambda sv: {},
    "fused": lambda sv: dict(fuse_steps=4),
    "tree": lambda sv: dict(draft=sv.NgramDraft(), spec_k=3,
                            spec_tree=True, spec_width=2),
}


def _fleet(s, names, option, **kw):
    return [s.sv.EngineReplica(s.engine(n, **OPTIONS[option](s.sv), **kw))
            for n in names]


def _scattered(s, option, tag):
    r = s.sv.Router(_fleet(s, [f"{tag}0", f"{tag}1"], option))
    grids = [r.submit(PROMPTS[i], BUDGETS[i]) for i in range(3)]
    out = {}
    for _ in range(2):
        out.update(r.step())
    grids += [r.submit(PROMPTS[i], BUDGETS[i]) for i in range(3, 6)]
    grids.append(r.submit(PATTERN[:5], 6, **SAMPLED))
    out.update(_drive(r))
    return r, out


def _disaggregated(s, option, tag):
    r = s.sv.Router([
        s.sv.EngineReplica(s.engine(f"{tag}p", prefill_chunk=3,
                                    **OPTIONS[option](s.sv)),
                           role="prefill"),
        s.sv.EngineReplica(s.engine(f"{tag}d", **OPTIONS[option](s.sv)),
                           role="decode")])
    for i in range(4):
        r.submit(PROMPTS[i], BUDGETS[i])
    r.submit(PATTERN[:5], 6, **SAMPLED)
    return r, _drive(r)


def _rebalanced(s, option, tag):
    r = s.sv.Router(_fleet(s, [f"{tag}0", f"{tag}1"], option, num_slots=1),
                    policy="least_loaded")
    grids = [r.submit(PROMPTS[i], BUDGETS[i]) for i in range(4)]
    grids.append(r.submit(PATTERN[:5], 6, **SAMPLED))
    queued = [g for g in grids
              if r[g].state is s.sv.RequestState.QUEUED]
    victim = r._requests[queued[0]].replica
    victim.drain()
    assert r.rebalance_queued(victim) >= 1
    return r, _drive(r)


def _failover(s, option, tag):
    try:
        r = s.sv.Router(_fleet(s, [f"{tag}0", f"{tag}1"], option))
        for i in range(4):
            r.submit(PROMPTS[i], BUDGETS[i])
        r.submit(PATTERN[:5], 8, **SAMPLED)
        out = {}
        for _ in range(3):
            out.update(r.step())
        s.faults.inject("replica.die", nth=1)
        out.update(_drive(r))
        return r, out
    finally:
        s.faults.reset()


SCENARIOS = {"scattered": _scattered, "disaggregated": _disaggregated,
             "rebalanced": _rebalanced, "failover": _failover}
CASES = [("scattered", "plain"), ("scattered", "fused"),
         ("scattered", "tree"), ("disaggregated", "plain"),
         ("disaggregated", "fused"), ("rebalanced", "plain"),
         ("failover", "plain"), ("failover", "fused"), ("failover", "tree")]


def _single_engine(port, done):
    """Every routed request again, through one port engine."""
    eng = port.engine("single", num_slots=2)
    rids = {}
    for g, req in done.items():
        kw = ({} if req.temperature <= 0 else
              dict(temperature=req.temperature, top_p=req.top_p,
                   seed=req.seed))
        rids[g] = eng.submit(req.prompt, req.max_new_tokens, **kw)
    out = eng.run(max_steps=1000)
    return {g: [int(t) for t in out[rid]] for g, rid in rids.items()}


@pytest.mark.parametrize("scenario,option", CASES)
def test_routed_streams_equal_jax_router_and_one_engine(lms, scenario,
                                                        option):
    jax_side, port = _sides(lms)
    tag = f"{scenario[:2]}{option[:2]}"
    jr, jdone = SCENARIOS[scenario](jax_side, option, tag)
    pr, pdone = SCENARIOS[scenario](port, option, tag)
    assert _tokens(pdone) == _tokens(jdone)
    assert all(req.state is psv.RequestState.FINISHED
               for req in pdone.values())
    assert _tokens(pdone) == _single_engine(port, pdone)
    assert pr.counters() == jr.counters()
    assert pr.fleet_events == jr.fleet_events
    assert pr.fleet_counts() == jr.fleet_counts()
    assert {g: (q.n_handoffs, q.n_failovers) for g, q in pdone.items()} \
        == {g: (q.n_handoffs, q.n_failovers) for g, q in jdone.items()}
    for prep, jrep in zip(pr.replicas, jr.replicas):
        ps, js = (prep.engine.metrics.summary(),
                  jrep.engine.metrics.summary())
        assert ps["requests_transferred"] == js["requests_transferred"]
        assert ps["requests_finished"] == js["requests_finished"]
        assert prep.state.value == jrep.state.value
    c = pr.counters()
    if scenario == "disaggregated":
        assert c["handoffs"] == 5
        pre = pr.replicas[0].engine
        assert pre.metrics.requests_transferred == 5
        states = {s["state"] for s in pre.tracer.summaries().values()}
        assert states == {"transferred"}
    if scenario == "failover":
        assert c["failovers"] >= 1
        assert pr.health()["status"] == "degraded"


@pytest.mark.parametrize("n", [0, 1, 7, 50])
def test_replay_key_equals_jax(n):
    for seed in (0, 5, 2 ** 31 + 3):
        got = _replay_key(seed, n)
        want = j_replay_key(seed, n)
        assert got.dtype == np.int64 and got.shape == (2,)
        np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_transfer_round_trip_equals_jax(lms):
    """The engine-level handoff: detach a greedy and a sampled stream
    mid-decode and adopt them on a second engine; the continuations, the
    tracer's terminal state and the flight record equal JAX's; a slab
    engine refuses an admitted request with JAX's message."""
    from distkeras_tpu.obs.recorder import get_recorder as jget
    from distkeras_tpu.obs.recorder import reset_recorder as jreset
    from distkeras_tpu_torch.obs.recorder import get_recorder as pget
    from distkeras_tpu_torch.obs.recorder import reset_recorder as preset
    jax_side, port = _sides(lms)
    results = []
    for s, get, reset in ((jax_side, jget, jreset), (port, pget, preset)):
        reset()
        src, dst = s.engine("tr-src"), s.engine("tr-dst")
        rid_g = src.submit(PROMPTS[0], BUDGETS[0])
        rid_s = src.submit(PATTERN[:5], 8, **SAMPLED)
        for _ in range(5):
            src.step()
        moved = {}
        for rid in (rid_g, rid_s):
            req = src.transfer_out(rid)
            assert req is not None and req.state.value == "queued"
            moved[rid] = dst.transfer_in(req)
        out = dst.run(max_steps=500)
        recs = [(r["kind"], r.get("engine"), r.get("n_generated"))
                for r in get().records()
                if r["kind"] == "serving.transferred"]
        terminal = {rid: st["state"]
                    for rid, st in src.tracer.summaries().items()}
        slab = s.engine("tr-slab", kv_layout="slab")
        slab.submit(PROMPTS[0], 4)
        slab.step()
        with pytest.raises(RuntimeError) as err:
            slab.transfer_out(0)
        results.append(([list(map(int, out[moved[r]]))
                         for r in (rid_g, rid_s)], recs, terminal,
                        str(err.value),
                        src.metrics.summary()["requests_transferred"]))
        reset()
    assert results[0] == results[1]
    assert results[1][4] == 2


def test_affinity_key_and_probe_equal_jax(lms):
    """Two templates through ``prefix_affinity``: the homes of every
    request, the probes and the hit maps equal JAX's after each drain;
    ``probe`` moves neither the hit counts nor the LRU ticks."""
    jax_side, port = _sides(lms)
    t_a = np.tile(PATTERN, 2)[:8]
    t_b = np.tile(PATTERN[::-1], 2)[:8]
    seen = []
    for s in (jax_side, port):
        r = s.sv.Router([s.sv.EngineReplica(s.engine(n, page_len=4))
                         for n in ("pa0", "pa1")],
                        policy="prefix_affinity")
        trail = []
        for tpl in (t_a, t_b, t_a, t_b, t_a):
            g = r.submit(tpl, 4)
            trail.append(r._requests[g].replica.name)
            r.run(max_steps=500)
            probes = []
            for rep in r.replicas:
                cache = rep.engine.prefix
                ticks = {n: nd.last_used for n, nd in cache._nodes.items()}
                hits = dict(cache._hits)
                probes.append((cache.probe(cache.affinity_key(t_a)),
                               cache.probe(cache.affinity_key(t_b)),
                               cache.probe(cache.affinity_key(t_a[:3])),
                               cache.affinity_key(t_a)))
                assert cache._hits == hits
                assert {n: nd.last_used
                        for n, nd in cache._nodes.items()} == ticks
            trail.append(probes)
        seen.append(trail)
    assert seen[0] == seen[1]
    homes = [x for x in seen[1] if isinstance(x, str)]
    assert homes[0] != homes[1] and homes[2] == homes[0]


def test_deadline_budget_follows_moves_as_in_jax(lms):
    """A queued request whose budget ran out while queued comes back
    TIMED_OUT from a rebalance (it is not handed a fresh deadline), and a
    failover carries the remaining budget; as JAX's router does."""
    jax_side, port = _sides(lms)
    seen = []
    for s in (jax_side, port):
        t = [0.0]

        def fleet(names, **kw):
            reps = []
            for n in names:
                e = s.engine(n, **kw)
                e.metrics = s.sv.ServingMetrics(clock=lambda: t[0])
                reps.append(s.sv.EngineReplica(e))
            return reps

        r = s.sv.Router(fleet(["dh0", "dh1"], num_slots=1),
                        policy="least_loaded")
        r.submit(PROMPTS[0], BUDGETS[0])
        r.submit(PROMPTS[1], BUDGETS[1])
        r.step()
        gq = r.submit(PROMPTS[2], BUDGETS[2], deadline_s=0.5)
        src = r._requests[gq].replica
        t[0] = 1.0
        src.drain()
        r.rebalance_queued(src)
        done = _drive(r)
        try:
            t[0] = 0.0
            r2 = s.sv.Router(fleet(["db0", "db1"]))
            g = r2.submit(PROMPTS[0], BUDGETS[0], deadline_s=10.0)
            home = r2._requests[g].replica
            r2.step()
            r2.step()
            t[0] = 3.0
            s.faults.inject("replica.die", nth=r2.replicas.index(home) + 1)
            while r2._requests.get(g) is not None \
                    and r2._requests[g].replica is home:
                r2.step()
            left = r2[g].deadline_s if g in r2._requests else None
            done2 = _drive(r2)
        finally:
            s.faults.reset()
        seen.append(({g_: q.state.value for g_, q in done.items()},
                     _tokens(done), r.counters(), left, _tokens(done2),
                     r2.counters()))
    assert seen[0] == seen[1]
    assert "timed_out" in seen[1][0].values()
    assert seen[1][3] == pytest.approx(7.0)


def _controller_story(s, m_tag):
    """The controllers through the JAX fleet tests' stories: scale up on
    sheds (blocked by the cooldown and capped), scale down after idle
    (LIFO, then blocked at the floor), no scale-down while a replica
    drains, the SLO-burn drain and resume, and the chain."""
    sv = s.sv
    log = []
    # scale up on shed
    r = sv.Router([sv.EngineReplica(s.engine(f"{m_tag}as0", num_slots=1,
                                             max_queue=1))])
    minted = []

    def factory():
        minted.append(f"{m_tag}as{len(minted) + 1}")
        return sv.EngineReplica(s.engine(minted[-1], num_slots=1,
                                         max_queue=1))

    ctl = sv.AutoscaleController(r, factory, min_serving=1, max_replicas=2,
                                 up_sustain=2, cooldown=3)
    kept = []

    def shed_once():
        with pytest.raises(sv.AdmissionRejected):
            for i in range(6):
                kept.append(r.submit(PROMPTS[i % len(PROMPTS)], 4))

    for _ in range(4):
        shed_once()
        log.append(ctl.tick())
    out = r.run(max_steps=2000)
    log += [ctl.decisions, ctl.counts(), r.counters(), r.fleet_events,
            sorted(out), ctl.signals()]
    # scale down after idle
    r = sv.Router([sv.EngineReplica(s.engine(f"{m_tag}sd0"))])
    ctl = sv.AutoscaleController(
        r, lambda: sv.EngineReplica(s.engine(f"{m_tag}sd-x")),
        min_serving=1, max_replicas=2, idle_sustain=2, cooldown=0)
    added = r.add_replica(lambda: sv.EngineReplica(s.engine(f"{m_tag}sd1")))
    ctl._added.append(added.name)
    for _ in range(14):
        log.append(ctl.tick())
        r.step()
    log += [ctl.decisions, r.fleet_events, r.fleet_counts()]
    # never removes a draining replica
    r = sv.Router([sv.EngineReplica(s.engine(f"{m_tag}nd{i}"))
                   for i in range(3)])
    ctl = sv.AutoscaleController(
        r, lambda: sv.EngineReplica(s.engine(f"{m_tag}nd-x")),
        min_serving=1, max_replicas=4, idle_sustain=1, cooldown=0)
    r.replica(f"{m_tag}nd2").drain()
    log += [ctl.tick() for _ in range(3)]
    r.replica(f"{m_tag}nd2").resume()
    for _ in range(3):
        log.append(ctl.tick())
        r.step()
    log += [ctl.decisions, r.fleet_events]
    # SLO burn: drain, then resume on a fresh window
    e0 = s.engine(f"{m_tag}slo0", slo=[s.slo.ttft_p99(1e-9)])
    r = sv.Router([sv.EngineReplica(e0),
                   sv.EngineReplica(s.engine(f"{m_tag}slo1"))],
                  policy="least_loaded")
    burn = sv.SLOBurnController(r, drain_above=2.0, resume_below=1.0,
                                min_serving=1)
    rid = r.replica(f"{m_tag}slo0").submit(PROMPTS[0], 4)
    while e0[rid].state is not sv.RequestState.DECODING:
        e0.step()
    log.append(r.replica(f"{m_tag}slo0").slo_burn())
    log.append(burn.tick())
    while e0.scheduler.pending:
        e0.step()
    e0.metrics = sv.ServingMetrics()
    log.append(burn.tick())
    log.append({rep.name: rep.state.value for rep in r.replicas})
    # the chain, attached
    auto = sv.AutoscaleController(
        r, lambda: sv.EngineReplica(s.engine(f"{m_tag}cc-x")),
        min_serving=1, max_replicas=2, idle_sustain=1, cooldown=0)
    chain = sv.ControllerChain(burn, auto)
    r.attach_controller(chain)
    log.append(chain.tick())
    g = r.submit(PROMPTS[0], BUDGETS[0])
    out = r.run(max_steps=2000)
    log += [list(map(int, out[g])), auto.decisions, r.fleet_events,
            r.counters()]
    return log


def test_controllers_decide_as_jax(lms):
    jax_side, port = _sides(lms)
    jlog = _controller_story(jax_side, "c")
    plog = _controller_story(port, "c")
    assert plog == jlog
    assert any(d["action"] == "scale_up" for d in plog[4])


def test_replica_validation_messages_equal_jax(lms):
    jax_side, port = _sides(lms)
    msgs = []
    for s in (jax_side, port):
        sv = s.sv
        cases = [
            lambda: sv.EngineReplica(s.engine("v-slab", kv_layout="slab")),
            lambda: sv.EngineReplica(s.engine("v-role"), role="verifier"),
            lambda: sv.Router([sv.EngineReplica(s.engine("v-x"),
                                                name="same"),
                               sv.EngineReplica(s.engine("v-y"),
                                                name="same")]),
            lambda: sv.Router([sv.EngineReplica(s.engine("v-z"),
                                                role="prefill")]),
            lambda: sv.Router([sv.EngineReplica(s.engine("v-w"))],
                              policy="round_robin"),
            lambda: sv.Router([]),
        ]
        got = []
        for fn in cases:
            with pytest.raises(ValueError) as err:
                fn()
            got.append(str(err.value))
        rep = sv.EngineReplica(s.engine("v-un"))
        with pytest.raises(sv.AdmissionRejected) as err:
            rep.submit(PROMPTS[0], 4)
        got.append(str(err.value))
        rep.start()
        rep.drain()
        with pytest.raises(sv.ReplicaUnavailable) as err:
            rep.submit(PROMPTS[0], 4)
        got.append(str(err.value))
        rep.mark_dead(RuntimeError("boom"))
        with pytest.raises(sv.ReplicaDead) as err:
            rep.step()
        got.append(str(err.value))
        got.append(sorted(rep.health()))
        msgs.append(got)
    assert msgs[0] == msgs[1]


def _replay_fleet(s, tag, n=2, **kw):
    kw.setdefault("max_queue", 6)
    return s.sv.Router([s.engine(f"{tag}{i}", **kw) for i in range(n)])


def _drop_port_key(obj):
    """The report without the summaries' one port-only key
    (``speculation.path_acceptance_rate``; ROADMAP Queue 3)."""
    if isinstance(obj, dict):
        return {k: _drop_port_key(v) for k, v in obj.items()
                if k != "path_acceptance_rate"}
    if isinstance(obj, list):
        return [_drop_port_key(v) for v in obj]
    return obj


def _comparable(res, report):
    rep = report.build_report(res)
    return copy.deepcopy({
        "outcomes": res.outcomes, "incidents": res.incidents,
        "fleet_timeline": res.fleet_timeline,
        "autoscale_events": res.autoscale_events,
        "engine_ids": res.engine_ids, "iterations": res.iterations,
        "report": report.to_json(_drop_port_key(rep)),
        "markdown": report.to_markdown(rep)})


def test_replay_through_router_equals_jax_and_repeats(lms):
    jax_side, port = _sides(lms)
    runs = []
    for s in (jax_side, port, port):
        spec = s.sv.diurnal_burst_scenario(V, scale=0.5, prompt_max=16,
                                           output_max=8)
        tr = s.sv.synthesize(spec, seed=11)
        objs = [s.slo.ttft_p99(0.25), s.slo.availability(0.5)]
        res = s.sv.replay(tr, _replay_fleet(s, "lg"), objectives=objs,
                          dt=1e-3)
        runs.append(_comparable(res, s.report))
        del res
        gc.collect()
    assert runs[1] == runs[0]
    assert runs[2] == runs[1]
    assert sorted(runs[1]["engine_ids"]) == ["lg0", "lg1"]
    assert any("tokens_crc" in o for o in runs[1]["outcomes"])


def test_chaos_replay_through_autoscaled_fleet_equals_jax_and_repeats(lms):
    """The scripted mid-crowd ``replica.die`` through a two-replica fleet
    with an ``AutoscaleController``: outcomes (token CRCs), incidents,
    the fleet timeline, the decisions and the report equal JAX's, twice;
    the dead replica's engine is collected once the fleet dropped it."""
    jax_side, port = _sides(lms)
    runs = []
    for s in (jax_side, port, port):
        sv = s.sv
        spec = sv.WorkloadSpec(
            vocab=V,
            phases=(sv.PhaseSpec("steady", 25, 0.15),
                    sv.PhaseSpec("crowd", 30, 0.5),
                    sv.PhaseSpec("recovery", 25, 0.1)),
            prompt_max=16, output_max=8, length_quantum=8,
            sampled_frac=0.5, chaos=(sv.ChaosSpec("replica.die", at=30),))
        tr = sv.synthesize(spec, seed=17)
        try:
            minted = []

            def factory(s=s, minted=minted):
                minted.append(f"czs{len(minted)}")
                return s.sv.EngineReplica(s.engine(minted[-1],
                                                   max_queue=6))

            r = _replay_fleet(s, "cz", max_queue=4)
            ctl = sv.AutoscaleController(r, factory, min_serving=1,
                                         max_replicas=3, up_sustain=1,
                                         idle_sustain=4, cooldown=2)
            r.attach_controller(ctl)
            seed_engines = [weakref.ref(rep.engine) for rep in r.replicas]
            res = sv.replay(tr, r, objectives=[s.slo.availability(0.9)],
                            dt=1e-3)
            runs.append(_comparable(res, s.report))
            if s is port:
                gone = {rep.name for rep in r.replicas}
                del res
                gc.collect()
                dead_names = [n for _, e, n in r.fleet_events
                              if e == "dead"]
                assert dead_names and dead_names[0] not in gone
                assert any(ref() is None for ref in seed_engines)
            del r, ctl
        finally:
            s.faults.reset()
        gc.collect()
    assert runs[1] == runs[0]
    assert runs[2] == runs[1]
    assert any(ev["point"] == "replica.die" for ev in runs[1]["incidents"])
    assert any(row.get("dead", 0) >= 1 for row in runs[1]["fleet_timeline"])
    assert '"recovery"' in runs[1]["report"]


def test_dead_replica_unit_in_flight_is_dropped_unread(lms):
    """A replica that dies with a launched, unfetched decode unit: the
    router re-admits its streams from its own token mirror, the dead
    engine's unit is dropped (never fetched into the moved requests,
    even when a metrics swap later drains the dead engine), and every
    stream equals a single engine's."""
    _, port = _sides(lms)
    try:
        r = psv.Router(_fleet(port, ["dp0", "dp1"], "plain"))
        for i in range(4):
            r.submit(PROMPTS[i], BUDGETS[i])
        r.submit(PATTERN[:5], 8, **SAMPLED)
        out = {}
        for _ in range(4):
            out.update(r.step())
        victim = r.replicas[0]
        assert victim.engine._pending is not None
        moved = [tr.grid for tr in r._requests.values()
                 if tr.replica is victim]
        pfaults.inject("replica.die", nth=1)
        out.update(r.step())
        assert victim.state is psv.ReplicaState.DEAD and moved
        assert victim.engine._pending is None
        held = {g: list(r[g].generated) for g in moved if g in r._requests}
        victim.engine.metrics = psv.ServingMetrics()
        assert {g: list(r[g].generated) for g in held} == held
        out.update(_drive(r))
    finally:
        pfaults.reset()
    assert r.counters()["failovers"] == len(moved)
    assert _tokens(out) == _single_engine(port, out)
