"""The port's load generator (``distkeras_tpu_torch.serving.loadgen``)
against the JAX package's ``distkeras_tpu.serving.loadgen``, with no
model: ``synthesize`` gives the same traces bit for bit (both reference
scenarios, three seeds), a trace's JSONL crosses both ways byte for
byte, the specs and chaos entries refuse the same inputs with the same
messages and arm the same fault triggers, and the iteration clock ticks
alike."""

import dataclasses
import json

import numpy as np
import pytest

from distkeras_tpu.serving import loadgen as jlg

from distkeras_tpu_torch.serving import loadgen as plg

SEEDS = (0, 7, 23)
SCENARIOS = {
    "diurnal": dict(scale=1.0, prompt_max=24, output_max=12),
    "diurnal_serving_lengths": dict(scale=0.5, prompt_max=480,
                                    output_max=64, length_quantum=16),
    "flash_crowd_chaos": dict(scale=1.0),
}


def _spec(mod, name, vocab=29):
    kw = SCENARIOS[name]
    if name.startswith("diurnal"):
        return mod.diurnal_burst_scenario(vocab, **kw)
    return mod.flash_crowd_chaos_scenario(vocab, **kw)


def _plain(trace):
    """A trace as plain data: every dataclass as a dict."""
    return {"requests": [dataclasses.asdict(r) for r in trace.requests],
            "phases": [dataclasses.asdict(p) for p in trace.phases],
            "chaos": [dataclasses.asdict(c) for c in trace.chaos],
            "meta": json.loads(json.dumps(trace.meta))}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_synthesize_equals_jax_bit_for_bit(name, seed):
    pt = plg.synthesize(_spec(plg, name), seed=seed)
    jt = jlg.synthesize(_spec(jlg, name), seed=seed)
    assert _plain(pt) == _plain(jt)
    assert len(pt) == len(jt) > 10
    assert plg.synthesize(_spec(plg, name), seed=seed) == pt
    assert pt.meta["spec"] == jt.meta["spec"]


@pytest.mark.parametrize("name", ["diurnal", "flash_crowd_chaos"])
def test_trace_jsonl_crosses_both_ways(tmp_path, name):
    spec_p, spec_j = _spec(plg, name), _spec(jlg, name)
    if name == "diurnal":
        extra = (plg.ChaosSpec("serving.decode", at=10, clear_at=20,
                               every=3, action="stall", stall_s=0.01),)
        spec_p = dataclasses.replace(spec_p, chaos=extra,
                                     sampled_frac=0.25, deadline_frac=0.5,
                                     deadline_iters=40)
        spec_j = dataclasses.replace(
            spec_j, chaos=(jlg.ChaosSpec("serving.decode", at=10,
                                         clear_at=20, every=3,
                                         action="stall", stall_s=0.01),),
            sampled_frac=0.25, deadline_frac=0.5, deadline_iters=40)
    pt, jt = plg.synthesize(spec_p, seed=5), jlg.synthesize(spec_j, seed=5)
    pp, jp = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    pt.to_jsonl(str(pp))
    jt.to_jsonl(str(jp))
    assert pp.read_bytes() == jp.read_bytes()
    from_jax = plg.Trace.from_jsonl(str(jp))
    to_jax = jlg.Trace.from_jsonl(str(pp))
    assert from_jax == pt
    assert _plain(to_jax) == _plain(pt)
    assert any(r.deadline is not None for r in from_jax.requests) \
        == (name == "diurnal")
    # unknown record types and unknown chaos keys are skipped alike
    with open(pp, "a") as f:
        f.write(json.dumps({"type": "from_the_future", "x": 1}) + "\n")
        f.write(json.dumps({"type": "chaos", "point": "replica.die",
                            "at": 99, "blast_radius": "zone"}) + "\n")
    ext_p, ext_j = (plg.Trace.from_jsonl(str(pp)),
                    jlg.Trace.from_jsonl(str(pp)))
    assert ext_p.requests == pt.requests
    assert plg.ChaosSpec("replica.die", at=99) in ext_p.chaos
    assert _plain(ext_p) == _plain(ext_j)


def _message(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


#: invalid constructions, each given the module to build it from
INVALID = {
    "vocab": lambda m: m.WorkloadSpec(vocab=2,
                                      phases=(m.PhaseSpec("p", 10, 0.1),)),
    "no_phase": lambda m: m.WorkloadSpec(vocab=29, phases=()),
    "template_len": lambda m: m.WorkloadSpec(
        vocab=29, phases=(m.PhaseSpec("p", 10, 0.1),), template_len=32,
        prompt_max=32),
    "sampled_frac": lambda m: m.WorkloadSpec(
        vocab=29, phases=(m.PhaseSpec("p", 10, 0.1),), sampled_frac=1.5),
    "deadline_iters": lambda m: m.WorkloadSpec(
        vocab=29, phases=(m.PhaseSpec("p", 10, 0.1),), deadline_frac=0.5),
    "no_tenant": lambda m: m.WorkloadSpec(
        vocab=29, phases=(m.PhaseSpec("p", 10, 0.1),), tenants=()),
    "quantum": lambda m: m.WorkloadSpec(
        vocab=29, phases=(m.PhaseSpec("p", 10, 0.1),), length_quantum=0),
    "shape": lambda m: m.PhaseSpec("p", 10, 0.1, shape="square"),
    "duration": lambda m: m.PhaseSpec("p", 0, 0.1),
    "rate": lambda m: m.PhaseSpec("p", 5, -0.1),
    "chaos_point": lambda m: m.ChaosSpec("", at=3),
    "chaos_at": lambda m: m.ChaosSpec("replica.die", at=-1),
    "chaos_clear": lambda m: m.ChaosSpec("serving.decode", at=5,
                                         clear_at=5),
    "clock_dt": lambda m: m.IterationClock(dt=0.0),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_validation_messages_equal_jax(case):
    build = INVALID[case]
    assert _message(lambda: build(plg)) == _message(lambda: build(jlg))


def test_chaos_kwargs_rates_and_clock_equal_jax():
    entries = [dict(point="replica.die", at=3),
               dict(point="serving.prefill", at=2, clear_at=9, every=4,
                    action="stall", stall_s=0.05),
               dict(point="serving.decode", at=1, prob=0.3, seed=11,
                    transient=True)]
    for kw in entries:
        assert plg.ChaosSpec(**kw).inject_kwargs() == \
            jlg.ChaosSpec(**kw).inject_kwargs()
    for name in ("diurnal", "flash_crowd_chaos"):
        for pp, jp in zip(_spec(plg, name).phases, _spec(jlg, name).phases):
            assert [pp.rate_at(i) for i in range(pp.duration)] == \
                [jp.rate_at(i) for i in range(jp.duration)]
    pc, jc = plg.IterationClock(dt=2.5e-3, t0=1.0), \
        jlg.IterationClock(dt=2.5e-3, t0=1.0)
    for n in (1, 3, 0, 7):
        assert pc.advance(n) == jc.advance(n)
    assert pc() == jc()
    assert plg._token_crc(np.arange(9)) == jlg._token_crc(np.arange(9))


def test_templates_share_their_prefix():
    spec = _spec(plg, "diurnal_serving_lengths")
    tr = plg.synthesize(spec, seed=3)
    by_template = {}
    for r in tr.requests:
        if r.template is not None:
            by_template.setdefault(r.template, set()).add(
                r.prompt[:spec.template_len])
        assert len(r.prompt) % spec.length_quantum == 0
        assert 1 <= r.max_new_tokens <= spec.output_max
    assert by_template
    assert all(len(p) == 1 for p in by_template.values())
