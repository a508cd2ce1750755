"""The port's six serving examples (``distkeras_tpu_torch/examples``) run
in-process on the CPU (``--device cpu``) with the lines, return values
and thresholds that ``tests/test_examples.py`` asserts of their JAX
counterparts. ``moe_serving`` asserts the single-device line in place of
JAX's expert-parallel one (``ep_mesh`` waits for ROADMAP Queue 1 item
10); ``loadgen_scenario``, which JAX does not test, is held to JAX's
trace request for request and to byte-identical replays."""

import dataclasses
import importlib
import sys

import pytest
import torch

from distkeras_tpu.serving import loadgen as jlg


@pytest.fixture(autouse=True, scope="module")
def _few_intraop_threads():
    """Small models: two intra-op threads contend less with the other
    test processes than a full pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _example(name):
    return importlib.import_module(f"distkeras_tpu_torch.examples.{name}")


def run_port_example(name, *args):
    old = sys.argv
    sys.argv = [name, *args, "--device", "cpu"]
    try:
        return _example(name).main()
    finally:
        sys.argv = old


def test_port_continuous_batching(capsys):
    matches = run_port_example("continuous_batching")
    out = capsys.readouterr().out
    assert "token-identical to generate()" in out
    assert matches >= 3       # every greedy request passed its oracle


def test_port_speculative_serving(capsys):
    matches = run_port_example("speculative_serving")
    out = capsys.readouterr().out
    assert "token-identical to generate()" in out
    assert "kicked back to plain decode" in out
    assert matches == 5       # every speculative request passed its oracle


def test_port_router_serving(capsys):
    matches = run_port_example("router_serving")
    out = capsys.readouterr().out
    assert "token-identical to generate()" in out
    assert "prefix-affinity hit rates" in out
    assert "handed off, outputs token-identical" in out
    assert "failed over and completed token-identically" in out
    assert "'slow': 'drain'" in out and "'slow': 'resume'" in out
    assert "OK" in out
    assert matches == 11    # every oracle-checked request matched


def test_port_request_tracing(capsys):
    served = run_port_example("request_tracing")
    out = capsys.readouterr().out
    assert "request timelines" in out
    assert "Chrome trace:" in out and "Perfetto" in out
    assert "SLO report:" in out and "burn_rate" in out
    assert "flight recorder ring" in out
    assert "shed by bounded admission" in out
    assert served >= 5


def test_port_moe_serving(capsys):
    matches = run_port_example("moe_serving")
    out = capsys.readouterr().out
    assert "token-identical to generate()" in out
    assert "expert_load" in out and "moe_route" in out
    assert "expert-parallel decode skipped (single-device backend)" in out
    assert "ROADMAP Queue 1 item 10" in out
    assert matches == 4 and "OK" in out


def test_port_loadgen_scenario(capsys):
    """The example's run: the trace round-trips, the designed overload
    sheds in the burst and flash phases, and the artifacts are written."""
    rep = run_port_example("loadgen_scenario")
    out = capsys.readouterr().out
    assert "trace JSONL round-trip OK" in out and "artifacts:" in out
    assert rep["headline"]["min_attainment"] < 1.0
    assert {p["name"] for p in rep["phases"] if p["shed"]} >= {"flash"}


def test_port_loadgen_trace_is_jax_and_replays_byte_identically():
    """The example's trace is JAX's ``synthesize`` of the same scenario
    and seed, request for request; two replays through fresh engines
    give byte-identical reports."""
    from distkeras_tpu_torch.obs import report
    mod = _example("loadgen_scenario")
    _, trace = mod.scenario_trace()
    jspec = jlg.diurnal_burst_scenario(mod.VOCAB, scale=0.6, prompt_max=16,
                                       output_max=8)
    jtrace = jlg.synthesize(jspec, seed=mod.SEED)
    assert len(trace.requests) == len(jtrace.requests) > 10
    for p, j in zip(trace.requests, jtrace.requests):
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
    first, second = (mod.replay_trace(trace, torch.device("cpu"))
                     for _ in range(2))
    assert first.outcomes == second.outcomes
    assert report.to_json(report.build_report(first)) == \
        report.to_json(report.build_report(second))
