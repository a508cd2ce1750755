"""Production-shaped traffic + scenario SLO report, end to end (the port's
copy of ``examples/loadgen_scenario.py``).

The capacity-review workflow for the continuous-batching engine:

  1. synthesize the fixed diurnal+burst reference scenario -- a ramp to
     steady state, a 4x step burst, recovery, a flash crowd, a ramp
     down -- with heavy-tailed lengths, shared template prefixes and
     three priority tenants, all from one seed (the JAX package's
     trace, request for request);
  2. round-trip the trace through its JSONL artifact;
  3. replay it open-loop through a small engine on the virtual
     iteration clock: per-phase metrics windows, a windowed time series
     of the live registry, SLO burn rings -- deterministic, no sleeps
     (replaying twice gives byte-identical reports);
  4. build the scenario report: per-phase SLO attainment, max burn,
     saturation/shed-onset detection, then write the markdown/JSON
     artifacts and the self-contained HTML timeline dashboard.

On the card the engine's prefill runs K1f and its decode K3.

Run (``--device cpu`` without a card):
    python -m distkeras_tpu_torch.examples.loadgen_scenario
"""

from __future__ import annotations

import argparse
import os
import tempfile

VOCAB = 256
SEED = 17
DT = 1e-3


def scenario_trace(seed: int = SEED):
    """The reference scenario, scaled for a quick run. The generator
    quantizes prompt lengths (``length_quantum``) the way a production
    deployment buckets them."""
    from distkeras_tpu_torch.serving import diurnal_burst_scenario, synthesize
    spec = diurnal_burst_scenario(VOCAB, scale=0.6, prompt_max=16,
                                  output_max=8)
    return spec, synthesize(spec, seed=seed)


def replay_trace(trace, device):
    """Replay ``trace`` through a deliberately small engine (2 slots, a
    short admission queue) so the burst and flash phases queue and shed;
    objectives are in virtual seconds (iterations * ``DT``). A fresh
    model from seed 0 each call."""
    from distkeras_tpu_torch.models import Model, zoo
    from distkeras_tpu_torch.obs.slo import availability, tpot_p99, ttft_p99
    from distkeras_tpu_torch.serving import ServingEngine, replay
    model = Model.build(
        zoo.transformer_lm(VOCAB, d_model=64, num_heads=4,
                           num_layers=2, mlp_ratio=2, use_rope=True),
        (16,), seed=0, device=device)
    return replay(
        trace,
        ServingEngine(model, num_slots=2, max_len=48, max_queue=6,
                      device=device),
        objectives=[ttft_p99(250 * DT), tpot_p99(50 * DT),
                    availability(0.9)],
        dt=DT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args, _ = ap.parse_known_args()

    from distkeras_tpu_torch.compat import resolve_device
    from distkeras_tpu_torch.obs import report as scenario_report
    from distkeras_tpu_torch.serving import Trace

    device = resolve_device(args.device)
    # 1. the reference scenario
    spec, trace = scenario_trace()
    print(f"trace: {len(trace.requests)} requests over "
          f"{spec.total_iterations} iterations, "
          f"{len(trace.phases)} phases")
    by_tenant = {}
    for r in trace.requests:
        by_tenant[r.tenant] = by_tenant.get(r.tenant, 0) + 1
    print(f"tenant mix: {by_tenant}")

    out_dir = tempfile.mkdtemp(prefix="loadgen_scenario_")

    # 2. the replayable artifact: same seed => the same trace, and the
    # JSONL round-trips losslessly
    trace_path = os.path.join(out_dir, "trace.jsonl")
    trace.to_jsonl(trace_path)
    back = Trace.from_jsonl(trace_path)
    assert back.requests == trace.requests
    print(f"trace JSONL round-trip OK -> {trace_path}")

    # 3. replay through a small engine on the iteration clock
    result = replay_trace(back, device)
    print(f"replayed {result.iterations} iterations: {result.totals}")

    # 4. the scenario report: phases joined against the time series
    rep = scenario_report.build_report(result)
    h = rep["headline"]
    print(f"\nheadline: min attainment {h['min_attainment']:.3f} "
          f"({h['worst_objective']} during {h['worst_phase']}), "
          f"max burn {h['max_burn_rate']:.2f}")
    for ph in rep["phases"]:
        sat = next(iter(ph["saturation"].values()), {})
        onset = sat.get("shed_onset_t")
        att = min((ph.get("attainment") or {"": 1.0}).values())
        line = (f"  {ph['name']:<10} submitted={ph['submitted']:<3} "
                f"shed={ph['shed']:<2} attainment={att:.3f}")
        if onset is not None:
            line += f"  shed onset t={onset:.3f}"
        print(line)
    paths = scenario_report.save_report(rep, out_dir)
    print("\nartifacts:")
    for ext, p in paths.items():
        print(f"  {ext:<5} {p}")
    print(f"\nopen {paths['html']} in a browser for the timeline "
          "dashboard (phase bands, queue depth, latency percentiles, "
          "token/shed rates, SLO burn)")
    return rep


if __name__ == "__main__":
    main()
