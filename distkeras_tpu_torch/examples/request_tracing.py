"""Request-level observability tour: trace a bursty serving workload (the
port's copy of ``examples/request_tracing.py``).

  1. serve a small LM under a bursty open-loop arrival pattern -- two
     waves of requests against a bounded admission queue, so queueing,
     slot recycling and load shedding all happen;
  2. read every request's timeline (queued -> prefill/TTFT -> decode ->
     finish, with the queue depth it saw at submission) from the
     engine's tracer;
  3. dump the Chrome trace artifact -- load it at https://ui.perfetto.dev
     to see slot occupancy and per-request phases on a timeline;
  4. evaluate declared SLOs (ttft_p99 / tpot_p99 / availability) and
     print the burn-rate report the degradation machinery keys off;
  5. show the flight recorder's ring of recent engine iterations --
     what a crash dump would have contained.

On the card the prefill runs K1f and the decode K3.

Run (``--device cpu`` without a card):
    python -m distkeras_tpu_torch.examples.request_tracing
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

PATTERN = np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args, _ = ap.parse_known_args()

    from distkeras_tpu_torch.models import Model, zoo
    from distkeras_tpu_torch.obs.slo import availability, tpot_p99, ttft_p99
    from distkeras_tpu_torch.serving import AdmissionRejected, ServingEngine

    V, S = 29, 12
    model = Model.build(
        zoo.transformer_lm(V, d_model=32, num_heads=4, num_layers=2,
                           mlp_ratio=2, use_rope=True), (S,), seed=2,
        device=args.device)

    engine = ServingEngine(
        model, num_slots=3, max_len=48, prefill_chunk=4, max_queue=4,
        slo=[ttft_p99(30.0), tpot_p99(5.0), availability(0.5)],
        device=args.device)
    rs = np.random.RandomState(0)

    def burst(n, lo=3, hi=9):
        """Submit n requests at once; bounded admission may shed."""
        admitted, shed = [], 0
        for _ in range(n):
            p = rs.randint(0, V, (rs.randint(lo, hi),)).astype(np.int32)
            try:
                admitted.append(engine.submit(p, int(rs.randint(4, 9))))
            except AdmissionRejected:
                shed += 1
        return admitted, shed

    # wave 1 saturates the pool and the queue; a few iterations of
    # progress; wave 2 lands on a busy engine
    rids, shed1 = burst(6)
    for _ in range(4):
        engine.step()
    more, shed2 = burst(4)
    rids += more
    results = engine.run(max_steps=2000)
    print(f"served {len(results)} requests "
          f"({shed1 + shed2} shed by bounded admission)")

    # -- per-request timelines (the "what happened to THIS request" view)
    print("\nrequest timelines (admitted -> TTFT -> finish):")
    for rid, s in sorted(engine.tracer.summaries().items()):
        d = s["durations"]
        print(f"  req {rid}: state={s['state']} slot={s['slot']} "
              f"queue@submit={s['queue_depth_at_submit']} "
              f"queued={d.get('queued_s', 0) * 1e3:7.1f}ms "
              f"ttft={d.get('ttft_s', 0) * 1e3:7.1f}ms "
              f"total={d.get('total_s', 0) * 1e3:7.1f}ms "
              f"({s['n_tokens']} tok, {s['decode_iters']} decode iters)")

    # -- Chrome trace artifact (Perfetto)
    trace_path = os.path.join(tempfile.gettempdir(),
                              "request_tracing_example.json")
    engine.tracer.dump_chrome_trace(trace_path)
    with open(trace_path) as f:
        trace = json.load(f)
    flows = sum(1 for e in trace["traceEvents"] if e.get("ph") == "s")
    print(f"\nChrome trace: {len(trace['traceEvents'])} events, "
          f"{flows} request flows -> {trace_path}")
    print("open it at https://ui.perfetto.dev (Perfetto) or "
          "chrome://tracing")

    # -- SLO report (the principled degradation trigger)
    print("\nSLO report:")
    status = engine.slo.evaluate(engine.metrics)
    for name, st in status.items():
        bound = (f"< {st['threshold_s']:.3g}s" if "threshold_s" in st
                 else f">= {st['target']:.3g}")
        ok = "BREACH" if st["breach"] else "ok"
        val = "n/a" if st["value"] is None else f"{st['value']:.4g}"
        print(f"  {name:13s} {bound:10s} value={val:8s} "
              f"good={st['good_fraction']:.3f} "
              f"burn_rate={st['burn_rate']:.2f}  [{ok}]")
    print(f"health: {engine.health()['status']}")

    # -- flight recorder: what a crash dump would have contained
    ring = engine.recorder.records()
    iters = [r for r in ring if r["kind"] == "serving.iteration"]
    print(f"\nflight recorder ring: {len(ring)} records "
          f"({len(iters)} engine iterations; newest iter "
          f"{iters[-1]['iter'] if iters else '-'} with occupancy "
          f"{iters[-1]['occupied'] if iters else '-'})")

    return len(results)


if __name__ == "__main__":
    main()
