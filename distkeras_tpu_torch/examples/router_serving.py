"""Horizontal serving: a replicated-engine fleet behind the router (the
port's copy of ``examples/router_serving.py``).

Three engine replicas behind a prefix-affinity ``Router``, a
disaggregated prefill/decode pair handing streams off mid-request, a
replica killed mid-flight with every in-flight request completing
elsewhere token-identically, and an SLO-burn drain taking a breaching
replica out of rotation while its streams finish. On the card each
replica's prefill runs K1f and its decode K3 (the sampled request K4
and K7).

Run (``--device cpu`` without a card):
    python -m distkeras_tpu_torch.examples.router_serving
"""

from __future__ import annotations

import argparse

import numpy as np

PATTERN = np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args, _ = ap.parse_known_args()

    from distkeras_tpu_torch.models import Model, zoo
    from distkeras_tpu_torch.models.decoding import generate
    from distkeras_tpu_torch.resilience import faults
    from distkeras_tpu_torch.serving import (EngineReplica, Router,
                                             ServingEngine)

    # the usual overfit tiny LM: greedy rollouts verifiable against
    # generate()
    V, S = 29, 12
    X = np.tile(PATTERN, (256, 1))
    model = Model.build(
        zoo.transformer_lm(V, d_model=32, num_heads=4, num_layers=2,
                           mlp_ratio=2, use_rope=True), (S,), seed=2,
        device=args.device)
    model.fit(X[:, :-1], X[:, 1:], optimizer="adam", learning_rate=5e-3,
              batch_size=64, epochs=30,
              loss="sparse_categorical_crossentropy_from_logits")

    def engine(eid, **kw):
        return ServingEngine(model, num_slots=2, max_len=32,
                             engine_id=eid, page_len=4, device=args.device,
                             **kw)

    # --- 1. prefix-affinity routing over two replicas -------------------
    router = Router([EngineReplica(engine("r0")),
                     EngineReplica(engine("r1"))],
                    policy="prefix_affinity")
    template_a = np.tile(PATTERN, 2)[:8]
    template_b = np.tile(PATTERN[::-1], 2)[:8]
    jobs, grids = [], []
    for rep in range(3):                      # templates interleaved
        for tpl in (template_a, template_b):
            jobs.append(dict(prompt=tpl, max_new_tokens=5))
            grids.append(router.submit(**jobs[-1]))
    jobs.append(dict(prompt=PATTERN[:5], max_new_tokens=6,
                     temperature=0.9, top_p=0.95, seed=5))
    grids.append(router.submit(**jobs[-1]))
    results = router.run()

    matches = 0
    for g, job in zip(grids, jobs):
        if job.get("temperature", 0.0) == 0.0:
            ref = generate(model, job["prompt"][None],
                           max_new_tokens=job["max_new_tokens"],
                           temperature=0.0)
            assert np.array_equal(results[g], ref[0]), g
            matches += 1
    print(f"{matches} routed greedy requests token-identical to "
          "generate()")
    hit_rates = {rep.name: rep.engine.metrics.prefix_hit_rate
                 for rep in router.replicas}
    print("prefix-affinity hit rates per replica:",
          {k: (None if v is None else round(v, 2))
           for k, v in hit_rates.items()})
    print("router counters:", router.counters())

    # --- 2. disaggregated prefill/decode pools --------------------------
    disagg = Router([EngineReplica(engine("pre0"), role="prefill"),
                     EngineReplica(engine("dec0"), role="decode")])
    dg = [disagg.submit(PATTERN[:4], 7), disagg.submit(PATTERN[:6], 5)]
    dres = disagg.run()
    for g, (p, n) in zip(dg, ((PATTERN[:4], 7), (PATTERN[:6], 5))):
        ref = generate(model, p[None], max_new_tokens=n,
                       temperature=0.0)
        assert np.array_equal(dres[g], ref[0]), g
        matches += 1
    print(f"prefill->decode handoff: {disagg.counters()['handoffs']} "
          "streams handed off, outputs token-identical")

    # --- 3. replica death: mass failover --------------------------------
    fleet = Router([EngineReplica(engine("f0")),
                    EngineReplica(engine("f1"))])
    fg = [fleet.submit(PATTERN[:4], 8), fleet.submit(PATTERN[:6], 8),
          fleet.submit(PATTERN[:3], 8)]
    fout = {}
    for _ in range(4):                        # streams mid-decode
        for g, req in fleet.step().items():
            fout[g] = req.tokens
    faults.inject("replica.die", nth=1)       # next fleet step kills one
    try:
        while fleet.pending:
            for g, req in fleet.step().items():
                fout[g] = req.tokens
    finally:
        faults.reset()
    for g, (p, n) in zip(fg, ((PATTERN[:4], 8), (PATTERN[:6], 8),
                              (PATTERN[:3], 8))):
        ref = generate(model, p[None], max_new_tokens=n,
                       temperature=0.0)
        assert np.array_equal(fout[g], ref[0]), g
        matches += 1
    dead = [r.name for r in fleet.replicas if r.state.value == "dead"]
    print(f"replica {dead[0]} killed mid-flight; "
          f"{fleet.counters()['failovers']} requests failed over and "
          "completed token-identically")

    # --- 4. SLO-burn drain ----------------------------------------------
    from distkeras_tpu_torch.obs.slo import ttft_p99
    from distkeras_tpu_torch.serving import (SLOBurnController,
                                             ServingMetrics)
    slow = engine("slow", slo=[ttft_p99(1e-9)])   # unmeetable budget
    fine = engine("fine")
    drained_fleet = Router([EngineReplica(slow), EngineReplica(fine)],
                           policy="least_loaded")
    ctl = SLOBurnController(drained_fleet, drain_above=2.0)
    drained_fleet.attach_controller(ctl)
    rid = drained_fleet.replica("slow").submit(PATTERN[:4], 4)
    slow.run(max_steps=500)
    actions = ctl.tick()
    print(f"SLO-burn controller: {actions} "
          "(breaching replica drained, traffic shifts to the fleet)")
    slow.metrics = ServingMetrics()              # fresh window recovers
    print(f"after recovery: {ctl.tick()}")

    print("fleet health:", drained_fleet.health()["status"])
    print("OK")
    return matches


if __name__ == "__main__":
    main()
