"""MoE-native serving tour: dispatched expert decode through the
continuous-batching engine, with the expert-load telemetry (the port's
copy of ``examples/moe_serving.py``).

1. **Drop-free dispatched decode** -- the engine runs MoE blocks through
   ``MoE.decode_apply`` (capacity = the slot-token batch, so routing can
   never drop; K6a on the card): every greedy request is token-identical
   to the dense-routing ``generate()`` oracle.
2. **Dispatched vs dense-routing speed** -- the same model served by a
   ``moe_decode="dense"`` engine, same requests, marginal decode tok/s
   compared.
3. **Expert-load telemetry** -- per-expert load + router-entropy gauges,
   the smoothed routing concentration the paged admission consults, the
   ``moe_route`` tracer event on the decode cadence, and ``health()``'s
   moe block.
4. **Expert-parallel decode** (``ep_mesh``) needs a mesh of devices,
   which waits for ROADMAP Queue 1 item 10: the one-card port prints the
   JAX example's single-device line.

Run (``--device cpu`` without a card):
    python -m distkeras_tpu_torch.examples.moe_serving
"""

from __future__ import annotations

import argparse
import time

import numpy as np

V, S = 29, 12
PATTERN = np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8])


def build_moe_lm(device):
    from distkeras_tpu_torch.models import Model, zoo
    # hid = 4*d so the expert MLPs dominate the decode step -- the
    # regime the dispatch exists for
    return Model.build(
        zoo.transformer_lm(V, d_model=128, num_heads=4, num_layers=2,
                           mlp_ratio=4, use_rope=True, moe_every=1,
                           num_experts=8),
        (S,), seed=2, device=device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args, _ = ap.parse_known_args()

    from distkeras_tpu_torch.models.decoding import generate
    from distkeras_tpu_torch.serving import ServingEngine, ServingMetrics

    # memorize one repeating sequence: greedy margins are huge, so the
    # oracle comparisons are robust
    X = np.tile(PATTERN, (256, 1))
    model = build_moe_lm(args.device)
    model.fit(X[:, :-1], X[:, 1:], optimizer="adam", learning_rate=5e-3,
              batch_size=64, epochs=20,
              loss="sparse_categorical_crossentropy_from_logits")

    prompts = [PATTERN[:4], PATTERN[:6], PATTERN[:3], PATTERN[:5]]
    budgets = [8, 6, 9, 7]

    def drive(engine):
        engine.metrics = ServingMetrics()
        rids = [engine.submit(p, b) for p, b in zip(prompts, budgets)]
        t0 = time.perf_counter()
        out = engine.run(max_steps=2000)
        return rids, out, time.perf_counter() - t0

    # 1) dispatched MoE decode: the engine default
    eng = ServingEngine(model, num_slots=2, max_len=32, device=args.device)
    rids, out, _ = drive(eng)          # warm + oracle check
    rids, out, _ = drive(eng)
    matches = 0
    for rid, p, b in zip(rids, prompts, budgets):
        ref = generate(model, p[None], max_new_tokens=b, temperature=0.0)
        assert np.array_equal(out[rid], ref[0]), (out[rid], ref[0])
        matches += 1
    print(f"{matches} requests token-identical to generate() "
          "(drop-free dispatched decode)")

    # 2) dispatched vs dense-routing marginal decode rate
    dense = ServingEngine(model, num_slots=2, max_len=32,
                          moe_decode="dense", device=args.device)
    drive(dense)                        # warm
    _, _, _ = drive(eng)
    rate_disp = eng.metrics.decode_tokens_per_sec()
    _, _, _ = drive(dense)
    rate_dense = dense.metrics.decode_tokens_per_sec()
    print(f"dispatched {rate_disp:.1f} tok/s vs dense-routing "
          f"{rate_dense:.1f} tok/s ({rate_disp / rate_dense:.2f}x)")

    # 3) the expert-load telemetry tour
    moe = eng.metrics.summary()["moe"]
    load = moe["expert_load"]
    print(f"expert_load: {[round(v, 1) for v in load]} "
          f"(router_entropy {moe['router_entropy']:.3f} nats, "
          f"concentration {moe['concentration']:.3f})")
    routes = [ev for tl in eng.tracer.timelines() for ev in tl.events
              if ev["name"] == "moe_route"]
    assert routes, "moe_route event missing from every timeline"
    print(f"moe_route events on the decode cadence: {routes[0]}")
    health = eng.health()
    print(f"health moe block: {health['moe']}")

    # 4) expert-parallel decode needs a mesh (ROADMAP Queue 1 item 10);
    # the engine's ep_mesh= raises NotImplementedError naming it
    print("expert-parallel decode skipped (single-device backend); "
          "ep_mesh waits for ROADMAP Queue 1 item 10")

    print("OK")
    return matches


if __name__ == "__main__":
    main()
