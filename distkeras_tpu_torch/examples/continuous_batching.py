"""Continuous-batching LM serving: requests trickle in, slots recycle (the
port's copy of ``examples/continuous_batching.py``).

An open-loop client submits requests with different prompts, budgets,
sampling settings and stop tokens while the engine keeps one per-slot
decode step running over its paged KV pool: no request waits for a
neighbour to finish, long prompts ingest chunk by chunk between decode
iterations, and a request that hits its stop token frees its slot at
once for the next arrival. On the card the prefill runs K1f, the decode
K3, the sampled request K4 and K7.

Run (``--device cpu`` without a card):
    python -m distkeras_tpu_torch.examples.continuous_batching
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
    from distkeras_tpu_torch.serving import ServingEngine

    # a tiny LM overfit on one repeating sequence, so greedy rollouts
    # are predictable enough to verify against generate()
    V, S = 29, 12
    X = np.tile(PATTERN, (256, 1))
    model = Model.build(
        zoo.transformer_lm(V, d_model=32, num_heads=4, num_layers=2,
                           mlp_ratio=2, use_rope=True), (S,), seed=2,
        device=args.device)
    model.fit(X[:, :-1], X[:, 1:], optimizer="adam", learning_rate=5e-3,
              batch_size=64, epochs=30,
              loss="sparse_categorical_crossentropy_from_logits")

    engine = ServingEngine(model, num_slots=3, max_len=48, prefill_chunk=4,
                           device=args.device)

    # a burst of heterogeneous requests: mixed prompt lengths and
    # budgets, one greedy, one sampled, one stopping early on token 9
    jobs = [
        dict(prompt=PATTERN[:4], max_new_tokens=8),
        dict(prompt=PATTERN[:6], max_new_tokens=6, temperature=0.8,
             top_k=4, seed=7),
        dict(prompt=np.tile(PATTERN, 2)[:17], max_new_tokens=5),
        dict(prompt=PATTERN[:3], max_new_tokens=9, stop_token=9),
        dict(prompt=PATTERN[:5], max_new_tokens=7),
    ]
    rids = {}
    # staggered arrivals: two up front, the rest while decoding runs
    for j in jobs[:2]:
        rids[engine.submit(**j)] = j
    for _ in range(3):
        engine.step()
    for j in jobs[2:]:
        rids[engine.submit(**j)] = j

    results = engine.run()
    for rid in sorted(results):
        job = rids[rid]
        print(f"request {rid}: prompt {len(job['prompt'])} tok -> "
              f"{results[rid].tolist()}")

    m = engine.metrics.summary()
    print(f"served {m['requests_finished']} requests, "
          f"{m['tokens_generated']} tokens; "
          f"ttft p50 {m['ttft_s']['p50'] * 1e3:.0f} ms, "
          f"latency p50 {m['latency_s']['p50'] * 1e3:.0f} ms, "
          f"mean occupancy {m['slot_occupancy']['mean']:.2f}, "
          f"max queue depth {m['queue_depth']['max']}")

    # the oracle property: the greedy requests match standalone
    # generate() token for token
    matches = 0
    for rid, job in rids.items():
        if job.get("temperature", 0.0) == 0.0 \
                and "stop_token" not in job:
            ref = generate(model, job["prompt"][None],
                           max_new_tokens=job["max_new_tokens"],
                           temperature=0.0, prefill_chunk=4)
            assert np.array_equal(results[rid], ref[0]), rid
            matches += 1
    print(f"{matches} greedy requests token-identical to generate()")
    return matches


if __name__ == "__main__":
    main()
