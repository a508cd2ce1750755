"""Speculative decoding on the continuous-batching engine (the port's copy
of ``examples/speculative_serving.py``).

Decode is memory-bandwidth-bound: every iteration moves all the weights
plus the KV pages to emit one token per slot. Speculative decoding
amortizes one target pass over k drafted tokens; this example walks the
whole lifecycle on a tiny memorized LM:

  1. serve a bursty trace twice through one engine -- speculation on vs
     off, same requests -- and compare decode iterations (the memorized
     model's continuations repeat, so n-gram self-drafting wins);
  2. prove the correctness contract: every greedy speculative result is
     token-identical to a standalone ``generate()`` call (the verify
     windows run K3 on the card);
  3. feed an adversarial stream (a draft that can never match) and
     watch the per-request acceptance EMA kick it back to plain decode
     mid-flight;
  4. read the speculation telemetry: acceptance counters + percentiles
     in ``ServingMetrics.summary()``, per-request ``spec_verify``
     events on the tracer timelines.

``drive`` keeps the requests that ``engine.step()`` returns finished as
well as ``run()``'s: a request whose budget runs out inside the first
steps finishes there (the JAX example keeps only ``run()``'s).

Run (``--device cpu`` without a card):
    python -m distkeras_tpu_torch.examples.speculative_serving
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
    from distkeras_tpu_torch.serving import (DraftSource, NgramDraft,
                                             ServingEngine, ServingMetrics)

    V, S = 29, 12
    model = Model.build(
        zoo.transformer_lm(V, d_model=32, num_heads=4, num_layers=2,
                           mlp_ratio=2, use_rope=True), (S,), seed=2,
        device=args.device)
    X = np.tile(PATTERN, (256, 1))
    model.fit(X[:, :-1], X[:, 1:], optimizer="adam", learning_rate=5e-3,
              batch_size=64, epochs=30,
              loss="sparse_categorical_crossentropy_from_logits")

    engine = ServingEngine(model, num_slots=3, max_len=48,
                           draft=NgramDraft(), spec_k=3, spec_warmup=4,
                           device=args.device)

    # -- 1. the same bursty trace, speculation on vs off ------------------
    prompts = [np.tile(PATTERN, 2)[:n] for n in (10, 14, 6, 13, 8)]
    budgets = [12, 9, 14, 10, 11]

    def drive(speculate):
        engine.metrics = ServingMetrics()
        rids = [engine.submit(p, b, speculate=speculate)
                for p, b in zip(prompts[:3], budgets[:3])]
        out = {}
        for _ in range(4):                      # burst 2 lands mid-flight
            for r in engine.step():
                out[r.rid] = r.tokens
        rids += [engine.submit(p, b, speculate=speculate)
                 for p, b in zip(prompts[3:], budgets[3:])]
        out.update(engine.run(max_steps=2000))
        return rids, out, engine.metrics

    _, _, m_off = drive(speculate=False)
    rids, out, m_on = drive(speculate=True)
    s_on, s_off = m_on.summary(), m_off.summary()
    tok_iter_on = s_on["tokens_generated"] / max(
        1, sum(1 for _ in m_on.decode_samples))
    print(f"plain decode : {s_off['tokens_generated']} tokens in "
          f"{len(m_off.decode_samples)} decode iterations")
    print(f"speculative  : {s_on['tokens_generated']} tokens in "
          f"{len(m_on.decode_samples)} decode iterations "
          f"({tok_iter_on:.2f} tokens/iteration)")
    print(f"acceptance   : {s_on['acceptance_rate']:.2f} "
          f"({s_on['speculation']['accepted']}/"
          f"{s_on['speculation']['proposed']} drafts accepted; "
          f"per-slot p50/p99 = "
          f"{s_on['speculation']['accept_rate']['p50']:.2f}/"
          f"{s_on['speculation']['accept_rate']['p99']:.2f})")
    assert len(m_on.decode_samples) < len(m_off.decode_samples)

    # -- 2. the correctness contract --------------------------------------
    matches = 0
    for rid, p, b in zip(rids, prompts, budgets):
        ref = generate(model, p[None], max_new_tokens=b, temperature=0.0)
        np.testing.assert_array_equal(out[rid], ref[0])
        matches += 1
    print(f"{matches} speculative results token-identical to generate()")

    # -- 3. adversarial stream: the acceptance EMA kicks it back ----------
    class WrongDraft(DraftSource):
        """Proposes token 0, which the memorized model never emits."""

        def propose(self, requests, tok, t, out, active):
            out[:] = 0

    adversarial = ServingEngine(model, num_slots=1, max_len=64,
                                draft=WrongDraft(), spec_k=2,
                                spec_warmup=4, device=args.device)
    rid = adversarial.submit(np.tile(PATTERN, 2)[:8], 20)
    done = {}
    while adversarial.scheduler.pending:
        for r in adversarial.step():
            done[r.rid] = r
    req = done[rid]
    sa = adversarial.metrics.summary()
    assert req.spec_disabled
    print(f"adversarial stream: acceptance EMA {req.spec_ema:.2f} after "
          f"{req.spec_checks} verifies -> kicked back to plain decode "
          f"(proposals stopped at {sa['speculation']['proposed']}, "
          f"output still exact)")
    np.testing.assert_array_equal(
        req.tokens,
        generate(model, np.tile(PATTERN, 2)[None, :8], 20,
                 temperature=0.0)[0])

    # -- 4. per-request speculation telemetry -----------------------------
    tl = engine.tracer.timelines()[-1]
    ev = [e["name"] for e in tl.events]
    print(f"timeline rid={tl.rid}: events {ev[:6]}... "
          f"spec {tl.spec_accepted}/{tl.spec_proposed} accepted")
    return matches


if __name__ == "__main__":
    main()
