"""Tiny language model lifecycle: train -> generate -> quantize -> ship (the
port's copy of ``examples/lm_generate.py``).

  1. train a small decoder-only transformer (``zoo.transformer_lm``) on a
     synthetic arithmetic-sequence language ("count by k mod vocab") with
     ``model.fit`` (K1f, K1dq and K1dkv on the card);
  2. continue held-out prompts with greedy KV-cache ``generate()`` (K2)
     and score exact-match continuation accuracy;
  3. quantize the weights to int8 (``quantize_model``) and show the serving
     predictions agree; continue the same prompts with int8 weights
     (``generate(weights_dtype="int8")``, K5);
  4. ``save_model(..., quantize=True)`` and reload for serving.

Run (``--device cpu`` without a card):
    python -m distkeras_tpu_torch.examples.lm_generate
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

VOCAB, SEQ = 32, 12


def make_count_sequences(n: int, seed: int = 0):
    """Rows count upward by a per-row stride k in 1..4 (mod VOCAB): the
    next token is fully determined by (current token, stride), and the
    stride is inferable from any two neighbors -- learnable by a tiny LM."""
    rs = np.random.RandomState(seed)
    start = rs.randint(0, VOCAB, n)
    stride = rs.randint(1, 5, n)
    steps = np.arange(SEQ)
    return (start[:, None] + stride[:, None] * steps[None, :]) % VOCAB


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args, _ = ap.parse_known_args()

    from distkeras_tpu_torch.models import Model, load_model, save_model, zoo
    from distkeras_tpu_torch.models.quantize import quantize_model

    X = make_count_sequences(4096)
    model = Model.build(
        zoo.transformer_lm(VOCAB, d_model=64, num_heads=4, num_layers=2,
                           mlp_ratio=2),
        (SEQ - 1,), seed=0, device=args.device)
    model.fit(X[:, :-1], X[:, 1:], optimizer="adam", learning_rate=3e-3,
              batch_size=128, epochs=15,
              loss="sparse_categorical_crossentropy_from_logits")

    # held-out prompts: first 4 tokens fix (start, stride); the model must
    # continue the count exactly
    Xv = make_count_sequences(64, seed=1)
    out = model.generate(Xv[:, :4], max_new_tokens=SEQ - 4,
                         temperature=0.0)
    acc = float((out[:, 4:] == Xv[:, 4:]).mean())

    qm = quantize_model(model)
    out_q = qm.predict(Xv[:, :-1])
    agree = float((out_q.argmax(-1) ==
                   model.predict(Xv[:, :-1]).argmax(-1)).mean())
    out_i8 = model.generate(Xv[:, :4], max_new_tokens=SEQ - 4,
                            temperature=0.0, weights_dtype="int8")
    acc_i8 = float((out_i8[:, 4:] == Xv[:, 4:]).mean())

    workdir = tempfile.mkdtemp(prefix="lm_example_")
    path = os.path.join(workdir, "lm.dkt")
    save_model(model, path, quantize=True)
    served = load_model(path, keep_quantized=True, device=args.device)
    out_s = served.predict(Xv[:1, :-1])

    print(f"continuation exact-match: {acc:.3f}; "
          f"int8 vs f32 argmax agreement: {agree:.3f}; "
          f"served logits shape {out_s.shape}")
    print(f"int8-weight generate() exact-match: {acc_i8:.3f}")
    return acc


if __name__ == "__main__":
    main()
