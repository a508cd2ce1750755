"""Long-context serving end to end (the port's copy of
``examples/long_context_serving.py``).

1. **Batched prefill**: the prompt is ingested by one causal pass per
   layer (K1f on the card), then decoded from the KV cache (K2).
2. **int8 KV cache**: ``cache_dtype="int8"`` stores quantized payloads
   with per-token-per-head scales; greedy outputs are compared token for
   token against the float cache. Chunked prefill (``prefill_chunk``)
   gives the same greedy tokens.
3. **GQA**: ``num_kv_heads < num_heads`` shrinks the cache by the group
   factor.
4. **Sequence parallelism**: ring attention over an ``sp`` mesh axis of
   a 4-process world (``parallel.launch.World``; every process shares
   the card), with packed-sequence ``segment_ids`` travelling with the
   K/V shards, held against the dense attention layer.

Run (``--device cpu`` without a card):
    python -m distkeras_tpu_torch.examples.long_context_serving
"""

from __future__ import annotations

import argparse

import numpy as np

#: the ranks of part 4's world
SP_RANKS = 4


def ring_part(x, seg, device):
    """One rank of part 4: the ring layer over this rank's shard of
    ``x`` and the ids, gathered back; rank 0 also returns the max error
    against the dense layer on the whole sequence."""
    import torch

    from distkeras_tpu_torch.models import Model, Sequential
    from distkeras_tpu_torch.models.attention import MultiHeadAttention
    from distkeras_tpu_torch.parallel import collectives
    from distkeras_tpu_torch.parallel.mesh import make_mesh

    s, d = x.shape[1], x.shape[2]
    ring = Model.build(Sequential([MultiHeadAttention(
        num_heads=2, attn_impl="ring", seq_axis_name="sp", use_rope=True)]),
        (s, d), seed=0, device=device)
    oracle = Model.build(Sequential([MultiHeadAttention(
        num_heads=2, attn_impl="xla", use_rope=True)]), (s, d), seed=0,
        device=device)
    xt = torch.from_numpy(x).to(device)
    st = torch.from_numpy(seg).to(device)
    mesh = make_mesh(SP_RANKS, "sp", device=device)
    with mesh, torch.no_grad():
        i, n = mesh.axis_index("sp"), mesh.axis_size("sp")
        blk = slice(i * s // n, (i + 1) * s // n)
        y = ring.module.apply(ring.params, xt[:, blk],
                              segment_ids=st[:, blk])
        y = collectives.all_gather(y, "sp", axis=1, tiled=True)
        y_ref = oracle.module.apply(oracle.params, xt, segment_ids=st)
    return float((y - y_ref).abs().max())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args, _ = ap.parse_known_args()

    from distkeras_tpu_torch.models import Model, zoo
    from distkeras_tpu_torch.parallel.launch import World

    vocab, train_seq = 32, 64
    # GQA model: 4 query heads sharing 2 KV heads -> cache is half size
    model = Model.build(
        zoo.transformer_lm(vocab, d_model=32, num_heads=4, num_kv_heads=2,
                           num_layers=2, mlp_ratio=2, use_rope=True),
        (train_seq,), seed=0, device=args.device)

    # teach it a periodic pattern so greedy continuations are checkable
    pattern = np.array([3, 1, 4, 1, 5, 9, 2, 6])
    X = np.tile(pattern, (128, train_seq // len(pattern) + 1))[:,
                                                               :train_seq + 1]
    model.fit(X[:, :-1], X[:, 1:], optimizer="adam", learning_rate=5e-3,
              batch_size=32, epochs=8,
              loss="sparse_categorical_crossentropy_from_logits")

    # --- serving: long prompt through the batched prefill ---------------
    p_len = 48
    prompts = np.tile(pattern, (2, p_len // len(pattern)))[:, :p_len]
    out_bf = model.generate(prompts, 16, temperature=0.0)
    out_i8 = model.generate(prompts, 16, temperature=0.0,
                            cache_dtype="int8")
    want = np.tile(pattern, p_len // len(pattern) + 3)[:p_len + 16]
    acc = float((np.asarray(out_bf[0]) == want).mean())
    print(f"prefill+decode continues the pattern: acc {acc:.2f}")
    assert acc > 0.9, out_bf[0]
    match = float((np.asarray(out_bf) == np.asarray(out_i8)).mean())
    print(f"int8 KV cache greedy match vs bf16: {match:.2f}")
    assert match >= 0.95, match

    # chunked prefill: the same greedy tokens, O(chunk) prefill memory
    out_ck = model.generate(prompts, 16, temperature=0.0, prefill_chunk=16)
    ck_match = float((np.asarray(out_bf) == np.asarray(out_ck)).mean())
    print(f"chunked prefill greedy match vs one-pass: {ck_match:.2f}")
    assert ck_match >= 0.95, ck_match

    # --- the attention layer under sequence-parallel ring attention -----
    s = 8 * SP_RANKS
    rs = np.random.RandomState(0)
    x = rs.randn(2, s, 16).astype(np.float32)
    seg = np.sort(rs.randint(0, 3, (2, s)), axis=1).astype(np.int32)
    with World(SP_RANKS) as world:
        errs = world.run(ring_part, x, seg, args.device)
    err = max(errs)
    print(f"ring attention + packed segment_ids over {SP_RANKS} processes: "
          f"max err vs dense oracle {err:.2e}")
    assert err < 1e-4
    print("OK")
    return err


if __name__ == "__main__":
    main()
