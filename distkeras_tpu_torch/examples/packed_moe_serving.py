"""Packed-sequence training of a dispatched-MoE LM with sliding-window
attention, then quantized serving (the port's copy of
``examples/packed_moe_serving.py``).

1. **Packed/variable-length sequences** -- several short documents packed
   per row with ``segment_ids``; attention never crosses a document
   boundary (K1f, K1dq and K1dkv with the ids on the card) and padding
   positions carry label -1 for the masked LM loss.
2. **Dispatched MoE** -- ``dispatch="tokens"``: per-token expert FLOPs are
   ``top_k x capacity_factor`` MLPs instead of all ``num_experts`` (the
   capacity plan's scatter, stacked expert MLP and gather combine).
3. **Sliding-window attention** -- ``attn_window`` bounds each query's
   reach (the kernels skip the key blocks a window cannot see).
4. **Serving dtype levers** -- greedy ``generate()`` with the bf16 cache +
   pre-cast weights defaults (K2), then ``weights_dtype="int8"``
   weight-only quantized serving (K5).

Run (``--device cpu`` without a card):
    python -m distkeras_tpu_torch.examples.packed_moe_serving
"""

from __future__ import annotations

import argparse

import numpy as np

#: training steps of the packed MoE LM
STEPS = 150


def make_packed_copy_task(n_rows: int = 48, seq: int = 24, vocab: int = 24,
                          seed: int = 0):
    """Rows pack two short 'documents' plus padding. The task is a copy
    LM (predict the current token), trivially learnable -- the point is
    the packing plumbing, not the modeling."""
    rs = np.random.RandomState(seed)
    X = np.zeros((n_rows, seq), np.int32)
    seg = np.full((n_rows, seq), -1, np.int32)
    labels = np.full((n_rows, seq), -1, np.int32)
    for i in range(n_rows):
        a = rs.randint(6, 12)                  # doc A length
        b = rs.randint(6, seq - a - 1)         # doc B length
        X[i, :a] = rs.randint(1, vocab, a)
        X[i, a:a + b] = rs.randint(1, vocab, b)
        seg[i, :a] = 0
        seg[i, a:a + b] = 1
        labels[i, :a + b] = X[i, :a + b]       # copy task; pad = -1
    return X, seg, labels


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args, _ = ap.parse_known_args()

    import torch

    from distkeras_tpu_torch.models import Model, zoo
    from distkeras_tpu_torch.models.decoding import generate
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.optimizers import (apply_updates,
                                                    get_optimizer)
    from distkeras_tpu_torch.utils.tree import tree_leaves, tree_unflatten

    vocab, seq = 24, 24
    X, seg, labels = make_packed_copy_task(seq=seq, vocab=vocab)

    # capacity_factor = num_experts / top_k (= 4/2) makes expert capacity
    # equal the token count: provably drop-free dispatch, which keeps the
    # cross-document isolation check below exact. dtype='bfloat16' makes
    # the serving levers (bf16 cache + pre-cast weights) engage in
    # generate() below.
    model = Model.build(
        zoo.transformer_lm(vocab, d_model=48, num_heads=4, num_layers=2,
                           mlp_ratio=2, attn_window=8, dtype="bfloat16",
                           moe_every=2, num_experts=4,
                           moe_dispatch="tokens",
                           moe_capacity_factor=2.0,
                           moe_aux_loss_weight=0.01),
        (seq,), seed=0, device=args.device)
    loss_fn = get_loss("masked_sparse_categorical_crossentropy_from_logits")
    opt = get_optimizer("adam", learning_rate=5e-3)

    dev = model.device
    params = model.params
    opt_state = opt.init(params)
    xt, st, yt = (torch.from_numpy(a).to(dev) for a in (X, seg, labels))

    model.module.train()
    first = None
    for _ in range(STEPS):
        loss = loss_fn(yt, model.module.apply(params, xt, segment_ids=st))
        grads = torch.autograd.grad(loss, tree_leaves(params))
        with torch.no_grad():
            upd, opt_state = opt.update(tree_unflatten(params, grads),
                                        opt_state, params)
            apply_updates(params, upd)
        if first is None:
            first = float(loss.detach())
    model.module.eval()
    last = float(loss.detach())
    print(f"packed MoE-SWA LM: masked loss {first:.3f} -> {last:.3f}")
    assert last < 0.5 * first, "packed training failed to converge"

    # cross-segment isolation spot-check: perturb doc A, doc B's logits
    # must not move (causality alone could not guarantee this direction)
    row = X[:1].copy()
    a_len = int((seg[0] == 0).sum())
    b_span = seg[0] == 1
    row2 = row.copy()
    row2[0, :a_len] = (row[0, :a_len] % (vocab - 1)) + 1
    with torch.no_grad():
        out1, out2 = (model.module.apply(params, torch.from_numpy(r).to(dev),
                                         segment_ids=st[:1]).float().cpu()
                      .numpy() for r in (row, row2))
    leak = float(np.abs(out1[0, b_span] - out2[0, b_span]).max())
    print(f"cross-document logit leak after perturbing doc A: {leak}")
    assert leak == 0.0

    # serving: greedy continuation, full precision vs int8 weights
    prompts = X[:2, :4].astype(np.int32)
    out_bf = generate(model, prompts, max_new_tokens=8)
    out_i8 = generate(model, prompts, max_new_tokens=8,
                      weights_dtype="int8")
    agree = float((out_bf == out_i8).mean())
    print(f"int8 vs full-precision greedy agreement: {agree:.2f}")
    assert out_bf.shape == (2, 12) and agree > 0.6
    print("OK")


if __name__ == "__main__":
    main()
