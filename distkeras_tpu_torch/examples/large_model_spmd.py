"""Training a model larger than one card: dp x tp x ep over a 3-D mesh of
processes (the port's copy of ``examples/large_model_spmd.py``).

A transformer LM with an MoE block, its parameters sharded by the rules
of ``parallel.sharding`` (Megatron column->row for attention and MLP,
the expert axis for the MoE) and trained by ``SPMDTrainer`` with the
batch sharded over the ``workers`` axis, over JAX's mesh ``{"workers":
2, "ep": 2, "tp": 2}``: an 8-process world (``parallel.launch.World``;
on a one-card machine every process shares the card).

Run (``--device cpu`` without a card):
    python -m distkeras_tpu_torch.examples.large_model_spmd
"""

from __future__ import annotations

import argparse

import numpy as np

#: JAX's mesh, one process a position
MESH = {"workers": 2, "ep": 2, "tp": 2}
#: the ranks' results of the last ``main()`` (each with its kernel
#: launch counts)
RESULTS: list = []


def train_rank(X, Y, device):
    """One rank: build the model from the seed, train it over the mesh,
    and (every rank) the losses and the first 64 rows' predictions."""
    from distkeras_tpu_torch.data import Dataset
    from distkeras_tpu_torch.models import Dense, Model, Sequential
    from distkeras_tpu_torch.models.attention import TransformerBlock
    from distkeras_tpu_torch.models.layers import Embedding
    from distkeras_tpu_torch.models.moe import MoE
    from distkeras_tpu_torch.parallel import SPMDTrainer, make_mesh_2d

    V, S, D = 64, X.shape[1], 64
    module = Sequential([
        Embedding(V, D),
        TransformerBlock(num_heads=8, mlp_ratio=2, causal=True),
        TransformerBlock(num_heads=8, causal=True,
                         mlp_layer=MoE(num_experts=4, hidden_dim=128,
                                       top_k=2)),
        Dense(V, use_bias=False),
    ])
    model = Model.build(module, (S,), seed=0, device=device)
    mesh = make_mesh_2d(MESH, device=device)
    trainer = SPMDTrainer(
        model, mesh=mesh, data_axes=("workers",), tp_axis="tp", ep_axis="ep",
        batch_size=128, num_epoch=3, worker_optimizer="adam",
        optimizer_kwargs={"learning_rate": 3e-3},
        loss="sparse_categorical_crossentropy_from_logits")
    trained = trainer.train(Dataset({"features": X, "label": Y}))
    from distkeras_tpu_torch import kernels
    return {"params": model.num_params(),
            "losses": trainer.get_history().losses(),
            "preds": trained.predict(X[:64]).argmax(-1),
            "launches": {k: n for k, n in kernels.launch_counts().items()
                         if n}}


def main(rows: int = 4096):
    """``rows``: the training sequences (JAX's 4096)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args, _ = ap.parse_known_args()

    from distkeras_tpu_torch.compat import resolve_device
    from distkeras_tpu_torch.parallel.launch import World

    device = resolve_device(args.device).type
    V, S = 64, 16
    rs = np.random.RandomState(0)
    # next-token prediction on sequences with a learnable bigram structure
    trans = rs.permutation(V)
    X = rs.randint(0, V, (rows, S))
    Y = trans[X]  # label = fixed permutation of the current token

    ranks = int(np.prod(list(MESH.values())))
    with World(ranks, timeout=600) as world:
        res = world.run(train_rank, X, Y, device)
    RESULTS[:] = res
    head = res[0]
    print(f"model: {head['params']:,} params")
    losses = head["losses"]
    print(f"loss: {losses[:3].mean():.3f} -> {losses[-3:].mean():.3f}")
    acc = float((head["preds"] == Y[:64]).mean())
    print(f"next-token accuracy: {acc:.3f}")
    return acc


if __name__ == "__main__":
    main()
