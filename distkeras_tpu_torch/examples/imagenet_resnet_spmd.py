"""ResNet/ImageNet-style training over a world of processes (the port's
copy of ``examples/imagenet_resnet_spmd.py``, BASELINE config 3).

The complete recipe: a ResNet from the zoo, cosine-with-warmup schedule,
data-parallel (+ optional ZeRO/FSDP) sharding through ``SPMDTrainer``
over a ``workers`` axis of every rank of the world, gradient
accumulation, checkpointing and per-epoch validation, on synthetic
ImageNet-shaped data. BatchNorm's moments are the global batch's. The
world has ``--ranks`` processes (``parallel.launch.World``; on a
one-card machine every process shares the card), as JAX's script takes
every device.

Run (``--device cpu`` without a card):
    python -m distkeras_tpu_torch.examples.imagenet_resnet_spmd
"""

from __future__ import annotations

import argparse

import numpy as np

#: the ranks' results of the last ``main()`` (each with its kernel
#: launch counts)
RESULTS: list = []


def synthetic_imagenet(n, image_size, classes, seed=0):
    """Class-conditional blob images: learnable, ImageNet-shaped."""
    rs = np.random.RandomState(seed)
    protos = rs.rand(classes, 8, 8, 3).astype(np.float32)
    y = rs.randint(0, classes, n)
    small = protos[y] + 0.15 * rs.randn(n, 8, 8, 3).astype(np.float32)
    reps = image_size // 8
    X = np.clip(np.tile(small, (1, reps, reps, 1)), 0.0, 1.0)
    return X, y


def train_rank(args, device):
    """One rank: the trainer over a ``workers`` axis of the whole world;
    returns the history's validation accuracy and steps a second."""
    from distkeras_tpu_torch.data import Dataset
    from distkeras_tpu_torch.models import Model, zoo
    from distkeras_tpu_torch.ops import schedules
    from distkeras_tpu_torch.parallel import SPMDTrainer, make_mesh_2d
    from distkeras_tpu_torch.parallel.mesh import world_size

    X, y = synthetic_imagenet(args.n, args.image_size, args.classes)
    n_val = max(args.batch, args.n // 10)
    ds = Dataset({"features": X[n_val:], "label": y[n_val:]})
    val = Dataset({"features": X[:n_val], "label": y[:n_val]})

    if args.variant == "resnet50":
        module = zoo.resnet50(num_classes=args.classes, dtype="bfloat16")
    else:
        module = zoo.resnet18_thin(num_classes=args.classes, width=16)
    model = Model.build(module, (args.image_size, args.image_size, 3),
                        seed=0, device=device)

    steps_per_epoch = len(ds["features"]) // args.batch
    mesh = make_mesh_2d({"workers": world_size()}, device=device)
    trainer = SPMDTrainer(
        model, mesh=mesh, data_axes=("workers",), tp_axis=None,
        fsdp_axis="workers" if args.fsdp else None,
        batch_size=args.batch, num_epoch=args.epochs,
        grad_accum_steps=args.accum,
        worker_optimizer="momentum",
        optimizer_kwargs={"learning_rate": schedules.cosine_decay(
            0.1, steps_per_epoch * args.epochs,
            warmup_steps=steps_per_epoch)},
        loss="sparse_categorical_crossentropy_from_logits",
        metrics=["accuracy"], validation_data=val,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_async=args.checkpoint_dir is not None)
    trainer.train(ds)
    h = trainer.get_history()
    from distkeras_tpu_torch import kernels
    return {"params": model.num_params(), "steps_s": h.steps_per_second(),
            "val": h.metric("val_accuracy"),
            "launches": {k: n for k, n in kernels.launch_counts().items()
                         if n}}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="resnet18_thin",
                    choices=["resnet18_thin", "resnet50"])
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--fsdp", action="store_true",
                    help="ZeRO-shard large kernels over the data axis")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--ranks", type=int, default=4,
                    help="processes of the world (one a mesh position)")
    ap.add_argument("--device", default="cuda")
    args, _ = ap.parse_known_args()

    from distkeras_tpu_torch.compat import resolve_device
    from distkeras_tpu_torch.parallel.launch import World

    device = resolve_device(args.device).type
    with World(args.ranks, timeout=900) as world:
        res = world.run(train_rank, args, device)
    RESULTS[:] = res
    head = res[0]
    print(f"{args.variant}: {head['params']:,} params on {args.ranks} "
          "processes")
    va = head["val"]
    print(f"steps/sec {head['steps_s']:.2f}; "
          f"val accuracy per epoch: {np.round(va, 3).tolist()}")
    return float(va[-1])


if __name__ == "__main__":
    main()
