"""ViT classification with callbacks + out-of-core shards (the port's copy
of ``examples/vit_finetune_callbacks.py``).

A Vision Transformer from the zoo, trained from an out-of-core
``ShardedDataset`` (npz shards on disk, loaded one at a time with
background prefetch) under a callback stack:

  * ``EarlyStopping(monitor="val_accuracy", restore_best_weights=True)``
  * ``ModelCheckpoint`` exporting the best serving model per improvement
  * ``CSVLogger`` appending one row per epoch

The "images" are a synthetic shape-vs-texture problem the tiny ViT can
learn: class = whether the dominant horizontal frequency is low or high.
On the card its attention is K1f, K1dq and K1dkv without the causal
mask (head dim 8).

Run (``--device cpu`` without a card):
    python -m distkeras_tpu_torch.examples.vit_finetune_callbacks
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

def make_freq_images(n: int, size: int = 16, seed: int = 0):
    """Class 0: low-frequency stripes; class 1: high-frequency stripes."""
    rs = np.random.RandomState(seed)
    y = rs.randint(0, 2, n)
    xs = np.arange(size, dtype=np.float32)
    freq = np.where(y == 0, 1.0, 4.0) * 2 * np.pi / size
    phase = rs.rand(n, 1) * 2 * np.pi
    stripes = np.sin(freq[:, None] * xs[None, :] + phase)  # [n, size]
    img = np.repeat(stripes[:, None, :], size, axis=1)     # [n, size, size]
    img = img[..., None] + 0.3 * rs.randn(n, size, size, 1)
    return np.repeat(img, 3, axis=-1).astype(np.float32), y


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args, _ = ap.parse_known_args()

    from distkeras_tpu_torch.data import Dataset, ShardedDataset
    from distkeras_tpu_torch.models import Model, zoo
    from distkeras_tpu_torch.models.serialization import load_model
    from distkeras_tpu_torch.utils import (CSVLogger, EarlyStopping,
                                           ModelCheckpoint)

    SIZE, N, SHARDS = 16, 4096, 4
    X, y = make_freq_images(N, SIZE)
    Xv, yv = make_freq_images(512, SIZE, seed=1)

    workdir = tempfile.mkdtemp(prefix="vit_example_")
    sds = ShardedDataset.write(Dataset({"features": X, "label": y}),
                               workdir, num_shards=SHARDS, prefix="train")

    model = Model.build(
        zoo.vit(image_size=SIZE, patch_size=4, d_model=32, num_heads=4,
                num_layers=2, mlp_ratio=2, num_classes=2),
        (SIZE, SIZE, 3), seed=0, device=args.device)

    ckpt = os.path.join(workdir, "best.dkt")
    hist = model.fit(
        sds, optimizer="adamw", learning_rate=3e-3, batch_size=64,
        epochs=12, metrics=["accuracy"], validation_data=(Xv, yv),
        loss="sparse_categorical_crossentropy_from_logits",
        clip_grad_norm=1.0,
        callbacks=[
            EarlyStopping(monitor="val_accuracy", patience=4,
                          restore_best_weights=True),
            ModelCheckpoint(ckpt, monitor="val_accuracy",
                            save_best_only=True),
            CSVLogger(os.path.join(workdir, "train_log.csv")),
        ])

    acc = float((model.predict(Xv).argmax(-1) == yv).mean())
    best = load_model(ckpt, device=args.device)
    best_acc = float((best.predict(Xv).argmax(-1) == yv).mean())
    print(f"val accuracy: {acc:.3f} (restored best); "
          f"checkpoint file: {best_acc:.3f}; "
          f"{len(hist.epochs)} epochs logged over {SHARDS} shards")
    return acc


if __name__ == "__main__":
    main()
