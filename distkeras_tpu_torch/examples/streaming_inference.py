"""Streaming inference: continuous prediction over an unbounded feed (the
port's copy of ``examples/streaming_inference.py``).

The reference's Kafka streaming example consumes records from a topic,
runs the trained model and produces predictions. The transport is any
iterator of feature batches here (a Kafka consumer loop, a socket
reader, a file tailer); ``StreamingPredictor`` runs one forward shape for
every batch, staging batch t+1 on the device while batch t computes.

Run (``--device cpu`` without a card):
    python -m distkeras_tpu_torch.examples.streaming_inference
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def feed(num_batches: int, batch_size: int, d: int, seed: int = 0):
    """Stand-in for a Kafka consumer: yields ragged feature batches."""
    rs = np.random.RandomState(seed)
    for i in range(num_batches):
        n = batch_size if i % 3 else batch_size // 2  # ragged now and then
        yield rs.randn(n, d).astype(np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args, _ = ap.parse_known_args()

    from distkeras_tpu_torch.data import Dataset
    from distkeras_tpu_torch.inference import StreamingPredictor
    from distkeras_tpu_torch.models import Dense, Model, Sequential
    from distkeras_tpu_torch.parallel import SingleTrainer

    D, C = 32, 5
    rs = np.random.RandomState(0)
    X = rs.randn(4096, D).astype(np.float32)
    y = np.argmax(X @ rs.randn(D, C), axis=1)

    model = Model.build(Sequential([Dense(64, activation="relu"),
                                    Dense(C)]), (D,), seed=0,
                        device=args.device)
    trainer = SingleTrainer(
        model, worker_optimizer="momentum",
        optimizer_kwargs={"learning_rate": 0.1},
        loss="sparse_categorical_crossentropy_from_logits",
        batch_size=256, num_epoch=3)
    trained = trainer.train(Dataset({"features": X, "label": y}))

    predictor = StreamingPredictor(trained, batch_size=256)
    t0 = time.perf_counter()
    total = 0
    for i, preds in enumerate(
            predictor.predict_stream(feed(50, 256, D))):
        total += len(preds)
        if i % 10 == 0:
            print(f"batch {i:3d}: {len(preds)} rows -> "
                  f"class histogram {np.bincount(preds.argmax(-1), minlength=5)}")
    dt = time.perf_counter() - t0
    print(f"streamed {total} rows in {dt:.2f}s "
          f"({total / dt:,.0f} rows/sec)")


if __name__ == "__main__":
    main()
