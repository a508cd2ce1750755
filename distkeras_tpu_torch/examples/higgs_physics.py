"""HIGGS-style physics classification with AEASGD, the reference's
ATLAS-Higgs workflow (the port's copy of ``examples/higgs_physics.py``).

Binary signal-against-background classification over tabular detector
features: ingest, StandardScaler-style normalization fitted on the
training split, a deep tanh MLP trained by AEASGD, then the Predictor ->
LabelIndex -> Evaluator chain. With no network, the script makes a
HIGGS-shaped problem (28 features: 21 low-level measurements and 7
derived invariant-mass-style combinations, the UCI HIGGS layout) whose
classes overlap, so accuracy stays below 1.0.

Run (``--device cpu`` without a card):
    python -m distkeras_tpu_torch.examples.higgs_physics
"""

from __future__ import annotations

import argparse

import numpy as np


def make_synthetic_higgs(n: int = 16384, seed: int = 0):
    rs = np.random.RandomState(seed)
    low = rs.randn(n, 21).astype(np.float32)  # "detector" measurements
    # derived features: pairwise nonlinear combinations (invariant-mass
    # style), scaled differently so normalization matters
    derived = np.stack([
        np.sqrt(np.abs(low[:, 0] * low[:, 1])) * 10.0,
        (low[:, 2] ** 2 + low[:, 3] ** 2) * 5.0,
        np.tanh(low[:, 4] + low[:, 5]) * 3.0,
        np.abs(low[:, 6] - low[:, 7]) * 7.0,
        (low[:, 8] * low[:, 9] * low[:, 10]) * 2.0,
        np.log1p(np.abs(low[:, 11] * low[:, 12])) * 8.0,
        (low[:, 13] + low[:, 14] + low[:, 15]) * 4.0,
    ], axis=1).astype(np.float32)
    h = (derived[:, 0] - derived[:, 1] + derived[:, 3]
         + 2.0 * np.tanh(derived[:, 5]) + 1.2 * rs.randn(n))
    y = (h > np.median(h)).astype(np.int64)
    return np.concatenate([low, derived], axis=1), y


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--device", default="cuda")
    args, _ = ap.parse_known_args()

    import torch

    from distkeras_tpu_torch.data import (Dataset, LabelIndexTransformer,
                                          StandardScaleTransformer)
    from distkeras_tpu_torch.inference import (AccuracyEvaluator,
                                               ModelPredictor)
    from distkeras_tpu_torch.models import Dense, Model, Sequential
    from distkeras_tpu_torch.ops.metrics import auc
    from distkeras_tpu_torch.parallel import AEASGD
    from distkeras_tpu_torch.parallel.distributed import default_num_workers

    X, y = make_synthetic_higgs(args.n)
    n_eval = len(X) // 4
    ds = Dataset({"features": X[:-n_eval], "label": y[:-n_eval]})
    ds_eval = Dataset({"features": X[-n_eval:], "label": y[-n_eval:]})

    # the physics features span wildly different scales: standardize on
    # the TRAINING split and apply the fitted stats to eval (the
    # reference's StandardScaler stage)
    scaler = StandardScaleTransformer("features", output_col="features")
    ds = scaler.fit(ds)(ds)
    ds_eval = scaler(ds_eval)

    model = Model.build(Sequential([
        Dense(300, activation="tanh"),   # the HIGGS paper's deep-tanh MLP
        Dense(300, activation="tanh"),
        Dense(2),
    ]), (X.shape[1],), seed=0, device=args.device)

    n_workers = default_num_workers(args.device)
    trainer = AEASGD(
        model, num_workers=n_workers, batch_size=64,
        communication_window=8, rho=5.0, learning_rate=0.01,
        num_epoch=args.epochs, worker_optimizer="adam",
        optimizer_kwargs={"learning_rate": 1e-3},
        loss="sparse_categorical_crossentropy_from_logits")
    trained = trainer.train(ds)
    print(f"trained AEASGD in {trainer.get_training_time():.1f}s")

    # full inference chain: Predictor -> LabelIndex -> Evaluator
    scored = ModelPredictor(trained, output_col="scores").predict(ds_eval)
    labeled = LabelIndexTransformer(input_col="scores",
                                    output_col="prediction")(scored)
    acc = AccuracyEvaluator(prediction_col="prediction").evaluate(labeled)
    signal_score = np.ascontiguousarray(np.asarray(scored["scores"])[:, 1])
    roc = float(auc(torch.from_numpy(np.asarray(ds_eval["label"])),
                    torch.from_numpy(signal_score)))
    print(f"held-out accuracy: {acc:.4f}   ROC-AUC: {roc:.4f}")
    return acc


if __name__ == "__main__":
    main()
