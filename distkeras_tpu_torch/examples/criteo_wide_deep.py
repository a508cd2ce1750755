"""Wide & Deep CTR training with DOWNPOUR, BASELINE config 4 (the port's
copy of ``examples/criteo_wide_deep.py``).

The reference's DOWNPOUR runs on Criteo-style tabular data through
Spark DataFrame ingest. With no network, the script makes a
Criteo-shaped problem: ``wide_dim`` one-hot cross features with a sparse
linear ground truth and dense numeric features with a nonlinear one.
The model is ``models.blocks.WideAndDeep`` (linear over the wide half,
an MLP over the deep half), trained by DOWNPOUR and evaluated with the
predictor chain (accuracy, macro-F1, AUC).

Run (``--device cpu`` without a card):
    python -m distkeras_tpu_torch.examples.criteo_wide_deep
"""

from __future__ import annotations

import argparse

import numpy as np


def make_synthetic_criteo(n: int = 16384, wide_dim: int = 64,
                          deep_dim: int = 16, seed: int = 0):
    rs = np.random.RandomState(seed)
    # wide: multi-hot cross features (sparse 0/1); deep: dense numerics
    wide = (rs.rand(n, wide_dim) < 0.05).astype(np.float32)
    deep = rs.randn(n, deep_dim).astype(np.float32)
    w_true = rs.randn(wide_dim) * 2.0
    h = wide @ w_true + np.tanh(deep[:, :4]).sum(-1) + 0.3 * rs.randn(n)
    y = (h > np.median(h)).astype(np.int64)
    return wide, deep, y


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args, _ = ap.parse_known_args()

    from distkeras_tpu_torch.data import (Dataset, LabelIndexTransformer,
                                          VectorAssemblerTransformer)
    from distkeras_tpu_torch.inference import (AccuracyEvaluator, Evaluator,
                                               ModelPredictor)
    from distkeras_tpu_torch.models import Model
    from distkeras_tpu_torch.models.blocks import WideAndDeep
    from distkeras_tpu_torch.parallel import DOWNPOUR
    from distkeras_tpu_torch.parallel.distributed import default_num_workers

    WIDE, DEEP = 64, 16
    wide, deep, y = make_synthetic_criteo(wide_dim=WIDE, deep_dim=DEEP)
    # Spark-ML-style assembly: the VectorAssembler stage builds the
    # features_col every trainer consumes
    ds = VectorAssemblerTransformer(["wide", "deep"])(
        Dataset({"wide": wide, "deep": deep, "label": y}))

    model = Model.build(
        WideAndDeep(wide_dim=WIDE, deep_hidden=(64, 32), num_classes=2),
        (WIDE + DEEP,), seed=0, device=args.device)

    n_workers = default_num_workers(args.device)
    trainer = DOWNPOUR(
        model, num_workers=n_workers, communication_window=5,
        commit_scale=1.0 / n_workers, batch_size=64, num_epoch=8,
        worker_optimizer="adam", optimizer_kwargs={"learning_rate": 1e-2},
        loss="sparse_categorical_crossentropy_from_logits",
        metrics=["accuracy"])
    trained = trainer.train(ds)

    acc_train = trainer.get_history().metric("accuracy")
    print(f"train acc (last steps): {acc_train[-8:].mean():.3f}")

    ds = ModelPredictor(trained, output_col="prediction").predict(ds)
    ds = LabelIndexTransformer(input_col="prediction",
                               output_col="predicted_index")(ds)
    acc = AccuracyEvaluator(prediction_col="predicted_index").evaluate(ds)
    f1 = Evaluator("f1", prediction_col="prediction").evaluate(ds)
    roc = Evaluator("auc", prediction_col="prediction").evaluate(ds)
    print(f"eval accuracy: {acc:.4f}  macro-F1: {f1:.4f}  AUC: {roc:.4f}")
    return acc


if __name__ == "__main__":
    main()
