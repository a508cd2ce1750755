"""End-to-end workflow: ingest -> preprocess -> train -> predict ->
evaluate (the port's copy of ``examples/mnist_workflow.py``).

The reference dist-keras notebook's pipeline: MNIST-shaped ingest,
min-max / reshape / one-hot preprocessing, one trainer of the family,
then ``ModelPredictor`` -> ``LabelIndexTransformer`` ->
``AccuracyEvaluator``. With no network, the script makes an MNIST-shaped
problem (28x28 digit-blob images, 10 classes); swap
``make_synthetic_mnist`` for ``Dataset.from_csv`` on real data.

Run (``--device cpu`` without a card):
    python -m distkeras_tpu_torch.examples.mnist_workflow --trainer aeasgd
"""

from __future__ import annotations

import argparse

import numpy as np


def make_synthetic_mnist(n: int = 8192, seed: int = 0):
    """MNIST-shaped synthetic digits: class k = a fixed random 28x28
    prototype + noise. Flat 784-vector features, int labels."""
    rs = np.random.RandomState(seed)
    protos = rs.rand(10, 784).astype(np.float32) * 255.0
    y = rs.randint(0, 10, n)
    X = protos[y] + 32.0 * rs.randn(n, 784).astype(np.float32)
    return np.clip(X, 0, 255), y


def build_model(input_shape, conv: bool, device):
    from distkeras_tpu_torch.models import Model, zoo

    module = zoo.lenet5(num_classes=10) if conv else zoo.mlp(
        (512, 256), num_classes=10)
    return Model.build(module, input_shape, seed=0, device=device)


def make_trainer(name: str, model, num_workers: int, epochs: int):
    from distkeras_tpu_torch.parallel import (ADAG, AEASGD, DOWNPOUR,
                                              AveragingTrainer, DynSGD, EASGD,
                                              EnsembleTrainer, SingleTrainer)

    common = dict(
        worker_optimizer="momentum",
        optimizer_kwargs={"learning_rate": 0.05},
        loss="sparse_categorical_crossentropy_from_logits",
        features_col="features_norm", label_col="label",
        batch_size=64, num_epoch=epochs)
    dist = dict(num_workers=num_workers, **common)
    trainers = {
        "single": lambda: SingleTrainer(model, **common),
        "ensemble": lambda: EnsembleTrainer(model, num_models=2, **common),
        "averaging": lambda: AveragingTrainer(model, **dist),
        # momentum inflates commit deltas; scale by 1/n so the naive
        # center-sum update stays stable at many workers
        "downpour": lambda: DOWNPOUR(model, communication_window=5,
                                     commit_scale=1.0 / num_workers, **dist),
        "easgd": lambda: EASGD(model, rho=5.0, learning_rate=0.01,
                               communication_window=5, **dist),
        "aeasgd": lambda: AEASGD(model, rho=5.0, learning_rate=0.01,
                                 communication_window=16, **dist),
        # ADAG's first commits act like sign-updates of magnitude
        # adag_learning_rate; keep it well under the glorot weight scale
        # of the 784-wide model
        "adag": lambda: ADAG(model, communication_window=5,
                             adag_learning_rate=0.001, **dist),
        "dynsgd": lambda: DynSGD(model, communication_window=5, **dist),
    }
    return trainers[name]()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trainer", default="aeasgd",
                    choices=["single", "ensemble", "averaging", "downpour",
                             "easgd", "aeasgd", "adag", "dynsgd"])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--conv", action="store_true",
                    help="LeNet-5 on 28x28x1 instead of an MLP on 784")
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from distkeras_tpu_torch.data import (Dataset, LabelIndexTransformer,
                                          MinMaxTransformer,
                                          OneHotTransformer,
                                          ReshapeTransformer)
    from distkeras_tpu_torch.inference import (AccuracyEvaluator,
                                               ModelPredictor)
    from distkeras_tpu_torch.parallel.distributed import default_num_workers

    num_workers = args.workers or default_num_workers(args.device)

    # -- ingest (reference: CSV -> Spark DataFrame) ------------------------
    X, y = make_synthetic_mnist(args.n)
    ds = Dataset({"features": X, "label": y})

    # -- preprocess (reference: MinMax + Reshape + OneHot transformers) ----
    ds = MinMaxTransformer(o_min=0.0, o_max=1.0, i_min=0.0, i_max=255.0,
                           input_col="features",
                           output_col="features_norm")(ds)
    if args.conv:
        ds = ReshapeTransformer("features_norm", "features_norm",
                                (28, 28, 1))(ds)
    ds = OneHotTransformer(10, input_col="label",
                           output_col="label_onehot")(ds)  # demo parity

    # -- train -------------------------------------------------------------
    input_shape = (28, 28, 1) if args.conv else (784,)
    model = build_model(input_shape, args.conv, args.device)
    trainer = make_trainer(args.trainer, model, num_workers, args.epochs)
    trained = trainer.train(ds)
    result = trained[0] if isinstance(trained, list) else trained
    print(f"trained {args.trainer} in {trainer.get_training_time():.1f}s; "
          f"{result.num_params():,} params")

    # -- predict + evaluate (reference: ModelPredictor ->
    #    LabelIndexTransformer -> AccuracyEvaluator) -----------------------
    ds = ModelPredictor(result, features_col="features_norm",
                        output_col="prediction").predict(ds)
    ds = LabelIndexTransformer(input_col="prediction",
                               output_col="predicted_index")(ds)
    acc = AccuracyEvaluator(label_col="label",
                            prediction_col="predicted_index").evaluate(ds)
    print(f"train accuracy: {acc:.4f}")
    return acc


if __name__ == "__main__":
    main()
