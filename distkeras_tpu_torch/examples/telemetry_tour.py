"""Telemetry tour: train briefly, serve briefly, print ONE unified
snapshot (the port's copy of ``examples/telemetry_tour.py``).

A single ``telemetry_snapshot()`` answers, for the whole process, where
the step time went (span tree + the training tape's data/host/device
breakdown), whether anything was rebuilt after warm-up (the port's
compile counts are its kernel builds), whether the input pipeline
stalled (prefetch queue depth/stall gauges), how fast training ran
(imgs/sec, MFU, goodput) and what serving latency looked like
(TTFT/latency percentiles).

The JAX example takes the train step's FLOPs from XLA's cost analysis;
here ``torch.utils.flop_counter.FlopCounterMode`` counts one step of the
same train step on a second build of the model (its matrix products,
forward and backward), the numerator of the tape's MFU. On the card the
LM's training runs K1f, K1dq and K1dkv and its serving K1f and K3.

Run (``--device cpu`` without a card):
    python -m distkeras_tpu_torch.examples.telemetry_tour
"""

from __future__ import annotations

import argparse
import json

import numpy as np

PATTERN = np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8])


def train_step_flops(build, batch: int) -> float:
    """The FLOPs of one SGD train step at ``batch`` rows of zeros, on a
    fresh model from ``build()`` (the step updates it in place)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.optimizers import get_optimizer
    from distkeras_tpu_torch.parallel.worker import TrainCarry, make_train_step
    probe = build()
    opt = get_optimizer("sgd", learning_rate=0.1)
    step = make_train_step(
        probe.module,
        get_loss("sparse_categorical_crossentropy_from_logits"), opt)
    carry = TrainCarry(probe.params, opt.init(probe.params))
    xb = torch.zeros((batch,) + tuple(probe.input_shape),
                     device=probe.device)
    yb = torch.zeros((batch,), dtype=torch.int64, device=probe.device)
    probe.module.train()
    with FlopCounterMode(display=False) as counter:
        step(carry, (xb, yb))
    return float(counter.get_total_flops())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args, _ = ap.parse_known_args()

    from distkeras_tpu_torch import obs
    from distkeras_tpu_torch.data import Dataset
    from distkeras_tpu_torch.models import Model, zoo
    from distkeras_tpu_torch.parallel.trainers import SingleTrainer
    from distkeras_tpu_torch.serving import ServingEngine

    # ---- 1. train briefly, with an MFU-capable tape -------------------
    rs = np.random.RandomState(0)
    X = rs.rand(2048, 16).astype(np.float32)
    y = (X.sum(axis=1) > 8).astype(np.int32)

    def build():
        return Model.build(zoo.mlp((64, 32), num_classes=2), (16,), seed=0,
                           device=args.device)

    model = build()
    batch = 64
    # FLOPs per example from one counted train step -- the numerator
    # for MFU
    flops_per_example = train_step_flops(build, batch) / batch

    peak, kind = obs.detect_peak_flops()
    if peak is None:
        # no spec-sheet peak for this device (the CPU): supply a nominal
        # peak so the MFU plumbing is visible end to end -- the number is
        # then relative to that stated peak
        peak = 1e12
    tape = obs.TrainingTape(name="tour", unit="imgs",
                            flops_per_example=flops_per_example,
                            peak_flops=peak)
    trainer = SingleTrainer(
        model, worker_optimizer="sgd", learning_rate=0.1,
        loss="sparse_categorical_crossentropy_from_logits",
        batch_size=batch, num_epoch=3, telemetry=tape)
    with obs.span("tour.train"):
        trained = trainer.train(Dataset({"features": X, "label": y}))

    # ---- 2. serve briefly --------------------------------------------
    V, S = 29, 12
    Xlm = np.tile(PATTERN, (128, 1))
    lm = Model.build(
        zoo.transformer_lm(V, d_model=32, num_heads=4, num_layers=2,
                           mlp_ratio=2, use_rope=True), (S,), seed=2,
        device=args.device)
    lm.fit(Xlm[:, :-1], Xlm[:, 1:], optimizer="adam", learning_rate=5e-3,
           batch_size=64, epochs=3,
           loss="sparse_categorical_crossentropy_from_logits")
    engine = ServingEngine(lm, num_slots=2, max_len=32, prefill_chunk=4,
                           device=args.device)
    with obs.span("tour.serve"):
        for k in range(4):
            engine.submit(PATTERN[: 3 + k], max_new_tokens=5)
        engine.run(max_steps=500)

    # ---- 3. the unified snapshot -------------------------------------
    snap = obs.telemetry_snapshot()
    tour = tape.snapshot()
    serving = snap["components"]["serving"]
    print("=== unified telemetry snapshot ===")
    print(json.dumps({
        "train": {
            "imgs_per_sec": round(
                snap["metrics"]["gauges"]["tour.imgs_per_sec"][""]
                ["value"], 1),
            "goodput": round(tour["goodput"], 4),
            "mfu": round(tour["mfu"], 6),
            "phases_s": {k: round(v, 4)
                         for k, v in tour["phases_s"].items()},
            "recompiles": tour["recompiles"],
        },
        "prefetch": {
            "queue_depth_max": snap["metrics"]["gauges"]
            ["prefetch.queue_depth"]["stream=prefetch"]["max"],
            "stall_s_total": round(
                snap["metrics"]["histograms"]["prefetch.stall_s"]
                ["stream=prefetch"]["sum"], 4),
        },
        "serving": {
            "requests_finished": serving["requests_finished"],
            "ttft_s_p50": round(serving["ttft_s"]["p50"], 4),
            "latency_s_p50": round(serving["latency_s"]["p50"], 4),
        },
        "compile": {"count": snap["compile"]["count"],
                    "seconds": round(snap["compile"]["seconds"], 2)},
        "spans": sorted(snap["spans"]),
    }, indent=1))

    # the same snapshot, through the exporters
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/telemetry.jsonl"
        obs.exporters.JsonlExporter(path).export()
        snap2, spans2 = obs.exporters.read_jsonl(path)
        assert snap2 == json.loads(json.dumps(snap["metrics"]))
        # serving metrics live on the engine's WINDOW registry (a fresh
        # ServingMetrics per reporting interval); export that window
        prom = obs.exporters.prometheus_text(
            engine.metrics.registry.snapshot())
        assert "distkeras_serving_ttft_s" in prom
        assert "quantile=" in prom
    print("exporters: JSONL round-trip OK, prometheus text OK")
    print(f"train step FLOPs per example (FlopCounterMode): "
          f"{flops_per_example:.0f}; peak {peak:.3g} ({kind})")

    acc = float((np.argmax(trained.predict(X), axis=1) == y).mean())
    print(f"trained accuracy {acc:.3f}; tour complete")
    return acc


if __name__ == "__main__":
    main()
