"""The port's four training examples (``distkeras_tpu_torch/examples``)
run in-process on the CPU (``--device cpu``) with the lines, return
values and thresholds that ``tests/test_examples.py`` asserts of their
JAX counterparts."""

import importlib
import sys

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _few_intraop_threads():
    """Small models: two intra-op threads contend less with the other
    test processes than a full pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_port_example(name, *args):
    old = sys.argv
    sys.argv = [name, *args, "--device", "cpu"]
    try:
        return importlib.import_module(
            f"distkeras_tpu_torch.examples.{name}").main()
    finally:
        sys.argv = old


def test_port_lm_generate(capsys):
    acc = run_port_example("lm_generate")
    out = capsys.readouterr().out
    assert "int8 vs f32" in out
    assert "int8-weight generate() exact-match" in out
    assert acc > 0.9, acc


def test_port_packed_moe_serving(capsys):
    run_port_example("packed_moe_serving")
    out = capsys.readouterr().out
    assert "cross-document logit leak" in out and "OK" in out
    assert "cross-document logit leak after perturbing doc A: 0.0" in out


def test_port_telemetry_tour(capsys):
    acc = run_port_example("telemetry_tour")
    out = capsys.readouterr().out
    assert "unified telemetry snapshot" in out
    # the one-snapshot surface: rates, goodput, MFU, compile counts,
    # prefetch stalls, serving percentiles
    for key in ("imgs_per_sec", "goodput", "mfu", "recompiles",
                "stall_s_total", "ttft_s_p50"):
        assert key in out, key
    assert "JSONL round-trip OK" in out
    assert "(FlopCounterMode)" in out
    assert acc > 0.7, acc


def test_port_telemetry_tour_counts_the_step_flops():
    """``FlopCounterMode`` over one SGD step of the tour's MLP counts its
    matrix products: 2 * (16*64 + 64*32 + 32*2) a row in the forward, as
    many for the weight gradients, and the input gradients of the two
    layers past the first (the input rows need none)."""
    from distkeras_tpu_torch.models import Model, zoo
    mod = importlib.import_module(
        "distkeras_tpu_torch.examples.telemetry_tour")
    flops = mod.train_step_flops(
        lambda: Model.build(zoo.mlp((64, 32), num_classes=2), (16,),
                            seed=0, device="cpu"), 64)
    fwd = 2 * (16 * 64 + 64 * 32 + 32 * 2)
    bwd_dw = fwd
    bwd_dx = 2 * (64 * 32 + 32 * 2)
    assert flops == 64 * (fwd + bwd_dw + bwd_dx)


def test_port_vit_finetune_callbacks(capsys):
    acc = run_port_example("vit_finetune_callbacks")
    out = capsys.readouterr().out
    assert "epochs logged" in out
    assert acc > 0.85, acc
