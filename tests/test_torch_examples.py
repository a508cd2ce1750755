"""The port's data-plane examples (``distkeras_tpu_torch/examples``) run
in-process on the CPU (``--device cpu``) at the arguments and thresholds
that ``tests/test_examples.py`` gives their JAX counterparts; the MNIST
workflow takes three of its eight trainers. ``num_workers=None`` is one
worker here (the CPU's device count)."""

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


@pytest.mark.parametrize("trainer", ["single", "downpour", "aeasgd"])
def test_port_mnist_workflow(trainer, capsys):
    acc = run_port_example("mnist_workflow", "--trainer", trainer,
                           "--epochs", "2", "--n", "2048")
    out = capsys.readouterr().out
    assert f"trained {trainer} in" in out and "train accuracy:" in out
    assert acc > 0.75, (trainer, acc)


def test_port_criteo_wide_deep(capsys):
    acc = run_port_example("criteo_wide_deep")
    out = capsys.readouterr().out
    assert "train acc (last steps):" in out and "AUC:" in out
    assert acc > 0.85, acc


def test_port_higgs_physics(capsys):
    acc = run_port_example("higgs_physics", "--epochs", "4", "--n", "8192")
    out = capsys.readouterr().out
    assert "ROC-AUC" in out
    assert acc > 0.8, acc


def test_port_streaming_inference(capsys):
    run_port_example("streaming_inference")
    assert "streamed 10624 rows" in capsys.readouterr().out


#: every example of the port
EXAMPLES = ["streaming_inference", "mnist_workflow", "criteo_wide_deep",
            "higgs_physics", "continuous_batching", "lm_generate",
            "speculative_serving", "router_serving", "loadgen_scenario",
            "request_tracing", "moe_serving", "packed_moe_serving",
            "telemetry_tour", "vit_finetune_callbacks",
            "long_context_serving", "large_model_spmd",
            "imagenet_resnet_spmd"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_default_to_the_card(monkeypatch, name):
    """Without ``--device`` an example runs on CUDA, and without a card
    that raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    monkeypatch.setattr(sys, "argv", [name])
    mod = importlib.import_module(f"distkeras_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main()
