"""The port's SPMD examples on the CPU (``--device cpu``), each over its
own world of processes (``parallel.launch.World``), with the lines and
thresholds ``tests/test_examples.py`` asserts of the JAX ones:

* ``large_model_spmd`` over JAX's 8-position mesh ``{"workers": 2, "ep":
  2, "tp": 2}`` (8 processes), on 1024 of JAX's 4096 training rows (the
  data is cut, not the mesh: an 8-process world on the test machine's
  cores); it still reaches JAX's next-token accuracy of 1.000;
* ``imagenet_resnet_spmd`` at JAX's test arguments (``--n 2048 --epochs
  4 --batch 32 --fsdp``) over a 4-process world."""

import sys

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _few_intraop_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_port_large_model_spmd(monkeypatch, capsys):
    from distkeras_tpu_torch.examples import large_model_spmd
    monkeypatch.setattr(sys, "argv", ["large_model_spmd", "--device", "cpu"])
    acc = large_model_spmd.main(rows=1024)
    out = capsys.readouterr().out
    assert "model: 124,352 params" in out
    assert "next-token accuracy: 1.000" in out and acc == 1.0
    first, last = (float(v) for v in
                   out.split("loss: ")[1].split("\n")[0].split(" -> "))
    assert last < first


def test_port_imagenet_resnet_spmd(monkeypatch, capsys):
    from distkeras_tpu_torch.examples import imagenet_resnet_spmd
    monkeypatch.setattr(sys, "argv", [
        "imagenet_resnet_spmd", "--n", "2048", "--epochs", "4", "--batch",
        "32", "--fsdp", "--ranks", "4", "--device", "cpu"])
    acc = imagenet_resnet_spmd.main()
    out = capsys.readouterr().out
    assert "on 4 processes" in out and "val accuracy per epoch" in out
    assert acc > 0.9, acc
