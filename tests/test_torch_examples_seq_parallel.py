"""The port's ``long_context_serving`` example on the CPU (``--device
cpu``) with the lines ``tests/test_examples.py`` asserts of the JAX one:
batched prefill, the int8 KV cache and chunked prefill on a GQA model,
then ring attention with packed ids over a 4-process world
(``parallel.launch.World``) against the dense layer."""

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


def test_port_long_context_serving(capsys):
    from distkeras_tpu_torch.examples import long_context_serving
    old = sys.argv
    sys.argv = ["long_context_serving", "--device", "cpu"]
    try:
        err = long_context_serving.main()
    finally:
        sys.argv = old
    out = capsys.readouterr().out
    assert "int8 KV cache greedy match vs bf16: 1.00" in out
    assert "chunked prefill greedy match vs one-pass: 1.00" in out
    assert "ring attention + packed segment_ids over 4 processes" in out
    assert "OK" in out and err < 1e-4
