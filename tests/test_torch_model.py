"""The port's ``transformer_lm`` against the JAX package's: the JAX
parameters go across with ``from_jax_params`` and both forward the same
tokens. Also: the weight bridge refuses mismatched trees, and the
package imports nothing of JAX or of the JAX package."""

import ast
import os

import numpy as np
import pytest
import torch

from distkeras_tpu.models import Model as JaxModel
from distkeras_tpu.models import zoo as jax_zoo

from distkeras_tpu_torch.compat import resolve_device
from distkeras_tpu_torch.models import Model, from_jax_params, zoo
from distkeras_tpu_torch.serving import ServingEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, S = 37, 13


def _pair(seed=0, **cfg):
    kw = dict(d_model=32, num_heads=4, num_layers=2, mlp_ratio=2)
    kw.update(cfg)
    jm = JaxModel.build(jax_zoo.transformer_lm(V, **kw), (S,), seed=seed)
    pm = Model.build(zoo.transformer_lm(V, **kw), (S,), seed=seed,
                     device="cpu")
    from_jax_params(pm, jm.params, jm.state)
    return jm, pm


def _tokens(b=2):
    return np.random.RandomState(7).randint(0, V, (b, S)).astype(np.int32)


#: float32 forward of a 2-layer model: matmul and softmax reassociation
F32_TOL = 1e-4
#: bf16 compute: a few bf16 ulps (2^-8) of O(1) logits after two blocks
BF16_TOL = 6e-2


@pytest.mark.parametrize("cfg", [
    {},                                              # MHA, RoPE, RMSNorm
    {"num_kv_heads": 2},                             # GQA
    {"num_kv_heads": 1, "attn_window": 4},           # MQA + sliding window
    {"use_rope": False, "max_len": S, "norm": "layernorm"},
    {"rope_scale": 2.0},
], ids=["mha", "gqa", "mqa-swa", "posemb-layernorm", "rope-scale"])
def test_forward_logits_match_jax(cfg):
    jm, pm = _pair(**cfg)
    x = _tokens()
    ref, _ = jm.apply(jm.params, jm.state, x)
    got = pm.apply(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=F32_TOL,
                               rtol=F32_TOL)


def test_forward_logits_match_jax_bf16():
    """bf16 compute: norms in f32 and cast back, projections and the MLP
    in bf16 — the same rounding points on both sides."""
    jm, pm = _pair(dtype="bfloat16", num_kv_heads=2)
    x = _tokens()
    ref, _ = jm.apply(jm.params, jm.state, x)
    got = pm.apply(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=BF16_TOL)


def test_bridge_refuses_mismatched_trees():
    jm, pm = _pair()
    params = [dict(p) for p in jm.params]
    params[-1] = {"kernel": np.zeros((32, V + 1), np.float32)}
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(pm, params)
    params[-1] = {"kernel": np.zeros((32, V), np.float32), "bias": 0}
    with pytest.raises(ValueError, match="unexpected"):
        from_jax_params(pm, params)
    with pytest.raises(ValueError, match="no state"):
        from_jax_params(pm, jm.params, [{"moving_mean": np.zeros(3)}])


def test_moe_is_not_ported_yet():
    """MoE blocks build, serve and train now; expert parallelism is what
    is not ported yet."""
    lm = zoo.transformer_lm(V, d_model=16, num_heads=2, num_layers=1,
                            moe_every=1, num_experts=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        zoo.transformer_lm(V, moe_every=1, num_experts=4,
                           moe_expert_axis="expert")
    m = Model.build(lm, (6,), device="cpu")
    m.module.train()
    out = m.module(torch.zeros(1, 6, dtype=torch.long))
    assert out.shape == (1, 6, V) and out.requires_grad


def test_entry_points_need_cuda_unless_told_cpu():
    """No entry point carries on quietly on the CPU: the default device
    is the CUDA card, and without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model.build(zoo.transformer_lm(V, d_model=16, num_heads=2,
                                       num_layers=1), (S,))
    pm = Model.build(zoo.transformer_lm(V, d_model=16, num_heads=2,
                                        num_layers=1), (S,), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(pm)
    assert ServingEngine(pm, device="cpu").device.type == "cpu"


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _port_files():
    root = os.path.join(REPO, "distkeras_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = list(_port_files())
    assert len(files) > 10 and os.path.exists(files[-1])
    rel = {os.path.relpath(f, REPO) for f in files}
    assert os.path.join("distkeras_tpu_torch", "serving",
                        "speculation.py") in rel
    bad = []
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "flax") or root == "distkeras_tpu":
                bad.append((os.path.relpath(path, REPO), mod))
    assert not bad, f"the port imports JAX or the JAX package: {bad}"
