"""The port's weight-only quantization against the JAX package's: the
nibble packing, ``quantize_weight`` and both tree quantizers bit for
bit, the quantized matmul's plain version against the Pallas kernel
(interpret mode) and the JAX reference, ``QuantizedModel.predict``, and
``generate(weights_dtype="int8"/"int4")`` token for token.

The port runs its plain PyTorch versions on the CPU (the K5 kernel runs
only on the card, ``tests/test_torch_cuda.py``). Every input is made
with numpy from a seed; weights cross with ``from_jax_params``, and a
JAX quantized tree with ``qtree_from_jax``."""

import numpy as np
import pytest
import torch

import jax

from distkeras_tpu.models import Model as JaxModel
from distkeras_tpu.models import decoding as jd
from distkeras_tpu.models import quantize as jquant
from distkeras_tpu.models import zoo as jax_zoo
from distkeras_tpu.ops import quant_matmul as jqm

from distkeras_tpu_torch.models import (Model, from_jax_params,
                                        qtree_from_jax, zoo)
from distkeras_tpu_torch.models import quantize as pquant
from distkeras_tpu_torch.ops.quant_matmul import (
    dequant_params_tree, dequant_weight, gather_rows, is_qdict, pack_rows,
    quant_matmul, quantize_params_tree, quantize_weight, reference_matmul,
    tree_quant_errors, unpack_rows)

V = 41
#: float32 matmuls over K <= 256 summed in two orders
MM_TOL = 1e-5
_PAIRS = {}


def _pair(cfg):
    if cfg not in _PAIRS:
        kw = dict(d_model=32, num_heads=4, num_layers=2, mlp_ratio=2)
        if cfg == "gqa":
            kw["num_kv_heads"] = 2
        if cfg == "posemb":
            kw.update(use_rope=False, max_len=24)
        if cfg.startswith("moe"):
            # stacked expert leaves, an even and an odd expert count
            kw.update(moe_every=1, num_experts=5 if cfg == "moe-odd" else 4)
        jm = JaxModel.build(jax_zoo.transformer_lm(V, **kw), (8,), seed=5)
        pm = Model.build(zoo.transformer_lm(V, **kw), (8,), seed=5,
                         device="cpu")
        from_jax_params(pm, jm.params, jm.state)
        jd._resolve_head_dims(jm.module, jm.params)
        _PAIRS[cfg] = (jm, pm)
    return _PAIRS[cfg]


def _np(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


def _assert_qdict_equal(ours, theirs, where=""):
    assert set(ours) == set(theirs), where
    for key in theirs:
        a, b = _np(ours[key]), np.asarray(theirs[key])
        assert a.dtype == b.dtype and a.shape == b.shape, (where, key)
        np.testing.assert_array_equal(a, b, err_msg=f"{where}/{key}")


# --- the nibble packing and quantize_weight ---------------------------------


@pytest.mark.parametrize("shape", [(6, 5), (8, 3, 4), (2, 1)])
def test_pack_rows_bitwise_jax_and_round_trips(shape):
    q = np.random.RandomState(0).randint(-7, 8, shape).astype(np.int8)
    ours = pack_rows(torch.from_numpy(q))
    theirs = np.asarray(jqm.pack_rows(jax.numpy.asarray(q)))
    np.testing.assert_array_equal(ours.numpy(), theirs)
    np.testing.assert_array_equal(unpack_rows(ours).numpy(), q)
    np.testing.assert_array_equal(
        unpack_rows(ours).numpy(),
        np.asarray(jqm.unpack_rows(jax.numpy.asarray(theirs))))


QW_CASES = {
    "int8": ((64, 48), None, 8),
    "int4-packed": ((64, 48), None, 4),
    "int4-odd-leading": ((63, 48), None, 4),
    "wq-int8": ((32, 4, 8), (0,), 8),
    "wq-int4": ((32, 4, 8), (0,), 4),
    "wo-int8": ((4, 8, 32), (0, 1), 8),
    "wo-int4": ((4, 8, 32), (0, 1), 4),
    "embed-odd-vocab-int4": ((41, 32), None, 4),
    # MoE's stacked expert leaves: w1 [E, d, h], w2 [E, h, d], one scale
    # per output channel shared by every expert; int4 packs along the
    # expert axis when E is even
    "experts-w1-int8": ((4, 16, 24), None, 8),
    "experts-w1-int4-even": ((4, 16, 24), None, 4),
    "experts-w1-int4-odd": ((5, 16, 24), None, 4),
    "experts-w2-int8-odd": ((5, 24, 16), None, 8),
}


@pytest.mark.parametrize("case", list(QW_CASES))
@pytest.mark.parametrize("zero_channel", [False, True])
def test_quantize_weight_bitwise_jax(case, zero_channel):
    shape, reduce_axes, bits = QW_CASES[case]
    w = (np.random.RandomState(1).randn(*shape) * 0.3).astype(np.float32)
    if zero_channel:
        w[..., 1] = 0.0
    ours = quantize_weight(torch.from_numpy(w), bits, reduce_axes)
    theirs = jqm.quantize_weight(w, bits, reduce_axes)
    _assert_qdict_equal(ours, theirs, case)
    assert ("q4" in ours) == (bits == 4 and shape[0] % 2 == 0)
    np.testing.assert_array_equal(dequant_weight(ours).numpy(),
                                  np.asarray(jqm.dequant_weight(theirs)))
    if zero_channel:
        assert dequant_weight(ours)[..., 1].abs().max() == 0.0


def test_quantize_weight_validates():
    w = torch.ones(8, 4)
    with pytest.raises(ValueError, match="bits"):
        quantize_weight(w, 3)
    with pytest.raises(ValueError, match="matrix"):
        quantize_weight(torch.ones(8), 8)
    with pytest.raises(ValueError, match="prefix"):
        quantize_weight(torch.ones(4, 4, 4), 8, reduce_axes=(1,))


@pytest.mark.parametrize("rows", [40, 41])
def test_gather_rows_equals_dequantized_table(rows):
    w = np.random.RandomState(2).randn(rows, 16).astype(np.float32)
    wq = quantize_weight(torch.from_numpy(w), 4)
    idx = torch.from_numpy(np.random.RandomState(3).randint(0, rows, (3, 5)))
    np.testing.assert_array_equal(gather_rows(wq, idx).numpy(),
                                  dequant_weight(wq)[idx].numpy())


# --- the trees --------------------------------------------------------------


def _walk_pairs(ours, theirs, path=""):
    """Yield ``(path, ours, theirs)`` for every leaf or qdict."""
    if is_qdict(theirs) or not isinstance(theirs, (dict, list, tuple)):
        yield path, ours, theirs
    elif isinstance(theirs, dict):
        assert set(ours) == set(theirs), path
        for k in theirs:
            yield from _walk_pairs(ours[k], theirs[k], f"{path}/{k}")
    else:
        assert len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            yield from _walk_pairs(a, b, f"{path}[{i}]")


@pytest.mark.parametrize("cfg", ["mha", "posemb", "moe", "moe-odd"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_tree_bitwise_jax(cfg, bits):
    jm, pm = _pair(cfg)
    ours = quantize_params_tree(pm.params, bits)
    theirs = jqm.quantize_params_tree(jm.params, bits)
    n_q = 0
    for path, a, b in _walk_pairs(ours, theirs):
        if is_qdict(b):
            n_q += 1
            _assert_qdict_equal(a, b, path)
        else:
            np.testing.assert_array_equal(_np(a.detach()), np.asarray(b))
    # embeddings, 2 x (wq, wk, wv, wo, w1, w2), the head (+ positions)
    assert n_q == 1 + 2 * 6 + 1 + (cfg == "posemb")
    errs = tree_quant_errors(pm.params, ours)
    jerrs = jqm.tree_quant_errors(jm.params, theirs)
    assert set(errs) == set(jerrs)
    for key in jerrs:
        for metric in ("max_abs_err", "rel_rms"):
            assert abs(errs[key][metric] - jerrs[key][metric]) <= 1e-6


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_bitwise_jax(bits):
    jm, pm = _pair("gqa")
    q, s = pquant.quantize_params(pm.params, bits)
    jq, js = jquant.quantize_params(jax.device_get(jm.params), bits)
    for (path, a, b), (_, sa, sb) in zip(_walk_pairs(q, jq),
                                         _walk_pairs(s, js)):
        np.testing.assert_array_equal(_np(a), np.asarray(b),
                                      err_msg=path)
        assert (sa is None) == (sb is None), path
        if sb is not None:
            np.testing.assert_array_equal(_np(sa), np.asarray(sb))
    deq = pquant.dequantize_params(q, s)
    jdeq = jquant.dequantize_params(jq, js)
    for path, a, b in _walk_pairs(deq, jdeq):
        np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=path)


@pytest.mark.parametrize("bits", [8, 4])
def test_dequant_params_tree_matches_jax(bits):
    jm, pm = _pair("mha")
    theirs = jqm.dequant_params_tree(jqm.quantize_params_tree(jm.params,
                                                              bits))
    ours = dequant_params_tree(quantize_params_tree(pm.params, bits))
    for path, a, b in _walk_pairs(ours, theirs):
        np.testing.assert_array_equal(_np(a.detach()), np.asarray(b),
                                      err_msg=path)


def test_qtree_from_jax_carries_bytes():
    jm, _ = _pair("mha")
    theirs = jqm.quantize_params_tree(jm.params, 4)
    ours = qtree_from_jax(theirs, device="cpu")
    for path, a, b in _walk_pairs(ours, theirs):
        if is_qdict(b):
            _assert_qdict_equal(a, b, path)


def test_qtree_from_jax_defaults_to_the_card():
    """Like every entry point, ``qtree_from_jax`` puts the tree on the
    CUDA card unless told ``device="cpu"``, and raises without one."""
    tree = {"w": {"q": np.ones((2, 3), np.int8),
                  "scale": np.ones(3, np.float32)}}
    if torch.cuda.is_available():
        assert qtree_from_jax(tree)["w"]["q"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            qtree_from_jax(tree)
    assert qtree_from_jax(tree, device="cpu")["w"]["q"].dtype == torch.int8


# --- the matmul --------------------------------------------------------------


def _layout_case(rs, layout, bits, k, n, m):
    if layout == "proj":                         # [d, h, e] -> [d, h*e]
        w = rs.randn(k, 4, n // 4).astype(np.float32)
        wq = jqm.quantize_weight(w, bits, reduce_axes=(0,))
    else:                                        # [h, e, d] -> [h*e, d]
        w = rs.randn(4, k // 4, n).astype(np.float32)
        wq = jqm.quantize_weight(w, bits, reduce_axes=(0, 1))
    x = rs.randn(m, k).astype(np.float32)
    return x, wq


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("layout", ["proj", "out"])
def test_plain_quant_matmul_matches_jax_kernel_interpret(bits, layout):
    """Aligned shapes (K, N % 128): the Pallas kernel in interpret
    mode."""
    rs = np.random.RandomState(4)
    x, wq = _layout_case(rs, layout, bits, 128, 256, 5)
    with jqm.force_interpret():
        assert jqm.fused_supported(128, 256)
        theirs = np.asarray(jqm.quant_matmul(jax.numpy.asarray(x), wq))
    ours = quant_matmul(torch.from_numpy(x),
                        qtree_from_jax(wq, device="cpu")).numpy()
    assert ours.dtype == np.float32 and ours.shape == (5, 256)
    assert _rel(ours, theirs) <= MM_TOL


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("layout,k,n,m", [("proj", 96, 100, 3),
                                          ("out", 200, 36, 7),
                                          ("proj", 36, 12, 1)])
def test_plain_quant_matmul_matches_jax_reference(bits, layout, k, n, m):
    """Misaligned shapes: JAX's reference branch; lead axes kept."""
    rs = np.random.RandomState(5)
    x, wq = _layout_case(rs, layout, bits, k, n, m)
    x3 = x.reshape(1, m, k)
    theirs = np.asarray(jqm.reference_matmul(jax.numpy.asarray(x3), wq))
    ours = quant_matmul(torch.from_numpy(x3),
                        qtree_from_jax(wq, device="cpu")).numpy()
    assert ours.shape == (1, m, n)
    assert _rel(ours, theirs) <= MM_TOL
    # and dequant-then-matmul agrees (the scale commutes out of the sum)
    deq = dequant_weight(qtree_from_jax(wq, device="cpu")) \
        .reshape(k, n).numpy()
    assert _rel(ours.reshape(m, n), x @ deq) <= 1e-4


def test_quant_matmul_rejects_mismatched_contraction():
    wq = quantize_weight(torch.ones(64, 8), 8)
    with pytest.raises(ValueError, match="contract"):
        reference_matmul(torch.ones(2, 32), wq)
    with pytest.raises(ValueError, match="contract"):
        quant_matmul(torch.ones(2, 32), wq)


# --- QuantizedModel and generate() -------------------------------------------


def test_quantized_model_predict_matches_jax():
    jm, pm = _pair("mha")
    x = np.random.RandomState(6).randint(0, V, (3, 8)).astype(np.int32)
    theirs = jquant.quantize_model(jm)
    ours = pquant.quantize_model(pm)
    got = ours.predict(x)
    want = theirs.predict(x)
    assert got.shape == want.shape == (3, 8, V)
    assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(), 1.0)
    assert ours.num_bytes() == theirs.num_bytes()
    back = pquant.dequantize_model(ours)
    np.testing.assert_allclose(
        back.apply(torch.from_numpy(x)).numpy(), got, rtol=0, atol=1e-6)


def _prompts(seed=0, b=2, p=11):
    return np.random.RandomState(seed).randint(0, V, (b, p)).astype(np.int32)


@pytest.mark.parametrize("prefill_chunk", [None, 4])
@pytest.mark.parametrize("weights_dtype", ["int8", "int4"])
@pytest.mark.parametrize("cfg", ["mha", "gqa", "posemb"])
def test_generate_quantized_weights_match_jax(cfg, weights_dtype,
                                              prefill_chunk):
    jm, pm = _pair(cfg)
    prompts = _prompts(7, p=10)
    want = jd.generate(jm, prompts, 8, weights_dtype=weights_dtype,
                       prefill_chunk=prefill_chunk)
    got = pm.generate(prompts, 8, weights_dtype=weights_dtype,
                      prefill_chunk=prefill_chunk)
    np.testing.assert_array_equal(got, want)


def test_generate_int8_dtype_means_int8_and_tree_is_cached():
    _, pm = _pair("mha")
    prompts = _prompts(8)
    a = pm.generate(prompts, 5, weights_dtype="int8")
    b = pm.generate(prompts, 5, weights_dtype=torch.int8)
    np.testing.assert_array_equal(a, b)
    tree = pm._serving_params_cache["int8"][1]
    attn = tree[1]["attn"]
    assert all(is_qdict(attn[k]) for k in ("wq", "wk", "wv", "wo"))
    assert attn["wq"]["scale"].shape == attn["wq"]["q"].shape[1:]
    assert attn["wo"]["scale"].shape == attn["wo"]["q"].shape[-1:]
    assert not is_qdict(tree[1]["norm1"]["scale"])
