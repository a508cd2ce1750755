"""Model files across the two packages: the port's layer registry and
``get_config`` against the JAX package's, and ``models/serialization.py``
(``save_model``/``load_model``, ``Model.save``/``Model.load``) reading
and writing the JAX package's ``<path>.json`` + ``<path>.npz`` files.

For an MLP, a CNN with BatchNorm state after a training step, the BiLSTM
(BASELINE config 5), ``resnet18_thin``, a 2-layer ``transformer_lm``
and a 2-layer all-MoE LM: the configs are JAX's dicts (and JSON text); a
file the JAX package writes loads in the port, and a file the port
writes loads in the JAX package, with predictions within 1e-5 of the
writer's (float32, summation order apart) and the LMs' greedy tokens
equal; ``quantize=True`` files hold bitwise the same int8 codes and
float32 scales. ``Remat(inner_spec=)`` and ``Residual(main_spec=,
shortcut_spec=)`` rebuild from their specs.
"""

import json

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.data import Dataset as JaxDataset
from distkeras_tpu.models import Model as JaxModel
from distkeras_tpu.models import Sequential as JaxSequential
from distkeras_tpu.models import blocks as jax_blocks
from distkeras_tpu.models import decoding as jd
from distkeras_tpu.models import layers as jax_layers
from distkeras_tpu.models import zoo as jax_zoo
from distkeras_tpu.models.core import layer_spec as jax_layer_spec
from distkeras_tpu.models.serialization import load_model as jax_load
from distkeras_tpu.models.serialization import save_model as jax_save
import distkeras_tpu.parallel as jax_parallel

from distkeras_tpu_torch.models import (LAYER_REGISTRY, Model, Sequential,
                                        blocks, from_jax_params,
                                        layer_from_spec, layer_spec, layers,
                                        load_model, save_model, zoo)
from distkeras_tpu_torch.models.quantize import QuantizedModel
from distkeras_tpu_torch.models.serialization import FORMAT_VERSION

TOL = 1e-5
V = 29
LOSS = "sparse_categorical_crossentropy_from_logits"


@pytest.fixture(autouse=True, scope="module")
def _one_intraop_thread():
    """Tiny tensors: one intra-op thread runs them faster than a pool
    that contends with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref), initial=0.0)
                 / max(float(np.max(np.abs(ref), initial=0.0)), 1e-30))


LM_KW = dict(d_model=16, num_heads=2, num_layers=2, mlp_ratio=2)
#: (zoo function, keywords, input shape, train one step first, is an LM)
CASES = {
    "mlp": ("mlp", dict(hidden=(16, 8), num_classes=3), (10,), False, False),
    "cnn_bn_trained": ("resnet18_thin", dict(num_classes=3, width=4),
                       (8, 8, 3), True, False),
    "bilstm": ("bilstm_classifier", dict(units=6, num_classes=2), (5, 4),
               False, False),
    "resnet18_thin": ("resnet18_thin", dict(num_classes=4), (16, 16, 3),
                      False, False),
    "transformer_lm": ("transformer_lm", dict(vocab_size=V, **LM_KW), (8,),
                       False, True),
    "moe_lm": ("transformer_lm", dict(vocab_size=V, moe_every=1,
                                      num_experts=4,
                                      moe_aux_loss_weight=0.01, **LM_KW),
               (8,), False, True),
}


def _inputs(case, n=3, seed=0):
    fn, kw, shape, _, lm = CASES[case]
    rs = np.random.RandomState(seed)
    if lm:
        return rs.randint(0, V, (n,) + shape).astype(np.int32)
    return rs.randn(n, *shape).astype(np.float32)


def _jax_model(case):
    """The case's JAX model (seed 2), after one SingleTrainer step where
    the case says so (its BN statistics moved)."""
    fn, kw, shape, trained, _ = CASES[case]
    jm = JaxModel.build(getattr(jax_zoo, fn)(**kw), shape, seed=2)
    if trained:
        rs = np.random.RandomState(5)
        X = rs.randn(8, *shape).astype(np.float32)
        y = rs.randint(0, kw["num_classes"], 8)
        jm = jax_parallel.SingleTrainer(
            jm, worker_optimizer="sgd", learning_rate=0.05, loss=LOSS,
            batch_size=8, num_epoch=1).train(JaxDataset(
                {"features": X, "label": y}))
    return jm


def _port_twin(case, jm):
    fn, kw, shape, _, _ = CASES[case]
    pm = Model.build(getattr(zoo, fn)(**kw), shape, seed=2, device="cpu")
    return from_jax_params(pm, jax.device_get(jm.params),
                           jax.device_get(jm.state))


@pytest.mark.parametrize("case", list(CASES))
def test_get_config_equals_jax(case):
    """The same dict, so the same JSON text; the spec rebuilds an equal
    model in the port, and the JAX spec does too."""
    fn, kw, shape, _, _ = CASES[case]
    jspec = getattr(jax_zoo, fn)(**kw)
    pspec = getattr(zoo, fn)(**kw)
    assert pspec.get_config() == jspec.get_config()
    assert json.dumps(layer_spec(pspec), indent=2) == \
        json.dumps(jax_layer_spec(jspec), indent=2)
    again = layer_from_spec(jax_layer_spec(jspec))
    assert layer_spec(again) == jax_layer_spec(jspec)


def test_registry_holds_every_jax_layer():
    from distkeras_tpu.models.core import LAYER_REGISTRY as JAX_REGISTRY
    assert sorted(LAYER_REGISTRY) == sorted(JAX_REGISTRY)
    assert len(LAYER_REGISTRY) == 32


@pytest.mark.parametrize("case", list(CASES))
def test_jax_file_loads_in_the_port(case, tmp_path):
    jm = _jax_model(case)
    path = str(tmp_path / "jax_model")
    jax_save(jm, path)
    pm = load_model(path, device="cpu")
    assert pm.input_shape == jm.input_shape
    assert pm.output_shape == jm.output_shape
    assert pm.module.get_config() == jm.module.get_config()
    x = _inputs(case)
    assert _rel(pm.predict(x), jm.predict(x)) <= TOL
    if CASES[case][4]:
        prompts = _inputs(case, n=2, seed=1)
        np.testing.assert_array_equal(pm.generate(prompts, 6),
                                      jd.generate(jm, prompts, 6))


@pytest.mark.parametrize("case", list(CASES))
def test_port_file_loads_in_jax(case, tmp_path):
    pm = _port_twin(case, _jax_model(case))
    path = str(tmp_path / "port_model")
    pm.save(path)
    with open(path + ".json") as f:
        arch = json.load(f)
    assert arch["format"] == FORMAT_VERSION
    jm = jax_load(path)
    x = _inputs(case)
    assert _rel(jm.predict(x), pm.predict(x)) <= TOL
    if CASES[case][4]:
        prompts = _inputs(case, n=2, seed=1)
        np.testing.assert_array_equal(jd.generate(jm, prompts, 6),
                                      pm.generate(prompts, 6))
    again = Model.load(path, device="cpu")
    assert np.array_equal(again.predict(x), pm.predict(x))


@pytest.mark.parametrize("case", list(CASES))
def test_quantized_files_are_bitwise_jax(case, tmp_path):
    """``quantize=True``: the same arrays under the same keys, bitwise;
    each package reads the other's file, dequantized and as a
    ``QuantizedModel`` from the codes and scales verbatim."""
    jm = _jax_model(case)
    pm = _port_twin(case, jm)
    jpath, ppath = str(tmp_path / "jq"), str(tmp_path / "pq")
    jax_save(jm, jpath, quantize=True)
    save_model(pm, ppath, quantize=True)
    with open(jpath + ".json") as f, open(ppath + ".json") as g:
        assert json.load(f) == json.load(g)
    with np.load(jpath + ".npz") as a, np.load(ppath + ".npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert any(k.startswith("scale:") for k in a.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            assert np.array_equal(a[k], b[k]), k
    x = _inputs(case)
    deq = load_model(jpath, device="cpu")
    jdeq = jax_load(ppath)
    assert _rel(deq.predict(x), jdeq.predict(x)) <= TOL
    q = load_model(jpath, keep_quantized=True, device="cpu")
    jq = jax_load(ppath, keep_quantized=True)
    assert isinstance(q, QuantizedModel)
    assert q.num_bytes() == jq.num_bytes()
    for got, ref in zip(jax.tree_util.tree_leaves(q.qparams),
                        jax.tree_util.tree_leaves(jq.qparams)):
        assert np.array_equal(got.numpy(), np.asarray(ref))
    assert _rel(q.predict(x), jq.predict(x)) <= TOL


def test_legacy_scale_entries_load(tmp_path):
    """A quantized file whose scales sit under JAX's legacy
    ``<key>:scale`` names (JAX serialization :147-163) loads the same."""
    jm = _jax_model("mlp")
    path = str(tmp_path / "q")
    jax_save(jm, path, quantize=True)
    with np.load(path + ".npz") as f:
        arrays = {(k[len("scale:"):] + ":scale" if k.startswith("scale:")
                   else k): f[k] for k in f.files}
    legacy = str(tmp_path / "legacy")
    np.savez(legacy + ".npz", **arrays)
    with open(path + ".json") as f, open(legacy + ".json", "w") as g:
        g.write(f.read())
    x = _inputs("mlp")
    assert np.array_equal(load_model(legacy, device="cpu").predict(x),
                          load_model(path, device="cpu").predict(x))
    assert np.array_equal(
        load_model(legacy, keep_quantized=True, device="cpu").predict(x),
        load_model(path, keep_quantized=True, device="cpu").predict(x))


def test_remat_and_residual_rebuild_from_specs(tmp_path):
    """``Remat(inner_spec=)`` and ``Residual(main_spec=, shortcut_spec=)``
    build from specs (no longer raise), have JAX's configs, and a remat
    LM's file crosses both ways."""
    inner = layers.Dense(4, activation="relu")
    r = blocks.Remat(inner_spec=layer_spec(inner), policy="dots")
    assert r.get_config() == jax_blocks.Remat(
        inner_spec=jax_layer_spec(jax_layers.Dense(4, activation="relu")),
        policy="dots").get_config()
    res = blocks.Residual(
        main_spec=layer_spec(Sequential([layers.Dense(6)])),
        shortcut_spec=layer_spec(layers.Dense(6, use_bias=False)),
        activation="tanh")
    jres = jax_blocks.Residual(
        main_spec=jax_layer_spec(JaxSequential([jax_layers.Dense(6)])),
        shortcut_spec=jax_layer_spec(jax_layers.Dense(6, use_bias=False)),
        activation="tanh")
    assert res.get_config() == jres.get_config()
    assert layer_spec(layer_from_spec(layer_spec(res))) == layer_spec(res)
    m = Model.build(Sequential([res, r]), (3,), seed=1, device="cpu")
    assert m.output_shape == (4,)

    kw = dict(vocab_size=V, remat="dots", **LM_KW)
    jm = JaxModel.build(jax_zoo.transformer_lm(**kw), (8,), seed=2)
    pm = Model.build(zoo.transformer_lm(**kw), (8,), seed=2, device="cpu")
    assert pm.module.get_config() == jm.module.get_config()
    from_jax_params(pm, jax.device_get(jm.params))
    path = str(tmp_path / "remat")
    pm.save(path)
    x = np.random.RandomState(0).randint(0, V, (2, 8)).astype(np.int32)
    assert _rel(jax_load(path).predict(x), pm.predict(x)) <= TOL
    jax_save(jm, path + "_j")
    assert _rel(load_model(path + "_j", device="cpu").predict(x),
                jm.predict(x)) <= TOL


#: JAX configs that once asked for what the port lacked: the expert and
#: BatchNorm axes still raise NotImplementedError naming ROADMAP Queue 1
#: item 10, never TypeError; the sequence-parallel ones are ported and
#: load with JAX's spec (``PORTED_SPECS``)
UNPORTED_SPECS = {
    "moe_expert_axis": ("MoE", dict(num_experts=4, hidden_dim=8,
                                    expert_axis_name="expert")),
    "batchnorm_axis_name": ("BatchNorm", dict(axis_name="dp")),
    "block_seq_axis": ("TransformerBlock", dict(num_heads=2,
                                                seq_axis_name="sp")),
    "positions_seq_axis": ("PositionalEmbedding", dict(
        max_len=8, seq_axis_name="sp")),
    "attention_ring": ("MultiHeadAttention", dict(num_heads=2,
                                                  attn_impl="ring")),
}


PORTED_SPECS = ("block_seq_axis", "positions_seq_axis", "attention_ring")


@pytest.mark.parametrize("case", list(UNPORTED_SPECS))
def test_unported_config_values_raise_naming_their_item(case):
    import distkeras_tpu.models as jax_models
    cls, kw = UNPORTED_SPECS[case]
    spec = jax_layer_spec(getattr(jax_models, cls)(**kw)) \
        if hasattr(jax_models, cls) else {"class": cls, "config": kw}
    if case in PORTED_SPECS:
        assert layer_spec(layer_from_spec(spec)) == spec
        return
    with pytest.raises(NotImplementedError, match="item 10"):
        layer_from_spec(spec)


def test_load_refuses_what_does_not_fit(tmp_path):
    jm = _jax_model("mlp")
    path = str(tmp_path / "m")
    jax_save(jm, path)
    with np.load(path + ".npz") as f:
        arrays = dict(f)
    arrays["params:0/kernel"] = np.zeros((3, 3), np.float32)
    np.savez(str(tmp_path / "bad") + ".npz", **arrays)
    with open(path + ".json") as f, \
            open(str(tmp_path / "bad") + ".json", "w") as g:
        g.write(f.read())
    with pytest.raises(ValueError, match="shape"):
        load_model(str(tmp_path / "bad"), device="cpu")
    del arrays["params:0/kernel"]
    np.savez(str(tmp_path / "bad") + ".npz", **arrays)
    with pytest.raises(KeyError):
        load_model(str(tmp_path / "bad"), device="cpu")
    with pytest.raises(ValueError, match="quantize=True"):
        load_model(path, keep_quantized=True, device="cpu")
    with pytest.raises(ValueError, match="not a layer spec"):
        layer_from_spec({"class_name": "Dense"})
    with pytest.raises(ValueError, match="unknown layer class"):
        layer_from_spec({"class": "Nope", "config": {}})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_model(path)
