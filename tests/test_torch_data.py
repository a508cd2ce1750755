"""The port's data plane against the JAX package: ``Dataset.from_csv``
through the host library, each ``native`` entry point (above and below
its 4 MiB threshold, and with ``DKT_DISABLE_NATIVE=1``), each
transformer, each ``Dataset`` method, the adapters, ``load_real_digits``,
and BASELINE config 4's ingest and DOWNPOUR as a whole
(``chip_smoke.criteo_ingest`` at 2,048 rows and 256 buckets).

The same seeded numpy inputs go through both packages. Columns are held
bitwise, min-max scaling within ``tests/test_native.py``'s tolerances;
the DOWNPOUR runs within ``tests/test_torch_distributed.py``'s 1e-4
(float32 on both sides, summation order apart).
"""

import os
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

import distkeras_tpu.data as jdata
from distkeras_tpu.data import native as jnative
from distkeras_tpu.data import real as jreal
from distkeras_tpu.inference import AccuracyEvaluator as JaxAccuracy
from distkeras_tpu.inference import Evaluator as JaxEvaluator
from distkeras_tpu.inference import ModelPredictor as JaxPredictor
from distkeras_tpu.models import Model as JaxModel
from distkeras_tpu.models import zoo as jzoo
import distkeras_tpu.parallel as jax_parallel

import chip_smoke
import distkeras_tpu_torch.data as pdata
from distkeras_tpu_torch import compat
from distkeras_tpu_torch.data import native
from distkeras_tpu_torch.data import real as preal
from distkeras_tpu_torch.inference import (AccuracyEvaluator, Evaluator,
                                           ModelPredictor)
from distkeras_tpu_torch.models import Model, from_jax_params, to_jax_params
from distkeras_tpu_torch.models import zoo as pzoo
from distkeras_tpu_torch.obs import collectors
from distkeras_tpu_torch import parallel
from distkeras_tpu_torch.parallel import shard_epoch_data

#: the port against JAX on float32 training: summation order apart
REL_TOL = 1e-4
#: min-max scaling against numpy (``tests/test_native.py``)
FIT_RTOL, SCALE_ATOL = 1e-6, 1e-5
LOSS = "sparse_categorical_crossentropy_from_logits"


@pytest.fixture(autouse=True, scope="module")
def _one_intraop_thread():
    """Tiny tensors: one intra-op thread runs them faster than a pool
    that contends with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                      a.shape, b.shape)
    if a.dtype == object:      # rows of their own types: row by row
        assert all(type(x) is type(y) and np.array_equal(x, y)
                   for x, y in zip(a, b))
    else:
        np.testing.assert_array_equal(a, b)


def _same_ds(jds, pds):
    assert list(jds.columns) == list(pds.columns)
    for col in jds.columns:
        _same(jds[col], pds[col])


# --- Dataset.from_csv through the host library -------------------------------

#: (file text, from_csv keywords): the first four rows are the table of
#: files ``numpy.loadtxt`` parsed differently from JAX's native parser
CSV_CASES = {
    "tab_separated_default_sep": ("1\t2\t3\n4\t5\t6\n", {}),
    "mixed_comma_and_tab": ("1,2\t3\n4\t5,6\n", {}),
    "trailing_separator": ("1,2,3,\n4,5,6,\n", {}),
    "empty_file": ("", {}),
    "header_and_label": ("a,b,c\n0,1.5,2\n1,-3.25,4e1\n",
                         dict(skip_header=True, label_col_index=0)),
    "label_last_semicolon": ("1;2;0\n3;4;1\n", dict(sep=";",
                                                   label_col_index=2)),
    "no_final_newline_crlf": ("1,2\r\n3,4", {}),
}


@pytest.mark.parametrize("case", list(CSV_CASES))
def test_from_csv_matches_jax(case, tmp_path):
    text, kw = CSV_CASES[case]
    p = tmp_path / "data.csv"
    p.write_text(text)
    _same_ds(jdata.Dataset.from_csv(p, **kw), pdata.Dataset.from_csv(p, **kw))


@pytest.mark.parametrize("text, match", [("1,2,3\n4,x,6\n", "malformed"),
                                         ("1,2,3\n4,5\n", "ragged")])
def test_from_csv_errors_match_jax(text, match, tmp_path):
    p = tmp_path / "bad.csv"
    p.write_text(text)
    with pytest.raises(ValueError, match=match) as jerr:
        jdata.Dataset.from_csv(p)
    with pytest.raises(ValueError, match=match) as perr:
        pdata.Dataset.from_csv(p)
    assert str(jerr.value).split(":")[0] == str(perr.value).split(":")[0]


# --- the host library ------------------------------------------------------------


def _native_inputs(rs, big):
    """Seeded inputs of every entry point, above (``big``) or below the
    4 MiB threshold."""
    n = 40_000 if big else 64
    x = (rs.randn(n, 32) * 7 + 3).astype(np.float32)
    x[:, 5] = 2.5                                     # degenerate column
    labels = rs.randint(-2, 70, n)                    # some out of range
    return {"x": x, "perm": rs.permutation(n),
            "u8": rs.randint(0, 255, (n, 8, 8, 2)).astype(np.uint8),
            "labels": labels}


def _run_native(mod, inp):
    x = inp["x"]
    mins, maxs = mod.minmax_fit(x)
    return {"gather": mod.gather(x, inp["perm"]),
            "gather_u8": mod.gather(inp["u8"], inp["perm"][::2]),
            "gather_i64": mod.gather(inp["labels"], inp["perm"]),
            "one_hot": mod.one_hot(inp["labels"], 64),
            "mins": mins, "maxs": maxs,
            "scale": mod.minmax_scale(x, mins, maxs, -1.0, 2.0)}


def _assert_native_equal(ref, got):
    for key in ("gather", "gather_u8", "gather_i64", "one_hot"):
        _same(ref[key], got[key])
    for key in ("mins", "maxs"):
        np.testing.assert_allclose(got[key], ref[key], rtol=FIT_RTOL)
    np.testing.assert_allclose(got["scale"], ref["scale"], atol=SCALE_ATOL)
    assert (got["scale"][:, 5] == -1.0).all()         # degenerate -> lo


@pytest.mark.parametrize("big", [False, True], ids=["numpy_path",
                                                    "native_path"])
def test_native_entry_points_match_jax(big):
    assert native.native_available(), native.native_status()
    inp = _native_inputs(np.random.RandomState(0), big)
    ref, got = _run_native(jnative, inp), _run_native(native, inp)
    _assert_native_equal(ref, got)
    labels = inp["labels"]
    # out-of-range labels give all-zero rows
    assert not got["one_hot"][(labels < 0) | (labels >= 64)].any()


@pytest.fixture
def native_disabled(monkeypatch):
    """The port's ``native`` module as a fresh process with
    ``DKT_DISABLE_NATIVE=1`` sees it."""
    monkeypatch.setenv("DKT_DISABLE_NATIVE", "1")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    return native


@pytest.mark.parametrize("big", [False, True], ids=["small", "large"])
def test_native_disabled_takes_numpy_and_matches_jax(big, native_disabled,
                                                     tmp_path):
    assert native_disabled.native_status() == \
        "fallback: disabled via DKT_DISABLE_NATIVE"
    assert not native_disabled.native_available()
    inp = _native_inputs(np.random.RandomState(1), big)
    _assert_native_equal(_run_native(jnative, inp),
                         _run_native(native_disabled, inp))
    p = tmp_path / "d.csv"
    p.write_text("1\t2,3\n4,5,6\n")
    _same(jnative.read_csv(p), native_disabled.read_csv(p))


def test_native_library_builds_under_a_hash_of_source_and_flags(
        tmp_path, monkeypatch):
    path = native.library_path()
    assert os.path.dirname(path) == compat.build_dir()
    assert os.path.basename(path).startswith("libdkt_data-")
    with open(native._SRC, "rb") as a, open(os.path.join(
            os.path.dirname(compat.PACKAGE_DIR), "native", "dkt_data.cc"),
            "rb") as b:
        assert a.read() == b.read()   # the port's copy of the JAX source
    monkeypatch.setenv("DKT_KERNEL_BUILD_DIR", str(tmp_path))
    fresh = native.library_path()
    assert fresh.startswith(str(tmp_path))
    before = collectors.compile_totals()["count"]
    assert native._build(fresh) is None
    assert os.path.exists(fresh)
    assert collectors.compile_totals()["count"] == before + 1
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []


def test_shuffle_filter_and_epoch_stack_run_the_host_library(monkeypatch):
    lib = native._load()
    assert lib is not None, native.native_status()
    calls = []
    c_gather = lib.dkt_gather
    monkeypatch.setattr(lib, "dkt_gather", lambda *a: (
        calls.append(a[3] * a[4]), c_gather(*a))[1])
    rs = np.random.RandomState(4)
    X = rs.randn(40_000, 40).astype(np.float32)        # 6.4 MB
    y = rs.randint(0, 5, 40_000)
    ds = pdata.Dataset({"features": X, "label": y})
    sh = ds.shuffle(seed=7)
    perm = np.random.RandomState(7).permutation(len(ds))
    _same(sh["features"], X[perm])
    _same(sh["label"], y[perm])
    assert calls == [X.nbytes]                       # labels: numpy's path
    _same(ds.filter(lambda d: d["label"] > 0)["features"], X[y > 0])
    assert len(calls) == 2
    Xs, Ys, S = shard_epoch_data(X, y, 4, 32, perm)
    _same(Xs.reshape(-1, 40), X[perm][:S * 128])
    assert len(calls) == 3


# --- transformers ------------------------------------------------------------------


def _transform_cases():
    rs = np.random.RandomState(2)
    obj = np.empty(3, dtype=object)
    obj[:] = [[1.0, 2.0], np.array([3.0, 4.0]), (5, 6)]
    mixed = np.array(["x", 3, "x", 2.5], dtype=object)
    cat = np.array(["b", "a", "b", "c", "b", "a", "d"])
    return {
        "one_hot": (lambda m: m.OneHotTransformer(7),
                    {"label": rs.randint(0, 7, 50)}),
        "one_hot_native": (lambda m: m.OneHotTransformer(
            64, output_col="oh"), {"label": rs.randint(0, 64, 20_000)}),
        "label_index_argmax": (lambda m: m.LabelIndexTransformer(3),
                               {"prediction": rs.randn(9, 3)}),
        "label_index_binary": (lambda m: m.LabelIndexTransformer(),
                               {"prediction": rs.rand(9, 1)}),
        "minmax_inferred": (lambda m: m.MinMaxTransformer(-1.0, 1.0),
                            {"features": rs.randn(40, 6) * 9}),
        "minmax_native": (lambda m: m.MinMaxTransformer(0.0, 1.0),
                          {"features": (rs.rand(40_000, 32) * 255)
                           .astype(np.float32)}),
        "minmax_given_images": (lambda m: m.MinMaxTransformer(
            0.0, 1.0, i_min=0.0, i_max=255.0),
            {"features": rs.randint(0, 256, (6, 4, 4, 1))}),
        "reshape": (lambda m: m.ReshapeTransformer("features", "img",
                                                   (4, 4, 2)),
                    {"features": rs.randn(5, 32)}),
        "dense_object_rows": (lambda m: m.DenseTransformer(),
                              {"features": obj}),
        "dense_numeric": (lambda m: m.DenseTransformer(),
                          {"features": rs.randint(0, 5, (4, 3))}),
        "standard_scale": (lambda m: m.StandardScaleTransformer(),
                           {"features": rs.randn(64, 5) * 4 + 2}),
        "hashing_string_int_float2d": (lambda m: m.HashingTransformer(
            64, ["s", "i", "f"], output_col="wide"),
            {"s": np.array(["x", "y", "x", "zz", "y"]),
             "i": np.array([10, 10, 20, 30, -4]),
             "f": rs.randn(5, 3).astype(np.float32)}),
        "hashing_object_fallback": (lambda m: m.HashingTransformer(
            16, ["c"]), {"c": mixed}),
        "hashing_wide_rows": (lambda m: m.HashingTransformer(4096, ["c"]),
                              {"c": np.eye(2, 2000, 500, np.float32)}),
        "string_indexer": (lambda m: m.StringIndexerTransformer("cat"),
                           {"cat": cat}),
        "vector_assembler": (lambda m: m.VectorAssemblerTransformer(
            ["a", "b", "c"]), {"a": rs.randn(4), "b": rs.randint(0, 9, (4, 2)),
                               "c": np.arange(16).reshape(4, 2, 2)}),
    }


TRANSFORM_CASES = _transform_cases()


@pytest.mark.parametrize("case", list(TRANSFORM_CASES))
def test_transformer_matches_jax(case):
    make, cols = TRANSFORM_CASES[case]
    _same_ds(make(jdata)(jdata.Dataset(cols)),
             make(pdata)(pdata.Dataset(cols)))


def test_fitted_transformers_match_jax():
    rs = np.random.RandomState(3)
    train = {"features": (rs.randn(128, 4) * 5 + 3).astype(np.float32),
             "cat": np.array(list("aabbbcd") * 18 + ["e", "e"])}
    serve = {"features": (rs.randn(16, 4) * 9 - 2).astype(np.float32),
             "cat": np.array(list("abcdz") * 3 + ["q"])}
    outs = []
    for m in (jdata, pdata):
        sc = m.StandardScaleTransformer("features").fit(m.Dataset(train))
        keep = m.StringIndexerTransformer(
            "cat", handle_invalid="keep").fit(m.Dataset(train))
        strict = m.StringIndexerTransformer("cat").fit(m.Dataset(train))
        with pytest.raises(ValueError, match="unseen"):
            strict(m.Dataset(serve))
        with pytest.raises(ValueError, match="handle_invalid"):
            m.StringIndexerTransformer("cat", handle_invalid="skip")
        with pytest.raises(ValueError, match="out of range"):
            m.OneHotTransformer(3)(m.Dataset({"label": np.arange(4)}))
        outs.append((sc(m.Dataset(serve)), keep(m.Dataset(serve)),
                     list(keep.labels_)))
    _same_ds(outs[0][0], outs[1][0])
    _same_ds(outs[0][1], outs[1][1])
    assert outs[0][2] == outs[1][2] == ["b", "a", "c", "d", "e"]
    assert outs[1][1]["cat_index"][-1] == 5            # "keep": unseen


# --- Dataset methods ---------------------------------------------------------------


def _dataset_ops():
    rs = np.random.RandomState(5)
    cols = {"features": rs.randn(10, 3).astype(np.float32),
            "label": rs.randint(0, 3, 10), "id": np.arange(10)}
    mask = rs.rand(10) > 0.5
    return cols, {
        "from_records": lambda m, ds: m.Dataset.from_records(
            [{"x": 1, "y": 2.0, "s": "a"}, {"x": 3, "y": 4.0, "s": "bc"}]),
        "select": lambda m, ds: ds.select(["label", "id"]),
        "drop": lambda m, ds: ds.drop("id"),
        "shuffle": lambda m, ds: ds.shuffle(seed=3),
        "filter_mask": lambda m, ds: ds.filter(mask),
        "filter_callable": lambda m, ds: ds.filter(
            lambda d: d["label"] == 1),
        "map_column": lambda m, ds: ds.map_column("features", np.tanh,
                                                  "t"),
        "take_skip_split_concat": lambda m, ds: ds.split(0.7)[0].concat(
            ds.take(2)).skip(1),
        "with_column": lambda m, ds: ds.with_column("label", np.ones(10)),
    }


DATASET_COLS, DATASET_OPS = _dataset_ops()


@pytest.mark.parametrize("op", list(DATASET_OPS))
def test_dataset_method_matches_jax(op):
    fn = DATASET_OPS[op]
    _same_ds(fn(jdata, jdata.Dataset(DATASET_COLS)),
             fn(pdata, pdata.Dataset(DATASET_COLS)))


@pytest.mark.parametrize("drop", [True, False])
def test_batches_match_jax(drop):
    got = list(pdata.Dataset(DATASET_COLS).batches(3, drop_remainder=drop))
    ref = list(jdata.Dataset(DATASET_COLS).batches(3, drop_remainder=drop))
    assert len(got) == len(ref) == (3 if drop else 4)
    for (jx, jy), (px, py) in zip(ref, got):
        _same(jx, px)
        _same(jy, py)
        assert px.flags["C_CONTIGUOUS"]


def test_dataset_errors_match_jax():
    for m in (jdata, pdata):
        ds = m.Dataset(DATASET_COLS)
        with pytest.raises(ValueError, match="bool"):
            ds.filter(np.arange(10))
        with pytest.raises(ValueError, match="bool"):
            ds.filter(np.array([True, False]))
        with pytest.raises(ValueError, match="empty"):
            m.Dataset.from_records([])
        with pytest.raises(KeyError, match="available"):
            ds.select(["nope"])


def test_from_pandas_and_parquet_match_jax(tmp_path):
    pd = pytest.importorskip("pandas")
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq
    rs = np.random.RandomState(6)
    X = rs.randn(32, 4).astype(np.float32)
    y = rs.randint(0, 3, 32)
    df = pd.DataFrame({"label": y, "category": np.array(
        ["a", "b", "c", "a"] * 8, dtype=object)})
    _same_ds(jdata.Dataset.from_pandas(df), pdata.Dataset.from_pandas(df))
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"features": pa.array(list(X)),
                             "label": pa.array(y)}), path)
    _same_ds(jdata.Dataset.from_parquet(path),
             pdata.Dataset.from_parquet(path))
    _same_ds(jdata.Dataset.from_parquet(path, columns=["label"]),
             pdata.Dataset.from_parquet(path, columns=["label"]))


# --- adapters ----------------------------------------------------------------------


def _iterable_cases():
    rs = np.random.RandomState(7)
    feats = rs.randn(6, 4).astype(np.float32)
    return {
        "pairs": [(feats[i], i % 3) for i in range(6)],
        "dicts": [{"a": feats[i, :2], "b": i, "s": f"v{i % 2}"}
                  for i in range(6)],
        "bare_rows": [list(feats[i]) for i in range(6)],
        "torch_pairs": [(torch.from_numpy(feats[i]), torch.tensor(i))
                        for i in range(6)],
    }


ITERABLE_CASES = _iterable_cases()


@pytest.mark.parametrize("case", list(ITERABLE_CASES))
def test_from_iterable_matches_jax(case):
    rows = ITERABLE_CASES[case]
    _same_ds(jdata.from_iterable(rows), pdata.from_iterable(rows))


def test_from_iterable_errors_match_jax():
    for m in (jdata, pdata):
        with pytest.raises(ValueError, match="empty"):
            m.from_iterable([])
        with pytest.raises(ValueError, match="mixed dict"):
            m.from_iterable([{"a": 1}, (np.zeros(2), 1)])
        with pytest.raises(ValueError, match="pairs"):
            m.from_iterable([(1, 2, 3)])


def _torch_sources():
    from torch.utils.data import (BatchSampler, DataLoader,
                                  SequentialSampler, TensorDataset)
    g = torch.Generator().manual_seed(0)
    X = torch.randn(32, 6, generator=g)
    y = torch.randint(0, 3, (32,), generator=g)
    tds = TensorDataset(X, y)
    return {
        "map_style": (lambda: tds, {}),
        "map_style_limit": (lambda: tds, dict(limit=7)),
        "loader_ragged": (lambda: DataLoader(tds, batch_size=10), {}),
        "loader_limit": (lambda: DataLoader(tds, batch_size=10),
                         dict(limit=15)),
        "loader_batch_size_none": (lambda: DataLoader(tds, batch_size=None),
                                   {}),
        "loader_batch_sampler": (lambda: DataLoader(
            tds, batch_sampler=BatchSampler(SequentialSampler(tds), 4,
                                            False)), {}),
        "features_only": (lambda: TensorDataset(X), dict(limit=5)),
    }


TORCH_SOURCES = _torch_sources()


@pytest.mark.parametrize("case", list(TORCH_SOURCES))
def test_from_torch_matches_jax(case):
    make, kw = TORCH_SOURCES[case]
    ref = jdata.from_torch(make(), **kw)
    got = pdata.from_torch(make(), **kw)
    _same_ds(ref, got)
    if "limit" in kw:
        assert len(got) == kw["limit"]


# --- real digits -------------------------------------------------------------------


def _same_real(a, b):
    assert a.name == b.name and a.num_classes == b.num_classes
    assert a.is_real == b.is_real
    for x, y in zip(a[:4], b[:4]):
        _same(x, y)


def test_load_real_digits_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("DKT_MNIST_NPZ", str(tmp_path / "missing.npz"))
    # scikit-learn's digits when it is installed, else the flagged set
    _same_real(jreal.load_real_digits(seed=3), preal.load_real_digits(seed=3))
    rs = np.random.RandomState(8)
    npz = tmp_path / "mnist.npz"
    np.savez(npz, x_train=rs.randint(0, 256, (20, 28, 28), np.uint8),
             y_train=rs.randint(0, 10, 20),
             x_test=rs.randint(0, 256, (6, 28, 28), np.uint8),
             y_test=rs.randint(0, 10, 6))
    monkeypatch.setenv("DKT_MNIST_NPZ", str(npz))
    got = preal.load_real_digits()
    assert got.name == "mnist" and got.x_train.shape == (20, 784)
    _same_real(jreal.load_real_digits(), got)
    monkeypatch.setenv("DKT_MNIST_NPZ", str(tmp_path / "missing.npz"))
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    got = preal.load_real_digits(test_fraction=0.25, seed=1)
    assert got.name == "synthetic" and not got.is_real
    _same_real(jreal.load_real_digits(test_fraction=0.25, seed=1), got)


# --- the slice as a whole: BASELINE config 4 ---------------------------------------

ROWS, BUCKETS, DEEP, WORKERS, BATCH = 2048, 256, (32, 16), 2, 64


@pytest.fixture(scope="module")
def criteo(tmp_path_factory):
    """Config 4's stand-in at 2,048 rows through both packages' ingest."""
    path = str(tmp_path_factory.mktemp("criteo") / "counts.tsv")
    cats = chip_smoke.criteo_standin(path, rows=ROWS)
    with open(path) as f:
        assert f.readline().count("\t") == chip_smoke.CRITEO_COUNTS
    return (chip_smoke.criteo_ingest(jdata, path, cats, buckets=BUCKETS),
            chip_smoke.criteo_ingest(pdata, path, cats, buckets=BUCKETS))


def test_config4_ingest_is_bitwise_jax(criteo):
    jds, pds = criteo
    _same_ds(jds, pds)
    X = pds["features"]
    assert X.shape == (ROWS, BUCKETS + chip_smoke.CRITEO_COUNTS)
    assert X.dtype == np.float32 and np.isfinite(X).all()
    # each row sets one bucket per categorical column at most (collisions
    # merge), and the deep half lies in [0, 1]
    wide, deep = X[:, :BUCKETS], X[:, BUCKETS:]
    assert ((wide.sum(1) >= 1) & (wide.sum(1) <= chip_smoke.CRITEO_CATS)
            ).all()
    assert deep.min() == 0.0 and deep.max() == 1.0
    assert abs(pds["label"].mean() - chip_smoke.CRITEO_POSITIVE) < 0.01


def test_config4_downpour_matches_jax(criteo):
    jds, pds = criteo
    kw = dict(num_workers=WORKERS, batch_size=BATCH,
              communication_window=chip_smoke.CRITEO_WINDOW,
              commit_scale=1.0 / WORKERS, num_epoch=2,
              worker_optimizer="adam",
              learning_rate=chip_smoke.CRITEO_LR, loss=LOSS)
    shape = (BUCKETS + chip_smoke.CRITEO_COUNTS,)
    jm = JaxModel.build(jzoo.wide_and_deep(BUCKETS, DEEP, 2), shape, seed=0)
    pm = from_jax_params(Model.build(pzoo.wide_and_deep(BUCKETS, DEEP, 2),
                                     shape, seed=0, device="cpu"),
                         jax.device_get(jm.params))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt = jax_parallel.DOWNPOUR(jm, **kw)
        jm = jt.train(jds)
        pt = parallel.DOWNPOUR(pm, **kw)
        pm = pt.train(pds)
    np.testing.assert_allclose(pt.get_history().losses(),
                               np.asarray(jt.get_history().losses()),
                               rtol=REL_TOL)
    ref = jax.tree_util.tree_leaves(jax.device_get(jm.params))
    got = jax.tree_util.tree_leaves(to_jax_params(pm))
    for r, g in zip(ref, got):
        assert np.max(np.abs(np.asarray(r) - g)) <= REL_TOL * np.max(
            np.abs(r))
    js = JaxPredictor(jm, output_col="prediction").predict(jds)
    ps = ModelPredictor(pm, output_col="prediction").predict(pds)
    jidx = jdata.LabelIndexTransformer()(js)
    pidx = pdata.LabelIndexTransformer()(ps)
    differ = int((jidx["predicted_index"] != pidx["predicted_index"]).sum())
    assert differ <= 2, differ
    jacc = JaxAccuracy(prediction_col="predicted_index").evaluate(jidx)
    pacc = AccuracyEvaluator(prediction_col="predicted_index").evaluate(pidx)
    assert abs(jacc - pacc) <= 2 / ROWS
    jauc = JaxEvaluator("auc").evaluate(js)
    pauc = Evaluator("auc").evaluate(ps)
    assert abs(jauc - pauc) <= 1e-3 and pauc > 0.6, (jauc, pauc)
