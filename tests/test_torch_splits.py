"""The splits of the redesigned K5, K3 and K2 on the CPU.

``split_plan`` of each kernel is a function of the shapes and the SM
count alone (K3's and K2's never see the position ``t``): every weight
byte row, every logical page and every cache position lands in exactly
one split, and the grid fills the card. The kernels' split-and-merge
arithmetic, in plain PyTorch (``split_matmul_reference``,
``paged_decode_split_reference``, ``decode_split_reference``), agrees
with the JAX package's functions as its own tests run them: the Pallas
kernels in interpret mode (or JAX's reference branch where the Pallas
gates refuse a shape), inputs made with numpy from a seed.
"""

import inspect
import itertools
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distkeras_tpu.models import decoding as jd
from distkeras_tpu.ops import quant_matmul as jqm
from distkeras_tpu.ops.decode_attention import \
    decode_attention as jax_decode_attention
from distkeras_tpu.ops.paged_attention import \
    paged_decode_attention as jax_paged

import distkeras_tpu_torch.ops.decode_attention  # noqa: F401
import distkeras_tpu_torch.ops.paged_attention  # noqa: F401
import distkeras_tpu_torch.ops.quant_matmul  # noqa: F401
from distkeras_tpu_torch.models import qtree_from_jax
from distkeras_tpu_torch.serving import tree_ancestors

# the modules themselves (``ops`` re-exports functions of the same names)
da = sys.modules["distkeras_tpu_torch.ops.decode_attention"]
pa = sys.modules["distkeras_tpu_torch.ops.paged_attention"]
qm = sys.modules["distkeras_tpu_torch.ops.quant_matmul"]

#: float32 agreement of the split merge with the Pallas online softmax
SPLIT_TOL = 1e-5
#: float32 matmuls over K <= 512 summed in two orders (relative)
MM_TOL = 1e-5

SMS = (132, 114, 16)


# --- K5 ----------------------------------------------------------------------


@pytest.mark.parametrize("num_sms", SMS)
@pytest.mark.parametrize("tensor_cores", [False, True])
def test_quant_matmul_split_plan_covers_every_row_once(num_sms,
                                                       tensor_cores):
    for m in (1, 2, 3, 4, 5, 8, 9, 16, 72, 256):
        for k_rows, n in ((1024, 4096), (512, 4096), (1024, 1024),
                          (4096, 1024), (1024, 32768), (1000, 1000),
                          (18, 12)):
            plan = qm.split_plan(m, k_rows, n, num_sms,
                                 tensor_cores=tensor_cores)
            assert plan == qm.split_plan(m, k_rows, n, num_sms,
                                         tensor_cores=tensor_cores)
            route, tile, ksplit, kchunk = plan
            assert kchunk % qm.STAGE_ROWS == 0
            # byte row r lies in split r // kchunk, and no split is empty
            assert (ksplit - 1) * kchunk < k_rows <= ksplit * kchunk
            # one cluster holds a column tile's splits
            assert 1 <= ksplit <= qm.MAX_SPLIT
            if route == 1:
                assert tensor_cores and m >= qm.TC_MIN_ROWS
                assert 1 <= tile <= min(qm.TC_MAX_TILES, -(-m // 16))
            else:
                assert tile in qm.M_TILES and tile >= min(m, 8)


@pytest.mark.parametrize("num_sms", SMS)
def test_quant_matmul_split_plan_fills_the_card(num_sms):
    """The engine's decode shapes (M4, the LM's matrices) and the tree
    verify's (M72) put a block on (nine in ten or more of) the SMs, as far
    as the K split's cluster and its whole stages allow."""
    for m in (4, 72):
        for k_rows, n in ((1024, 4096), (512, 4096), (1024, 1024),
                          (4096, 1024), (1024, 32768), (512, 32768)):
            route, tile, ksplit, _ = qm.split_plan(m, k_rows, n, num_sms,
                                                   tensor_cores=True)
            rows = 16 * tile if route == 1 else tile
            tiles = -(-n // qm.BLOCK_N) * -(-m // rows)
            assert (route, tile) == ((0, 4) if m == 4 else (route, tile))
            assert tiles * ksplit >= 0.9 * min(
                num_sms, tiles * min(qm.MAX_SPLIT,
                                     k_rows // qm.STAGE_ROWS))


def _qmm_case(rs, bits, layout, k, n, m):
    if layout == "proj":                         # [d, h, e] -> [d, h*e]
        w = rs.randn(k, 4, n // 4).astype(np.float32)
        wq = jqm.quantize_weight(w, bits, reduce_axes=(0,))
    else:                                        # [h, e, d] -> [h*e, d]
        w = rs.randn(4, k // 4, n).astype(np.float32)
        wq = jqm.quantize_weight(w, bits, reduce_axes=(0, 1))
    return rs.randn(m, k).astype(np.float32), wq


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("layout,k,n,m", [("proj", 512, 256, 5),
                                          ("out", 256, 128, 9),
                                          ("proj", 200, 36, 3)])
def test_quant_matmul_split_sum_matches_jax(bits, layout, k, n, m):
    """K5's ordered split-K sum (each chunk of byte rows contracted, the
    partials added in split order, then scaled) at several split counts,
    the plan's own among them, against JAX ``quant_matmul``: the Pallas
    kernel in interpret mode on aligned shapes, its reference branch on
    the rest."""
    rs = np.random.RandomState(21)
    x, wq = _qmm_case(rs, bits, layout, k, n, m)
    with jqm.force_interpret():
        theirs = np.asarray(jqm.quant_matmul(jnp.asarray(x), wq))
    tw = qtree_from_jax(wq, device="cpu")
    k_rows = k // 2 if bits == 4 else k
    _, _, ksplit, kchunk = qm.split_plan(m, k_rows, n, 132,
                                         tensor_cores=False)
    splits = {(ksplit, kchunk), (1, k_rows)}
    splits |= {(-(-k_rows // c), c) for c in (64, 128) if c < k_rows}
    for ks, kc in sorted(splits):
        ours = qm.split_matmul_reference(torch.from_numpy(x), tw, ks,
                                         kc).numpy()
        assert ours.shape == (m, n)
        assert _rel(ours, theirs) <= MM_TOL, (ks, kc)


# --- K3 ----------------------------------------------------------------------


def test_paged_split_plan_ignores_t_and_covers_every_page_once():
    assert "t" not in inspect.signature(pa.split_plan).parameters
    for num_sms in SMS:
        for rows in (1, 4, 32, 64, 128, 1024):
            for (pages, page_len), window in itertools.product(
                    ((128, 16), (4, 8), (300, 4), (5, 256), (2048, 1),
                     (1, 16)), (None, 1, 6, 256)):
                nsplit, pps = pa.split_plan(rows, pages, page_len, num_sms,
                                            window=window, w_len=9)
                assert 1 <= pps <= pa.MAX_SPLIT_PAGES
                owner = np.arange(pages) // pps
                assert owner.max() == nsplit - 1   # no split left empty
                cpages = max(1, pa.CHUNK_POSITIONS // page_len)
                assert pps % cpages == 0 or pps == pa.MAX_SPLIT_PAGES \
                    or nsplit == 1


def test_paged_split_plan_fills_the_card():
    """The serving engine's decode (4 slots x 16 kv heads, 128 pages of
    16) and phase 4's 8 slots: enough splits for every SM, one chunk of
    positions or more each."""
    for rows in (4 * 16, 8 * 16, 8 * 4):
        nsplit, pps = pa.split_plan(rows, 128, 16, 132)
        assert rows * nsplit >= 2 * 132 and pps * 16 >= 128
    assert pa.split_plan(64, 128, 16, 132) == (16, 8)
    assert pa.split_plan(128, 128, 16, 132) == (8, 16)
    # a 256-position window: the splits cut its 18 pages, not the table
    assert pa.split_plan(128, 128, 16, 132, window=256) == (16, 8)


N_PAGES = 20
#: 8 logical pages a slot; sentinel (= N) entries, one in the middle
TABLE = np.array([[7, 2, 9, 12, 15, 1, 20, 20],
                  [0, 5, 20, 20, 20, 20, 20, 20],
                  [3, 11, 20, 6, 8, 10, 13, 14],
                  [20, 20, 20, 20, 20, 20, 20, 20]], np.int32)
#: slot 3 is free: its position is past capacity, its pages sentinels
T_POS = np.array([20, 7, 30, 40], np.int32)


def _quant_pages(rs, bits, hkv, page_len, d):
    out = []
    for _ in range(2):
        x = jnp.asarray(rs.randn(N_PAGES, hkv, page_len, d), jnp.float32)
        q, sc = jd._quantize_kv(x, bits)
        out.append((np.array(jd.pack_int4(q) if bits == 4 else q),
                    np.array(sc)))
    return out


def _trees(rs, s, w):
    parents = np.full((s, w), -1, np.int64)
    for i in range(s):
        for j in range(1, rs.randint(1, w + 1)):
            parents[i, j] = rs.randint(0, j)
    return tree_ancestors(parents)[1]


SPLIT_CASES = {
    # name: (bits, page_len, g, w_len, window, tree)
    "float": (None, 8, 1, 1, None, False),
    "gqa_verify": (None, 8, 4, 3, None, False),
    # slot 2's window (24, 30] empties its leading splits
    "window": (None, 8, 2, 2, 6, False),
    "tree": (None, 8, 2, 5, None, True),
    "tree_window": (None, 8, 1, 4, 5, True),
    "int8": (8, 32, 2, 2, None, False),
    "int4": (4, 64, 1, 3, 40, False),
    "int4_tree": (4, 64, 2, 4, None, True),
}


@pytest.mark.parametrize("pps", [1, 2, 3, 8])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_paged_split_merge_matches_pallas(case, pps):
    """K3's split-and-merge at 8, 4, 3 and 1 splits against JAX
    ``paged_decode_attention`` (the Pallas kernel in interpret mode),
    every slot included: wholly masked splits past a short context,
    a window that empties the leading splits, a sentinel page inside a
    live range, the free slot (every page a sentinel: no split reaches
    its rows, which come out 0), int8 and packed int4 pages, and tree
    masks."""
    bits, page_len, g, w_len, window, tree = SPLIT_CASES[case]
    rs = np.random.RandomState(31)
    if bits is None:
        kp, vp = (rs.randn(N_PAGES, 2, page_len, 16).astype(np.float32)
                  for _ in range(2))
        ks = vs = None
    else:
        (kp, ks), (vp, vs) = _quant_pages(rs, bits, 2, page_len, 16)
    q = rs.randn(4, w_len, 2, g, 16).astype(np.float32)
    t = (T_POS * page_len // 8).astype(np.int32)
    anc = _trees(rs, 4, w_len) if tree else None
    scale = 16 ** -0.5
    jkw = dict(scale=scale, window=window, interpret=True)
    if bits is not None:
        jkw.update(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    if tree:
        jkw["anc"] = jnp.asarray(anc)
    ref = np.asarray(jax_paged(jnp.asarray(q), jnp.asarray(kp),
                               jnp.asarray(vp), jnp.asarray(t),
                               jnp.asarray(TABLE), **jkw))
    to = torch.from_numpy
    pkw = dict(scale=scale, window=window, pps=pps)
    if bits is not None:
        pkw.update(k_scale=to(ks), v_scale=to(vs))
    if tree:
        pkw["anc"] = to(anc)
    out = pa.paged_decode_split_reference(to(q), to(kp), to(vp), to(t),
                                          to(TABLE), **pkw).numpy()
    assert np.all(out[3] == 0)
    np.testing.assert_allclose(out, ref, atol=SPLIT_TOL, rtol=0)


# --- K2 ----------------------------------------------------------------------


def test_decode_split_plan_ignores_t_and_covers_every_position_once():
    """Split ``z`` owns positions ``[z * chunk, (z + 1) * chunk)``, whole
    chunks of the kernel's (32, 64 or 128 positions): every position of
    the cache lies in exactly one split, none lies past the cache's end,
    and at every ``t`` the live splits (those meeting ``[lo, t]``) fit
    the partials workspace ``live_splits`` sizes."""
    assert "t" not in inspect.signature(da.split_plan).parameters
    assert [da.chunk_positions(d, e) for d, e in (
        (64, 2), (64, 1), (64, 4), (128, 2), (32, 1), (128, 4))] == [
        64, 128, 32, 32, 128, 32]
    for num_sms, unit in itertools.product(SMS, (32, 64, 128)):
        for rows in (1, 4, 16, 64, 128, 1024):
            for length, window in itertools.product(
                    (1, 40, 128, 129, 1152, 4097, 100000),
                    (None, 1, 100, 256, 5000)):
                nsplit, chunk = da.split_plan(rows, length, num_sms,
                                              window=window, unit=unit)
                assert chunk % unit == 0
                owner = np.arange(length) // chunk
                assert owner.max() == nsplit - 1
                live = da.live_splits(nsplit, chunk, window)
                for t in {0, 1, length // 3, length - 2, length - 1}:
                    if not 0 <= t < length:
                        continue
                    lo, hi = da.valid_range(t, window)
                    assert 1 <= hi // chunk - lo // chunk + 1 <= live


@pytest.mark.parametrize("unit", [64, 128], ids=["bf16", "int8"])
@pytest.mark.parametrize("num_sms", SMS)
def test_decode_split_plan_fills_the_card(num_sms, unit):
    """generate()'s rows (4 x 4 and 4 x 16 kv heads, 8 x 16) at the end
    of a 1152-4096 position cache, with and without a 256-position
    window, in chunks of a bf16 and an int8 cache at D64: the live
    splits put a block on every SM, or on as many as whole chunks of the
    attended positions allow."""
    for rows, length, window in itertools.product(
            (16, 64, 128), (1152, 2048, 4096), (None, 256)):
        nsplit, chunk = da.split_plan(rows, length, num_sms, window=window,
                                      unit=unit)
        lo, hi = da.valid_range(length - 1, window)
        n_live = hi // chunk - lo // chunk + 1
        units = -(-(hi - lo + 1) // unit)
        assert rows * n_live >= min(num_sms, rows * units), \
            (rows, length, window)
    # generate()'s shape: 9 splits of 128 positions on a full card
    want = (9, 128) if num_sms > 16 else {64: (2, 576), 128: (2, 640)}[unit]
    assert da.split_plan(64, 1152, num_sms, unit=unit) == want


L_SLAB = 48
DECODE_SPLIT_CASES = {
    # name: (g, t, window, bits)
    "float": (1, 40, None, None),
    "gqa": (4, 37, None, None),
    # [36, 45]: the window empties the leading splits
    "window": (2, 45, 10, None),
    "t0": (1, 0, None, None),
    # t early in the cache: most splits dead
    "early": (2, 5, None, None),
    "int8": (2, 30, None, 8),
    "int4": (1, 44, 20, 4),
}


@pytest.mark.parametrize("chunk", [48, 24, 16, 6],
                         ids=["1split", "2splits", "3splits", "8splits"])
@pytest.mark.parametrize("case", list(DECODE_SPLIT_CASES))
def test_decode_split_merge_matches_pallas(case, chunk):
    """K2's split-and-merge at 1, 2, 3 and 8 splits of a 48-position
    cache against JAX ``decode_attention`` (the Pallas kernel in
    interpret mode, 8-position blocks): float32, GQA G4, a window that
    empties the leading splits, ``t`` = 0 and ``t`` early in the cache
    (most splits dead), int8 and int4-in-int8 caches."""
    g, t, window, bits = DECODE_SPLIT_CASES[case]
    rs = np.random.RandomState(41)
    q = rs.randn(3, g, 16).astype(np.float32)
    k, v = (rs.randn(3, L_SLAB, 16).astype(np.float32) for _ in range(2))
    scale = 16 ** -0.5
    jsc, tsc = {}, {}
    if bits is not None:
        (k, ks), (v, vs) = (tuple(np.array(a) for a in jd._quantize_kv(
            jnp.asarray(x), bits)) for x in (k, v))
        jsc = {"k_scale": jnp.asarray(ks), "v_scale": jnp.asarray(vs)}
        tsc = {"k_scale": torch.from_numpy(ks),
               "v_scale": torch.from_numpy(vs)}
    ref = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), t, scale=scale,
        window=window, block_l=8, interpret=True, **jsc))
    to = torch.from_numpy
    out = da.decode_split_reference(to(q), to(k), to(v), t, scale=scale,
                                    chunk=chunk, window=window, **tsc)
    assert out.dtype == torch.float32 and out.shape == (3, g, 16)
    np.testing.assert_allclose(out.numpy(), ref, atol=SPLIT_TOL, rtol=0)
