"""The port's speculative-decoding pieces against the JAX package's: the
tree ancestor mask of the paged decode kernel (K3-anc), the tree
helpers and the n-gram draft, the verify window (linear and tree) over
the paged pool, the acceptance walk and the accepted-path commit.

On the CPU the port's kernel wrapper runs its plain PyTorch version;
the JAX side runs the Pallas kernel in interpret mode, as
``tests/test_spec_tree.py`` does, and its CPU path (the page-gather
readout) for the verify window. Inputs are made with numpy from a seed
and handed to both; weights cross with ``from_jax_params``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distkeras_tpu.models import Model as JaxModel
from distkeras_tpu.models import decoding as jd
from distkeras_tpu.models import zoo as jax_zoo
from distkeras_tpu.ops.paged_attention import \
    paged_decode_attention as jax_paged
from distkeras_tpu.serving import speculation as js

from distkeras_tpu_torch.models import Model, decoding as pd, \
    from_jax_params, zoo
from distkeras_tpu_torch.ops.paged_attention import (
    check_rows, paged_decode_attention, paged_decode_attention_reference)
from distkeras_tpu_torch.serving import speculation as ps

#: float32 agreement of two summation orders (the Pallas kernel sums one
#: page at a time with an online softmax, the plain version a whole row)
F32_TOL = 2e-5
#: int8/int4 pages dequantize to values up to ~3: the same reassociation
#: on larger magnitudes
Q_TOL = 1e-4

N_PAGES = 12
TABLE = np.array([[7, 2, 9, 12], [0, 5, 12, 12], [3, 1, 4, 6],
                  [12, 12, 12, 12]], np.int32)
#: in units of page_len / 8; the last slot is free (past capacity)
T8 = np.array([20, 11, 26, 32], np.int32)


def _tree(rs, s_n, w_len, min_used=1):
    """Random topologically ordered trees: ``n`` used nodes each hanging
    off an earlier node, the rest unused (parent -1)."""
    parents = np.full((s_n, w_len), -1, np.int32)
    for s in range(s_n):
        n = rs.randint(min_used, w_len + 1)
        for j in range(1, n):
            parents[s, j] = rs.randint(0, j)
    return parents


def _pages(rs, bits, hkv, page_len, d):
    """Random float pages, or pages quantized as the pool stores them
    (int4 packed), with their scale planes."""
    out = []
    for _ in range(2):
        x = rs.randn(N_PAGES, hkv, page_len, d).astype(np.float32)
        if bits is None:
            out.append((x, None))
            continue
        q, sc = jd._quantize_kv(jnp.asarray(x), bits)
        out.append((np.array(jd.pack_int4(q) if bits == 4 else q),
                    np.array(sc)))
    return out


# --- K3-anc: the plain version against the Pallas kernel ---------------------


@pytest.mark.parametrize("bits,page_len", [(None, 8), (8, 32), (4, 64)])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("g", [1, 4])
def test_anc_plain_matches_pallas(g, window, bits, page_len):
    """Random trees over scrambled tables with sentinel entries, float,
    int8 and packed int4 pages (page_len as the Pallas kernel tiles
    them). Tolerance 2e-5 (float) / 1e-4 (quantized): summation order
    only; the free slot's rows are garbage on both sides."""
    rs = np.random.RandomState(21)
    w_len = 5
    (kp, ks), (vp, vs) = _pages(rs, bits, 2, page_len, 16)
    q = rs.randn(4, w_len, 2, g, 16).astype(np.float32)
    t = T8 * page_len // 8
    _, anc, _ = js.tree_ancestors(_tree(rs, 4, w_len))
    sc_j, sc_p = {}, {}
    if bits is not None:
        sc_j = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        sc_p = dict(k_scale=torch.from_numpy(ks),
                    v_scale=torch.from_numpy(vs))
    ref = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                    jnp.asarray(t), jnp.asarray(TABLE), scale=0.25,
                    window=window, anc=jnp.asarray(anc), interpret=True,
                    **sc_j)
    to = torch.from_numpy
    out = paged_decode_attention(to(q), to(kp), to(vp), to(t), to(TABLE),
                                 scale=0.25, window=window, anc=to(anc),
                                 **sc_p)
    np.testing.assert_allclose(out.numpy()[:3], np.asarray(ref)[:3],
                               atol=F32_TOL if bits is None else Q_TOL)


@pytest.mark.parametrize("bits", [None, 8, 4])
@pytest.mark.parametrize("window", [None, 3])
def test_chain_anc_equals_the_window_causal_mask_bitwise(window, bits):
    """A lower-triangular ``anc`` is the window-causal mask: the same
    output, bit for bit."""
    rs = np.random.RandomState(22)
    (kp, ks), (vp, vs) = _pages(rs, bits, 2, 8, 16)
    q = torch.from_numpy(rs.randn(4, 4, 2, 2, 16).astype(np.float32))
    sc = {} if bits is None else dict(k_scale=torch.from_numpy(ks),
                                      v_scale=torch.from_numpy(vs))
    args = (q, torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(T8), torch.from_numpy(TABLE))
    chain = torch.tril(torch.ones(4, 4, dtype=torch.bool)).expand(4, 4, 4)
    a = paged_decode_attention(*args, window=window, **sc)
    b = paged_decode_attention(*args, window=window, anc=chain.contiguous(),
                               **sc)
    assert torch.equal(a, b)


def test_anc_row_budget_and_reference_signature():
    """The kernel's row budget is W * G <= 64 per kv head; the plain
    version takes ``anc`` by keyword like the wrapper."""
    check_rows(9, 7)
    check_rows(64, 1)
    with pytest.raises(ValueError, match="64 rows per kv head"):
        check_rows(17, 4)
    rs = np.random.RandomState(23)
    (kp, _), (vp, _) = _pages(rs, None, 1, 8, 8)
    q = torch.zeros(4, 2, 1, 1, 8)
    out = paged_decode_attention_reference(
        q, torch.from_numpy(kp), torch.from_numpy(vp), torch.from_numpy(T8),
        torch.from_numpy(TABLE), scale=1.0,
        anc=torch.ones(4, 2, 2, dtype=torch.bool))
    assert out.shape == q.shape


# --- tree helpers and the n-gram draft: exactly JAX's ------------------------


def test_tree_ancestors_and_build_token_tree_equal_jax():
    rs = np.random.RandomState(24)
    parents = _tree(rs, 6, 9)
    for a, b in zip(ps.tree_ancestors(parents), js.tree_ancestors(parents)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    chains = [np.array([5, 6, 7]), np.array([5, 9]), np.array([5, 6, 8]),
              np.array([2, 2, 2, 2])]
    for cap in (2, 3, 5, 7, 20):
        out = []
        for mod in (ps, js):
            toks = np.zeros(8, np.int32)
            par = np.full(8, -1, np.int32)
            used = mod.build_token_tree(chains, toks, par, cap)
            out.append((used, toks, par))
        assert out[0][0] == out[1][0]
        np.testing.assert_array_equal(out[0][1], out[1][1])
        np.testing.assert_array_equal(out[0][2], out[1][2])


def test_ngram_lookup_continuations_and_grow_equal_jax():
    rs = np.random.RandomState(25)
    dp, dj = ps.NgramDraft(max_ngram=3), js.NgramDraft(max_ngram=3)
    head = [11, 7, 19]
    contexts = [np.array(head + [2] + head + [8] + head, np.int32),
                np.array([5, 1, 2, 9, 4, 1, 2, 7, 3, 1, 2], np.int32),
                np.array([1, 2, 3], np.int32),
                rs.randint(0, 6, 40).astype(np.int32)]
    for ctx in contexts:
        for k in (1, 3, 5):
            np.testing.assert_array_equal(dp.lookup(ctx, k),
                                          dj.lookup(ctx, k))
        for m in (0, 1, 2, 3):
            assert dp.continuations(ctx, m) == dj.continuations(ctx, m)
        for depth, width, budget in ((3, 2, 6), (4, 3, 8), (2, 1, 2)):
            got = []
            for d in (dp, dj):
                toks = np.zeros(9, np.int32)
                par = np.full(9, -1, np.int32)
                used = d._grow(ctx, toks, par, depth, width, budget)
                got.append((used, toks, par))
            assert got[0][0] == got[1][0]
            np.testing.assert_array_equal(got[0][1], got[1][1])
            np.testing.assert_array_equal(got[0][2], got[1][2])


# --- the verify window over the paged pool -----------------------------------

V = 37
PAGE_LEN, N_POOL = 4, 14
POOL_TABLE = np.array([[7, 2, 9, 14, 14], [0, 5, 14, 14, 14],
                       [3, 1, 4, 6, 11], [14, 14, 14, 14, 14]], np.int32)
#: slot 0's window runs into an unallocated page (those writes drop);
#: slot 3 is free (its position is past capacity)
POOL_T = np.array([9, 6, 13, 20], np.int32)
CONFIGS = {"mha": {}, "gqa": {"num_kv_heads": 2},
           "gqa-swa": {"num_kv_heads": 2, "attn_window": 5}}


def _pair(cfg):
    kw = dict(d_model=32, num_heads=4, num_layers=2, mlp_ratio=2)
    kw.update(CONFIGS[cfg])
    jm = JaxModel.build(jax_zoo.transformer_lm(V, **kw), (8,), seed=3)
    pm = Model.build(zoo.transformer_lm(V, **kw), (8,), seed=3,
                     device="cpu")
    from_jax_params(pm, jm.params, jm.state)
    jd._resolve_head_dims(jm.module, jm.params)
    return jm, pm


def _pools(pm, rs, cache_dtype):
    """The same random pool on both sides: float pages, or pages
    quantized by the JAX quantizer (int4 packed, with the marker)."""
    jc, pc = [], []
    for layer in pm.module.layers:
        if not isinstance(layer, zoo.TransformerBlock):
            jc.append(None)
            pc.append(None)
            continue
        shape = (N_POOL, layer.attn.kv_heads, PAGE_LEN,
                 layer.attn.head_dim)
        kv = {}
        for key in ("k", "v"):
            x = rs.randn(*shape).astype(np.float32)
            if cache_dtype is None:
                kv[key] = x
                continue
            bits = 4 if cache_dtype == "int4" else 8
            q, sc = jd._quantize_kv(jnp.asarray(x), bits)
            kv[key] = np.array(jd.pack_int4(q) if bits == 4 else q)
            kv[key + "_scale"] = np.array(sc)
        jkv = {k: jnp.asarray(a) for k, a in kv.items()}
        pkv = {k: torch.from_numpy(a.copy()) for k, a in kv.items()}
        if cache_dtype == "int4":
            jkv["q4"] = jnp.zeros((1, 1, 1, 1), jnp.int8)
            pkv["q4"] = True
        jc.append(jkv)
        pc.append(pkv)
    return jc, pc


def _assert_pools(jc, pc, skip=()):
    """Every plane equal to JAX's, but at the ``skip`` (page, offset)
    positions: the columns of unused tree nodes, whose garbage rows use
    the kernel's depth (ancestor count - 1 = -1 for a node with no
    ancestors) where JAX's gather path uses 0 (never read either way)."""
    for jkv, pkv in zip(jc, pc):
        if jkv is None:
            continue
        for key in ("k", "v", "k_scale", "v_scale"):
            if key not in pkv:
                continue
            a, b = pkv[key], torch.from_numpy(np.array(jkv[key]))
            if "q4" in pkv and key in ("k", "v"):
                a, b = pd.unpack_int4(a), pd.unpack_int4(b)
            a, b = a.numpy().copy(), b.numpy()
            for page, off in skip:
                a[page, :, off] = b[page, :, off]
            np.testing.assert_allclose(a, b, atol=F32_TOL)


def _verify_both(jm, pm, jc, pc, toks, tree, t=POOL_T):
    jtree = None if tree is None else {
        "depth": jnp.asarray(tree[0]), "anc": jnp.asarray(tree[1])}
    ptree = None if tree is None else {
        "depth": torch.from_numpy(tree[0]), "anc": torch.from_numpy(tree[1])}
    jout = jd.verify_step_slots_paged(
        jm.module, jm.params, jm.state, jc, jnp.asarray(toks),
        jnp.asarray(t), jnp.asarray(POOL_TABLE), PAGE_LEN, tree=jtree)
    pout = pd.verify_step_slots_paged(
        pm.module, pm.params, pc, torch.from_numpy(toks.astype(np.int64)),
        torch.from_numpy(t), torch.from_numpy(POOL_TABLE), PAGE_LEN,
        tree=ptree)
    return jout, pout


@pytest.mark.parametrize("cache_dtype", [None, "int8", "int4"])
@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("shape", ["linear", "tree"])
def test_verify_step_slots_paged_matches_jax(shape, cfg, cache_dtype):
    """A W=4 window at per-slot positions: the window-causal chain, or a
    random tree (ancestor mask, depth positions). Logits of the live
    slots' used nodes within 2e-5 (float32 reassociation); every pool
    plane equal to JAX's, the dropped writes included."""
    jm, pm = _pair(cfg)
    rs = np.random.RandomState(26)
    jc, pc = _pools(pm, rs, cache_dtype)
    toks = rs.randint(0, V, (4, 4)).astype(np.int32)
    tree = None
    if shape == "tree":
        depth, anc, _ = js.tree_ancestors(_tree(rs, 4, 4, min_used=3))
        tree = (depth, anc)
    jout, pout = _verify_both(jm, pm, jc, pc, toks, tree)
    # rows to compare: used nodes whose visible window columns all lie
    # on allocated pages (JAX reads an unallocated page as the clamped
    # last page, the port masks it: such rows are never consumed)
    anc = np.tril(np.ones((4, 4), bool))[None].repeat(4, 0) \
        if tree is None else tree[1]
    col_pos = POOL_T[:, None] + np.arange(4)
    lp = np.minimum(col_pos // PAGE_LEN, POOL_TABLE.shape[1] - 1)
    live_col = (col_pos // PAGE_LEN < POOL_TABLE.shape[1]) & (
        np.take_along_axis(POOL_TABLE, lp, 1) < N_POOL)
    rows = anc[:, np.arange(4), np.arange(4)] & ~(
        anc & ~live_col[:, None, :]).any(axis=2)
    assert rows.sum() >= 6
    np.testing.assert_allclose(pout[0].numpy()[rows],
                               np.asarray(jout[0])[rows], atol=F32_TOL)
    skip = []
    if tree is not None:
        for s_, j in zip(*np.nonzero(~anc[:, np.arange(4), np.arange(4)])):
            pos = POOL_T[s_] + j
            if pos // PAGE_LEN < POOL_TABLE.shape[1] and \
                    POOL_TABLE[s_, pos // PAGE_LEN] < N_POOL:
                skip.append((POOL_TABLE[s_, pos // PAGE_LEN],
                             pos % PAGE_LEN))
    _assert_pools(jout[1], pout[1], skip)
    if tree is not None:
        for jw, pw in zip(jout[2], pout[2]):
            assert (jw is None) == (pw is None)
            if pw is not None:
                for a, b in zip(pw, jw):
                    np.testing.assert_allclose(a.numpy()[rows],
                                               np.asarray(b)[rows],
                                               atol=F32_TOL)


#: every window column of the live slots on an allocated page (the
#: engine allocates what a walk can reach); slot 3 is free
WALK_T = np.array([8, 3, 12, 20], np.int32)


@pytest.mark.parametrize("cache_dtype", [None, "int4"])
def test_tree_walk_and_commit_match_jax(cache_dtype):
    """Greedy walk over a verified tree (one chain whose nodes are the
    target's own choices, so the walk goes deep) and the commit of the
    accepted path: emitted tokens, counts, paths and every pool plane
    equal to JAX's (the free slot's garbage walk aside)."""
    jm, pm = _pair("gqa")

    def pools():
        return _pools(pm, np.random.RandomState(27), cache_dtype)

    parents = np.array([[-1, 0, 0, 1], [-1, 0, 1, 2], [-1, 0, 0, -1],
                        [-1, -1, -1, -1]], np.int32)
    depth, anc, _ = js.tree_ancestors(parents)
    toks = np.random.RandomState(28).randint(0, V, (4, 4)).astype(np.int32)
    # read the target's choices node by node and plant them: slot 1's
    # chain and slot 0's second root child
    for j in range(3):
        _, pout = _verify_both(jm, pm, *pools(), toks, (depth, anc), WALK_T)
        choice = pout[0].argmax(-1).numpy()
        toks[1, j + 1] = choice[1, j]
        if j == 0:
            toks[0, 2] = choice[0, 0]
    jc, pc = pools()
    jout, pout = _verify_both(jm, pm, jc, pc, toks, (depth, anc), WALK_T)
    em_j, ne_j, path_j, _ = jd.tree_walk(jout[0], jnp.asarray(toks),
                                         jnp.asarray(parents))
    em_p, ne_p, path_p, keys_p = pd.tree_walk(pout[0], toks, parents)
    assert keys_p is None                     # a greedy walk draws nothing
    live = slice(0, 3)
    np.testing.assert_array_equal(ne_p[live], np.asarray(ne_j)[live])
    assert ne_p[1] == 4 and ne_p[0] >= 2
    np.testing.assert_array_equal(path_p[live], np.asarray(path_j)[live])
    np.testing.assert_array_equal(em_p[live], np.asarray(em_j)[live])
    ne_j = np.asarray(ne_j).copy()
    ne_j[3] = ne_p[3] = 0                  # the free slot commits nothing
    jcache = jd.commit_tree_path(jout[1], jout[2], jnp.asarray(path_j),
                                 jnp.asarray(WALK_T), jnp.asarray(ne_j),
                                 table=jnp.asarray(POOL_TABLE),
                                 page_len=PAGE_LEN)
    pcache = pd.commit_tree_path(pout[1], pout[2], path_p,
                                 torch.from_numpy(WALK_T), ne_p,
                                 torch.from_numpy(POOL_TABLE), PAGE_LEN)
    _assert_pools(jcache, pcache)


def test_int4_window_write_keeps_both_nibbles_of_a_shared_byte_row():
    """A window whose positions r and r + page_len/2 share a packed byte
    row: both nibbles land (a one-shot read-modify-write of all columns
    would lose one), bitwise JAX's column-by-column writer."""
    rs = np.random.RandomState(28)
    page_len, w_len = 8, 6
    x = rs.randn(3, 1, page_len, 4).astype(np.float32)
    q, sc = jd._quantize_kv(jnp.asarray(x), 4)
    kv0 = {"k": np.array(jd.pack_int4(q)), "v": np.array(jd.pack_int4(q)),
           "k_scale": np.array(sc), "v_scale": np.array(sc)}
    jkv = {k: jnp.asarray(a) for k, a in kv0.items()}
    jkv["q4"] = jnp.zeros((1, 1, 1, 1), jnp.int8)
    pkv = {k: torch.from_numpy(a.copy()) for k, a in kv0.items()}
    pkv["q4"] = True
    table = np.array([[2, 0]], np.int32)
    t = np.array([1], np.int32)                  # positions 1..6: 1 & 5
    k = rs.randn(1, w_len, 1, 4).astype(np.float32)
    v = rs.randn(1, w_len, 1, 4).astype(np.float32)
    for j in range(w_len):
        jkv = jd._cache_write_pages(jkv, jnp.asarray(k[:, j:j + 1]),
                                    jnp.asarray(v[:, j:j + 1]),
                                    jnp.asarray(t + j), jnp.asarray(table),
                                    page_len)
    index = pd.page_write_index(
        torch.from_numpy(t)[:, None] + torch.arange(w_len),
        torch.from_numpy(table), page_len, 3, split_halves=True)
    pd._cache_write_pages(pkv, torch.from_numpy(k), torch.from_numpy(v),
                          index)
    for key in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(pkv[key].numpy(), np.asarray(jkv[key]))
