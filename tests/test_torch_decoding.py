"""The port's serving decode path against the JAX package's: one-pass
and chunked prefill (logits and the cache they write), the paged decode
step on identical pages and tables, and the sampling mask.

The JAX side runs its CPU path (plain XLA attention and the page-gather
readout); the port runs its plain PyTorch versions. Weights cross with
``from_jax_params``; every input is made with numpy from a seed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distkeras_tpu.models import Model as JaxModel
from distkeras_tpu.models import decoding as jd
from distkeras_tpu.models import zoo as jax_zoo

from distkeras_tpu_torch.models import Model, decoding as pd, \
    from_jax_params, zoo
from distkeras_tpu_torch.ops import prng
from distkeras_tpu_torch.ops.attention import NEG_INF

V = 41
#: float32 reassociation of attention and matmul sums over <= 40 keys
TOL = 1e-4


def _pair(**cfg):
    kw = dict(d_model=32, num_heads=4, num_layers=2, mlp_ratio=2)
    kw.update(cfg)
    jm = JaxModel.build(jax_zoo.transformer_lm(V, **kw), (8,), seed=3)
    pm = Model.build(zoo.transformer_lm(V, **kw), (8,), seed=3,
                     device="cpu")
    from_jax_params(pm, jm.params, jm.state)
    jd._resolve_head_dims(jm.module, jm.params)
    return jm, pm


def _caches(jm, pm, length):
    return (jd.init_cache(jm.module, 1, length, jnp.float32),
            pd.init_cache(pm.module, 1, length, torch.float32, "cpu"))


def _assert_caches(jc, pc, upto):
    for jkv, pkv in zip(jc, pc):
        if jkv is None:
            assert pkv is None
            continue
        for key in ("k", "v"):
            np.testing.assert_allclose(pkv[key][:, :, :upto].numpy(),
                                       np.asarray(jkv[key])[:, :, :upto],
                                       atol=TOL)


CONFIGS = [{}, {"num_kv_heads": 2}, {"num_kv_heads": 2, "attn_window": 5}]
IDS = ["mha", "gqa", "gqa-swa"]


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_prefill_matches_jax(cfg):
    jm, pm = _pair(**cfg)
    prompt = np.random.RandomState(0).randint(0, V, (1, 19)).astype(np.int32)
    jc, pc = _caches(jm, pm, 32)
    jl, jc = jd.prefill(jm.module, jm.params, jm.state, jc,
                        jnp.asarray(prompt))
    pl, pc = pd.prefill(pm.module, pm.params, pc, torch.from_numpy(prompt))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=TOL)
    _assert_caches(jc, pc, 19)


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_prefill_chunk_step_matches_jax(cfg):
    """Three chunks (7, 7, 5 positions): the prefix pass (GQA folded
    into the rows, or the SWA band) and the lse merge on both sides."""
    jm, pm = _pair(**cfg)
    prompt = np.random.RandomState(1).randint(0, V, (1, 19)).astype(np.int32)
    jc, pc = _caches(jm, pm, 32)
    for t0 in (0, 7, 14):
        q_len = min(7, 19 - t0)
        final = t0 + q_len >= 19
        chunk = prompt[:, t0:t0 + q_len]
        jl, jc = jd.prefill_chunk_step(jm.module, jm.params, jm.state, jc,
                                       jnp.asarray(chunk), t0, final=final)
        pl, pc = pd.prefill_chunk_step(pm.module, pm.params, pc,
                                       torch.from_numpy(chunk), t0,
                                       final=final)
        _assert_caches(jc, pc, t0 + q_len)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=TOL)


#: scrambled physical pages, sentinel (= N) entries; slot 3 is free (its
#: position is past capacity) and slot 2 writes a page it owns mid-table
N_PAGES, PAGE_LEN = 14, 4
TABLE = np.array([[7, 2, 9, 14, 14], [0, 5, 14, 14, 14],
                  [3, 1, 4, 6, 11], [14, 14, 14, 14, 14]], np.int32)
T = np.array([10, 6, 17, 20], np.int32)


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_decode_step_slots_paged_matches_jax(cfg):
    jm, pm = _pair(**cfg)
    rs = np.random.RandomState(2)
    jcache, pcache = [], []
    for layer in pm.module.layers:
        if not isinstance(layer, zoo.TransformerBlock):
            jcache.append(None)
            pcache.append(None)
            continue
        shape = (N_PAGES, layer.attn.kv_heads, PAGE_LEN, layer.attn.head_dim)
        kv = {k: rs.randn(*shape).astype(np.float32) for k in ("k", "v")}
        jcache.append({k: jnp.asarray(a) for k, a in kv.items()})
        pcache.append({k: torch.from_numpy(a.copy()) for k, a in kv.items()})
    tok = rs.randint(0, V, 4).astype(np.int32)
    jl, jcache = jd.decode_step_slots_paged(
        jm.module, jm.params, jm.state, jcache, jnp.asarray(tok),
        jnp.asarray(T), jnp.asarray(TABLE), PAGE_LEN)
    pl, pcache = pd.decode_step_slots_paged(
        pm.module, pm.params, pcache, torch.from_numpy(tok),
        torch.from_numpy(T), torch.from_numpy(TABLE), PAGE_LEN)
    np.testing.assert_allclose(pl.numpy()[:3], np.asarray(jl)[:3], atol=TOL)
    for jkv, pkv in zip(jcache, pcache):
        if jkv is not None:
            for key in ("k", "v"):
                np.testing.assert_allclose(pkv[key].numpy(),
                                           np.asarray(jkv[key]), atol=TOL)


def test_masked_logits_candidate_set_matches_jax_with_ties():
    rs = np.random.RandomState(3)
    logits = rs.randint(-4, 4, (6, 50)).astype(np.float32)   # many ties
    temp = np.array([1.0, 0.7, 1.3, 0.0, 1.0, 0.5], np.float32)
    top_k = np.array([5, 0, 3, 4, 1, 7], np.int32)
    top_p = np.array([1.0, 0.6, 0.9, 1.0, 0.3, 0.75], np.float32)
    ref = np.asarray(jd._masked_logits_vec(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p)))
    got = pd._masked_logits_vec(
        torch.from_numpy(logits), torch.from_numpy(temp),
        torch.from_numpy(top_k), torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(got > NEG_INF / 2, ref > NEG_INF / 2)
    keep = ref > NEG_INF / 2
    np.testing.assert_allclose(got[keep], ref[keep], rtol=1e-6)


def test_sample_vec_draws_inside_the_candidate_set():
    """Per-row keys (the engine's) and one key (``generate()``'s): every
    draw equals JAX's ``_sample_vec`` on the same keys, a sampled token
    is a candidate and a greedy row is the argmax."""
    rs = np.random.RandomState(4)
    logits_np = rs.randn(3, 64).astype(np.float32)
    logits = torch.from_numpy(logits_np)
    temp = torch.tensor([0.8, 0.0, 1.5])
    top_k = torch.tensor([5, 0, 0])
    top_p = torch.tensor([1.0, 1.0, 0.5])
    cand = pd._masked_logits_vec(logits, temp, top_k, top_p) > NEG_INF / 2
    jknobs = [jnp.asarray(a.numpy()) for a in (temp, top_k, top_p)]

    out = []
    for i in range(20):
        for keys in (prng.split(prng.key(9 + i), 3), prng.key(9 + i)):
            got = pd._sample_vec(logits, temp, top_k, top_p, keys)
            want = jd._sample_vec(jnp.asarray(logits_np), *jknobs,
                                  jnp.asarray(keys.numpy(), jnp.uint32))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            out.append(got)
    out = torch.stack(out)
    assert torch.all(out[:, 1] == torch.argmax(logits[1]))
    for row in (0, 2):
        assert cand[row, out[:, row]].all()
    assert len(set(out[:, 0].tolist())) > 1      # it does sample


# --- the fixed-shape paged write ---------------------------------------------


def _reference_page_write(kv, k, v, pos, table, page_len, n_pages):
    """The writer the fixed-shape one replaced, entry by entry in
    row-major order: only positions on an allocated page are written.
    Returns the written planes and the live ``(page, offset)`` set."""
    out = {key: kv[key].clone() for key in pd.CACHE_PLANES if key in kv}
    q4 = "q4" in kv
    live = set()
    for s in range(pos.shape[0]):
        for w in range(pos.shape[1]):
            p = int(pos[s, w])
            lp = p // page_len
            if p < 0 or lp >= table.shape[1] or table[s, lp] >= n_pages:
                continue
            page, off = int(table[s, lp]), p % page_len
            live.add((page, off))
            if "k_scale" not in kv:
                out["k"][page, :, off] = k[s, w].to(out["k"].dtype)
                out["v"][page, :, off] = v[s, w].to(out["v"].dtype)
                continue
            for key, skey, x in (("k", "k_scale", k), ("v", "v_scale", v)):
                q, sc = pd._quantize_kv(x[s, w], 4 if q4 else 8)
                out[skey][page, :, off] = sc
                if not q4:
                    out[key][page, :, off] = q
                    continue
                half = page_len // 2
                cur = out[key][page, :, off % half].to(torch.int32) & 255
                nib = q.to(torch.int32) & 15
                b = ((cur & 0x0F) | (nib << 4) if off >= half
                     else (cur & 0xF0) | nib)
                out[key][page, :, off % half] = \
                    (b - 256 * (b > 127).to(torch.int32)).to(torch.int8)
    return out, live


@pytest.mark.parametrize("w_len", [1, 5])
@pytest.mark.parametrize("kind", ["bfloat16", "int8", "int4"])
def test_fixed_shape_page_write_matches_the_live_entry_writer(kind, w_len):
    """Random tables with sentinel entries, a free slot at the engine's
    sentinel position, windows crossing pages and reaching unallocated
    ones: the fixed-shape write (S * W entries, dead ones into the sink)
    is bitwise the live-entry writer on the live positions, and every
    other position of pages 0..N-1 keeps its bytes."""
    rs = np.random.RandomState(31 + w_len)
    n_pages, page_len, hkv, d, s_n, n_logical = 12, 8, 2, 4, 4, 4
    max_len = n_logical * page_len
    shape = (n_pages, hkv, page_len, d)
    if kind == "bfloat16":
        kv = {key: torch.from_numpy(rs.randn(*shape).astype(np.float32))
              .to(torch.bfloat16) for key in ("k", "v")}
    else:
        rows = page_len // 2 if kind == "int4" else page_len
        kv = {key: torch.from_numpy(rs.randint(
            -128, 128, (n_pages, hkv, rows, d)).astype(np.int8))
            for key in ("k", "v")}
        kv.update({key: torch.from_numpy(
            rs.rand(*shape[:3]).astype(np.float32))
            for key in ("k_scale", "v_scale")})
        if kind == "int4":
            kv["q4"] = True
    # distinct physical pages, some logical pages unallocated (sentinel)
    perm = rs.permutation(n_pages)
    table = np.full((s_n, n_logical), n_pages, np.int32)
    table[0, :3] = perm[:3]
    table[1, :2] = perm[3:5]
    table[2, [0, 2]] = perm[5:7]
    t = np.array([6, 12, 3, max_len], np.int64)      # slot 3 is free
    pos = t[:, None] + np.arange(w_len)
    k = torch.from_numpy(rs.randn(s_n, w_len, hkv, d).astype(np.float32))
    v = torch.from_numpy(rs.randn(s_n, w_len, hkv, d).astype(np.float32))
    before = {key: kv[key].clone() for key in pd.CACHE_PLANES if key in kv}
    ref, live = _reference_page_write(kv, k, v, pos, table, page_len,
                                      n_pages)
    assert len(live) >= 2 and len(live) < s_n * w_len
    index = pd.page_write_index(torch.from_numpy(pos),
                                torch.from_numpy(table), page_len, n_pages,
                                split_halves=kind == "int4")
    assert index.pages.shape == (s_n * w_len,)
    pd._cache_write_pages(kv, k, v, index)
    q4 = kind == "int4"
    for key, want in ref.items():
        got, old = kv[key], before[key]
        assert got.shape == old.shape
        if got.dtype == torch.bfloat16:       # compare the bits
            got, want, old = (x.view(torch.int16) for x in (got, want, old))
        assert torch.equal(got, want), key
        if q4 and key in ("k", "v"):           # per position
            got, old = pd.unpack_int4(got), pd.unpack_int4(old)
        keep = torch.ones(got.shape[:3], dtype=torch.bool)
        for page, off in live:
            keep[page, :, off] = False
        assert torch.equal(got[keep], old[keep]), key


#: a fused window's tables: every position a live slot writes in 4 steps
#: lies on an allocated page; slot 3 is free
FUSE_TABLE = np.array([[7, 2, 9, 12, 14], [0, 5, 13, 14, 14],
                       [3, 1, 4, 6, 11], [14, 14, 14, 14, 14]], np.int32)
FUSE_T = np.array([9, 5, 16, 20], np.int32)


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_decode_fused_slots_matches_jax(cfg):
    """A greedy 4-step window on random pages, with a stop token that
    fires inside the window for slot 1: the tokens of the live slots
    equal JAX's ``decode_fused_slots`` (the rest of slot 1's window
    repeats its stop), and the pages hold the same writes."""
    jm, pm = _pair(**cfg)
    rs = np.random.RandomState(5)
    shapes = {}
    for i, layer in enumerate(pm.module.layers):
        if isinstance(layer, zoo.TransformerBlock):
            shapes[i] = (N_PAGES, layer.attn.kv_heads, PAGE_LEN,
                         layer.attn.head_dim)
    planes = {i: {k: rs.randn(*sh).astype(np.float32) for k in ("k", "v")}
              for i, sh in shapes.items()}
    tok = rs.randint(0, V, 4).astype(np.int32)

    def run_jax(stop):
        cache = [None if i not in planes else
                 {k: jnp.asarray(a) for k, a in planes[i].items()}
                 for i in range(len(pm.module.layers))]
        toks, cache, _, _ = jd.decode_fused_slots(
            jm.module, jm.params, jm.state, cache, jnp.asarray(tok),
            jnp.asarray(FUSE_T), jnp.asarray(stop), 4,
            jnp.asarray(FUSE_TABLE), PAGE_LEN)
        return np.asarray(toks), cache

    free_run, _ = run_jax(np.full(4, -1, np.int32))
    stop = np.full(4, -1, np.int32)
    stop[1] = free_run[1, 1]
    jtoks, jcache = run_jax(stop)
    assert (jtoks[1, 1:] == stop[1]).all()
    pcache = [None if i not in planes else
              {k: torch.from_numpy(a.copy()) for k, a in planes[i].items()}
              for i in range(len(pm.module.layers))]
    ptoks, pcache, keys, stats = pd.decode_fused_slots(
        pm.module, pm.params, pcache, torch.from_numpy(tok).long(),
        torch.from_numpy(FUSE_T), torch.from_numpy(stop).long(), 4,
        torch.from_numpy(FUSE_TABLE), PAGE_LEN)
    assert keys is None and stats is None and tuple(ptoks.shape) == (4, 4)
    np.testing.assert_array_equal(ptoks.numpy()[:3], jtoks[:3])
    for jkv, pkv in zip(jcache, pcache):
        if jkv is not None:
            for key in ("k", "v"):
                np.testing.assert_allclose(pkv[key].numpy(),
                                           np.asarray(jkv[key]), atol=TOL)
