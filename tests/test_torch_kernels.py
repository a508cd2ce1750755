"""The port's attention kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the
JAX side runs the Pallas kernels in interpret mode, as the JAX
package's own tests do. Inputs are made with numpy from a seed and
handed to both. Tolerances are float32 reassociation bounds: the
Pallas kernels sum scores blockwise with an online softmax, the plain
versions over the whole row at once.

The CUDA kernels are held against their plain versions on the card by
``test_torch_cuda.py``.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax

from distkeras_tpu.models import decoding as jd
from distkeras_tpu.ops.attention import dot_product_attention as jax_dpa
from distkeras_tpu.ops.decode_attention import \
    decode_attention as jax_decode_attention
from distkeras_tpu.ops.flash_attention import _flash_forward
from distkeras_tpu.ops.flash_attention import \
    flash_attention as jax_flash_attention
from distkeras_tpu.ops.paged_attention import \
    paged_decode_attention as jax_paged

from distkeras_tpu_torch import compat, kernels
from distkeras_tpu_torch.models import Model, decoding as pd, zoo
from distkeras_tpu_torch.ops.attention import dot_product_attention
from distkeras_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_reference, split_plan)
from distkeras_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_forward)
from distkeras_tpu_torch.ops.paged_attention import (check_rows,
                                                     paged_decode_attention)
from distkeras_tpu_torch.serving import PagedKVPool

#: float32 agreement of two summation orders over <= 64 keys of O(1)
#: scores (a few ulps of the row sum, with margin)
F32_TOL = 2e-5


def _qkv(rs, b, sq, sk, h, d, hkv=None):
    hkv = h if hkv is None else hkv
    return (rs.randn(b, sq, h, d).astype(np.float32),
            rs.randn(b, sk, hkv, d).astype(np.float32),
            rs.randn(b, sk, hkv, d).astype(np.float32))


@pytest.mark.parametrize("causal,sq,sk,window", [
    (True, 40, 40, None),        # causal, ragged against the 16-key block
    (False, 24, 37, None),       # non-causal, Sq != Sk, ragged key tail
    (True, 40, 40, 9),           # sliding window
    (True, 19, 19, 3),           # window smaller than a block, ragged
])
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_flash_forward_matches_pallas(causal, sq, sk, window, layout):
    rs = np.random.RandomState(0)
    q, k, v = _qkv(rs, 2, sq, sk, 3, 16)
    if layout == "bhsd":
        q, k, v = (x.transpose(0, 2, 1, 3).copy() for x in (q, k, v))
    scale = 16 ** -0.5
    jo, jl = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            scale, causal, 8, 16, True, layout == "bhsd",
                            window)
    to = torch.from_numpy
    po, pl = flash_forward(to(q), to(k), to(v), scale=scale, causal=causal,
                           window=window, layout=layout)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=F32_TOL)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=F32_TOL,
                               rtol=1e-6)


@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 5)])
def test_plain_attention_matches_jax(causal, window):
    rs = np.random.RandomState(5)
    q, k, v = _qkv(rs, 2, 17, 17, 3, 8)
    ref = jax_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, window=window)
    got = dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=F32_TOL)


@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 5)])
@pytest.mark.parametrize("shape", ["qk", "bhqk"])
def test_plain_attention_mask_matches_jax(causal, window, shape):
    """A boolean ``mask`` (True: allowed), ANDed with causal/window, as
    JAX's ``dot_product_attention(mask=)`` does, broadcast from
    ``[Sq, Sk]`` or given whole as ``[B, H, Sq, Sk]``; rows with every
    key masked included."""
    rs = np.random.RandomState(11)
    q, k, v = _qkv(rs, 2, 17, 17, 3, 8)
    full = (2, 3, 17, 17) if shape == "bhqk" else (17, 17)
    mask = rs.rand(*full) < 0.6
    mask[..., 4, :] = False
    ref = jax_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, window=window, mask=jnp.asarray(mask))
    got = dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                window=window, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=F32_TOL)


#: (causal, window, kv heads, Sq); the keys are S = 44 long
BACKWARD_CASES = [
    (True, None, 3, 44),         # causal MHA
    (False, None, 3, 44),        # non-causal
    (True, 9, 3, 44),            # sliding window
    (True, None, 1, 44),         # GQA: 3 query heads share one kv head
    (True, 5, 1, 44),            # GQA + window
    (False, None, 3, 20),        # non-causal, Sq != Sk
    (False, None, 1, 20),        # non-causal, Sq != Sk, GQA 3x1
]


@pytest.mark.parametrize(
    "causal,window,hkv,sq", BACKWARD_CASES,
    ids=[f"{c}-{w}-{h}" + ("" if sq == 44 else f"-sq{sq}")
         for c, w, h, sq in BACKWARD_CASES])
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_flash_backward_matches_pallas(causal, window, hkv, sq, layout):
    """dq, dk, dv of the port's differentiable ``flash_attention`` (the
    plain backward on the CPU) against ``jax.grad`` through the Pallas
    backward kernels in interpret mode, at S=44 (not a multiple of the
    16-row blocks), and non-causal with Sq=20 queries. JAX expands grouped
    K/V with ``jnp.repeat`` before the kernel, so its dk/dv are the group
    sums the port computes natively. Tolerance: the JAX suite's own 2e-5
    (float32 reassociation)."""
    rs = np.random.RandomState(6)
    b, s, h, d = 2, 44, 3, 8
    q, k, v = _qkv(rs, b, sq, s, h, d, hkv=hkv)
    co = rs.randn(b, sq, h, d).astype(np.float32)
    if layout == "bhsd":
        q, k, v, co = (x.transpose(0, 2, 1, 3).copy() for x in (q, k, v, co))
    head_axis = 2 if layout == "bshd" else 1

    def loss(a, bb, c):
        bb = jnp.repeat(bb, h // hkv, axis=head_axis)
        c = jnp.repeat(c, h // hkv, axis=head_axis)
        out = jax_flash_attention(a, bb, c, causal=causal, window=window,
                                  layout=layout, interpret=True,
                                  bwd="pallas", block_q=16, block_k=16)
        return jnp.sum(out * co)

    ref = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal, window=window,
                          layout=layout)
    (out * torch.from_numpy(co)).sum().backward()
    for r, t in zip(ref, (tq, tk, tv)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   atol=F32_TOL)


def test_flash_forward_grouped_kv_equals_expanded():
    """Grouped queries read their shared K/V head: the same result as
    expanding the kv heads first (what the JAX package does)."""
    rs = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(x) for x in _qkv(rs, 1, 21, 21, 6, 8,
                                                  hkv=2))
    kw = dict(scale=0.3, causal=True, window=7)
    o, lse = flash_forward(q, k, v, **kw)
    oe, lsee = flash_forward(q, k.repeat_interleave(3, dim=2),
                             v.repeat_interleave(3, dim=2), **kw)
    torch.testing.assert_close(o, oe, rtol=0, atol=0)
    torch.testing.assert_close(lse, lsee, rtol=0, atol=0)


def test_flash_forward_rejects_what_it_does_not_take():
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_forward(x, torch.zeros(1, 5, 2, 8), torch.zeros(1, 5, 2, 8),
                      scale=1.0, causal=True)
    with pytest.raises(ValueError, match="requires causal"):
        flash_forward(x, x, x, scale=1.0, causal=False, window=2)
    with pytest.raises(TypeError):
        flash_forward(x.half(), x.half(), x.half(), scale=1.0, causal=True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_forward(x.to("meta"), x.to("meta"), x.to("meta"), scale=1.0,
                      causal=True)


#: scrambled physical placement with sentinel (unallocated, = N) entries
N_PAGES = 12
TABLE = np.array([[7, 2, 9, 12], [0, 5, 12, 12], [3, 1, 4, 6],
                  [12, 12, 12, 12]], np.int32)
#: the last slot is free: its position is the past-capacity sentinel
T = np.array([20, 11, 30, 32], np.int32)


def _pages(rs, hkv, page_len, d):
    return (rs.randn(N_PAGES, hkv, page_len, d).astype(np.float32),
            rs.randn(N_PAGES, hkv, page_len, d).astype(np.float32))


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("w_len", [1, 3])
@pytest.mark.parametrize("window", [None, 6])
def test_paged_decode_matches_pallas(g, w_len, window):
    rs = np.random.RandomState(2)
    kp, vp = _pages(rs, 2, 8, 16)
    q = rs.randn(4, w_len, 2, g, 16).astype(np.float32)
    scale = 16 ** -0.5
    ref = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                    jnp.asarray(T), jnp.asarray(TABLE), scale=scale,
                    window=window, interpret=True)
    to = torch.from_numpy
    out = paged_decode_attention(to(q), to(kp), to(vp), to(T), to(TABLE),
                                 scale=scale, window=window)
    # the free slot's rows are garbage by contract on both sides
    np.testing.assert_allclose(out.numpy()[:3], np.asarray(ref)[:3],
                               atol=F32_TOL)


def test_paged_decode_refuses_later_slices():
    """A packed int4 payload whose scale plane is not twice its rows is a
    layout error; the tree ancestor mask must be bool ``[S, W, W]``, and
    a window of W rows of G queries must fit the kernel's 64 rows per kv
    head."""
    rs = np.random.RandomState(3)
    kp, vp = (torch.from_numpy(x) for x in _pages(rs, 1, 8, 8))
    q = torch.zeros(4, 1, 1, 1, 8)
    t, table = torch.from_numpy(T), torch.from_numpy(TABLE)
    with pytest.raises(ValueError, match="int4 payload rows"):
        paged_decode_attention(q, kp.to(torch.int8), vp.to(torch.int8), t,
                               table, k_scale=kp[..., 0].repeat(1, 1, 3),
                               v_scale=vp[..., 0].repeat(1, 1, 3))
    with pytest.raises(ValueError, match="anc must be bool"):
        paged_decode_attention(q, kp, vp, t, table,
                               anc=torch.ones(4, 2, 2, dtype=torch.bool))
    with pytest.raises(ValueError, match="anc must be bool"):
        paged_decode_attention(q, kp, vp, t, table,
                               anc=torch.ones(4, 1, 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="64 rows per kv head"):
        check_rows(9, 8)
    check_rows(9, 7)


# --- K2: decode attention over the slab cache --------------------------------


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("t,window", [(0, None), (17, None), (31, None),
                                      (20, 6)])
@pytest.mark.parametrize("g", [1, 4])
def test_decode_attention_matches_pallas(g, t, window, quant):
    """The plain version (the port's CPU path) against the Pallas kernel
    in interpret mode, as ``tests/test_decode_kernel.py`` runs it; int8
    caches carry ``_quantize_kv`` payloads and scale planes. Tolerance:
    float32 reassociation (the Pallas kernel sums 8-key blocks online);
    int8 values reach ~3 after dequantization, hence 1e-4."""
    rs = np.random.RandomState(10)
    q = rs.randn(3, g, 16).astype(np.float32)
    k = rs.randn(3, 32, 16).astype(np.float32)
    v = rs.randn(3, 32, 16).astype(np.float32)
    scale = 16 ** -0.5
    sc, tsc = {}, {}
    if quant:
        (k, ks), (v, vs) = (tuple(np.array(a) for a in jd._quantize_kv(
            jnp.asarray(x))) for x in (k, v))
        sc = {"k_scale": jnp.asarray(ks), "v_scale": jnp.asarray(vs)}
        tsc = {"k_scale": torch.from_numpy(ks),
               "v_scale": torch.from_numpy(vs)}
    ref = jax_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               t, scale=scale, window=window, block_l=8,
                               interpret=True, **sc)
    to = torch.from_numpy
    got = decode_attention(to(q), to(k), to(v), t, scale=scale, window=window,
                           **tsc)
    assert got.dtype == torch.float32 and got.shape == (3, g, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=1e-4 if quant else F32_TOL)


def test_decode_attention_plain_rounds_like_the_jax_cpu_path():
    """bfloat16 cache: q * scale is rounded to the cache dtype before the
    contraction and the normalised probabilities before the value sum,
    the rounding points of JAX's ``_decode_scores``/``_decode_mix`` off
    the TPU. (CPU XLA has no bf16 x bf16 -> f32 dot, so the JAX side
    holds the bf16 values in float32 arrays: the products are exact
    either way.)"""
    rs = np.random.RandomState(11)
    rows, g, d, length, t = 4, 3, 16, 24, 19
    q = rs.randn(rows, g, d).astype(np.float32)
    k, v = (jnp.asarray(rs.randn(rows, length, d), jnp.bfloat16)
            for _ in range(2))
    scale = d ** -0.5

    def bf16(x):
        return x.astype(jnp.bfloat16).astype(jnp.float32)

    s = jnp.einsum("bgd,bld->bgl", bf16(jnp.asarray(q) * scale),
                   k.astype(jnp.float32))
    s = jnp.where((jnp.arange(length) <= t)[None, None], s,
                  -0.7 * float(np.finfo(np.float32).max))
    ref = jnp.einsum("bgl,bld->bgd", bf16(jax.nn.softmax(s, axis=-1)),
                     v.astype(jnp.float32))
    tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32)))
              .to(torch.bfloat16) for x in (k, v))
    got = decode_attention(torch.from_numpy(q), tk, tv, t, scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=F32_TOL)


def test_decode_attention_split_plan_and_refusals():
    """The flash-decoding split: whole 128-position chunks over the cache
    (or a window's span), enough live splits to fill the card but at most
    32 a row, never a split past the cache's end."""
    assert split_plan(64, 1152, 132) == (9, 128)
    assert split_plan(64, 40, 132) == (1, 128)
    assert split_plan(1, 100000, 132) == (32, 3200)
    assert split_plan(64, 1152, 132, window=256) == (9, 128)
    assert split_plan(4, 4096, 132, window=100) == (32, 128)
    for rows, n in ((3, 1), (64, 65), (16, 4097), (1, 63)):
        splits, chunk = split_plan(rows, n, 132)
        assert chunk % 128 == 0 and (splits - 1) * chunk < n <= splits * chunk
    x = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="outside the cache"):
        decode_attention(torch.zeros(2, 1, 16), x, x, 8)
    with pytest.raises(TypeError, match="int8"):
        decode_attention(torch.zeros(2, 1, 16), x, x, 3,
                         k_scale=x[..., 0], v_scale=x[..., 0])
    with pytest.raises(ValueError, match="cuda or cpu"):
        decode_attention(torch.zeros(2, 1, 16).to("meta"), x.to("meta"),
                         x.to("meta"), 3)
    assert decode_attention_reference(torch.zeros(2, 1, 16), x, x, 3,
                                      scale=0.25).shape == (2, 1, 16)


# --- K3: int8 and packed int4 pages ------------------------------------------


def _quant_pages(rs, bits, hkv, page_len, d):
    """Random pages quantized as the pool stores them (int4 packed)."""
    out = []
    for _ in range(2):
        x = jnp.asarray(rs.randn(N_PAGES, hkv, page_len, d), jnp.float32)
        q, sc = jd._quantize_kv(x, bits)
        out.append((np.array(jd.pack_int4(q) if bits == 4 else q),
                    np.array(sc)))
    return out


@pytest.mark.parametrize("g,w_len,window", [(1, 1, None), (4, 3, None),
                                            (2, 2, 40)])
@pytest.mark.parametrize("bits,page_len", [(8, 32), (4, 64)])
def test_quantized_paged_decode_matches_pallas(bits, page_len, g, w_len,
                                               window):
    """int8 pages (page_len 32) and packed int4 pages (page_len 64)
    against the Pallas kernel in interpret mode, as
    ``tests/test_int4_kv.py`` runs it; slot 3 is free."""
    rs = np.random.RandomState(12)
    (kp, ks), (vp, vs) = _quant_pages(rs, bits, 2, page_len, 16)
    q = rs.randn(4, w_len, 2, g, 16).astype(np.float32)
    t = T * page_len // 8
    scale = 16 ** -0.5
    ref = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                    jnp.asarray(t), jnp.asarray(TABLE), scale=scale,
                    window=window, k_scale=jnp.asarray(ks),
                    v_scale=jnp.asarray(vs), interpret=True)
    to = torch.from_numpy
    out = paged_decode_attention(to(q), to(kp), to(vp), to(t), to(TABLE),
                                 scale=scale, window=window, k_scale=to(ks),
                                 v_scale=to(vs))
    np.testing.assert_allclose(out.numpy()[:3], np.asarray(ref)[:3],
                               atol=1e-4)


def test_int4_page_write_matches_jax_and_keeps_the_other_nibble():
    """One-position writes into packed int4 pages (the read-modify-write
    of the byte row two positions share) are bitwise JAX's
    ``_cache_write_pages``, and the other position keeps its exact bits;
    a past-capacity position writes nothing."""
    rs = np.random.RandomState(13)
    (kp, ks), (vp, vs) = _quant_pages(rs, 4, 2, 64, 16)
    jkv = {"k": jnp.asarray(kp), "v": jnp.asarray(vp),
           "k_scale": jnp.asarray(ks), "v_scale": jnp.asarray(vs),
           "q4": jnp.zeros((1, 1, 1, 1), jnp.int8)}
    pkv = {"k": torch.from_numpy(kp.copy()), "v": torch.from_numpy(vp.copy()),
           "k_scale": torch.from_numpy(ks.copy()),
           "v_scale": torch.from_numpy(vs.copy()), "q4": True}
    table = np.array([[4, 1, 3]], np.int32)
    for t_pos in (0, 31, 32, 63, 64, 70, 129, 500):
        kh = rs.randn(1, 1, 2, 16).astype(np.float32)
        vh = rs.randn(1, 1, 2, 16).astype(np.float32)
        buddy = t_pos + 32 if (t_pos % 64) < 32 else t_pos - 32
        before = pd.unpack_int4(pkv["k"][table[0, min(buddy // 64, 2)]])
        jkv = jd._cache_write_pages(jkv, jnp.asarray(kh), jnp.asarray(vh),
                                    jnp.asarray([t_pos]), jnp.asarray(table),
                                    64)
        index = pd.page_write_index(torch.tensor([t_pos]),
                                    torch.from_numpy(table), 64, N_PAGES)
        pd._cache_write_pages(pkv, torch.from_numpy(kh), torch.from_numpy(vh),
                              index)
        for key in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(pkv[key].numpy(),
                                          np.asarray(jkv[key]))
        after = pd.unpack_int4(pkv["k"][table[0, min(buddy // 64, 2)]])
        np.testing.assert_array_equal(after[:, buddy % 64].numpy(),
                                      before[:, buddy % 64].numpy())


def test_int4_pool_insert_then_load_prefix_roundtrip():
    """Staging (unpacked) -> pool (packed, as JAX's ``pack_int4``) ->
    staging is bitwise for the payload and the scale planes; the pool
    counts packed payload plus scale planes per page and refuses an odd
    page_len."""
    model = Model.build(zoo.transformer_lm(29, d_model=32, num_heads=4,
                                           num_layers=2, num_kv_heads=2),
                        (8,), device="cpu")
    pool = PagedKVPool(model.module, num_slots=1, max_len=32, page_len=8,
                       dtype="int4", device="cpu")
    rs = np.random.RandomState(14)
    staging = pool.make_request_cache()
    for kv in staging:
        if kv is None:
            continue
        assert kv["k"].dtype == torch.int8 and kv["k"].shape[2] == 32
        for key in ("k", "v"):
            kv[key].copy_(torch.from_numpy(
                rs.randint(-7, 8, kv[key].shape).astype(np.int8)))
        for key in ("k_scale", "v_scale"):
            kv[key].copy_(torch.from_numpy(
                rs.rand(*kv[key].shape).astype(np.float32)))
    for lp in range(pool.pages_per_slot):
        pool.assign(0, lp, pool.alloc_page())
    pool.insert_pages(staging, 0, 0, 32)
    loaded = pool.load_prefix(pool.make_request_cache(),
                              [int(p) for p in pool.tables[0]], 32)
    for st, ld, pl in zip(staging, loaded, pool.cache):
        if st is None:
            continue
        assert pl["k"].shape == (pool.num_pages, 2, 4, 8) and "q4" in pl
        pages = st["k"][0].reshape(2, 4, 8, 8).transpose(0, 1)
        np.testing.assert_array_equal(
            pl["k"][pool.tables[0]].numpy(),
            np.asarray(jd.pack_int4(jnp.asarray(pages.numpy()))))
        for key in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(ld[key].numpy(), st[key].numpy())
    # per layer: k and v packed (2 heads x 4 byte rows x 8 dims) plus two
    # float32 scale planes (2 heads x 8 positions)
    assert pool.page_bytes == 2 * (2 * 2 * 4 * 8 + 2 * 4 * 2 * 8)
    with pytest.raises(ValueError, match="even"):
        PagedKVPool(model.module, num_slots=1, max_len=10, page_len=5,
                    dtype="int4", device="cpu")


def test_library_path_hashes_the_included_headers(tmp_path, monkeypatch):
    """A kernel library's file name hashes its source and the csrc/
    headers it includes, directly or through another header: editing
    ``sm90.cuh`` renames the libraries of ``moe_gemm.cu``, ``moe_bwd.cu``
    (both through ``moe_tc.cuh``), ``flash_bwd.cu``, ``flash_fwd.cu``,
    the two paged and the two slab decode units (through their headers),
    ``quant_matmul.cu`` and ``sampling.cu``, editing ``moe_tc.cuh`` those
    of the two MoE sources, editing ``dequant.cuh`` those of the paged
    and the slab decode and the quantized matmul, editing a decode header
    those of its two units (a stale build is never reused), and no
    other; an unchanged tree keeps every name."""
    csrc = tmp_path / "csrc"
    shutil.copytree(os.path.join(compat.PACKAGE_DIR, "csrc"), csrc)
    monkeypatch.setattr(compat, "PACKAGE_DIR", str(tmp_path))
    monkeypatch.setenv("DKT_KERNEL_BUILD_DIR", str(tmp_path / "build"))
    sources = sorted(set(kernels.SOURCES.values()))
    paged = {"paged_decode.cu", "paged_decode_q.cu"}
    slab = {"decode_attention.cu", "decode_attention_q8.cu"}
    for src in ("flash_bwd.cu", "flash_fwd.cu"):
        assert kernels._inputs(src) == [src, "sm90.cuh"]
    for src in ("moe_bwd.cu", "moe_gemm.cu"):
        assert kernels._inputs(src) == [src, "moe_tc.cuh", "sm90.cuh"]
    for srcs, head in ((paged, "paged_decode.cuh"),
                       (slab, "decode_attention.cuh")):
        for src in srcs:
            assert kernels._inputs(src) == [src, head, "dequant.cuh",
                                            "sm90.cuh"]
    assert kernels._inputs("quant_matmul.cu") == [
        "quant_matmul.cu", "dequant.cuh", "sm90.cuh"]
    assert kernels._inputs("sampling.cu") == ["sampling.cu", "sm90.cuh"]
    before = {src: kernels._library_path(src) for src in sources}
    assert {src: kernels._library_path(src) for src in sources} == before
    for name, renamed in (
            ("sm90.cuh", {"flash_bwd.cu", "flash_fwd.cu", "moe_bwd.cu",
                          "moe_gemm.cu", "quant_matmul.cu",
                          "sampling.cu"} | paged | slab),
            ("moe_tc.cuh", {"moe_bwd.cu", "moe_gemm.cu"}),
            ("dequant.cuh", {"quant_matmul.cu"} | paged | slab),
            ("paged_decode.cuh", paged),
            ("decode_attention.cuh", slab)):
        header = csrc / name
        header.write_text(header.read_text() + "\n// edited\n")
        after = {src: kernels._library_path(src) for src in sources}
        assert {src for src in sources
                if after[src] != before[src]} == renamed, name
        assert {src: kernels._library_path(src) for src in sources} == after
        header.write_text(header.read_text()[:-len("\n// edited\n")])
        assert {src: kernels._library_path(src) for src in sources} == before
