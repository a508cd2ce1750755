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

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax

from distkeras_tpu.ops.attention import dot_product_attention as jax_dpa
from distkeras_tpu.ops.flash_attention import _flash_forward
from distkeras_tpu.ops.flash_attention import \
    flash_attention as jax_flash_attention
from distkeras_tpu.ops.paged_attention import \
    paged_decode_attention as jax_paged

from distkeras_tpu_torch.ops.attention import dot_product_attention
from distkeras_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_forward)
from distkeras_tpu_torch.ops.paged_attention import paged_decode_attention

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


@pytest.mark.parametrize("causal,window,hkv", [
    (True, None, 3),             # causal MHA
    (False, None, 3),            # non-causal
    (True, 9, 3),                # sliding window
    (True, None, 1),             # GQA: 3 query heads share one kv head
    (True, 5, 1),                # GQA + window
])
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_flash_backward_matches_pallas(causal, window, hkv, layout):
    """dq, dk, dv of the port's differentiable ``flash_attention`` (the
    plain backward on the CPU) against ``jax.grad`` through the Pallas
    backward kernels in interpret mode, at S=44 (not a multiple of the
    16-row blocks). JAX expands grouped K/V with ``jnp.repeat`` before the
    kernel, so its dk/dv are the group sums the port computes natively.
    Tolerance: the JAX suite's own 2e-5 (float32 reassociation)."""
    rs = np.random.RandomState(6)
    b, s, h, d = 2, 44, 3, 8
    q, k, v = _qkv(rs, b, s, s, h, d, hkv=hkv)
    co = rs.randn(b, s, h, d).astype(np.float32)
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


def test_flash_attention_refuses_packed_sequences():
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flash_attention(x, x, x, causal=True,
                        segment_ids=torch.zeros(1, 4, dtype=torch.int32))


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
    rs = np.random.RandomState(3)
    kp, vp = (torch.from_numpy(x) for x in _pages(rs, 1, 8, 8))
    q = torch.zeros(4, 1, 1, 1, 8)
    t, table = torch.from_numpy(T), torch.from_numpy(TABLE)
    with pytest.raises(NotImplementedError, match="K3-int8"):
        paged_decode_attention(q, kp, vp, t, table, k_scale=kp[..., 0],
                               v_scale=vp[..., 0])
    with pytest.raises(NotImplementedError, match="K3-anc"):
        paged_decode_attention(q, kp, vp, t, table,
                               anc=torch.ones(4, 1, 1, dtype=torch.bool))
