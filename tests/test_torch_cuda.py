"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA card and skips without one; the
file imports nothing of JAX, so on the card it runs without the JAX
package's test configuration:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import os
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from distkeras_tpu_torch import kernels
from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.models import Model, zoo
from distkeras_tpu_torch.models import decoding as pd
from distkeras_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_reference)
from distkeras_tpu_torch.ops.flash_attention import (
    attention_delta, flash_backward, flash_backward_reference, flash_forward,
    flash_forward_reference)
from distkeras_tpu_torch.parallel import SingleTrainer
import distkeras_tpu_torch.ops.moe_kernels as moe_kernels
from distkeras_tpu_torch.ops.moe_kernels import (
    bwd_dw1, bwd_dw1_reference, bwd_dx, bwd_dx_reference, gather_gemm1,
    gather_gemm1_reference)
from distkeras_tpu_torch.ops.paged_attention import (
    paged_decode_attention, paged_decode_attention_reference)
from distkeras_tpu_torch.ops.paged_attention import \
    split_plan as paged_split_plan
from distkeras_tpu_torch.ops.quant_matmul import (quant_matmul,
                                                  quantize_weight,
                                                  reference_matmul)
from distkeras_tpu_torch.ops.sampling import (MAX_BOUNDARY_PARTINGS,
                                              boundary_partings,
                                              sample_epilogue,
                                              sample_epilogue_reference)
from distkeras_tpu_torch.serving import (EngineReplica, NgramDraft,
                                         PagedKVPool, Router, ServingEngine,
                                         tree_ancestors)

pytestmark = pytest.mark.cuda

# the module itself (``ops`` re-exports the function of the same name)
decode_module = sys.modules["distkeras_tpu_torch.ops.decode_attention"]

#: float32: two summation orders over up to 1000 keys of O(1) scores
F32_TOL = 2e-4
#: bfloat16: output rounding (2^-8 relative) of O(1) attention outputs
#: plus the reassociation of the bf16-rounded probabilities
BF16_TOL = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(rs, b, sq, sk, h, hkv, d, dtype, device, layout):
    def make(s, heads):
        x = torch.from_numpy(rs.randn(b, s, heads, d).astype(np.float32))
        if layout == "bhsd":
            x = x.transpose(1, 2).contiguous()
        return x.to(device, dtype)
    return make(sq, h), make(sk, hkv), make(sk, hkv)


def _segment_ids(rs, kind, b, s, dev):
    """Packed-sequence ids: ``"contiguous"`` (sorted documents),
    ``"late"`` (a last document whose queries find their first tiles
    wholly masked), ``"unsorted"`` (interleaved, with a -1 tail),
    ``"equal"`` (one id: bitwise the result of no ids), or None."""
    if kind is None:
        return None
    pos = np.arange(s)
    ids = {"contiguous": lambda: np.sort(rs.randint(0, 4, (b, s)), axis=1),
           "late": lambda: np.tile(pos >= s - s // 8, (b, 1)),
           "unsorted": lambda: np.where(pos >= s - s // 5, -1,
                                        rs.randint(0, 4, (b, s))),
           "equal": lambda: np.full((b, s), 5)}[kind]()
    return torch.from_numpy(ids.astype(np.int32)).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,sq,sk,window,hkv,d,layout,seg", [
    (True, 300, 300, None, 4, 64, "bshd", None),
    (True, 257, 257, 64, 2, 64, "bshd", None),
    (False, 96, 1000, None, 4, 64, "bhsd", None),
    (True, 130, 130, None, 4, 128, "bhsd", None),
    (True, 70, 70, 5, 1, 32, "bshd", None),
    (True, 300, 300, None, 4, 64, "bshd", "contiguous"),
    (True, 1000, 1000, None, 4, 64, "bshd", "late"),
    (False, 200, 200, None, 4, 64, "bhsd", "unsorted"),
    (True, 257, 257, 64, 2, 64, "bshd", "contiguous"),     # window + GQA
    (True, 130, 130, None, 1, 128, "bhsd", "unsorted"),    # GQA 4x1
    (True, 300, 300, 40, 4, 32, "bshd", "equal"),
    (True, 1000, 1000, 100, 2, 128, "bshd", None),          # window, D128
    (True, 1000, 1000, None, 4, 128, "bshd", "late"),       # ids, D128
    (True, 513, 513, 200, 1, 128, "bhsd", "contiguous"),    # window + ids
    (False, 96, 1000, None, 4, 128, "bshd", None),          # Sq != Sk, D128
    (True, 300, 300, 40, 4, 64, "bshd", "equal"),
    (True, 300, 300, None, 2, 128, "bhsd", "equal"),
])
def test_flash_kernel_matches_plain(dev, dtype, causal, sq, sk, window,
                                    hkv, d, layout, seg):
    rs = np.random.RandomState(0)
    q, k, v = _qkv(rs, 2, sq, sk, 4, hkv, d, dtype, dev, layout)
    ids = _segment_ids(rs, seg, 2, sq, dev)
    kw = dict(scale=d ** -0.5, causal=causal, window=window, layout=layout)
    before = kernels.launch_counts()["flash_fwd"]
    o, lse = flash_forward(q, k, v, segment_ids=ids, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_fwd"] == before + 1
    ro, rl = flash_forward_reference(q, k, v, segment_ids=ids, **kw)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert o.dtype == dtype and o.shape == q.shape
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, rl, atol=1e-3, rtol=1e-5)
    if seg == "equal":
        o0, lse0 = flash_forward(q, k, v, **kw)
        assert torch.equal(o, o0) and torch.equal(lse, lse0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_kv_segment_ids_match_plain(dev, dtype, causal, d):
    """K1f, K1dq and K1dkv with k-side ids that differ from the q side
    (a ring hop's): every row admits a key (ids 0-2 at keys 0-2), so the
    backward's lse is finite, as the ring's merged one is; a row whose
    id no key carries gets an lse under ``NEG_INF / 2``."""
    rs = np.random.RandomState(27)
    b, s, h = 2, 300, 4
    q, k, v = _qkv(rs, b, s, s, h, h, d, dtype, dev, "bshd")
    dout = torch.from_numpy(rs.randn(b, s, h, d).astype(np.float32)).to(
        dev, dtype)
    qs = rs.randint(0, 3, (b, s)).astype(np.int32)
    ks = rs.randint(0, 3, (b, s)).astype(np.int32)
    ks[:, :3] = [0, 1, 2]
    qs[:, :2] = [0, 1]
    qseg, kseg = (torch.from_numpy(x).to(dev) for x in (qs, ks))
    kw = dict(scale=d ** -0.5, causal=causal, segment_ids=qseg,
              kv_segment_ids=kseg)
    o, lse = flash_forward(q, k, v, **kw)
    ro, rl = flash_forward_reference(q, k, v, **kw)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, rl, atol=1e-3, rtol=1e-5)
    delta = attention_delta(o, dout)
    got = flash_backward(q, k, v, o, lse, dout, delta, **kw)
    ref = flash_backward_reference(q, k, v, o, lse, dout, delta, **kw)
    for a, r in zip(got, ref):
        err = (a.float() - r.float()).abs().max() / r.float().abs().max()
        assert err <= (1e-4 if dtype == torch.float32 else 2e-2), err
    dead = qseg.clone()
    dead[0, 5] = 7
    _, dl = flash_forward(q, k, v, **dict(kw, segment_ids=dead))
    assert (dl[0, :, 5] < -1e37).all() and (dl[1] > -1e3).all()


def _forward_case(rs, b, s, h, hkv, d, offset=0):
    """bf16 q, k, v ``[B, S, H, D]`` (bshd); with ``offset`` each is a view
    that starts that many elements into a larger buffer."""
    def make(heads):
        x = torch.from_numpy(rs.randn(b, s, heads, d).astype(np.float32))
        buf = torch.zeros(x.numel() + offset, dtype=torch.bfloat16,
                          device="cuda")
        view = buf[offset:].view(b, s, heads, d)
        view.copy_(x)
        return view
    return make(h), make(hkv), make(hkv)


def _assert_forward_matches_plain(q, k, v, kw, o, lse):
    ro, rl = flash_forward_reference(q, k, v, **kw)
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(o.float(), ro.float(), atol=BF16_TOL, rtol=0)
    torch.testing.assert_close(lse, rl, atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_forward_is_bitwise_repeatable(dev, d):
    """No atomics: two launches on the same bf16 inputs give the same bits
    (causal, GQA 4x4, ragged S); the grid's first batch row alone (a grid
    under the card's SM count: blocks of one warpgroup) gives the bits the
    whole batch gives (blocks of two)."""
    q, k, v = _forward_case(np.random.RandomState(13), 4, 700, 16, 4, d)
    kw = dict(scale=d ** -0.5, causal=True, window=None, layout="bshd")
    o, lse = flash_forward(q, k, v, **kw)
    o2, lse2 = flash_forward(q, k, v, **kw)
    o1, lse1 = flash_forward(q[:1], k[:1], v[:1], **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert torch.equal(o[:1], o1) and torch.equal(lse[:1], lse1)
    _assert_forward_matches_plain(q, k, v, kw, o, lse)


@pytest.mark.parametrize("d,window", [(64, None), (64, 100), (128, None)])
def test_flash_forward_unaligned_views_take_the_copy_path(dev, d, window):
    """q, k and v starting one element into their buffers miss TMA's
    16-byte alignment: the producer copies their tiles element by element,
    with the bits of the TMA path on aligned copies."""
    q, k, v = _forward_case(np.random.RandomState(14), 4, 300, 16, 4, d,
                            offset=1)
    assert all(x.data_ptr() % 16 != 0 for x in (q, k, v))
    kw = dict(scale=d ** -0.5, causal=True, window=window, layout="bshd")
    before = kernels.launch_counts()["flash_fwd"]
    o, lse = flash_forward(q, k, v, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_fwd"] == before + 1
    _assert_forward_matches_plain(q, k, v, kw, o, lse)
    ao, alse = flash_forward(q.clone(), k.clone(), v.clone(), **kw)
    assert torch.equal(o, ao) and torch.equal(lse, alse)


def test_flash_forward_small_grid(dev):
    """B1 H2 S4096: fewer blocks than SMs, and long walks per block."""
    q, k, v = _forward_case(np.random.RandomState(15), 1, 4096, 2, 2, 64)
    kw = dict(scale=0.125, causal=True, window=None, layout="bshd")
    o, lse = flash_forward(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_forward_matches_plain(q, k, v, kw, o, lse)


N_PAGES = 12
TABLE = np.array([[7, 2, 9, 12], [0, 5, 12, 12], [3, 1, 4, 6],
                  [12, 12, 12, 12]], np.int32)
T = np.array([20, 11, 28, 32], np.int32)   # slot 3 is free


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,w_len,window,d", [(1, 1, None, 64),
                                              (4, 3, 6, 64),
                                              (4, 1, None, 128),
                                              (2, 4, None, 32)])
def test_paged_kernel_matches_plain(dev, dtype, g, w_len, window, d):
    rs = np.random.RandomState(1)
    kp, vp = (torch.from_numpy(rs.randn(N_PAGES, 2, 8, d)
                               .astype(np.float32)).to(dev, dtype)
              for _ in range(2))
    q = torch.from_numpy(rs.randn(4, w_len, 2, g, d).astype(np.float32)) \
        .to(dev)
    t = torch.from_numpy(T).to(dev)
    table = torch.from_numpy(TABLE).to(dev)
    before = kernels.launch_counts()["paged_decode"]
    out = paged_decode_attention(q, kp, vp, t, table, scale=0.2,
                                 window=window)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["paged_decode"] == before + 1
    ref = paged_decode_attention_reference(q, kp, vp, t, table, scale=0.2,
                                           window=window)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(out[:3], ref[:3], atol=tol, rtol=0)
    assert torch.all(out[3] == 0)   # a free slot reads no page at all


def test_engine_on_card_goes_through_both_kernels(dev):
    model = Model.build(zoo.transformer_lm(97, d_model=128, num_heads=4,
                                           num_layers=2, dtype="bfloat16",
                                           num_kv_heads=2),
                        (16,), seed=0, device=dev)
    eng = ServingEngine(model, num_slots=2, max_len=128, prefill_chunk=32)
    rs = np.random.RandomState(2)
    kernels.reset_launch_counts()
    rids = [eng.submit(rs.randint(0, 97, n), 6) for n in (70, 9, 40)]
    out = eng.run(max_steps=500)
    assert sorted(out) == rids
    assert all(len(out[r]) == n + 6 for r, n in zip(rids, (70, 9, 40)))
    counts = kernels.launch_counts()
    assert counts["flash_fwd"] > 0 and counts["paged_decode"] > 0


def _slab(rs, rows, length, d, strided):
    """A ``[rows, length, d]`` cache view; ``strided`` cuts it out of a
    longer buffer, so its row stride is not ``length * d``."""
    x = torch.from_numpy(rs.randn(rows, length + 24 * strided, d)
                         .astype(np.float32))
    return x[:, :length] if strided else x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,d,window,length,t,strided", [
    (1, 64, None, 1152, 1151, False),     # generate's shape (per row)
    (4, 64, None, 300, 200, True),        # GQA, positions past t unused
    (4, 128, 37, 500, 499, False),        # window, D=128
    (1, 32, None, 40, 39, True),          # a short cache, one split
    (2, 64, 256, 1152, 700, False),       # window 256 mid-cache
    (1, 64, None, 4096, 100, False),      # t early: most splits dead
    (2, 64, 300, 4096, 3000, True),       # leading splits left empty
    (4, 32, 130, 2048, 2047, False),      # a window over three splits
    (64, 128, None, 600, 599, False),     # G = 64 at D = 128
])
def test_decode_kernel_matches_plain(dev, dtype, g, d, window, length, t,
                                     strided):
    rs = np.random.RandomState(5)
    rows = 6
    q = torch.from_numpy(rs.randn(rows, g, d).astype(np.float32)).to(dev,
                                                                     dtype)
    k, v = (_slab(rs, rows, length, d, strided).to(dev, dtype)
            for _ in range(2))
    before = kernels.launch_counts()["decode_attention"]
    out = decode_attention(q, k, v, t, scale=d ** -0.5, window=window)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["decode_attention"] == before + 1
    ref = decode_attention_reference(q, k, v, t, scale=d ** -0.5,
                                     window=window)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert out.dtype == torch.float32 and out.shape == q.shape
    torch.testing.assert_close(out, ref, atol=tol, rtol=0)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("g,d,window,length,t,strided", [
    (1, 64, None, 1152, 1151, False),
    (4, 64, 256, 1152, 900, True),
    (4, 128, None, 40, 39, False),
    (2, 32, None, 300, 123, True),
    (1, 64, None, 4096, 70, False),       # t early: most splits dead
    (64, 128, 200, 1000, 900, True),      # G = 64 at D = 128, a window
])
def test_decode_kernel_q8_matches_plain(dev, bits, g, d, window, length, t,
                                        strided):
    """int8 caches and int4 caches (one int8 byte per entry in [-7, 7]):
    float32 math on both sides, only the summation order differs."""
    rs = np.random.RandomState(6)
    rows = 6
    q = torch.from_numpy(rs.randn(rows, g, d).astype(np.float32)).to(dev)
    (k, ks), (v, vs) = (pd._quantize_kv(_slab(rs, rows, length, d, strided)
                                        .to(dev), bits) for _ in range(2))
    before = kernels.launch_counts()["decode_attention_q8"]
    out = decode_attention(q, k, v, t, scale=d ** -0.5, window=window,
                           k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["decode_attention_q8"] == before + 1
    ref = decode_attention_reference(q, k, v, t, scale=d ** -0.5,
                                     window=window, k_scale=ks, v_scale=vs)
    torch.testing.assert_close(out, ref, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("length,t,window", [(1152, 1151, None),
                                             (1152, 1151, 256),
                                             (100, 99, None)],
                         ids=["merge", "window", "one_split"])
def test_decode_kernel_one_launch_bitwise_counters_zero(dev, cache, length,
                                                        t, window):
    """generate()'s rows (B4 x Hkv16, G1, D64): one CUDA kernel a call
    (the kernel nodes of a captured graph: no cast of q, no second merge
    kernel) for bfloat16 and float32 queries; a bfloat16 q gives bitwise
    the output of a float32 q of the same values; a repeat gives the same
    bits; the arrival counters are all zero after the calls."""
    rs = np.random.RandomState(9)
    rows, g, d = 64, 1, 64
    q32 = torch.from_numpy(rs.randn(rows, g, d).astype(np.float32)).to(
        dev, torch.bfloat16).float()
    x = [torch.from_numpy(rs.randn(rows, length, d).astype(np.float32))
         .to(dev) for _ in range(2)]
    kw = dict(scale=d ** -0.5, window=window)
    if cache == "int8":
        (k, ks), (v, vs) = (pd._quantize_kv(a, 8) for a in x)
        kw.update(k_scale=ks, v_scale=vs)
    else:
        k, v = (a.to(getattr(torch, cache)) for a in x)
    out = decode_attention(q32, k, v, t, **kw)
    q16 = q32.to(torch.bfloat16)
    assert torch.equal(out, decode_attention(q16, k, v, t, **kw))
    assert torch.equal(out, decode_attention(q32, k, v, t, **kw))
    for q in (q32, q16):
        assert chip_smoke.kernels_per_call(
            lambda: decode_attention(q, k, v, t, **kw)) == 1
    torch.cuda.synchronize()
    counters = decode_module._workspaces[q32.device][0]
    assert int(counters.abs().sum()) == 0
    ref = decode_attention_reference(q32, k, v, t, **kw)
    tol = BF16_TOL if cache == "bfloat16" else \
        chip_smoke.KERNEL_Q_TOL if cache == "int8" else F32_TOL
    torch.testing.assert_close(out, ref, atol=tol, rtol=0)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("g,w_len,window,d,page_len", [(1, 1, None, 64, 16),
                                                       (4, 3, 6, 64, 32),
                                                       (2, 4, None, 32, 8),
                                                       (4, 1, None, 128, 64)])
def test_paged_kernel_quantized_matches_plain(dev, bits, g, w_len, window, d,
                                              page_len):
    """int8 pages and packed int4 pages (the positions scale with the
    page length; slot 3 is free)."""
    rs = np.random.RandomState(7)
    pages = []
    for _ in range(2):
        x = torch.from_numpy(rs.randn(N_PAGES, 2, page_len, d)
                             .astype(np.float32)).to(dev)
        payload, sc = pd._quantize_kv(x, bits)
        pages.append((pd.pack_int4(payload) if bits == 4 else payload, sc))
    (kp, ks), (vp, vs) = pages
    q = torch.from_numpy(rs.randn(4, w_len, 2, g, d).astype(np.float32)) \
        .to(dev)
    t = torch.from_numpy(T * page_len // 8).to(dev)
    table = torch.from_numpy(TABLE).to(dev)
    name = f"paged_decode_q{bits}"
    before = kernels.launch_counts()[name]
    out = paged_decode_attention(q, kp, vp, t, table, scale=0.2,
                                 window=window, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    ref = paged_decode_attention_reference(q, kp, vp, t, table, scale=0.2,
                                           window=window, k_scale=ks,
                                           v_scale=vs)
    torch.testing.assert_close(out[:3], ref[:3], atol=F32_TOL, rtol=0)
    assert torch.all(out[3] == 0)


def test_generate_on_card_launches_k2_per_layer_step(dev):
    """12 layers, 6 new tokens: the decode kernel runs once per layer per
    decode step (12 x 5), in the variant of the cache dtype; a float32
    decode step on the card agrees with the CPU on the same cache."""
    model = Model.build(zoo.transformer_lm(97, d_model=128, num_heads=4,
                                           num_layers=12, dtype="bfloat16",
                                           num_kv_heads=2),
                        (16,), seed=0, device=dev)
    prompts = np.random.RandomState(8).randint(0, 97, (2, 30))
    for cache_dtype, name, other in ((None, "decode_attention",
                                      "decode_attention_q8"),
                                     ("int8", "decode_attention_q8",
                                      "decode_attention"),
                                     ("int4", "decode_attention_q8",
                                      "decode_attention")):
        kernels.reset_launch_counts()
        out = model.generate(prompts, 6, cache_dtype=cache_dtype)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert counts[name] == 12 * 5 and counts[other] == 0, counts
        assert counts["flash_fwd"] == 12
        assert out.shape == (2, 36) and np.array_equal(out[:, :30], prompts)
        assert ((out >= 0) & (out < 97)).all()

    f32 = Model.build(zoo.transformer_lm(97, d_model=128, num_heads=4,
                                         num_layers=2, num_kv_heads=2),
                      (16,), seed=0, device=dev)
    cpu = Model.build(zoo.transformer_lm(97, d_model=128, num_heads=4,
                                         num_layers=2, num_kv_heads=2),
                      (16,), seed=0, device="cpu")
    cache = pd.init_cache(f32.module, 2, 40, torch.float32, dev)
    toks = torch.from_numpy(prompts).to(dev)
    with torch.no_grad():
        pd.prefill(f32.module, f32.params, cache, toks)
        cpu_cache = [None if kv is None else {k: a.cpu() for k, a in
                                              kv.items()} for kv in cache]
        got, _ = pd.decode_step(f32.module, f32.params, cache, toks[:, -1],
                                30)
        ref, _ = pd.decode_step(cpu.module, cpu.params, cpu_cache,
                                toks[:, -1].cpu(), 30)
    torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("cache_dtype", ["int8", "int4"])
def test_engine_on_card_runs_the_quantized_paged_kernel(dev, cache_dtype):
    model = Model.build(zoo.transformer_lm(97, d_model=128, num_heads=4,
                                           num_layers=2, dtype="bfloat16",
                                           num_kv_heads=2),
                        (16,), seed=0, device=dev)
    eng = ServingEngine(model, num_slots=2, max_len=128, prefill_chunk=32,
                        cache_dtype=cache_dtype)
    rs = np.random.RandomState(9)
    kernels.reset_launch_counts()
    rids = [eng.submit(rs.randint(0, 97, n), 6) for n in (70, 9, 40)]
    out = eng.run(max_steps=500)
    assert sorted(out) == rids
    counts = kernels.launch_counts()
    name = "paged_decode_q8" if cache_dtype == "int8" else "paged_decode_q4"
    assert counts[name] > 0 and counts["paged_decode"] == 0, counts


def _anc_pages(rs, variant, d, page_len, dev):
    """K/V pages of one variant: float32 or bf16, or int8 / packed int4
    with their scale planes (``{}`` for float pages)."""
    out = []
    for _ in range(2):
        x = torch.from_numpy(rs.randn(N_PAGES, 2, page_len, d)
                             .astype(np.float32)).to(dev)
        if variant in (torch.float32, torch.bfloat16):
            out.append((x.to(variant), None))
            continue
        payload, sc = pd._quantize_kv(x, variant)
        out.append((pd.pack_int4(payload) if variant == 4 else payload, sc))
    (kp, ks), (vp, vs) = out
    return kp, vp, ({} if ks is None else dict(k_scale=ks, v_scale=vs))


ANC_VARIANTS = [torch.float32, torch.bfloat16, 8, 4]
ANC_NAMES = {torch.float32: "paged_decode_anc",
             torch.bfloat16: "paged_decode_anc", 8: "paged_decode_q8_anc",
             4: "paged_decode_q4_anc"}


@pytest.mark.parametrize("variant", ANC_VARIANTS,
                         ids=["f32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("g,w_len,window,d,page_len", [(1, 9, None, 64, 16),
                                                       (4, 9, 6, 64, 16),
                                                       (2, 5, None, 32, 8),
                                                       (1, 16, 40, 128, 32)])
def test_anc_kernel_matches_plain(dev, variant, g, w_len, window, d,
                                  page_len):
    """K3-anc, the tree ancestor mask, in its three page variants against
    the plain version on random trees (slot 3 is free)."""
    rs = np.random.RandomState(10)
    kp, vp, sc = _anc_pages(rs, variant, d, page_len, dev)
    q = torch.from_numpy(rs.randn(4, w_len, 2, g, d).astype(np.float32)) \
        .to(dev)
    parents = np.full((4, w_len), -1, np.int64)
    for s in range(4):
        for j in range(1, rs.randint(1, w_len + 1)):
            parents[s, j] = rs.randint(0, j)
    anc = torch.from_numpy(tree_ancestors(parents)[1]).to(dev)
    t = torch.from_numpy(T * page_len // 8).to(dev)
    table = torch.from_numpy(TABLE).to(dev)
    name = ANC_NAMES[variant]
    before = kernels.launch_counts()[name]
    out = paged_decode_attention(q, kp, vp, t, table, scale=0.2,
                                 window=window, anc=anc, **sc)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    ref = paged_decode_attention_reference(q, kp, vp, t, table, scale=0.2,
                                           window=window, anc=anc, **sc)
    tol = BF16_TOL if variant == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(out[:3], ref[:3], atol=tol, rtol=0)
    assert torch.all(out[3] == 0)


@pytest.mark.parametrize("variant", ANC_VARIANTS,
                         ids=["f32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("window", [None, 5])
def test_chain_anc_kernel_equals_window_causal_bitwise(dev, variant, window):
    """A lower-triangular ``anc`` through the anc kernel gives the
    window-causal kernel's output bit for bit."""
    rs = np.random.RandomState(11)
    kp, vp, sc = _anc_pages(rs, variant, 64, 16, dev)
    q = torch.from_numpy(rs.randn(4, 9, 2, 1, 64).astype(np.float32)) \
        .to(dev)
    t = torch.from_numpy(T * 2).to(dev)
    table = torch.from_numpy(TABLE).to(dev)
    chain = torch.tril(torch.ones(9, 9, dtype=torch.bool, device=dev))
    a = paged_decode_attention(q, kp, vp, t, table, window=window, **sc)
    b = paged_decode_attention(q, kp, vp, t, table, window=window,
                               anc=chain.expand(4, 9, 9).contiguous(), **sc)
    assert torch.equal(a, b)


def test_engine_on_card_tree_speculation_launches_anc(dev):
    """Two layers, float32, ``spec_tree=True``: the tree verify goes
    through the anc kernel and the streams equal the plain engine's."""
    model = Model.build(zoo.transformer_lm(97, d_model=128, num_heads=4,
                                           num_layers=2, num_kv_heads=2),
                        (16,), seed=0, device=dev)
    rs = np.random.RandomState(12)
    motif = rs.randint(0, 97, 12)
    prompts = [np.tile(motif, 6)[:n] for n in (50, 23)] + \
        [rs.randint(0, 97, 30)]

    def run(**kw):
        eng = ServingEngine(model, num_slots=2, max_len=128,
                            prefill_chunk=32, **kw)
        rids = [eng.submit(p, 10) for p in prompts]
        out = eng.run(max_steps=500)
        return [out[r] for r in rids], eng

    plain, _ = run()
    kernels.reset_launch_counts()
    spec, eng = run(draft=NgramDraft(), spec_k=4, spec_tree=True,
                    spec_width=2)
    counts = kernels.launch_counts()
    assert counts["paged_decode_anc"] > 0, counts
    for a, b in zip(plain, spec):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="64 rows per kv head"):
        ServingEngine(model, num_slots=2, max_len=128, draft=NgramDraft(),
                      spec_k=16, spec_tree=True, spec_width=4)


#: the split kernel's edges: (query group, window rows, SWA, tree)
K3_SPLIT_SPECS = [(1, 1, None, False), (4, 9, None, True),
                  (2, 3, 100, False)]


def _k3_split_case(rs, variant, d, g, w_len, window, tree, dev):
    """Four slots over 128 logical pages of 16 (one kv head pair): the
    contexts 1, page_len - 1, exactly the end of the first split (from
    the card's own plan) and 2047 positions, the pages in a scrambled
    order with sentinels past each slot's last one."""
    page_len, p_max, hkv = 16, 128, 2
    _, pps = paged_split_plan(4 * hkv, p_max, page_len,
                              kernels.num_sms(torch.cuda.current_device()))
    ctx = np.array([1, page_len - 1, pps * page_len, 2047])
    t = (ctx - w_len).clip(0).astype(np.int32)
    n_live = [-(-(int(ti) + w_len) // page_len) for ti in t]
    n_pages = sum(n_live) + 3
    perm = rs.permutation(n_pages)
    table = np.full((4, p_max), n_pages, np.int32)
    used = 0
    for i, n in enumerate(n_live):
        table[i, :n] = perm[used:used + n]
        used += n
    pages = []
    for _ in range(2):
        x = torch.from_numpy(rs.randn(n_pages, hkv, page_len, d)
                             .astype(np.float32)).to(dev)
        if variant in (torch.float32, torch.bfloat16):
            pages.append((x.to(variant), None))
            continue
        payload, sc = pd._quantize_kv(x, variant)
        pages.append((pd.pack_int4(payload) if variant == 4 else payload,
                      sc))
    (kp, ks), (vp, vs) = pages
    kw = dict(scale=d ** -0.5, window=window)
    if ks is not None:
        kw.update(k_scale=ks, v_scale=vs)
    if tree:
        parents = np.full((4, w_len), -1, np.int64)
        for s in range(4):
            for j in range(1, w_len):
                parents[s, j] = rs.randint(0, j)
        kw["anc"] = torch.from_numpy(tree_ancestors(parents)[1]).to(dev)
    q = torch.from_numpy(rs.randn(4, w_len, hkv, g, d).astype(np.float32)) \
        .to(dev)
    return (q, kp, vp, torch.from_numpy(t).to(dev),
            torch.from_numpy(table).to(dev)), kw


@pytest.mark.parametrize("spec", K3_SPLIT_SPECS,
                         ids=["decode", "gqa_tree", "verify_swa"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("variant", ANC_VARIANTS,
                         ids=["f32", "bf16", "int8", "int4"])
def test_paged_kernel_splits_match_plain(dev, variant, d, spec):
    """The split kernel at the edges of its plan: a context of one
    position, of page_len - 1, ending exactly at a split's end and of
    2047 positions (odd positions in int4 pages), GQA G4 W9 trees and a
    verify window under SWA that empties the leading splits; D 32, 64
    and 128; one launch, the plain version's values, bitwise repeats."""
    g, w_len, window, tree = spec
    rs = np.random.RandomState(13)
    args, kw = _k3_split_case(rs, variant, d, g, w_len, window, tree, dev)
    quant = variant in (8, 4)
    name = (f"paged_decode_q{variant}" if quant else "paged_decode") + \
        ("_anc" if tree else "")
    before = kernels.launch_counts()[name]
    out = paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    ref = paged_decode_attention_reference(*args, **kw)
    tol = chip_smoke.KERNEL_BF16_TOL if variant == torch.bfloat16 else \
        chip_smoke.KERNEL_Q_TOL if quant else F32_TOL
    torch.testing.assert_close(out, ref, atol=tol, rtol=0)
    assert torch.equal(out, paged_decode_attention(*args, **kw))


#: backward gradients relative to the largest reference magnitude:
#: float32 differs by summation order over up to 300 keys; bfloat16 by
#: the output rounding (2^-8) plus the bf16-rounded P and dS tiles
BWD_F32_REL_TOL = 1e-4
BWD_BF16_REL_TOL = 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,s,window,hkv,d,layout,seg", [
    (True, 300, None, 4, 64, "bshd", None),     # causal, ragged vs 64
    (True, 257, 64, 4, 64, "bhsd", None),       # sliding window
    (True, 200, None, 1, 64, "bshd", None),     # GQA: 4 query heads per kv
    (True, 130, 9, 2, 128, "bshd", None),       # GQA + window, D=128
    (False, 70, None, 4, 32, "bhsd", None),     # non-causal, D=32
    (True, 300, None, 4, 64, "bshd", "contiguous"),
    (True, 1000, None, 4, 64, "bhsd", "late"),
    (False, 200, None, 4, 64, "bshd", "unsorted"),
    (True, 257, 64, 4, 64, "bshd", "contiguous"),  # window
    (True, 200, None, 1, 64, "bshd", "unsorted"),  # GQA 4x1
    (True, 130, 9, 2, 128, "bhsd", "equal"),
    (False, (96, 300), None, 4, 64, "bshd", None),   # Sq != Sk
    (False, (200, 70), None, 1, 64, "bhsd", None),   # Sq > Sk, GQA 4x1
])
def test_flash_backward_kernels_match_plain(dev, dtype, causal, s, window,
                                            hkv, d, layout, seg):
    """``s``: the length of both sides, or (Sq, Sk) of a non-causal
    call."""
    rs = np.random.RandomState(3)
    sq, sk = s if isinstance(s, tuple) else (s, s)
    q, k, v = _qkv(rs, 2, sq, sk, 4, hkv, d, dtype, dev, layout)
    ids = _segment_ids(rs, seg, 2, sq, dev)
    kw = dict(scale=d ** -0.5, causal=causal, window=window, layout=layout,
              segment_ids=ids)
    out, lse = flash_forward(q, k, v, **kw)
    dout = torch.from_numpy(rs.randn(*q.shape).astype(np.float32)) \
        .to(dev, dtype)
    delta = attention_delta(out, dout, layout)
    before = kernels.launch_counts()
    got = flash_backward(q, k, v, out, lse, dout, delta, **kw)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert after["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    ref = flash_backward_reference(q, k, v, out, lse, dout, delta, **kw)
    tol = BWD_F32_REL_TOL if dtype == torch.float32 else BWD_BF16_REL_TOL
    for name, g, r, like in zip(("dq", "dk", "dv"), got, ref, (q, k, v)):
        assert g.dtype == dtype and g.shape == like.shape, name
        assert torch.isfinite(g.float()).all(), name
        err = (g.float() - r.float()).abs().max().item()
        scale = r.float().abs().max().item()
        assert err <= tol * scale, (name, err, scale)
    if seg == "equal":
        kw["segment_ids"] = None
        plain = flash_backward(q, k, v, out, lse, dout, delta, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, plain))


def _backward_case(rs, dev, b, s, h, hkv, d, window=None, offset=0):
    """bf16 q, k, v, dout ``[B, S, H, D]`` (bshd) and the forward's out and
    lse; with ``offset`` each input is a view that starts that many
    elements into a larger buffer."""
    def make(heads):
        x = torch.from_numpy(rs.randn(b, s, heads, d).astype(np.float32))
        buf = torch.zeros(x.numel() + offset, dtype=torch.bfloat16,
                          device=dev)
        view = buf[offset:].view(b, s, heads, d)
        view.copy_(x)
        return view
    q, k, v, dout = make(h), make(hkv), make(hkv), make(h)
    kw = dict(scale=d ** -0.5, causal=True, window=window, layout="bshd")
    out, lse = flash_forward(q, k, v, **kw)
    return (q, k, v, out, lse, dout, attention_delta(out, dout)), kw


def _assert_backward_matches_plain(args, kw, got):
    ref = flash_backward_reference(*args, **kw)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert torch.isfinite(g.float()).all(), name
        err = (g.float() - r.float()).abs().max().item()
        scale = r.float().abs().max().item()
        assert err <= BWD_BF16_REL_TOL * scale, (name, err, scale)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_backward_is_bitwise_repeatable(dev, d):
    """No atomics: two launches of each backward kernel on the same bf16
    inputs give the same bits (causal, GQA 2x2, ragged S)."""
    args, kw = _backward_case(np.random.RandomState(7), dev, 2, 700, 4, 2,
                              d)
    first = flash_backward(*args, **kw)
    second = flash_backward(*args, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _assert_backward_matches_plain(args, kw, first)


@pytest.mark.parametrize("window", [None, 100])
def test_flash_backward_unaligned_views_take_the_copy_path(dev, window):
    """q, k, v and dout starting one element into their buffers miss
    TMA's 16-byte alignment: the kernels copy their tiles element by
    element and agree with the plain version as the TMA path does."""
    args, kw = _backward_case(np.random.RandomState(8), dev, 2, 300, 4, 2,
                              64, window=window, offset=1)
    assert all(x.data_ptr() % 16 != 0 for x in args[:3])
    before = kernels.launch_counts()
    got = flash_backward(*args, **kw)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert after["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    _assert_backward_matches_plain(args, kw, got)
    aligned = tuple(x.clone() if i < 3 or i == 5 else x
                    for i, x in enumerate(args))
    assert all(torch.equal(a, b)
               for a, b in zip(got, flash_backward(*aligned, **kw)))


def test_flash_backward_small_grid(dev):
    """B1 H2 S4096: fewer blocks than SMs, and long walks per block."""
    args, kw = _backward_case(np.random.RandomState(9), dev, 1, 4096, 2, 2,
                              64)
    got = flash_backward(*args, **kw)
    torch.cuda.synchronize()
    _assert_backward_matches_plain(args, kw, got)


def test_single_trainer_on_card_launches_the_training_kernels(dev):
    """One epoch of a small bf16 LM on the card: every step runs the
    forward and both backward kernels once per layer, and loss falls."""
    model = Model.build(zoo.transformer_lm(97, d_model=128, num_heads=4,
                                           num_layers=2, dtype="bfloat16",
                                           num_kv_heads=2),
                        (64,), seed=0, device=dev)
    rs = np.random.RandomState(4)
    rows = np.tile(rs.randint(0, 97, 16), (32, 5))[:, :65]
    data = Dataset.from_arrays(rows[:, :-1], rows[:, 1:])
    trainer = SingleTrainer(model, worker_optimizer="adam",
                            learning_rate=3e-3, batch_size=4, num_epoch=1,
                            loss="sparse_categorical_crossentropy_from_logits")
    kernels.reset_launch_counts()
    trainer.train(data)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    steps = 32 // 4
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert counts[name] == 2 * steps, (name, counts)
    losses = trainer.get_history().losses()
    assert np.isfinite(losses).all()
    assert losses[-4:].mean() < losses[0]


# --- K5: the quantized matmul ------------------------------------------------

#: the 218M LM's matrices and a ragged one, by their first word:
#: (weight shape, reduce axes), as chip_smoke.py's phase 15 runs them
QMM_SHAPES = {label.split()[0]: (shape, reduce_axes)
              for label, shape, reduce_axes in chip_smoke.QMM_SHAPES}


def _qmm_case(rs, shape, reduce_axes, bits, m, dtype, dev):
    w = torch.from_numpy((rs.randn(*shape) * 0.05).astype(np.float32))
    wq = {k: v.to(dev) for k, v in
          quantize_weight(w, bits, reduce_axes).items()}
    k = int(np.prod(shape[:len(reduce_axes or (0,))]))
    x = torch.from_numpy(rs.randn(m, k).astype(np.float32)).to(dev, dtype)
    return x, wq


@pytest.mark.parametrize("m", [1, 4, 8, 72])
@pytest.mark.parametrize("name", list(QMM_SHAPES))
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_kernel_matches_plain(dev, bits, name, m):
    shape, reduce_axes = QMM_SHAPES[name]
    rs = np.random.RandomState(m)
    dtype = torch.bfloat16 if name in ("wq", "w1") else torch.float32
    x, wq = _qmm_case(rs, shape, reduce_axes, bits, m, dtype, dev)
    assert ("q4" in wq) == (bits == 4)
    key = "quant_matmul_q4" if bits == 4 else "quant_matmul_q8"
    before = kernels.launch_counts()[key]
    out = quant_matmul(x, wq)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[key] == before + 1
    ref = reference_matmul(x, wq)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    err = (out - ref).abs().max().item() / ref.abs().max().item()
    assert err <= chip_smoke.QMM_TOL, err


def test_quant_matmul_kernel_is_bitwise_repeatable(dev):
    rs = np.random.RandomState(3)
    for shape, reduce_axes in (QMM_SHAPES["wo"], QMM_SHAPES["w2"]):
        x, wq = _qmm_case(rs, shape, reduce_axes, 4, 72, torch.float32, dev)
        assert torch.equal(quant_matmul(x, wq), quant_matmul(x, wq))


def test_quant_matmul_cpu_plain_cuda_kernel(dev):
    rs = np.random.RandomState(4)
    x, wq = _qmm_case(rs, (64, 48), None, 8, 3, torch.float32, "cpu")
    before = kernels.launch_counts()["quant_matmul_q8"]
    got = quant_matmul(x, wq)
    assert kernels.launch_counts()["quant_matmul_q8"] == before
    torch.testing.assert_close(got, reference_matmul(x, wq), rtol=0, atol=0)
    on_card = quant_matmul(x.to(dev), {k: v.to(dev) for k, v in wq.items()})
    torch.cuda.synchronize()
    assert kernels.launch_counts()["quant_matmul_q8"] == before + 1
    torch.testing.assert_close(on_card.cpu(), got, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", [1, 2, 3, 5, 8, 9, 16, 72, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_kernel_every_tile(dev, bits, dtype, m):
    """Every activation tile of both routes (CUDA cores at M <= 8 and for
    float32, tensor cores for bf16 from M9 on, up to 80 rows a block and
    beyond) at w1's shape, a ragged N, a weight off a 16-byte boundary
    (the plain-load fill) and a K of one split; one launch, the plain
    version's values within QMM_TOL, bitwise repeats."""
    rs = np.random.RandomState(100 + m)
    key = "quant_matmul_q4" if bits == 4 else "quant_matmul_q8"
    for k, n, offset in ((1024, 4096, 0), (512, 1000, 0), (256, 96, 1),
                         (64, 384, 0)):
        w = torch.from_numpy((rs.randn(k, n) * 0.05).astype(np.float32))
        wq = {a: b.to(dev) for a, b in quantize_weight(w, bits).items()}
        if offset:
            name = "q4" if bits == 4 else "q"
            buf = torch.zeros(wq[name].numel() + offset, dtype=torch.int8,
                              device=dev)
            buf[offset:] = wq[name].reshape(-1)
            wq[name] = buf[offset:].view(wq[name].shape)
            assert wq[name].data_ptr() % 16
        x = torch.from_numpy(rs.randn(m, k).astype(np.float32)).to(dev,
                                                                   dtype)
        before = kernels.launch_counts()[key]
        out = quant_matmul(x, wq)
        torch.cuda.synchronize()
        assert kernels.launch_counts()[key] == before + 1
        ref = reference_matmul(x, wq)
        err = (out - ref).abs().max().item() / ref.abs().max().item()
        assert err <= chip_smoke.QMM_TOL, (k, n, offset, err)
        assert torch.equal(out, quant_matmul(x, wq))


# --- K4: the fused sampling epilogue -----------------------------------------

#: mixed rows (greedy, top-k, top-p, both, k = 1, k >= V, p <= 0, +-0.0
#: logits at the k-th value, a tie at the k-th value), as chip_smoke.py's
#: phase 16 draws them
k4_case = chip_smoke.k4_inputs
K4_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.parametrize("dtype", K4_DTYPES)
@pytest.mark.parametrize("v", [100, 1000, 32768, 151936, 256000])
@pytest.mark.parametrize("s", [1, 4, 5, 8])
def test_sample_epilogue_kernel_matches_plain(dev, s, v, dtype):
    """Tokens equal the plain version's but at counted nucleus-boundary
    rows. V 256000 is too wide for a block's shared memory at 8 blocks a
    row: the kernel re-reads its slice from L2 on each pass."""
    rs = np.random.RandomState(s * 1000 + v)
    parted_total = 0
    for _ in range(4):
        args = k4_case(rs, s, v, dev, dtype)
        before = kernels.launch_counts()["sample_epilogue"]
        out = sample_epilogue(*args)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["sample_epilogue"] == before + 1
        ref = sample_epilogue_reference(*args)
        assert out.dtype == ref.dtype and out.shape == (s,)
        parted_total += len(boundary_partings(out, ref, *args[:4]))
    assert parted_total <= MAX_BOUNDARY_PARTINGS


def test_sample_epilogue_zero_and_empty_nucleus_rows(dev):
    """The +-0.0 row (ties of +0.0 and -0.0 at the k-th value, kept by
    index) and the p <= 0 row (nothing kept: index 0) on their own, every
    knob row once, float32 and bf16."""
    for dtype in (torch.float32, torch.bfloat16):
        rs = np.random.RandomState(7)
        args = k4_case(rs, len(chip_smoke.K4_TEMP), 2000, dev, dtype)
        out = sample_epilogue(*args)
        ref = sample_epilogue_reference(*args)
        assert len(boundary_partings(out, ref, *args[:4])) \
            <= MAX_BOUNDARY_PARTINGS
        temp, top_p = args[1].cpu(), args[3].cpu()
        empty = torch.nonzero((temp > 0) & (top_p <= 0)).flatten()
        assert len(empty) == 1 and int(out[empty[0]]) == 0


def test_sample_epilogue_is_one_kernel(dev):
    """One CUDA kernel a call: a captured graph of the call holds one
    kernel node (no cast, sort or copy around the launch)."""
    for dtype in (torch.float32, torch.bfloat16):
        args = k4_case(np.random.RandomState(3), 8, 32768, dev, dtype)
        assert chip_smoke.kernels_per_call(
            lambda: sample_epilogue(*args)) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sample_epilogue_bitwise_repeat(dev, dtype):
    rs = np.random.RandomState(5)
    for v in (1000, 32768, 151936):
        args = k4_case(rs, 8, v, dev, dtype)
        assert torch.equal(sample_epilogue(*args), sample_epilogue(*args))


def test_sample_epilogue_cpu_plain_cuda_kernel(dev):
    args = k4_case(np.random.RandomState(1), 8, 500, "cpu")
    before = kernels.launch_counts()["sample_epilogue"]
    got = sample_epilogue(*args)
    assert kernels.launch_counts()["sample_epilogue"] == before
    torch.testing.assert_close(got, sample_epilogue_reference(*args),
                               rtol=0, atol=0)
    on_card = sample_epilogue(*[a.to(dev) for a in args])
    torch.cuda.synchronize()
    assert kernels.launch_counts()["sample_epilogue"] == before + 1
    assert len(boundary_partings(on_card, got, *args[:4])) \
        <= MAX_BOUNDARY_PARTINGS


@pytest.mark.parametrize("wq,cache_dtype", [("int8", None),
                                            ("int4", "int4")])
def test_engine_on_card_weight_quant_runs_k5_and_k4(dev, wq, cache_dtype):
    """A quantized-weight engine on the card: K5 in every decode step
    (the projections, MLP and head), K4 for the sampled request."""
    model = Model.build(zoo.transformer_lm(97, d_model=128, num_heads=4,
                                           num_layers=2, dtype="bfloat16",
                                           num_kv_heads=2),
                        (16,), seed=0, device=dev)
    eng = ServingEngine(model, num_slots=2, max_len=128, prefill_chunk=32,
                        weight_quant=wq, cache_dtype=cache_dtype,
                        fused_sampling=True)
    rs = np.random.RandomState(9)
    kernels.reset_launch_counts()
    rids = [eng.submit(rs.randint(0, 97, 70), 6),
            eng.submit(rs.randint(0, 97, 9), 6, temperature=0.8, top_k=20,
                       top_p=0.9, seed=2),
            eng.submit(rs.randint(0, 97, 40), 6)]
    out = eng.run(max_steps=500)
    assert sorted(out) == rids
    counts = kernels.launch_counts()
    key = "quant_matmul_q4" if wq == "int4" else "quant_matmul_q8"
    # at least 5 decode steps, each 2 layers x (q, k, v, o, w1, w2) + head
    assert counts[key] >= 5 * (2 * 6 + 1), counts
    assert counts["sample_epilogue"] >= 1, counts
    bf16_bytes = model.num_params() * 2
    assert eng.param_bytes() < bf16_bytes * (0.55 if wq == "int8" else 0.3)


def test_generate_on_card_quantized_weights_launch_k5(dev):
    model = Model.build(zoo.transformer_lm(97, d_model=128, num_heads=4,
                                           num_layers=2, dtype="bfloat16"),
                        (16,), seed=0, device=dev)
    prompts = np.random.RandomState(3).randint(0, 97, (2, 30))
    for wd in ("int8", "int4"):
        kernels.reset_launch_counts()
        out = model.generate(prompts, 6, weights_dtype=wd)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        # per decode step: 2 layers x (q, k, v, o, w1, w2) + the head;
        # plus the prefill's head
        assert counts["quant_matmul_q8"] == 5 * 13 + 1, counts
        assert counts["decode_attention"] == 2 * 5, counts
        assert out.shape == (2, 36) and ((out >= 0) & (out < 97)).all()


# --- K6a: the MoE expert up-projection with the token gather fused in --------

#: phase 19's cases, by label: (tokens, capacity, d, H, routing)
K6A_CASES = {label: case for label, *case in chip_smoke.K6A_CASES}


def _k6a_check(out, ref, dtype):
    """``out`` against ``ref``, the float32 plain result
    (``chip_smoke.k6a_reference``) at phase 19's tolerances."""
    assert ref.dtype == torch.float32
    err = (out.float() - ref).abs().max().item()
    if dtype == torch.bfloat16:
        assert err <= chip_smoke.K6A_BF16_TOL, err
    else:
        assert err / ref.abs().max().item() <= chip_smoke.K6A_F32_TOL, err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("label", list(K6A_CASES))
def test_moe_gather_gemm1_kernel_matches_plain(dev, label, dtype):
    """K6a against its plain version on phase 19's plans (bf16 2e-2 max
    abs, float32 1e-4 relative); rows no slot won equal ``act(b1)``; the
    same inputs give the same bits."""
    n, c, d, h, routing = K6A_CASES[label]
    rs = np.random.RandomState(n + c)
    xt, src, w1, b1 = chip_smoke.k6a_inputs(rs, n, c, d, h, routing, dtype,
                                            dev)
    before = kernels.launch_counts()["moe_gather_gemm1"]
    out = gather_gemm1(xt, src, w1, b1, c)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["moe_gather_gemm1"] == before + 1
    assert out.dtype == dtype and out.shape == (8, c, h)
    ref = chip_smoke.k6a_reference(xt, src, w1, b1, c)
    _k6a_check(out, ref, dtype)
    empty = (src < 0).reshape(8, c)
    if empty.any():
        act_b1 = torch.nn.functional.gelu(b1.float(), approximate="tanh")
        _k6a_check(out[empty], act_b1[:, None].expand(8, c, h)[empty],
                   dtype)
    assert torch.equal(out, gather_gemm1(xt, src, w1, b1, c))


@pytest.mark.parametrize("activation", ["relu", "silu", "linear"])
@pytest.mark.parametrize("n,c,d,h", [(5, 3, 40, 99), (300, 90, 70, 136)])
def test_moe_gather_gemm1_odd_widths_and_activations(dev, n, c, d, h,
                                                     activation):
    """Widths off the 16-byte load (H not a multiple of 8), a d split
    that does not divide d, and the other epilogues."""
    rs = np.random.RandomState(h)
    xt, src, w1, b1 = chip_smoke.k6a_inputs(rs, n, c, d, h, "random",
                                            torch.float32, dev)
    out = gather_gemm1(xt, src, w1, b1, c, activation)
    ref = chip_smoke.k6a_reference(xt, src, w1, b1, c, activation)
    _k6a_check(out, ref, torch.float32)


def _k6a_launch(xt, src, w1, b1, c, wg, activation="gelu"):
    """K6a through its wrapper, once, on a capacity that takes the
    tensor-core kernel with ``wg`` warpgroups a block."""
    d, h = w1.shape[1:]
    assert moe_kernels.gemm1_plan(c, d, h, 8,
                                  kernels.num_sms(xt.device.index),
                                  True)[0] == wg
    before = kernels.launch_counts()["moe_gather_gemm1"]
    out = gather_gemm1(xt, src, w1, b1, c, activation)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["moe_gather_gemm1"] == before + 1
    return out


@pytest.mark.parametrize("n,c,d,h,wg", [(64, 33, 70, 136, 1),
                                        (20, 20, 1024, 2048, 1),
                                        (300, 90, 70, 136, 2),
                                        (2048, 640, 1024, 2048, 2)])
def test_moe_gather_gemm1_bf16_is_bitwise_repeatable(dev, n, c, d, h, wg):
    """No atomics: the tensor-core kernel, with one warpgroup a block (C
    <= 64) or two (C > 64), gives the same bits twice, and agrees with
    the plain version."""
    xt, src, w1, b1 = chip_smoke.k6a_inputs(np.random.RandomState(wg + c),
                                            n, c, d, h, "random",
                                            torch.bfloat16, dev)
    first = _k6a_launch(xt, src, w1, b1, c, wg)
    assert torch.equal(first, _k6a_launch(xt, src, w1, b1, c, wg))
    _k6a_check(first, chip_smoke.k6a_reference(xt, src, w1, b1, c),
               torch.bfloat16)


@pytest.mark.parametrize("n,c,wg", [(64, 40, 1), (256, 80, 2)])
def test_moe_gather_gemm1_unaligned_w1_takes_the_copy_path(dev, n, c, wg):
    """A w1 view one element into its buffer misses TMA's 16-byte
    alignment: the kernel copies w1 with cp.async element by element,
    bitwise equal to the TMA path on an aligned copy of it."""
    d, h = 1024, 2048
    xt, src, w1, b1 = chip_smoke.k6a_inputs(np.random.RandomState(11), n, c,
                                            d, h, "random", torch.bfloat16,
                                            dev)
    buf = torch.empty(w1.numel() + 1, dtype=w1.dtype, device=dev)
    view = buf[1:].view(w1.shape)
    view.copy_(w1)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    got = _k6a_launch(xt, src, view, b1, c, wg)
    assert torch.equal(got, _k6a_launch(xt, src, w1, b1, c, wg))
    _k6a_check(got, chip_smoke.k6a_reference(xt, src, w1, b1, c),
               torch.bfloat16)


@pytest.mark.parametrize("n,c,wg", [(40, 60, 1), (150, 200, 2)])
@pytest.mark.parametrize("activation", ["linear", "relu", "gelu"])
def test_moe_gather_gemm1_empty_rows_are_act_b1(dev, n, c, wg, activation):
    """A row tile no slot reached (its product skipped) and the -1 rows
    of a filled tile write the same bits, act(b1[e]) from the float32
    epilogue: exactly b1 and relu(b1) for linear and relu, gelu within
    the bf16 tolerance of the plain version."""
    d, h = 136, 200
    xt, src, w1, b1 = chip_smoke.k6a_inputs(np.random.RandomState(wg), n, c,
                                            d, h, "two-experts",
                                            torch.bfloat16, dev)
    tok = src.reshape(8, c)
    # experts 2-7 hold no slot, experts 0-1 a filled prefix and -1 rows
    assert (tok[2:] < 0).all() and (tok[:2] < 0).any() and (
        tok[:2] >= 0).any()
    out = _k6a_launch(xt, src, w1, b1, c, wg, activation)
    empty = tok < 0
    rows = out[empty]
    want = gather_gemm1_reference(xt, src, w1, b1, c, activation)[empty]
    if activation == "gelu":
        _k6a_check(rows, chip_smoke.k6a_reference(
            xt, src, w1, b1, c, activation)[empty], torch.bfloat16)
    else:
        assert torch.equal(rows, want)
    per_expert = out.reshape(8, c, h)
    for e in range(8):
        e_rows = per_expert[e][empty[e]]
        assert (e_rows == e_rows[:1]).all(), e


def test_moe_gather_gemm1_routes_agree(dev):
    """The tensor-core kernel with one warpgroup a block (C 64) and with
    two (C 72), and the CUDA-core kernel on the same values in float32,
    give the same function: each within the bf16 tolerance of the plain
    version."""
    d, h = 1024, 2048
    for n, c, wg in ((96, 64, 1), (96, 72, 2)):
        xt, src, w1, b1 = chip_smoke.k6a_inputs(np.random.RandomState(13),
                                                n, c, d, h, "random",
                                                torch.bfloat16, dev)
        ref = chip_smoke.k6a_reference(xt, src, w1, b1, c)
        _k6a_check(_k6a_launch(xt, src, w1, b1, c, wg), ref,
                   torch.bfloat16)
        f32 = gather_gemm1(xt.float(), src, w1.float(), b1.float(), c)
        _k6a_check(f32, ref, torch.bfloat16)


def test_moe_gather_gemm1_cpu_plain_cuda_kernel(dev):
    xt, src, w1, b1 = chip_smoke.k6a_inputs(np.random.RandomState(2), 12, 5,
                                            32, 48, "random", torch.float32,
                                            "cpu")
    before = kernels.launch_counts()["moe_gather_gemm1"]
    got = gather_gemm1(xt, src, w1, b1, 5)
    assert kernels.launch_counts()["moe_gather_gemm1"] == before
    torch.testing.assert_close(
        got, gather_gemm1_reference(xt, src, w1, b1, 5), rtol=0, atol=0)
    on_card = gather_gemm1(*(a.to(dev) for a in (xt, src, w1, b1)), 5)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["moe_gather_gemm1"] == before + 1
    torch.testing.assert_close(on_card.cpu(), got, rtol=1e-5, atol=1e-5)


def test_engine_on_card_moe_runs_k6a_per_layer_step(dev):
    """An MoE engine on the card: K6a once per MoE layer in every decode
    step and verify when dispatched, never with ``moe_decode="dense"``;
    ``generate()`` on fused-dispatch layers launches it once per layer
    in the prefill and in every decode step."""
    import sys
    model = Model.build(zoo.transformer_lm(97, d_model=128, num_heads=4,
                                           num_layers=2, dtype="bfloat16",
                                           mlp_ratio=2, moe_every=1,
                                           num_experts=8),
                        (16,), seed=0, device=dev)
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, 97, 40), rs.randint(0, 97, 9)]
    eng_mod = sys.modules["distkeras_tpu_torch.serving.engine"]
    for mode, draft in (("dispatched", None), ("dense", None),
                        ("dispatched", NgramDraft())):
        eng = ServingEngine(model, num_slots=2, max_len=128,
                            prefill_chunk=32, moe_decode=mode, draft=draft,
                            spec_k=3)
        kernels.reset_launch_counts()
        with chip_smoke._Calls(eng_mod, "decode_step_slots_paged",
                               "verify_step_slots_paged") as steps:
            rids = [eng.submit(p, 6) for p in prompts]
            out = eng.run(max_steps=200)
        assert sorted(out) == rids
        n = kernels.launch_counts()["moe_gather_gemm1"]
        if mode == "dispatched":
            assert steps.n >= 5 and n == 2 * steps.n, (n, steps.n)
            assert eng.metrics.summary()["moe"] is not None
        else:
            assert n == 0 and eng.metrics.summary()["moe"] is None
    for blk in model.module.layers[1:3]:
        blk.mlp.dispatch = "fused"
    kernels.reset_launch_counts()
    out = model.generate(np.stack([prompts[0][:9], prompts[1]]), 3)
    torch.cuda.synchronize()
    # the prefill and two decode steps, 2 layers each
    assert kernels.launch_counts()["moe_gather_gemm1"] == 3 * 2
    assert out.shape == (2, 12)


# --- K6b, K6c: the fused MoE block's backward -------------------------------

#: phase 22's cases, by label: (tokens, capacity, d, H, routing)
K6BC_CASES = {label: case for label, *case in chip_smoke.K6BC_CASES}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("label", list(K6BC_CASES))
def test_moe_backward_kernels_match_plain(dev, label, dtype):
    """K6b and K6c against their plain versions on phase 22's plans, at
    phase 22's tolerances (relative to each output's largest |value|):
    rows no slot won give exact zeros, the same inputs the same bits."""
    n, c, d, h, routing = K6BC_CASES[label]
    args = chip_smoke.k6bc_inputs(np.random.RandomState(n + c), n, c, d, h,
                                  routing, dtype, dev)
    xt, src = args[0], args[2]
    before = kernels.launch_counts()
    out = bwd_dx(*args, c)
    ref = bwd_dx_reference(*args, c)
    dw1 = bwd_dw1(xt, ref[1], src, c)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["moe_bwd_dx"] == before["moe_bwd_dx"] + 1
    assert after["moe_bwd_dw1"] == before["moe_bwd_dw1"] + 1
    bf16 = dtype == torch.bfloat16
    tol = chip_smoke.K6BC_BF16_TOL if bf16 else chip_smoke.K6BC_F32_TOL
    f32_tol = chip_smoke.K6BC_BF16_F32_OUT_TOL if bf16 else tol
    empty = (src < 0).reshape(8, c)
    for name, a, b in zip(chip_smoke.K6BC_OUTPUTS, out, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        limit = f32_tol if name == "rowdot" else tol
        assert chip_smoke._rel(a, b) <= limit, name
        assert (a[empty] == 0).all(), name
    assert chip_smoke._rel(
        dw1, bwd_dw1_reference(xt, ref[1], src, c)) <= f32_tol
    again = bwd_dx(*args, c)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert torch.equal(dw1, bwd_dw1(xt, ref[1], src, c))


@pytest.mark.parametrize("label", ["training N8192", "odd d70 H70 N300"])
def test_moe_backward_bf16_is_bitwise_repeatable(dev, label):
    """K6b and K6c, whose mainloop lives in the header they share with
    K6a, give the same bits twice on the same bf16 inputs."""
    n, c, d, h, routing = K6BC_CASES[label]
    args = chip_smoke.k6bc_inputs(np.random.RandomState(c), n, c, d, h,
                                  routing, torch.bfloat16, dev)
    xt, src = args[0], args[2]
    first = bwd_dx(*args, c)
    dw1 = bwd_dw1(xt, first[1], src, c)
    again = bwd_dx(*args, c)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert torch.equal(dw1, bwd_dw1(xt, again[1], src, c))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", ["relu", "silu", "linear"])
def test_moe_backward_kernels_other_activations(dev, activation, dtype):
    n, c, d, h = 300, 90, 70, 136
    args = chip_smoke.k6bc_inputs(np.random.RandomState(7), n, c, d, h,
                                  "random", dtype, dev)
    out = bwd_dx(*args, c, activation)
    ref = bwd_dx_reference(*args, c, activation)
    bf16 = dtype == torch.bfloat16
    tol = chip_smoke.K6BC_BF16_TOL if bf16 else chip_smoke.K6BC_F32_TOL
    f32_tol = chip_smoke.K6BC_BF16_F32_OUT_TOL if bf16 else tol
    for name, a, b in zip(chip_smoke.K6BC_OUTPUTS, out, ref):
        limit = f32_tol if name == "rowdot" else tol
        assert chip_smoke._rel(a, b) <= limit, name


def test_moe_backward_cpu_plain_cuda_kernel(dev):
    """A CPU tensor takes the plain version (no launch), a CUDA tensor
    the kernel."""
    args = chip_smoke.k6bc_inputs(np.random.RandomState(3), 12, 5, 32, 48,
                                  "random", torch.float32, "cpu")
    xt, src = args[0], args[2]
    before = kernels.launch_counts()
    got = bwd_dx(*args, 5)
    got_w = bwd_dw1(xt, got[1], src, 5)
    assert kernels.launch_counts() == before
    on_card = bwd_dx(*(a.to(dev) for a in args), 5)
    on_card_w = bwd_dw1(xt.to(dev), got[1].to(dev), src.to(dev), 5)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["moe_bwd_dx"] == before["moe_bwd_dx"] + 1
    assert after["moe_bwd_dw1"] == before["moe_bwd_dw1"] + 1
    for a, b in zip(on_card + (on_card_w,), got + (got_w,)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


def test_moe_train_step_on_card_runs_k6abc_per_block(dev):
    """One training step of an all-MoE LM with the fused dispatch on the
    card launches K6a, K6b and K6c once per MoE block."""
    model = Model.build(zoo.transformer_lm(97, d_model=128, num_heads=4,
                                           num_layers=2, dtype="bfloat16",
                                           mlp_ratio=2, moe_every=1,
                                           num_experts=8,
                                           moe_dispatch="fused",
                                           moe_aux_loss_weight=0.01,
                                           moe_capacity_factor=1.0),
                        (64,), seed=0, device=dev)
    rs = np.random.RandomState(4)
    x = rs.randint(0, 97, (32, 64))
    kernels.reset_launch_counts()
    trainer = SingleTrainer(model, worker_optimizer="adam",
                            learning_rate=1e-3, batch_size=32,
                            loss="sparse_categorical_crossentropy_from_"
                                 "logits")
    trainer.train(Dataset.from_arrays(x, np.roll(x, -1, axis=1)))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for name in ("moe_gather_gemm1", "moe_bwd_dx", "moe_bwd_dw1"):
        assert counts[name] == 2, (name, counts)
    assert np.isfinite(trainer.get_history().losses()).all()


# --- the zero-bubble loop: launches free of host syncs, capture readiness ---


def _small_lm(dev, **kw):
    return Model.build(zoo.transformer_lm(97, d_model=128, num_heads=4,
                                          num_layers=2, dtype="bfloat16",
                                          **kw),
                       (16,), seed=0, device=dev)


@pytest.mark.parametrize("label", [c[0] for c in chip_smoke.SYNC_FREE_CASES]
                         + ["MoE dispatched greedy", "MoE dispatched sampled"]
                         + [c[0] for c in chip_smoke.OBS_SYNC_FREE_CASES])
def test_launch_step_makes_no_host_sync(dev, label):
    """Every ``_launch_step`` of a pipelined ``fuse_steps=4`` engine, a
    single step or a fused window, greedy or sampled, over bf16, int8 or
    int4 pages, int8 weights, fused sampling, and dispatched MoE, runs
    under ``torch.cuda.set_sync_debug_mode("error")`` without raising
    (phase 25's configurations, on a 2-layer model); with the tracer, the
    flight recorder, SLOs and a time series on, every obs hook does too
    (phase 32's configurations)."""
    if label.startswith("obs"):
        sampled = dict(chip_smoke.OBS_SYNC_FREE_CASES)[label]
        watch = chip_smoke.sync_free_run(
            _small_lm(dev, num_kv_heads=2), label,
            chip_smoke.obs_engine_kw(True), sampled, obs_hooks=True)
        assert watch.windows >= 1 and watch.units > watch.windows
        return
    if label.startswith("MoE"):
        model = _small_lm(dev, mlp_ratio=2, moe_every=1, num_experts=8)
        kw, sampled = {}, label.endswith("sampled")
    else:
        model = _small_lm(dev, num_kv_heads=2)
        _, kw, sampled = next(c for c in chip_smoke.SYNC_FREE_CASES
                              if c[0] == label)
    watch = chip_smoke.sync_free_run(model, label, kw, sampled)
    assert watch.windows >= 1 and watch.units > watch.windows


@pytest.mark.parametrize("num_steps", [1, 4])
def test_decode_launch_is_capture_ready(dev, num_steps):
    """One ``decode_step_slots_paged`` and one ``decode_fused_slots``
    window of 4, on static buffers, captured in a CUDA graph after a
    warm call: the replay equals the eager call bitwise in its tokens
    and in every visible page. Nothing on the main path uses a graph."""
    same_tokens, same_pages, replay_ms, _ = chip_smoke.capture_check(
        _small_lm(dev, num_kv_heads=2), dev, num_steps)
    assert same_tokens and same_pages
    assert replay_ms > 0


# --- the slab engine, host KV offload, quantized MoE experts -------------------


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_slab_decode_launch_makes_no_host_sync(dev, sampled):
    """Every ``_launch_step`` of a pipelined ``fuse_steps=4`` slab engine,
    single steps and fused windows, runs under
    ``set_sync_debug_mode("error")`` (the slab write lands in place,
    a free slot's in the sink row)."""
    watch = chip_smoke.sync_free_run(_small_lm(dev, num_kv_heads=2),
                                     "slab", dict(kv_layout="slab"), sampled)
    assert watch.windows >= 1 and watch.units > watch.windows


@pytest.mark.parametrize("num_steps", [1, 4])
def test_slab_decode_launch_is_capture_ready(dev, num_steps):
    """One ``decode_step_slots`` and one slab ``decode_fused_slots`` window
    of 4 captured in a CUDA graph replay bitwise equal to the eager call,
    tokens and rows."""
    same_tokens, same_rows, replay_ms, _ = chip_smoke.capture_check(
        _small_lm(dev, num_kv_heads=2), dev, num_steps, layout="slab")
    assert same_tokens and same_rows
    assert replay_ms > 0


def _fill_planes(pool, seed):
    gen = torch.Generator(device=pool.device).manual_seed(seed)
    for kv in pool.cache:
        if kv is None:
            continue
        for x in kv["sink"].values():
            if x.dtype == torch.int8:
                x.copy_(torch.randint(-128, 128, x.shape, generator=gen,
                                      device=x.device, dtype=torch.int8))
            else:
                x.copy_(torch.randn(x.shape, generator=gen, device=x.device))


def _planes(pool, pids):
    return [{k: kv[k][pids].clone() for k in ("k", "v", "k_scale", "v_scale")
             if k in kv} for kv in pool.cache if kv is not None]


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8", "int4"])
def test_offload_restore_round_trip_on_the_card(dev, cache_dtype):
    """The host tier on the card: a swap-out makes no host sync (a device
    snapshot, a non-blocking copy into pinned memory, an event), later
    writes do not reach it, the first restore fences it, and the pages
    restored onto other ids are byte-identical; a batch freed whole is
    dropped unfenced; ``offload_bytes`` is pages x ``page_bytes``."""
    model = _small_lm(dev, num_kv_heads=2)
    dtype = torch.bfloat16 if cache_dtype == "bfloat16" else cache_dtype
    pool = PagedKVPool(model.module, 2, 64, page_len=16, host_pages=4,
                       dtype=dtype, device=dev)
    assert next(kv for kv in pool.host_cache
                if kv is not None)["k"].is_pinned()
    _fill_planes(pool, 3)
    want = _planes(pool, [0, 2])
    with chip_smoke._SyncErrors():
        hids = pool.offload_pages([0, 2])
    assert pool.host_swap_pending == 2 and pool.host_fences == 0
    _fill_planes(pool, 4)                       # overwrite the sources
    pool.restore_pages(hids, [3, 5])
    assert pool.host_fences == 1 and pool.host_swap_pending == 0
    for got, ref in zip(_planes(pool, [3, 5]), want):
        for key in ref:
            assert torch.equal(got[key], ref[key]), key
    pool.free_host(hids)
    dropped = pool.offload_pages([1])
    pool.free_host(dropped)
    assert pool.host_fences == 1 and pool.host_free_pages == 4
    assert pool.offload_bytes == 3 * pool.page_bytes
    assert pool.pages_offloaded == 3 and pool.pages_restored == 2


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantized_moe_experts_match_the_cpu(dev, bits):
    """An MoE layer's int8/int4 stacked expert leaves, quantized on the
    CPU and moved to the card: ``_moe_params`` dequantizes them there
    bitwise as on the CPU, and ``decode_apply`` over them (K6a) matches
    the CPU's plain path on the same input."""
    from distkeras_tpu_torch.models.decoding import _moe_params
    from distkeras_tpu_torch.models.moe import MoE
    from distkeras_tpu_torch.ops.quant_matmul import quantize_params_tree
    from distkeras_tpu_torch.utils.tree import tree_map
    kw = dict(mlp_ratio=2, moe_every=1, num_experts=8)
    cpu = Model.build(zoo.transformer_lm(97, d_model=128, num_heads=4,
                                         num_layers=2, dtype="bfloat16",
                                         **kw), (16,), seed=0, device="cpu")
    card = _small_lm(dev, **kw)
    q_cpu = quantize_params_tree(cpu.params, bits)
    q_card = tree_map(lambda x: x.to(dev), q_cpu)
    x = torch.from_numpy(np.random.RandomState(5).randn(4, 1, 128).astype(
        np.float32)).to(torch.bfloat16)
    n = 0
    for layer_c, layer_g, pc, pg in zip(cpu.module.layers,
                                        card.module.layers, q_cpu, q_card):
        mlp_c = getattr(layer_c, "mlp", None)
        if not isinstance(mlp_c, MoE):
            continue
        dc, dg = _moe_params(mlp_c, pc["mlp"]), _moe_params(layer_g.mlp,
                                                            pg["mlp"])
        for key in ("w1", "w2"):
            assert dg[key].dtype == torch.bfloat16
            assert torch.equal(dg[key].cpu(), dc[key]), key
        before = kernels.launch_counts()["moe_gather_gemm1"]
        got = layer_g.mlp.decode_apply(dg, x.to(dev)).float().cpu()
        assert kernels.launch_counts()["moe_gather_gemm1"] == before + 1
        ref = mlp_c.decode_apply(dc, x).float()
        assert (got - ref).abs().max() / ref.abs().max() <= BF16_TOL
        n += 1
    assert n == 2


# --- K7: JAX's threefry draw (csrc/prng.cu) -----------------------------------


@pytest.mark.parametrize("case", chip_smoke.K7_CASES,
                         ids=[c[0] for c in chip_smoke.K7_CASES])
def test_k7_matches_plain_version(dev, case):
    """K7 against its plain version on the card at phase 26's shapes:
    splits, bits and uniforms bitwise, the Gumbel field within
    ``prng.GUMBEL_ULPS``; one launch a call, bitwise repeatable."""
    from distkeras_tpu_torch.ops import prng
    _, r, n, mode = case
    keys = prng.split(prng.key(5), r).to(dev)
    lo, hi = chip_smoke._k7_range(mode)
    before = kernels.launch_counts()["prng"]
    out = prng._launch(keys, n, mode, lo, hi)
    assert kernels.launch_counts()["prng"] == before + 1
    ref = prng.draw_reference(keys, n, mode, lo, hi)
    torch.cuda.synchronize()
    if mode == prng.GUMBEL:
        assert prng.ulps(out, ref).max() <= prng.GUMBEL_ULPS
    else:
        assert torch.equal(out, ref)
    assert torch.equal(out, prng._launch(keys, n, mode, lo, hi))


@pytest.mark.parametrize("shape", [(7,), (3, 5), (4, 29), (2, 3, 1000)])
def test_k7_draws_equal_the_cpu(dev, shape):
    """The public draws on card keys against the same draws on CPU keys
    (the plain version there): keys, splits, bits, float32/bf16/fp16
    uniforms and Bernoulli masks bitwise; Gumbel and normal fields
    within the stated ulps; batched keys too."""
    from distkeras_tpu_torch.ops import prng
    for rng in (prng.key(2 ** 32 + 9), prng.split(prng.key(3), 4)):
        card = rng.to(dev)
        assert torch.equal(prng.split(card, 3).cpu(), prng.split(rng, 3))
        assert torch.equal(prng.random_bits(card, shape).cpu(),
                           prng.random_bits(rng, shape))
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            assert torch.equal(
                prng.uniform(card, shape, dt, -0.3, 0.3).cpu(),
                prng.uniform(rng, shape, dt, -0.3, 0.3))
        assert torch.equal(prng.bernoulli(card, 0.7, shape).cpu(),
                           prng.bernoulli(rng, 0.7, shape))
        assert prng.ulps(prng.gumbel(card, shape).cpu(),
                         prng.gumbel(rng, shape)).max() <= prng.GUMBEL_ULPS
        assert prng.ulps(prng.normal(card, shape).cpu(),
                         prng.normal(rng, shape)).max() <= prng.NORMAL_ULPS


def test_model_built_on_the_card_equals_the_cpu_build(dev):
    """``Model.build(seed=)`` draws on the card (K7) the CPU's weights,
    bitwise: the LM's initializers are uniform."""
    kw = dict(d_model=64, num_heads=4, num_layers=2, mlp_ratio=2)
    card = Model.build(zoo.transformer_lm(97, **kw), (16,), seed=4,
                       device=dev)
    cpu = Model.build(zoo.transformer_lm(97, **kw), (16,), seed=4,
                      device="cpu")
    for a, b in zip(card.module.parameters(), cpu.module.parameters()):
        assert torch.equal(a.cpu(), b)


def test_sampled_card_engine_equals_cpu_float32_choices(dev):
    """A float32 model's sampled streams through the card engine (K7 keys
    and fields, K3 readout) equal the CPU engine's on the same weights,
    with the unfused and the fused sampler: the keys are bitwise and the
    Gumbel fields within a few ulps of each other."""
    cpu = Model.build(zoo.transformer_lm(97, d_model=128, num_heads=4,
                                         num_layers=2), (16,), seed=1,
                      device="cpu")
    card = Model.build(zoo.transformer_lm(97, d_model=128, num_heads=4,
                                          num_layers=2), (16,), seed=1,
                       device=dev)
    rs = np.random.RandomState(0)
    reqs = [(rs.randint(0, 97, 20), dict(temperature=1.5, seed=3)),
            (rs.randint(0, 97, 9), dict(temperature=2.0, top_k=10,
                                        seed=2 ** 32 + 1)),
            (rs.randint(0, 97, 14), {})]

    def streams(model, device, fused):
        eng = ServingEngine(model, num_slots=3, max_len=64, page_len=16,
                            device=device, fused_sampling=fused)
        rids = [eng.submit(p, 16, **k) for p, k in reqs]
        out = eng.run(max_steps=300)
        return [out[r] for r in rids]

    for fused in (False, True):
        for a, b in zip(streams(card, dev, fused),
                        streams(cpu, "cpu", fused)):
            np.testing.assert_array_equal(a, b)


# --- the distributed-SGD family with its workers stacked on the card --------

def _mlp(device):
    from distkeras_tpu_torch.models import Sequential
    from distkeras_tpu_torch.models.layers import Dense
    return Model.build(Sequential([Dense(64, activation="relu"), Dense(4)]),
                       (16,), seed=0, device=device)


@pytest.mark.parametrize("name", ["DOWNPOUR", "ADAG"])
def test_engine_center_on_card_matches_cpu(dev, name):
    """The stacked-worker engine's center after two epochs of 8 workers
    on the card equals the CPU run of the same MLP (float32, the same
    seeded weights) within 1e-3 of each leaf's largest |value|."""
    import distkeras_tpu_torch.parallel as par
    rs = np.random.RandomState(0)
    X = rs.randn(1024, 16).astype(np.float32)
    y = np.argmax(X @ rs.randn(16, 4), axis=1)
    ds = Dataset({"features": X, "label": y})
    kw = dict(num_workers=8, batch_size=32, num_epoch=2,
              communication_window=2, worker_optimizer="sgd",
              learning_rate=0.05,
              loss="sparse_categorical_crossentropy_from_logits")
    card = getattr(par, name)(_mlp(dev), **kw).train(ds)
    cpu = getattr(par, name)(_mlp("cpu"), **kw).train(ds)
    for a, b in zip(card.module.parameters(), cpu.module.parameters()):
        a = a.detach().cpu()
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


def test_lm_downpour_losses_on_card_match_cpu(dev):
    """DOWNPOUR over a 2-layer LM of the full widths (d_model 1024, 16
    heads, vocab 32768), 2 workers, bf16 on the card: the per-worker
    losses agree with the CPU float32 run within 5e-2 relative, and the
    flash kernels launch once per layer in every worker step."""
    import distkeras_tpu_torch.parallel as par
    cfg = dict(d_model=1024, num_heads=16, num_layers=2, mlp_ratio=4)
    card = Model.build(zoo.transformer_lm(32768, dtype="bfloat16", **cfg),
                       (16,), seed=0, device=dev)
    cpu = Model.build(zoo.transformer_lm(32768, **cfg), (16,), seed=0,
                      device="cpu")
    rs = np.random.RandomState(0)
    toks = np.tile(rs.randint(0, 32768, (8, 32)), (1, 5))[:, :129]
    ds = Dataset.from_arrays(toks[:, :-1], toks[:, 1:])
    kw = dict(num_workers=2, batch_size=2, num_epoch=2,
              communication_window=2, worker_optimizer="adam",
              learning_rate=1e-3,
              loss="sparse_categorical_crossentropy_from_logits")
    tr_card = par.DOWNPOUR(card, **kw)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    tr_card.train(ds)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    steps = 2 * (8 // (2 * 2)) * 2
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert counts[name] == 2 * steps, (name, counts[name])
    assert counts["prng"] == steps + 1
    tr_cpu = par.DOWNPOUR(cpu, **kw)
    tr_cpu.train(ds)
    a, b = tr_card.get_history().losses(), tr_cpu.get_history().losses()
    assert a.shape == b.shape == (steps // 2, 2)
    np.testing.assert_allclose(a, b, rtol=5e-2)


def test_lm_downpour_center_on_card_matches_cpu(dev):
    """The center a DOWNPOUR run of a 2-layer full-width LM extracts on
    the card (float32, 2 workers, window 2 amortized with staggered
    offsets, two epochs: the snapshot rows, the block commits and the
    tail carry all shape it) equals the CPU run's: each leaf's move from
    the initial weights agrees within 1e-3 of the CPU move's largest
    |value|, and the center did move."""
    import distkeras_tpu_torch.parallel as par
    cfg = dict(d_model=1024, num_heads=16, num_layers=2, mlp_ratio=4)
    card = Model.build(zoo.transformer_lm(32768, **cfg), (16,), seed=0,
                       device=dev)
    cpu = Model.build(zoo.transformer_lm(32768, **cfg), (16,), seed=0,
                      device="cpu")
    init = [t.detach().clone() for t in cpu.module.parameters()]
    rs = np.random.RandomState(0)
    toks = np.tile(rs.randint(0, 32768, (8, 32)), (1, 5))[:, :129]
    ds = Dataset.from_arrays(toks[:, :-1], toks[:, 1:])
    kw = dict(num_workers=2, batch_size=2, num_epoch=2,
              communication_window=2, worker_optimizer="sgd",
              learning_rate=0.5,
              loss="sparse_categorical_crossentropy_from_logits")
    tr_card = par.DOWNPOUR(card, **kw)
    tr_card.train(ds)
    assert tr_card.engine.amortized
    assert tr_card.engine.server_updates == 2
    par.DOWNPOUR(cpu, **kw).train(ds)
    for a, b, b0 in zip(card.module.parameters(), cpu.module.parameters(),
                        init):
        moved = (b.detach() - b0).abs().max()
        assert float(moved) > 0
        got = a.detach().cpu() - b0
        assert float((got - (b.detach() - b0)).abs().max()) \
            <= 1e-3 * float(moved)


@pytest.mark.parametrize("label", [c[0] for c in chip_smoke.DIST_SYNC_FREE])
def test_engine_epoch_makes_no_host_sync(dev, label):
    """One engine epoch of each algorithm (its data on the card) runs
    under ``torch.cuda.set_sync_debug_mode("error")`` without raising:
    the commit mask is host arithmetic, the commits and steps stay on
    the card (phase 27's check, on a 2-layer model)."""
    _, algo, window, amortized = next(c for c in chip_smoke.DIST_SYNC_FREE
                                      if c[0] == label)
    eng = chip_smoke.engine_sync_free(_small_lm(dev), algo, window,
                                      amortized)
    assert eng.server_updates >= 1


# --- the vision layers and a BatchNorm ResNet's training step ----------------

#: the convolution and pool SAME-padding cases (XLA's asymmetric pads) on
#: the card: (layer, keywords, input shape)
SAME_CASES = {
    "conv2d_3x3_s2_even": ("Conv2D", dict(filters=8, kernel_size=3,
                                          strides=2), (16, 16, 4)),
    "conv2d_stem_7x7_s2_even": ("Conv2D", dict(
        filters=16, kernel_size=7, strides=2, use_bias=False), (32, 32, 3)),
    "conv2d_4x4_s1_odd": ("Conv2D", dict(filters=8, kernel_size=4),
                          (15, 15, 4)),
    "conv1d_4_s2_odd": ("Conv1D", dict(filters=8, kernel_size=4, strides=2),
                        (17, 4)),
    "maxpool_3x3_s2_even": ("MaxPooling2D", dict(pool_size=3, strides=2,
                                                 padding="SAME"),
                            (16, 16, 4)),
    "maxpool_3x3_s2_odd": ("MaxPooling2D", dict(pool_size=3, strides=2,
                                                padding="SAME"),
                           (15, 15, 4)),
    "avgpool_3x3_s2_even": ("AveragePooling2D", dict(
        pool_size=3, strides=2, padding="SAME"), (16, 16, 4)),
}
#: float32 on the card (TF32 off) against the CPU: summation order
VISION_F32_TOL = 1e-4


def _rel_err(got, ref):
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("case", list(SAME_CASES))
def test_same_padding_layer_on_card_matches_cpu(dev, case):
    """Forward and gradients (input and weights) of a SAME-padded
    convolution or pool on the card against the same layer on the CPU."""
    import copy
    from distkeras_tpu_torch.models import layers
    from distkeras_tpu_torch.ops import prng
    torch.backends.cudnn.allow_tf32 = False
    name, kw, shape = SAME_CASES[case]
    layer = getattr(layers, name)(**kw)
    out_shape = layer.build(shape, prng.key(0))
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(4, *shape).astype(np.float32))
    r = torch.from_numpy(rs.randn(4, *out_shape).astype(np.float32))
    res = []
    for lay, d in ((layer, "cpu"), (copy.deepcopy(layer).to(dev), dev)):
        p = lay.param_tree()
        xd = x.to(d).requires_grad_(True)
        y = lay.apply(p, xd)
        grads = torch.autograd.grad((y * r.to(d)).sum(),
                                    [xd] + list(p.values()))
        res.append((y, grads))
    (y0, g0), (y1, g1) = res
    assert tuple(y1.shape) == (4,) + tuple(out_shape)
    assert _rel_err(y1, y0) <= VISION_F32_TOL
    for a, b in zip(g1, g0):
        assert _rel_err(a, b) <= VISION_F32_TOL


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3),
                                       ("bfloat16", 5e-2)])
def test_resnet_train_step_on_card_matches_cpu(dev, dtype, tol):
    """A training-mode step of ``resnet18_thin`` (BatchNorm with its
    state) on the card against the CPU path at the same dtype: the loss,
    every gradient and the new running statistics."""
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.parallel import value_and_grad
    from distkeras_tpu_torch.utils.tree import tree_leaves
    torch.backends.cudnn.allow_tf32 = False
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(8, 32, 32, 3).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 10, 8))
    loss_fn = get_loss("sparse_categorical_crossentropy_from_logits")
    out = []
    for d in ("cpu", dev):
        m = Model.build(zoo.resnet18_thin(10, dtype=dtype), (32, 32, 3),
                        seed=0, device="cpu").to(d)
        loss, grads, _ = value_and_grad(m.module, loss_fn, m.params,
                                        x.to(d), y.to(d), state=m.state)
        out.append((loss, tree_leaves(grads), tree_leaves(m.state)))
    (l0, g0, s0), (l1, g1, s1) = out
    assert abs(float(l1) - float(l0)) <= tol * abs(float(l0))
    for a, b in zip(g1, g0):
        assert _rel_err(a, b) <= tol
    for a, b in zip(s1, s0):
        assert _rel_err(a, b) <= tol


# --- the rest of the zoo (ViT's attention, the remaining convolutions,
# --- the recurrent layers) ----------------------------------------------------

#: square attention with no causal mask, as chip_smoke.py's phases 3 and 6
#: run it: ViT-S/16's shape (S196, ragged against the 64-row tiles) and a
#: long one; (B, S, H, D)
NONCAUSAL_CASES = {"vit_s16_b32_s196": (32, 196, 6, 64),
                   "b1_h16_s2048": (1, 2048, 16, 64),
                   "vit_b2_s197_d128": (2, 197, 4, 128)}


@pytest.mark.parametrize("case", list(NONCAUSAL_CASES))
def test_flash_non_causal_forward_and_backward_match_plain(dev, case):
    """K1f, K1dq and K1dkv without the causal mask (bf16): one launch of
    each, against the plain versions at phase 3's and phase 6's limits."""
    b, s, h, d = NONCAUSAL_CASES[case]
    rs = np.random.RandomState(29)
    q, k, v = _qkv(rs, b, s, s, h, h, d, torch.bfloat16, dev, "bshd")
    kw = dict(scale=d ** -0.5, causal=False, window=None, layout="bshd")
    before = kernels.launch_counts()
    out, lse = flash_forward(q, k, v, **kw)
    dout = torch.from_numpy(rs.randn(*q.shape).astype(np.float32)) \
        .to(dev, torch.bfloat16)
    delta = attention_delta(out, dout)
    got = flash_backward(q, k, v, out, lse, dout, delta, **kw)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert after[name] == before[name] + 1, name
    _assert_forward_matches_plain(q, k, v, kw, out, lse)
    _assert_backward_matches_plain((q, k, v, out, lse, dout, delta), kw,
                                   got)


#: the remaining convolutions on the card (float32, TF32 off) against the
#: CPU: (layer, keywords, input shape)
ZOO_CONV_CASES = {
    "conv_transpose_same_s2_odd": ("Conv2DTranspose", dict(
        filters=8, kernel_size=3, strides=2), (15, 15, 4)),
    "conv_transpose_valid_s2_even": ("Conv2DTranspose", dict(
        filters=8, kernel_size=4, strides=2, padding="VALID"), (16, 16, 4)),
    "depthwise_m1_same_s2_even": ("DepthwiseConv2D", dict(
        kernel_size=3, strides=2, use_bias=False), (16, 16, 8)),
    "depthwise_m2_same_s1_odd": ("DepthwiseConv2D", dict(
        kernel_size=3, depth_multiplier=2), (15, 15, 8)),
    "separable_s2": ("SeparableConv2D", dict(filters=8, kernel_size=3,
                                             strides=2), (16, 16, 4)),
}


@pytest.mark.parametrize("case", list(ZOO_CONV_CASES))
def test_zoo_conv_layer_on_card_matches_cpu(dev, case):
    """Forward and gradients (input and weights) of a transposed,
    depthwise or separable convolution on the card against the CPU."""
    import copy
    from distkeras_tpu_torch.models import layers
    from distkeras_tpu_torch.ops import prng
    from distkeras_tpu_torch.utils.tree import tree_leaves
    torch.backends.cudnn.allow_tf32 = False
    name, kw, shape = ZOO_CONV_CASES[case]
    layer = getattr(layers, name)(**kw)
    out_shape = layer.build(shape, prng.key(0))
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(4, *shape).astype(np.float32))
    r = torch.from_numpy(rs.randn(4, *out_shape).astype(np.float32))
    res = []
    for lay, d in ((layer, "cpu"), (copy.deepcopy(layer).to(dev), dev)):
        p = lay.param_tree()
        xd = x.to(d).requires_grad_(True)
        y = lay.apply(p, xd)
        grads = torch.autograd.grad((y * r.to(d)).sum(),
                                    [xd] + tree_leaves(p))
        res.append((y, grads))
    (y0, g0), (y1, g1) = res
    assert tuple(y1.shape) == (4,) + tuple(out_shape)
    assert _rel_err(y1, y0) <= VISION_F32_TOL
    for a, b in zip(g1, g0):
        assert _rel_err(a, b) <= VISION_F32_TOL


@pytest.mark.parametrize("cls", ["LSTM", "GRU"])
def test_recurrent_step_on_card_matches_cpu(dev, cls):
    """A bidirectional recurrent layer's forward and gradients (float32,
    TF32 off) on the card against the CPU: the time loop of matmuls and
    gates, no cuDNN RNN."""
    import copy
    from distkeras_tpu_torch.models import recurrent
    from distkeras_tpu_torch.ops import prng
    from distkeras_tpu_torch.utils.tree import tree_leaves
    layer = recurrent.Bidirectional(getattr(recurrent, cls)(
        32, return_sequences=True))
    out_shape = layer.build((20, 24), prng.key(1))
    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.randn(8, 20, 24).astype(np.float32))
    r = torch.from_numpy(rs.randn(8, *out_shape).astype(np.float32))
    res = []
    for lay, d in ((layer, "cpu"), (copy.deepcopy(layer).to(dev), dev)):
        p = lay.param_tree()
        xd = x.to(d).requires_grad_(True)
        y = lay.apply(p, xd)
        grads = torch.autograd.grad((y * r.to(d)).sum(),
                                    [xd] + tree_leaves(p))
        res.append((y, grads))
    (y0, g0), (y1, g1) = res
    assert _rel_err(y1, y0) <= VISION_F32_TOL
    for a, b in zip(g1, g0):
        assert _rel_err(a, b) <= 1e-3


def test_vit_step_on_card_launches_the_flash_kernels(dev):
    """A 2-layer ViT training step on the card: each flash kernel once
    per block (no causal mask), gradients within 1e-3 of the CPU's in
    float32."""
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.parallel import value_and_grad
    from distkeras_tpu_torch.utils.tree import tree_leaves
    spec = dict(image_size=32, patch_size=8, d_model=64, num_heads=2,
                num_layers=2, num_classes=10)
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(4, 32, 32, 3).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 10, 4))
    loss_fn = get_loss("sparse_categorical_crossentropy_from_logits")
    out = []
    for d in ("cpu", dev):
        m = Model.build(zoo.vit(**spec), (32, 32, 3), seed=0,
                        device="cpu").to(d)
        before = kernels.launch_counts()
        m.module.train()
        loss, grads, _ = value_and_grad(m.module, loss_fn, m.params,
                                        x.to(d), y.to(d))
        if d != "cpu":
            torch.cuda.synchronize()
            after = kernels.launch_counts()
            for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
                assert after[name] - before[name] == 2, name
        out.append((loss, tree_leaves(grads)))
    (l0, g0), (l1, g1) = out
    assert abs(float(l1) - float(l0)) <= 1e-3 * abs(float(l0))
    for a, b in zip(g1, g0):
        assert _rel_err(a, b) <= 1e-3


# --- the Trainer surface: checkpoints, the fused head, staging ---------------

def test_checkpoint_snapshot_is_fenced_before_save_returns(dev, tmp_path):
    """``save()`` returns only once its pinned copies have landed: the
    caller's in-place update right after it is not in the checkpoint."""
    from distkeras_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                      _snapshot_flat)
    rs = np.random.RandomState(0)
    w = torch.from_numpy(rs.randn(1024, 1024).astype(np.float32)).to(dev)
    t = torch.tensor(7, dtype=torch.int32, device=dev)
    want = w.cpu().numpy().copy()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, {"w": w, "t": t})
    w.add_(1.0)             # queued behind the copies on the same stream
    t.add_(1)
    got = mgr.restore({"w": w, "t": t})
    assert np.array_equal(got["w"], want) and int(got["t"]) == 7
    flat = _snapshot_flat({"w": w})
    w.mul_(0.0)
    assert np.array_equal(flat["w"], want + 1.0)


def test_checkpoint_round_trip_card_and_cpu(dev, tmp_path):
    """A carry checkpointed on the card resumes on the CPU and back: the
    restored leaves are the saved bits, placed on the resuming model's
    device; a card run resumed on the card is bitwise its uninterrupted
    run."""
    from distkeras_tpu_torch.models import Sequential
    from distkeras_tpu_torch.models.layers import Dense
    from distkeras_tpu_torch.utils.tree import tree_leaves
    rs = np.random.RandomState(0)
    X = rs.randn(256, 8).astype(np.float32)
    ds = Dataset({"features": X, "label": (X.sum(1) > 0).astype(np.int64)})
    kw = dict(batch_size=32, worker_optimizer="adam", learning_rate=1e-2,
              loss="sparse_categorical_crossentropy_from_logits")

    def mlp(d):
        return Model.build(Sequential([Dense(16, activation="relu"),
                                       Dense(2)]), (8,), seed=0, device=d)

    whole = SingleTrainer(mlp(dev), num_epoch=3, **kw).train(ds)
    ck = str(tmp_path / "ck")
    card = SingleTrainer(mlp(dev), num_epoch=2, checkpoint_dir=ck,
                         **kw).train(ds)
    saved = [t.detach().cpu().clone() for t in tree_leaves(card.params)]
    on_cpu = SingleTrainer(mlp("cpu"), num_epoch=2, checkpoint_dir=ck,
                           resume=True, **kw)
    cpu_model = on_cpu.train(ds)   # nothing left to train: the restore
    assert len(on_cpu.get_history().epochs) == 0
    for a, b in zip(tree_leaves(cpu_model.params), saved):
        assert a.device.type == "cpu" and torch.equal(a, b)
    resumed = SingleTrainer(mlp(dev), num_epoch=3, checkpoint_dir=ck,
                            resume=True, **kw).train(ds)
    for a, b in zip(tree_leaves(resumed.params), tree_leaves(whole.params)):
        assert a.device.type == dev.type and torch.equal(a, b)


def test_fused_cross_entropy_on_card_matches_cpu(dev):
    """The fused head in bf16 on the card (tensor-core products, float32
    accumulation) against the CPU's float32 plain path within 2e-2."""
    from distkeras_tpu_torch.ops.losses import fused_linear_cross_entropy
    rs = np.random.RandomState(0)
    h = torch.from_numpy(rs.randn(2, 300, 256).astype(np.float32))
    w = torch.from_numpy((rs.randn(256, 1000) * 0.05).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 1000, (2, 300)))
    y[0, :17] = -1
    out = []
    for d, dt in (("cpu", torch.float32), (dev, torch.bfloat16)):
        hd = h.to(d, dt).requires_grad_(True)
        wd = w.to(d).requires_grad_(True)
        loss = fused_linear_cross_entropy(hd, wd, y.to(d), num_chunks=8,
                                          ignore_index=-1, compute_dtype=dt)
        gh, gw = torch.autograd.grad(loss, (hd, wd))
        out.append((float(loss.detach()), gh.float().cpu(), gw.cpu()))
    (l0, h0, w0), (l1, h1, w1) = out
    assert abs(l1 - l0) <= BF16_TOL * abs(l0)
    assert _rel_err(h1, h0) <= BF16_TOL and _rel_err(w1, w0) <= BF16_TOL


def test_device_stager_places_chunks_on_the_card(dev):
    """The trainers' staging: a chunk's arrays arrive on the card with
    their values and dtypes (pinned, non-blocking copies); on the CPU a
    chunk passes through."""
    from distkeras_tpu_torch.utils.prefetch import Prefetcher, device_stager
    rs = np.random.RandomState(0)
    chunks = [(rs.randn(4, 2, 8).astype(np.float32),
               rs.randint(0, 9, (4, 2)), 4) for _ in range(3)]
    got = list(Prefetcher(lambda c: c, chunks, depth=2,
                          place=device_stager(dev)))
    for (_, (Xs, Ys, n)), (X, Y, m) in zip(got, chunks):
        assert Xs.is_cuda and Ys.is_cuda and n == m
        assert np.array_equal(Xs.cpu().numpy(), X)
        assert np.array_equal(Ys.cpu().numpy(), Y)
    cpu = device_stager("cpu")(chunks[0])
    assert cpu is chunks[0]


# --- the serving tier: handoff between engines on the card -------------------


def test_disaggregated_handoff_on_card_equals_one_engine(dev):
    """A prefill replica and a decode replica on the card serve six
    requests (greedy and sampled, fused sampling, a two-chunk prompt),
    one handoff each, as one card engine does: every stream equal, or
    parting at a near-tie of the CPU float32 scores (``chip_smoke``'s
    rule, with its bound from this model's bf16 logit error)."""
    model = _small_lm(dev, num_kv_heads=2)
    f32 = Model.build(zoo.transformer_lm(97, d_model=128, num_heads=4,
                                         num_layers=2, num_kv_heads=2),
                      (16,), seed=0, device="cpu")
    f32.module.load_state_dict(model.module.state_dict())
    rs = np.random.RandomState(3)
    reqs = [(rs.randint(0, 97, n),
             {} if i % 2 == 0 else dict(temperature=0.8, top_k=20,
                                        top_p=0.9, seed=10 + i))
            for i, n in enumerate((9, 30, 17, 44, 23, 12))]
    kw = dict(num_slots=3, max_len=96, page_len=16, prefill_chunk=32,
              device=dev, fused_sampling=True)
    eng = ServingEngine(model, engine_id="card-one", **kw)
    rids = [eng.submit(p, 16, **k) for p, k in reqs]
    one = eng.run(max_steps=500)
    router = Router([
        EngineReplica(ServingEngine(model, engine_id="card-p", **kw),
                      role="prefill"),
        EngineReplica(ServingEngine(model, engine_id="card-d", **kw),
                      role="decode")])
    grids = [router.submit(p, 16, **k) for p, k in reqs]
    fleet = router.run(max_steps=1000)
    assert router.counters()["handoffs"] == len(reqs)
    assert router.replica("card-p").engine.metrics.requests_transferred \
        == len(reqs)
    tie_rel = chip_smoke.TIE_ERR_FACTOR * chip_smoke.bf16_rel_err(
        model, f32, reqs[3][0])
    chip_smoke.check_identity(
        f32, ([(r, p) for r, (p, _) in zip(rids, reqs)], one),
        ([(g, p) for g, (p, _) in zip(grids, reqs)], fleet), reqs,
        "card disaggregated handoff", tie_rel)


def test_transfer_round_trip_makes_no_host_sync_after_the_drain(dev):
    """A sampled stream mid-decode leaves one card engine and joins
    another: after the pipeline drain (``_flush_pending``, the one
    sync), ``transfer_out`` and ``transfer_in`` run under
    ``set_sync_debug_mode("error")``; the stream keeps its tokens and its
    key and runs to its budget on the second engine, and the first
    engine's other stream finishes there."""
    model = _small_lm(dev, num_kv_heads=2)
    kw = dict(num_slots=2, max_len=64, page_len=16, device=dev,
              fused_sampling=True)
    src = ServingEngine(model, engine_id="card-src", **kw)
    dst = ServingEngine(model, engine_id="card-dst", **kw)
    prompt = (np.arange(20) * 7 + 3) % 97
    rid = src.submit(prompt, 24, temperature=0.8, seed=7)
    other = src.submit(prompt[:11], 24)
    while len(src[rid].generated) < 5:
        src.step()
    assert src._pending is not None
    src._flush_pending()
    key = src._keys[src[rid].slot].copy()
    kept = list(src[rid].generated)
    with chip_smoke._SyncErrors():
        req = src.transfer_out(rid)
        new = dst.transfer_in(req)
    assert req is not None and req.generated == kept
    np.testing.assert_array_equal(req.rng, key)
    moved = dst.run(max_steps=300)[new]
    rest = src.run(max_steps=300)
    assert len(moved) == len(prompt) + 24
    np.testing.assert_array_equal(moved[:len(prompt) + len(kept)],
                                  np.concatenate([prompt, kept]))
    assert len(rest[other]) == 11 + 24
    assert src.metrics.requests_transferred == 1


# --- the data plane and job deployment (phase 34) ---------------------------


def test_host_library_runs_the_shuffle_and_the_epoch_stack(dev,
                                                           monkeypatch):
    """The host library builds on the card's machine, and
    ``Dataset.shuffle`` and ``shard_epoch_data`` run its C gather above
    the 4 MiB threshold (rows bitwise numpy's)."""
    from distkeras_tpu_torch.data import native
    from distkeras_tpu_torch.parallel import shard_epoch_data
    assert native.native_status().startswith("native:")
    with chip_smoke._NativeGathers() as gathers:
        rs = np.random.RandomState(0)
        X = rs.randn(50_000, 32).astype(np.float32)
        y = rs.randint(0, 2, 50_000)
        sh = Dataset({"features": X, "label": y}).shuffle(3)
        perm = np.random.RandomState(3).permutation(len(X))
        np.testing.assert_array_equal(sh["features"], X[perm])
        Xs, _, S = shard_epoch_data(X, y, 4, 64, perm)
        np.testing.assert_array_equal(Xs.reshape(-1, 32),
                                      X[perm][:S * 256])
    assert gathers.c_calls == 2 and gathers.numpy_calls == 2


def test_from_torch_lands_card_tensors_on_the_host(dev):
    from torch.utils.data import DataLoader, TensorDataset
    from distkeras_tpu_torch.data import from_torch
    X = torch.arange(96, device=dev, dtype=torch.float32).reshape(32, 3)
    y = torch.arange(32, device=dev)
    for source in (TensorDataset(X, y),
                   DataLoader(TensorDataset(X, y), batch_size=10),
                   DataLoader(TensorDataset(X, y), batch_size=None)):
        ds = from_torch(source, limit=20)
        assert isinstance(ds["features"], np.ndarray)
        np.testing.assert_array_equal(ds["features"], X[:20].cpu().numpy())
        np.testing.assert_array_equal(ds["label"], y[:20].cpu().numpy())


def test_two_process_job_trains_on_the_card_with_equal_digests(dev,
                                                              tmp_path):
    """Phase 34 (c)'s job without the daemon: two gloo ranks, each
    training ``DEPLOY_SCRIPT``'s MLP on the card, print equal digests."""
    from distkeras_tpu_torch.deploy import Job, JobSpec
    cats = chip_smoke.criteo_standin(str(tmp_path / "c.tsv"), rows=4096)
    assert len(cats) == 4096
    script = tmp_path / "w.py"
    script.write_text(chip_smoke.DEPLOY_SCRIPT)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = Job(JobSpec(script=str(script),
                      args=[str(tmp_path / "c.tsv"), "cuda"],
                      num_processes=2, env={"PYTHONPATH": repo},
                      timeout=120)).run()
    assert res.ok, res.logs
    digests = sorted(chip_smoke._job_lines(res.logs, "DIGEST"))
    assert [d[1] for d in digests] == ["0", "1"]
    assert digests[0][2] == digests[1][2] == "3.0"
    assert digests[0][3] == digests[1][3]
    assert int(digests[0][4]) == 8     # K7: one split a step, 8 steps


# --- the attention kernels at the examples' head dims (8, 12, 16) ----------

#: the head dims the one-card examples' models give (d_model / heads)
SMALL_HEAD_DIMS = (8, 12, 16)


@pytest.mark.parametrize("d", SMALL_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,s,window,hkv,seg", [
    (True, 300, None, 4, None),             # causal (the LMs' prefill)
    (True, 257, 8, 2, "contiguous"),        # window 8 + ids + GQA (packed)
    (False, (64, 200), None, 4, None),      # non-causal, Sq != Sk (ViT)
    (True, 130, None, 1, "unsorted"),       # GQA 4x1, ids with a -1 tail
])
def test_flash_kernels_at_small_head_dims_match_plain(dev, d, dtype, causal,
                                                      s, window, hkv, seg):
    """K1f, K1dq and K1dkv at head dims 8, 12 and 16: one launch each,
    the plain versions' values at the tolerances of D 32-128."""
    rs = np.random.RandomState(17)
    sq, sk = s if isinstance(s, tuple) else (s, s)
    q, k, v = _qkv(rs, 2, sq, sk, 4, hkv, d, dtype, dev, "bshd")
    ids = _segment_ids(rs, seg, 2, sq, dev)
    kw = dict(scale=d ** -0.5, causal=causal, window=window, layout="bshd",
              segment_ids=ids)
    before = kernels.launch_counts()
    out, lse = flash_forward(q, k, v, **kw)
    dout = torch.from_numpy(rs.randn(*q.shape).astype(np.float32)) \
        .to(dev, dtype)
    delta = attention_delta(out, dout, "bshd")
    got = flash_backward(q, k, v, out, lse, dout, delta, **kw)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert after[name] == before[name] + 1, name
    ro, rl = flash_forward_reference(q, k, v, **kw)
    f32 = dtype == torch.float32
    torch.testing.assert_close(out.float(), ro.float(), rtol=0,
                               atol=F32_TOL if f32 else BF16_TOL)
    torch.testing.assert_close(lse, rl, atol=1e-3, rtol=1e-5)
    ref = flash_backward_reference(q, k, v, out, lse, dout, delta, **kw)
    tol = BWD_F32_REL_TOL if f32 else BWD_BF16_REL_TOL
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert torch.isfinite(g.float()).all(), name
        err = (g.float() - r.float()).abs().max().item()
        assert err <= tol * r.float().abs().max().item(), (name, err)


@pytest.mark.parametrize("d", SMALL_HEAD_DIMS)
@pytest.mark.parametrize("cache", ["float32", "bfloat16", 8, 4])
@pytest.mark.parametrize("g,window,length,t,strided", [
    (1, None, 96, 95, False),         # generate()'s shape (prompt + new)
    (4, 8, 300, 200, True),           # GQA, a window, a strided view
    (2, None, 4096, 3000, False),     # many splits, the merge
])
def test_decode_kernel_at_small_head_dims_matches_plain(dev, d, cache, g,
                                                        window, length, t,
                                                        strided):
    """K2 and K2-q8 at head dims 8, 12 and 16 (rows of 8, 12, 16, 24 or
    32 bytes: 4-, 8- and 16-byte copies)."""
    rs = np.random.RandomState(18)
    rows = 6
    quant = cache in (8, 4)
    qdt = torch.float32 if quant else getattr(torch, cache)
    q = torch.from_numpy(rs.randn(rows, g, d).astype(np.float32)).to(dev,
                                                                     qdt)
    kw = dict(scale=d ** -0.5, window=window)
    if quant:
        (k, ks), (v, vs) = (pd._quantize_kv(_slab(rs, rows, length, d,
                                                  strided).to(dev), cache)
                            for _ in range(2))
        kw.update(k_scale=ks, v_scale=vs)
    else:
        k, v = (_slab(rs, rows, length, d, strided).to(dev, qdt)
                for _ in range(2))
    name = "decode_attention_q8" if quant else "decode_attention"
    before = kernels.launch_counts()[name]
    out = decode_attention(q, k, v, t, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    ref = decode_attention_reference(q, k, v, t, **kw)
    tol = BF16_TOL if cache == "bfloat16" else F32_TOL
    torch.testing.assert_close(out, ref, atol=tol, rtol=0)
    assert torch.equal(out, decode_attention(q, k, v, t, **kw))


@pytest.mark.parametrize("d", SMALL_HEAD_DIMS)
@pytest.mark.parametrize("variant", ANC_VARIANTS,
                         ids=["f32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("spec", K3_SPLIT_SPECS,
                         ids=["decode", "gqa_tree", "verify_swa"])
def test_paged_kernel_at_small_head_dims_matches_plain(dev, d, variant,
                                                       spec):
    """K3 (float, int8, int4) and K3-anc at head dims 8, 12 and 16, at
    the split plan's edges; plus the examples' page of 4 positions."""
    g, w_len, window, tree = spec
    rs = np.random.RandomState(19)
    args, kw = _k3_split_case(rs, variant, d, g, w_len, window, tree, dev)
    quant = variant in (8, 4)
    name = (f"paged_decode_q{variant}" if quant else "paged_decode") + \
        ("_anc" if tree else "")
    before = kernels.launch_counts()[name]
    out = paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 1
    ref = paged_decode_attention_reference(*args, **kw)
    tol = chip_smoke.KERNEL_BF16_TOL if variant == torch.bfloat16 else \
        chip_smoke.KERNEL_Q_TOL if quant else F32_TOL
    torch.testing.assert_close(out, ref, atol=tol, rtol=0)
    assert torch.equal(out, paged_decode_attention(*args, **kw))
    # pages of 4 positions, as the examples' engines take
    kp, vp, sc = _anc_pages(rs, variant, d, 4, dev)
    q = torch.from_numpy(rs.randn(4, 1, 2, g, d).astype(np.float32)).to(dev)
    targs = (torch.from_numpy(T // 2).to(dev),
             torch.from_numpy(TABLE).to(dev))
    out = paged_decode_attention(q, kp, vp, *targs, scale=0.3, **sc)
    ref = paged_decode_attention_reference(q, kp, vp, *targs, scale=0.3,
                                           **sc)
    torch.testing.assert_close(out[:3], ref[:3], atol=tol, rtol=0)


@pytest.mark.parametrize("d", [4, 24, 48, 256])
def test_attention_kernels_refuse_other_head_dims_naming_the_set(dev, d):
    """A head dim outside the kernels' set raises and names the set; it
    never falls back to the plain version."""
    rs = np.random.RandomState(20)
    q, k, v = _qkv(rs, 1, 16, 16, 2, 2, d, torch.bfloat16, dev, "bshd")
    want = r"\(8, 12, 16, 32, 64, 128\)"
    with pytest.raises(ValueError, match=want):
        flash_forward(q, k, v, scale=0.3, causal=True)
    with pytest.raises(ValueError, match=want):
        decode_attention(q[0], k[0], v[0], 1)
    kp = torch.zeros((N_PAGES, 2, 8, d), device=dev)
    with pytest.raises(ValueError, match=want):
        paged_decode_attention(
            torch.zeros((4, 1, 2, 1, d), device=dev), kp, kp,
            torch.from_numpy(T).to(dev), torch.from_numpy(TABLE).to(dev))


# --- kernel entry points the oracle lint holds (tools/lint_torch_kernel_
# --- oracles.py): each named by a card case against its plain version ---


@pytest.mark.parametrize("d", [8, 64])
def test_launch_dq_and_dkv_match_the_plain_backward(dev, d):
    """``launch_dq`` and ``launch_dkv`` (one kernel each, as chip_smoke
    times them) against ``flash_backward_reference``."""
    from distkeras_tpu_torch.ops.flash_attention import launch_dkv, launch_dq
    args, kw = _backward_case(np.random.RandomState(21), dev, 2, 200, 4, 2,
                              d)
    q, k, v, out, lse, dout, delta = args
    before = kernels.launch_counts()
    got = launch_dq(q, k, v, lse, dout, delta, kw["scale"], True, None,
                    "bshd") + \
        launch_dkv(q, k, v, lse, dout, delta, kw["scale"], True, None,
                   "bshd")
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert after["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    _assert_backward_matches_plain(args, kw, got)


def test_prng_categorical_equals_the_plain_gumbel_argmax(dev):
    """``prng.categorical`` on a card key: one K7 Gumbel field over the
    logits' whole shape (``draw_reference``'s counters), then the argmax:
    the same tokens as the plain field's argmax (logits spread far beyond
    the field's ulps)."""
    from distkeras_tpu_torch.ops import prng
    key = prng.key(11)
    logits = torch.from_numpy(np.random.RandomState(22).randn(6, 500)
                              .astype(np.float32) * 4).to(dev)
    before = kernels.launch_counts()["prng"]
    got = prng.categorical(key.to(dev), logits)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["prng"] == before + 1
    tiny = float(torch.finfo(torch.float32).tiny)
    field = prng.draw_reference(key[None].to(dev), logits.numel(),
                                prng.GUMBEL, tiny, 1.0).reshape(6, 500)
    assert torch.equal(got, torch.argmax(field + logits, dim=-1))


def test_sample_tokens_and_launch_kernel_match_the_plain_sampler(dev):
    """The fused sampler's pieces: ``launch_kernel`` (one K4 launch) and
    ``sample_tokens`` (K7's Gumbel field, then K4) against
    ``sample_epilogue_reference`` on the same field; greedy, top-k and
    temperature rows with no nucleus cut, so no boundary parting."""
    from distkeras_tpu_torch.ops import prng
    from distkeras_tpu_torch.ops.sampling import (gumbel_noise,
                                                  launch_kernel,
                                                  sample_tokens)
    rs = np.random.RandomState(23)
    logits = torch.from_numpy(rs.randn(4, 1000).astype(np.float32)
                              * 3).to(dev)
    temp = torch.tensor([0.0, 0.7, 1.0, 1.3], device=dev)
    top_k = torch.tensor([0, 5, 0, 40], device=dev)
    top_p = torch.ones(4, device=dev)
    keys = prng.split(prng.key(7), 4).to(dev)
    field = gumbel_noise(keys, 1000)
    ref = sample_epilogue_reference(logits, temp, top_k, top_p, field)
    before = kernels.launch_counts()
    got = launch_kernel(logits, temp, top_k, top_p, field)
    fused = sample_tokens(logits, temp, top_k, top_p, keys)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["sample_epilogue"] == before["sample_epilogue"] + 2
    assert after["prng"] == before["prng"] + 1
    assert torch.equal(got, ref) and torch.equal(fused, ref)


def test_fused_moe_apply_on_card_equals_its_plain_path(dev):
    """``fused_moe_apply`` (K6a forward; K6b and K6c in its backward) on
    the card against the same call on CPU tensors, which takes
    ``gather_gemm1_reference`` and the plain backward versions: float32,
    one top-2 plan of 4 experts with dropped slots."""
    from distkeras_tpu_torch.models.moe import _dispatch_plan
    n, d, hid, e, k, cap = 40, 24, 48, 4, 2, 12
    rs = np.random.RandomState(24)
    topi = torch.from_numpy(np.argsort(rs.randn(n, e), axis=1)[:, :k]
                            .astype(np.int64))
    gates = torch.from_numpy(rs.rand(n, k).astype(np.float32))
    dest, _, sg, keep = _dispatch_plan(topi, gates, e, cap)
    f = lambda *s, sc=1.0: torch.from_numpy(       # noqa: E731
        (rs.randn(*s) * sc).astype(np.float32))
    leaves = (f(n, d), f(e, d, hid, sc=0.3), f(e, hid, sc=0.1),
              f(e, hid, d, sc=0.3), f(e, d, sc=0.1))
    cot = f(n, d)

    def run(device):
        ls = [t.to(device).requires_grad_(True) for t in leaves]
        out = moe_kernels.fused_moe_apply(
            *ls, sg.to(device), dest.to(device), keep.to(device),
            capacity=cap)
        return [out] + list(torch.autograd.grad(out, ls, cot.to(device)))

    before = kernels.launch_counts()
    card = run(dev)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    for name in ("moe_gather_gemm1", "moe_bwd_dx", "moe_bwd_dw1"):
        assert after[name] > before[name], name
    for a, b in zip(card, run("cpu")):
        scale = max(1.0, b.abs().max().item())
        assert (a.cpu() - b).abs().max().item() <= 1e-4 * scale
