"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA card and skips without one; the
file imports nothing of JAX, so on the card it runs without the JAX
package's test configuration:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import kernels
from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.models import Model, zoo
from distkeras_tpu_torch.ops.flash_attention import (
    attention_delta, flash_backward, flash_backward_reference, flash_forward,
    flash_forward_reference)
from distkeras_tpu_torch.parallel import SingleTrainer
from distkeras_tpu_torch.ops.paged_attention import (
    paged_decode_attention, paged_decode_attention_reference)
from distkeras_tpu_torch.serving import ServingEngine

pytestmark = pytest.mark.cuda

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,sq,sk,window,hkv,d,layout", [
    (True, 300, 300, None, 4, 64, "bshd"),
    (True, 257, 257, 64, 2, 64, "bshd"),
    (False, 96, 1000, None, 4, 64, "bhsd"),
    (True, 130, 130, None, 4, 128, "bhsd"),
    (True, 70, 70, 5, 1, 32, "bshd"),
])
def test_flash_kernel_matches_plain(dev, dtype, causal, sq, sk, window,
                                    hkv, d, layout):
    rs = np.random.RandomState(0)
    q, k, v = _qkv(rs, 2, sq, sk, 4, hkv, d, dtype, dev, layout)
    before = kernels.launch_counts()["flash_fwd"]
    o, lse = flash_forward(q, k, v, scale=d ** -0.5, causal=causal,
                           window=window, layout=layout)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_fwd"] == before + 1
    ro, rl = flash_forward_reference(q, k, v, scale=d ** -0.5,
                                     causal=causal, window=window,
                                     layout=layout)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert o.dtype == dtype and o.shape == q.shape
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, rl, atol=1e-3, rtol=1e-5)


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


#: backward gradients relative to the largest reference magnitude:
#: float32 differs by summation order over up to 300 keys; bfloat16 by
#: the output rounding (2^-8) plus the bf16-rounded P and dS tiles
BWD_F32_REL_TOL = 1e-4
BWD_BF16_REL_TOL = 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,s,window,hkv,d,layout", [
    (True, 300, None, 4, 64, "bshd"),       # causal, ragged vs 64
    (True, 257, 64, 4, 64, "bhsd"),         # sliding window
    (True, 200, None, 1, 64, "bshd"),       # GQA: 4 query heads per kv
    (True, 130, 9, 2, 128, "bshd"),         # GQA + window, D=128
    (False, 70, None, 4, 32, "bhsd"),       # non-causal, D=32
])
def test_flash_backward_kernels_match_plain(dev, dtype, causal, s, window,
                                            hkv, d, layout):
    rs = np.random.RandomState(3)
    q, k, v = _qkv(rs, 2, s, s, 4, hkv, d, dtype, dev, layout)
    kw = dict(scale=d ** -0.5, causal=causal, window=window, layout=layout)
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
