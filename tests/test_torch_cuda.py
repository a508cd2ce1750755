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
from distkeras_tpu_torch.models import Model, zoo
from distkeras_tpu_torch.ops.flash_attention import (flash_forward,
                                                     flash_forward_reference)
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
