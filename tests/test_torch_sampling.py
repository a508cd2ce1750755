"""The port's fused sampling epilogue against the JAX package's: the
plain ``sample_epilogue`` token for token against the Pallas kernel in
interpret mode (and against the JAX reference branch at a misaligned
vocab) on the same logits and Gumbel field, exact ties at the k-th
value included; ``sample_tokens`` byte-identical to the unfused
``_sample_vec`` with the generators left in the same state; and the
engine's ``fused_sampling`` streams.

The K4 kernel itself runs only on the card (``tests/test_torch_cuda.py``).
Inputs are made with numpy from a seed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distkeras_tpu.ops import sampling as jsp

from distkeras_tpu_torch.models.decoding import _sample_vec
from distkeras_tpu_torch.ops.sampling import (boundary_partings,
                                              gumbel_noise, sample_epilogue,
                                              sample_epilogue_reference,
                                              sample_tokens)

#: mixed rows: greedy, top-k and top-p, nucleus only, top-k only, k=1,
#: k >= V, both cuts
TEMP = np.array([0.0, 0.7, 1.0, 1.3, 0.9, 1.1, 0.8], np.float32)
TOPK = np.array([0, 5, 0, 3, 1, 100000, 7], np.int32)
TOPP = np.array([1.0, 0.9, 0.5, 1.0, 0.8, 1.0, 0.3], np.float32)


def _inputs(seed, v, ties=False):
    rs = np.random.RandomState(seed)
    s = len(TEMP)
    if ties:                       # every value four times: ties at k-th
        logits = np.repeat(rs.randn(s, v // 4) * 2, 4, axis=1)
    else:
        logits = rs.randn(s, v) * 2
    u = rs.uniform(1e-6, 1.0, (s, v))
    g = -np.log(-np.log(u))
    return logits.astype(np.float32), g.astype(np.float32)


def _jax(logits, g):
    return np.asarray(jsp.sample_epilogue(
        jnp.asarray(logits), jnp.asarray(TEMP), jnp.asarray(TOPK),
        jnp.asarray(TOPP), jnp.asarray(g)))


def _ours(logits, g):
    return sample_epilogue(torch.from_numpy(logits), torch.from_numpy(TEMP),
                           torch.from_numpy(TOPK), torch.from_numpy(TOPP),
                           torch.from_numpy(g)).numpy()


@pytest.mark.parametrize("v", [128, 256])
@pytest.mark.parametrize("seed", range(4))
def test_plain_epilogue_matches_jax_kernel_interpret(seed, v):
    logits, g = _inputs(seed, v)
    with jsp.force_interpret():
        assert jsp.fused_supported(v)
        want = _jax(logits, g)
    np.testing.assert_array_equal(_ours(logits, g), want)


@pytest.mark.parametrize("v", [128, 256])
def test_plain_epilogue_tie_at_kth_matches_jax_kernel(v):
    logits, g = _inputs(11, v, ties=True)
    with jsp.force_interpret():
        want = _jax(logits, g)
    np.testing.assert_array_equal(_ours(logits, g), want)


@pytest.mark.parametrize("seed", range(3))
def test_plain_epilogue_misaligned_vocab_matches_jax_reference(seed):
    logits, g = _inputs(seed + 20, 100)
    assert not jsp.fused_supported(100)
    np.testing.assert_array_equal(_ours(logits, g), _jax(logits, g))


def _gens(seed):
    return [None if t <= 0 else torch.Generator().manual_seed(seed + i)
            for i, t in enumerate(TEMP)]


@pytest.mark.parametrize("seed", range(4))
def test_sample_tokens_byte_identical_to_sample_vec(seed):
    logits = torch.from_numpy(_inputs(seed + 40, 97)[0])
    knobs = [torch.from_numpy(a) for a in (TEMP, TOPK.astype(np.int64),
                                           TOPP)]
    ga, gb = _gens(seed), _gens(seed)
    fused = sample_tokens(logits, *knobs, ga)
    plain = _sample_vec(logits, *knobs, gb)
    assert fused.dtype == plain.dtype
    torch.testing.assert_close(fused, plain, rtol=0, atol=0)
    for a, b in zip(ga, gb):
        if a is not None:
            assert torch.equal(a.get_state(), b.get_state())


def test_gumbel_noise_draws_nothing_for_greedy_rows():
    gens = _gens(3)
    before = [None if g is None else g.get_state() for g in gens]
    noise = gumbel_noise(gens, 50, "cpu")
    assert noise.shape == (len(TEMP), 50)
    assert noise[0].abs().max() == 0.0 and noise[1].abs().max() > 0.0
    for g, st in zip(gens, before):
        if g is not None:
            assert not torch.equal(g.get_state(), st)


def test_epilogue_validates_shapes():
    logits = torch.zeros(2, 8)
    knob = torch.zeros(2)
    with pytest.raises(ValueError, match="shape"):
        sample_epilogue(logits, knob, knob.long(), knob, torch.zeros(2, 7))
    with pytest.raises(ValueError, match="top_k"):
        sample_epilogue(logits, knob, torch.zeros(3).long(), knob,
                        torch.zeros(2, 8))


# --- the check that admits a kernel's nucleus-boundary rows -------------------


def _knobs():
    return (torch.from_numpy(TEMP), torch.from_numpy(TOPK).long(),
            torch.from_numpy(TOPP))


def _sorted_excl(logits_row, temp):
    """The row's descending values and float64 exclusive cumsum (no
    top-k), and its tokens in sorted order."""
    lf = torch.from_numpy(logits_row).float() / temp
    order = torch.argsort(-lf, stable=True)
    p64 = torch.softmax(lf[order].double(), dim=-1)
    return order, torch.cumsum(p64, dim=-1) - p64


@pytest.mark.parametrize("seed", range(3))
def test_boundary_partings_none_when_tokens_agree(seed):
    logits, g = _inputs(seed, 256)
    temp, top_k, top_p = _knobs()
    lt = torch.from_numpy(logits)
    ref = sample_epilogue_reference(lt, temp, top_k, top_p,
                                    torch.from_numpy(g))
    assert boundary_partings(ref.clone(), ref, lt, temp, top_k, top_p) == []


@pytest.mark.parametrize("n", [3, 12, 40])
def test_boundary_partings_admits_a_flip_at_the_cut(n):
    """top_p set to the float32 of the exact exclusive mass at sorted
    entry ``n``: a kernel that keeps that entry (or drops it) where the
    plain version did not is a boundary row, and is admitted."""
    logits, g = _inputs(n, 256)
    temp, top_k, top_p = _knobs()
    row = 2                                   # nucleus only
    order, excl64 = _sorted_excl(logits[row], float(temp[row]))
    top_p[row] = float(np.float32(excl64[n]))
    lt = torch.from_numpy(logits)
    ref = sample_epilogue_reference(lt, temp, top_k, top_p,
                                    torch.from_numpy(g))
    out = ref.clone()
    lf = lt[row] / temp[row]
    plain_n = int((torch.softmax(lf[order], -1).cumsum(-1)
                   - torch.softmax(lf[order], -1) < top_p[row]).sum())
    if plain_n == n:               # the plain version dropped entry n
        out[row] = order[n]
    else:                          # it kept entry n; the kernel did not
        assert plain_n == n + 1
        ref[row], out[row] = order[n], order[0]
    found = boundary_partings(out, ref, lt, temp, top_k, top_p)
    assert [r for r, _, _ in found] == [row]
    _, margin, tol = found[0]
    assert margin <= tol < 1e-5


@pytest.mark.parametrize("offset", [1, 5])
def test_boundary_partings_refuses_a_token_off_the_cut(offset):
    """At an ordinary top_p row the cut lies far from every float32
    rounding: a kernel that keeps more of the sorted row than the plain
    version is refused, as is one that keeps an entry past the cut."""
    logits, g = _inputs(7, 256)
    temp, top_k, top_p = _knobs()
    lt = torch.from_numpy(logits)
    ref = sample_epilogue_reference(lt, temp, top_k, top_p,
                                    torch.from_numpy(g))
    row = 2
    order, excl64 = _sorted_excl(logits[row], float(temp[row]))
    n = int((excl64 < float(top_p[row])).sum())
    out = ref.clone()
    out[row] = order[n + offset - 1]
    if int(out[row]) == int(ref[row]):
        out[row] = order[n + offset]
    with pytest.raises(AssertionError, match="boundary"):
        boundary_partings(out, ref, lt, temp, top_k, top_p)


@pytest.mark.parametrize("row", [0, 3, 5])
def test_boundary_partings_refuses_rows_without_a_nucleus(row):
    """Greedy (0), top-k only (3) and k >= V (5) rows may not part."""
    logits, g = _inputs(1, 256)
    temp, top_k, top_p = _knobs()
    lt = torch.from_numpy(logits)
    ref = sample_epilogue_reference(lt, temp, top_k, top_p,
                                    torch.from_numpy(g))
    out = ref.clone()
    out[row] = (ref[row] + 1) % 256
    with pytest.raises(AssertionError, match="no nucleus cut"):
        boundary_partings(out, ref, lt, temp, top_k, top_p)


def test_boundary_partings_catch_a_nucleus_over_the_top_k_count():
    """A mask program that sums the no-top-k nucleus over ``clip(k, 1,
    V)`` entries (one) instead of all ``V`` parts from the plain version
    on the nucleus-only rows far from the boundary, and is refused."""
    temp, top_k, top_p = _knobs()
    wrong_k = torch.where(top_k <= 0, torch.ones_like(top_k), top_k)
    refused = 0
    for seed in range(6):
        logits, g = _inputs(seed, 256)
        lt, gt = torch.from_numpy(logits), torch.from_numpy(g)
        ref = sample_epilogue_reference(lt, temp, top_k, top_p, gt)
        out = sample_epilogue_reference(lt, temp, wrong_k, top_p, gt)
        out[0] = ref[0]                # a greedy row ignores the knobs
        if torch.equal(out, ref):
            continue
        with pytest.raises(AssertionError):
            boundary_partings(out, ref, lt, temp, top_k, top_p)
        refused += 1
    assert refused >= 3
