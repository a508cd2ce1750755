"""The port's fused sampling epilogue against the JAX package's: the
plain ``sample_epilogue`` token for token against the Pallas kernel in
interpret mode (and against the JAX reference branch at a misaligned
vocab) on the same logits and Gumbel field, exact ties at the k-th
value included; ``sample_tokens`` byte-identical to the unfused
``_sample_vec`` and to JAX's on the same per-row keys; the Gumbel field
against JAX's ``gumbel_noise``; and the engine's ``fused_sampling``
streams.

The K4 kernel itself runs only on the card (``tests/test_torch_cuda.py``);
its sort-free rule (radix descents over the values' bits: the k-th value
by counts, the nucleus threshold by the fixed-point mass strictly above
a value) is modelled here in numpy and held against the mask program and
the Pallas kernel. Inputs are made with numpy from a seed."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distkeras_tpu.models import decoding as jd
from distkeras_tpu.ops import sampling as jsp

from distkeras_tpu_torch.models.decoding import (_masked_logits_vec,
                                                 _sample_vec)
from distkeras_tpu_torch.ops import prng
from distkeras_tpu_torch.ops.attention import NEG_INF
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


def _row_keys(seed):
    """Per-row keys, as the engine holds them: one split of a seed."""
    return prng.split(prng.key(seed), len(TEMP))


@pytest.mark.parametrize("seed", range(4))
def test_sample_tokens_byte_identical_to_sample_vec(seed):
    """The fused sampler and the unfused one give the same tokens from
    the same per-row keys, and both equal JAX's ``_sample_vec``."""
    logits = torch.from_numpy(_inputs(seed + 40, 97)[0])
    knobs = [torch.from_numpy(a) for a in (TEMP, TOPK.astype(np.int64),
                                           TOPP)]
    keys = _row_keys(seed)
    fused = sample_tokens(logits, *knobs, keys)
    plain = _sample_vec(logits, *knobs, keys)
    assert fused.dtype == plain.dtype
    torch.testing.assert_close(fused, plain, rtol=0, atol=0)
    want = jd._sample_vec(jnp.asarray(logits.numpy()), jnp.asarray(TEMP),
                          jnp.asarray(TOPK), jnp.asarray(TOPP),
                          jnp.asarray(keys.numpy(), jnp.uint32))
    np.testing.assert_array_equal(plain.numpy(), np.asarray(want))


def test_gumbel_noise_draws_nothing_for_greedy_rows():
    """Every row gets its key's field, JAX's ``gumbel_noise`` within
    ``prng.GUMBEL_ULPS`` (greedy rows too, as in JAX); what a greedy row's
    field draws changes nothing: its token is the argmax whatever the
    noise."""
    keys = _row_keys(3)
    noise = gumbel_noise(keys, 50)
    assert noise.shape == (len(TEMP), 50)
    want = np.asarray(jsp.gumbel_noise(jnp.asarray(keys.numpy(), jnp.uint32),
                                       50))
    assert prng.ulps(noise, torch.from_numpy(want)).max() \
        <= prng.GUMBEL_ULPS
    logits = torch.from_numpy(_inputs(7, 50)[0])
    knobs = _knobs()
    a = sample_epilogue(logits, *knobs, noise)
    b = sample_epilogue(logits, *knobs, -noise)
    assert int(a[0]) == int(b[0]) == int(torch.argmax(logits[0]))


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


# --- the kernel's sort-free rule, modelled in numpy --------------------------

#: the model's knob rows: greedy, then k in {<= 0, 1, >= V} crossed with
#: p in {<= 0, 0.3, >= 1}, and both cuts in the middle
RULE_TEMP = np.array([0.0, 0.7, 1.0, 1.3, 0.9, 1.1, 0.8, 1.2, 0.6, 1.4,
                      0.5, 1.0], np.float32)
RULE_TOPK = np.array([0, 0, 0, -2, 1, 1, 1, 100000, 100000, 100000, 5, 7],
                     np.int64)
RULE_TOPP = np.array([1.0, 0.0, 0.3, 1.5, -0.5, 0.3, 1.0, 0.0, 0.3, 1.0,
                      0.9, 0.3], np.float32)
#: the kernel's fixed point: 40 fraction bits a mass term
_FIX = 2.0 ** 40


def _rule_inputs(seed, v, kind):
    """Rows for the model: ``random``; ``ties`` (every value four times);
    ``zeros`` (each row shifted so that its k-th largest value, or its
    4th without a top-k, is 0, with +0.0 and -0.0 in turn at the ranks
    around it: for k = 1 the largest value is a tie of +-0.0)."""
    s = len(RULE_TEMP)
    if kind == "ties":
        logits, g = _inputs(seed, v, ties=True)
        logits = np.concatenate([logits, logits[:s - len(TEMP)]])
        g = np.concatenate([g, g[:s - len(TEMP)]])
        return logits, g
    rs = np.random.RandomState(seed + 100)
    logits = (rs.randn(s, v) * 2).astype(np.float32)
    g = -np.log(-np.log(rs.uniform(1e-6, 1.0, (s, v)))).astype(np.float32)
    if kind == "zeros":
        for row in range(s):
            k = int(RULE_TOPK[row])
            r = k - 1 if 0 < k < v else 3
            order = np.argsort(-logits[row], kind="stable")
            logits[row] -= logits[row, order[r]]
            ranks = order[max(0, r - 2):r + 4]
            logits[row, ranks] = np.array([0.0, -0.0] * 3,
                                          np.float32)[:len(ranks)]
    return logits, g


def _keys(lf):
    """The kernel's order-preserving uint32 keys, -0.0 as +0.0."""
    u = lf.astype(np.float32).view(np.uint32).astype(np.int64)
    u[u == 0x80000000] = 0
    return np.where(u & 0x80000000, 0xFFFFFFFF ^ u, u | 0x80000000)


def _kval(key):
    key = int(key)
    u = key & 0x7FFFFFFF if key & 0x80000000 else 0xFFFFFFFF ^ key
    return float(np.array([u], np.uint32).view(np.float32)[0])


def _descend(keys, vals, thr_of_total, extra=None):
    """The kernel's radix descent, 8 bits a pass: in each pass the bins
    of the next digit among the keys under the prefix so far (their
    integer value, with ``extra = (key, value)`` added at its bin), and
    the lowest bin whose value above, plus what lay above the prefix, is
    under the threshold (taken from the first pass's total). Returns the
    key and the value above it. The kernel stops at the first chosen bin
    that holds one key: that key and value above are asserted to be the
    full descent's."""
    prefix, base, thr, early = 0, 0, None, None
    for shift in (24, 16, 8, 0):
        hi = 0 if shift == 24 else (0xFFFFFFFF << (shift + 8)) & 0xFFFFFFFF
        sel = (keys & hi) == prefix
        digits = (keys[sel] >> shift) & 255
        val = [0] * 256
        for d, x in zip(digits.tolist(), vals[sel].tolist()):
            val[d] += x
        if extra is not None and (extra[0] & hi) == prefix:
            val[(extra[0] >> shift) & 255] += extra[1]
        if thr is None:
            thr = thr_of_total(sum(val))
        run, best = 0, None
        for b in range(255, -1, -1):
            if base + run < thr:
                best, best_above = b, run
            run += val[b]
        base += best_above
        inside = keys[sel][digits == best].tolist()
        if extra is not None and (extra[0] & hi) == prefix \
                and (extra[0] >> shift) & 255 == best:
            inside.append(extra[0])
        if early is None and min(inside) == max(inside):
            early = (inside[0], base)
        prefix |= best << shift
    assert early == (prefix, base)
    return prefix, base


def _sort_free_rule(logits, temp, top_k, top_p, g):
    """The kernel's rule on each row, with no sort: the candidate mask
    and the token. Also checks the descents against the definitions
    they compute, by counting: kth has fewer than kc entries above it
    and at least kc at or above it; thresh is the smallest value >= kth
    in the row whose top-k mass strictly above is under p of the total."""
    s, v = logits.shape
    keep_all = np.zeros((s, v), bool)
    tokens = np.zeros(s, np.int64)
    for row in range(s):
        t = np.float32(temp[row]) if temp[row] > 0 else np.float32(1.0)
        lf = (logits[row] / t).astype(np.float32)
        keys = _keys(lf)
        k, p = int(top_k[row]), np.float32(top_p[row])
        do_k = 0 < k < v
        kc = k if do_k else v
        keep = np.ones(v, bool)
        member = np.ones(v, bool)
        extra = None
        mx = _kval(keys.max())
        mass = np.rint(np.exp((lf - np.float32(mx)).astype(np.float32))
                       .astype(np.float64) * _FIX).astype(np.int64)
        if do_k:
            kkey, n_gt = _descend(keys, np.ones(v, np.int64),
                                  lambda total: kc)
            assert (keys > kkey).sum() == n_gt < kc <= (keys >= kkey).sum()
            eq = keys == kkey
            keep = (keys > kkey) | (eq & (n_gt + np.cumsum(eq) <= kc))
            member = keys > kkey
            kmass = int(np.rint(float(np.exp(np.float32(
                np.float32(_kval(kkey)) - np.float32(mx)))) * _FIX))
            extra = (kkey, (kc - n_gt) * kmass)
        lfk = np.where(keep, lf, np.float32(NEG_INF))
        if 0 < p < 1:
            # an integer is under p Z exactly when it is under the
            # ceiling of the float64 product, as the kernel compares
            tkey, _ = _descend(keys[member], mass[member],
                               lambda total: math.ceil(float(p) *
                                                       float(total)),
                               extra)
            present = set(keys[member].tolist()) | (
                {extra[0]} if extra else set())
            total = int(mass[member].sum()) + (extra[1] if extra else 0)

            def above(key):
                m = int(mass[member & (keys > key)].sum())
                if extra and extra[0] > key:
                    m += extra[1]
                return m
            assert tkey == min(key for key in present
                               if above(key) < float(p) * float(total))
            thresh = _kval(tkey)
        else:
            thresh = np.inf
        lfm = lfk if p >= 1 else np.where(lfk >= thresh, lfk,
                                          np.float32(NEG_INF))
        keep_all[row] = lfm > NEG_INF
        tokens[row] = np.argmax((lfm + g[row]).astype(np.float32)) \
            if temp[row] > 0 else np.argmax(logits[row])
    return keep_all, tokens


RULE_CASES = [(kind, v, seed) for kind in ("random", "ties", "zeros")
              for v in (128, 256) for seed in range(3)]


@pytest.mark.parametrize("kind,v,seed", RULE_CASES)
def test_sort_free_rule_candidates_match_mask_program(kind, v, seed):
    """The model's candidate set is the unfused mask program's, row for
    row (``_masked_logits_vec``: stable rank top-k, float32 cumsum)."""
    logits, g = _rule_inputs(seed, v, kind)
    keep, _ = _sort_free_rule(logits, RULE_TEMP, RULE_TOPK, RULE_TOPP, g)
    want = _masked_logits_vec(torch.from_numpy(logits),
                              torch.from_numpy(RULE_TEMP),
                              torch.from_numpy(RULE_TOPK),
                              torch.from_numpy(RULE_TOPP)) > NEG_INF
    np.testing.assert_array_equal(keep, want.numpy())


@pytest.mark.parametrize("kind,v,seed", RULE_CASES)
def test_sort_free_rule_tokens_match_jax_kernel(kind, v, seed):
    """The model's tokens are the Pallas kernel's (interpret mode)."""
    logits, g = _rule_inputs(seed, v, kind)
    _, tokens = _sort_free_rule(logits, RULE_TEMP, RULE_TOPK, RULE_TOPP, g)
    with jsp.force_interpret():
        want = np.asarray(jsp.sample_epilogue(
            jnp.asarray(logits), jnp.asarray(RULE_TEMP),
            jnp.asarray(RULE_TOPK.astype(np.int32)), jnp.asarray(RULE_TOPP),
            jnp.asarray(g)))
    np.testing.assert_array_equal(tokens, want)
