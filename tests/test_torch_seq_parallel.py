"""Sequence parallelism in the port against the JAX package: the named
collectives, ``shard_map``, ring and Ulysses attention (forward and
gradients, with and without packed ids), the attention layers'
``seq_axis_name`` (global RoPE and positional-embedding positions), the
sequence-parallel ``transformer_lm``, and ``kv_segment_ids`` of the
flash wrappers.

The port runs in one 4-rank gloo world on the CPU
(``parallel.launch.World``, started once for the module, each rank on
one torch thread); its ranks import this module to run the ``_rank_*``
functions, so JAX is imported only inside the tests, which run the JAX
side in ``shard_map`` on 4 of the conftest's virtual CPU devices. On
the CPU the flash wrappers take their plain versions. Inputs are made
with numpy from seeds; every comparison is float32 and states its
tolerance.
"""

import functools

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.models import (Model, Sequential, from_jax_params,
                                        zoo)
from distkeras_tpu_torch.models.attention import (MultiHeadAttention,
                                                  PositionalEmbedding)
from distkeras_tpu_torch.ops.flash_attention import (
    attention_delta, flash_attention, flash_backward,
    flash_backward_reference, flash_forward, flash_forward_reference)
from distkeras_tpu_torch.ops.ring_attention import ring_attention
from distkeras_tpu_torch.ops.ulysses import ulysses_attention
from distkeras_tpu_torch.parallel import collectives as C
from distkeras_tpu_torch.parallel.launch import World
from distkeras_tpu_torch.parallel.mesh import (P, make_mesh, make_mesh_2d,
                                               replicated, worker_sharded)
from distkeras_tpu_torch.utils.tree import (tree_leaves, tree_map,
                                            tree_unflatten)

N = 4
#: the forward's float32 agreement (JAX's own ring/Ulysses tests)
FWD_TOL = 1e-5
#: gradients of the ring's two passes against JAX's custom VJP and its
#: plain loop (float32, two orders of the hops' sums)
GRAD_TOL = 1e-4
#: the sequence-parallel LM: logits and gradients relative to each
#: leaf's largest |value|
LM_TOL = 1e-4


# --- the world ---------------------------------------------------------------

class _Worlds:
    """One 4-rank world for the module, restarted if a failure broke it."""

    def __init__(self):
        self.world = None

    def run(self, fn, *args, **kwargs):
        if self.world is None or self.world.broken:
            self.world = World(N, threads=1, timeout=60)
        return self.world.run(fn, *args, **kwargs)

    def close(self):
        if self.world is not None:
            self.world.close()


@pytest.fixture(scope="module")
def world():
    w = _Worlds()
    yield w
    w.close()


_MESHES = {}


def _mesh(**shape):
    """This rank's mesh of the given axes (cached: a mesh's groups are
    made collectively, once)."""
    shape = shape or {"seq": N}
    key = tuple(shape.items())
    if key not in _MESHES:
        _MESHES[key] = make_mesh_2d(shape, device="cpu")
    return _MESHES[key]


def _local(a, axis_name="seq", dim=1):
    """This rank's block of dimension ``dim`` of the numpy array ``a``."""
    n, i = C.axis_size(axis_name), C.axis_index(axis_name)
    step = a.shape[dim] // n
    return torch.from_numpy(np.ascontiguousarray(
        np.take(a, np.arange(i * step, (i + 1) * step), axis=dim)))


def _gather(t, axis_name="seq", dim=1):
    return C.all_gather(t.detach(), axis_name, axis=dim, tiled=True).numpy()


def _jax_mesh(axis="seq", n=N):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:n]), (axis,))


def _jax_shard_map(fn, axis="seq", n_in=3, n=N):
    from jax.sharding import PartitionSpec as JP

    from distkeras_tpu.compat import shard_map
    return shard_map(fn, mesh=_jax_mesh(axis, n),
                     in_specs=(JP(None, axis),) * n_in,
                     out_specs=JP(None, axis))


def _qkv(seed, b, s, h, d, extra=1):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, s, h, d).astype(np.float32)
            for _ in range(3 + extra)]


# --- the collectives against lax ---------------------------------------------

def _rank_collectives(x, y):
    with _mesh():
        i = C.axis_index("seq")
        xl, yl = torch.from_numpy(x[i]), torch.from_numpy(y[i])
        shift = [(j, (j + 1) % N) for j in range(N)]
        holes = [(0, 2), (2, 3), (3, 0)]           # 1 sends, 1 receives none
        out = {
            "index": np.int64(i), "size": np.int64(C.psum(1, "seq")),
            "shift": C.ppermute(xl, "seq", shift),
            "back": C.ppermute(xl, "seq", [(d, s) for s, d in shift]),
            "holes": C.ppermute(xl, "seq", holes),
            "a2a_12": C.all_to_all(yl, "seq", 1, 2, tiled=True),
            "a2a_21": C.all_to_all(yl, "seq", 2, 1, tiled=True),
            "a2a_stack": C.all_to_all(yl[:, :N], "seq", 1, 0),
            "gather": C.all_gather(xl, "seq"),
            "gather_tiled": C.all_gather(xl, "seq", axis=1, tiled=True),
            "psum": C.psum(xl, "seq"),
            "psum_bf16": C.psum(xl.to(torch.bfloat16), "seq").float(),
        }
        shifted = C.shift_start([xl, yl.to(torch.bfloat16)], "seq").wait()
        out["shift_start"] = shifted[0]
        out["shift_start_bf16"] = shifted[1].float()
    return {k: np.asarray(v) for k, v in out.items()}


def test_collectives_match_lax(world):
    """``axis_index``, ``psum(1)``, ``ppermute`` (ring, inverse, a
    permutation with holes), tiled and stacked ``all_to_all``, stacked
    and tiled ``all_gather``: bitwise ``lax``'s under ``shard_map``;
    ``psum`` to float32 rounding; ``shift_start`` is the ring
    ``ppermute`` (bf16 bits included)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as JP

    from distkeras_tpu.compat import shard_map
    rs = np.random.RandomState(0)
    x = rs.randn(N, 3, 5).astype(np.float32)
    y = rs.randn(N, 2, 8, 4).astype(np.float32)
    got = world.run(_rank_collectives, x, y)
    shift = [(j, (j + 1) % N) for j in range(N)]

    def body(x, y):
        x, y = x[0], y[0]
        outs = (lax.axis_index("seq"), lax.psum(1, "seq"),
                lax.ppermute(x, "seq", shift),
                lax.ppermute(x, "seq", [(d, s) for s, d in shift]),
                lax.ppermute(x, "seq", [(0, 2), (2, 3), (3, 0)]),
                lax.all_to_all(y, "seq", 1, 2, tiled=True),
                lax.all_to_all(y, "seq", 2, 1, tiled=True),
                lax.all_to_all(y[:, :N], "seq", 1, 0),
                lax.all_gather(x, "seq"),
                lax.all_gather(x, "seq", axis=1, tiled=True),
                lax.psum(x, "seq"))
        return tuple(jnp.asarray(o)[None] for o in outs)

    names = ("index", "size", "shift", "back", "holes", "a2a_12", "a2a_21",
             "a2a_stack", "gather", "gather_tiled", "psum")
    fn = shard_map(body, mesh=_jax_mesh(), in_specs=(JP("seq"),) * 2,
                   out_specs=(JP("seq"),) * len(names))
    ref = jax.jit(fn)(x, y)
    for r in range(N):
        for name, want in zip(names, ref):
            want = np.asarray(want)[r]
            if name == "psum":
                np.testing.assert_allclose(got[r][name], want, rtol=1e-6)
            else:
                np.testing.assert_array_equal(got[r][name], want,
                                              err_msg=f"{name} rank {r}")
        np.testing.assert_array_equal(got[r]["shift_start"],
                                      np.asarray(ref[2])[r])
        bf = torch.from_numpy(y[(r - 1) % N]).to(torch.bfloat16).float()
        np.testing.assert_array_equal(got[r]["shift_start_bf16"], bf.numpy())
        np.testing.assert_allclose(got[r]["psum_bf16"],
                                   np.asarray(ref[10])[r], rtol=2e-2,
                                   atol=2e-2)


def _rank_differentiable(x, co):
    with _mesh():
        i = C.axis_index("seq")
        xl = torch.from_numpy(x[i]).requires_grad_()
        shift = [(j, (j + 1) % N) for j in range(N)]
        y = C.all_to_all(C.ppermute(xl, "seq", shift), "seq", 0, 1,
                         tiled=True)
        z = C.all_gather(C.psum(y * y, "seq"), "seq", axis=0, tiled=True)
        (z * torch.from_numpy(co[i])).sum().backward()
        return xl.grad.numpy()


def test_collective_gradients_match_lax(world):
    """The gradients of ``ppermute``, ``all_to_all``, ``psum`` and
    ``all_gather`` in a chain (the inverse shift, the all-to-all back,
    the summed cotangents, the slice of the reduce-scatter) equal JAX's
    transposes (float32 rounding)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as JP

    from distkeras_tpu.compat import shard_map
    rs = np.random.RandomState(1)
    x = rs.randn(N, 8, 4).astype(np.float32)
    co = rs.randn(N, 8, 16).astype(np.float32)
    got = world.run(_rank_differentiable, x, co)
    shift = [(j, (j + 1) % N) for j in range(N)]

    def body(x, co):
        y = lax.all_to_all(lax.ppermute(x[0], "seq", shift), "seq", 0, 1,
                           tiled=True)
        z = lax.all_gather(lax.psum(y * y, "seq"), "seq", axis=0,
                           tiled=True)
        return jnp.sum(z * co[0])[None]

    fn = shard_map(body, mesh=_jax_mesh(), in_specs=(JP("seq"),) * 2,
                   out_specs=JP("seq"))
    ref = jax.grad(lambda x: jnp.sum(fn(x, co)))(x)
    for r in range(N):
        np.testing.assert_allclose(got[r], np.asarray(ref)[r], rtol=1e-5,
                                   atol=1e-5)


def _rank_mesh_errors():
    out = {}
    for name, call in (("workers", lambda: make_mesh(N + 1)),
                       ("2d", lambda: make_mesh_2d({"dp": 3, "sp": 2}))):
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    m = make_mesh(2, "workers", device="cpu")
    out["workers2"] = (m.shape, m.size)
    out["specs"] = (replicated(m).spec, worker_sharded(m).spec)
    mesh = _mesh(dp=2, sp=2)
    out["2d_axes"] = (mesh.axis_index("dp"), mesh.axis_index("sp"),
                      mesh.axis_size("dp"), mesh.axis_size("sp"))
    return out


def test_make_mesh_and_make_mesh_2d_errors(world):
    """A mesh larger than the world raises ``ValueError`` as JAX's does
    (JAX: more workers than devices); a 2-D mesh's axis indices are
    row-major over the ranks; ``replicated``/``worker_sharded`` are
    JAX's specs."""
    got = world.run(_rank_mesh_errors)
    for r, out in enumerate(got):
        assert "exceeds available devices (4)" in out["workers"]
        assert "needs 6 devices, have 4" in out["2d"]
        assert out["workers2"] == ({"workers": 2}, 2)
        assert out["specs"] == (P(), P("workers"))
        assert out["2d_axes"] == (r // 2, r % 2, 2, 2)


def test_unbound_axis_raises_name_error():
    """A collective or an axis lookup outside a mesh raises ``NameError``
    (JAX's unbound axis); a sequence-parallel layer outside one sees the
    whole sequence only where JAX does (the positional embedding)."""
    with pytest.raises(NameError, match="unbound axis"):
        C.axis_index("sp")
    with pytest.raises(NameError, match="unbound axis"):
        C.ppermute(torch.zeros(2), "sp", [(0, 0)])
    pe = PositionalEmbedding(8, seq_axis_name="sp")
    m = Model.build(Sequential([pe]), (8, 4), device="cpu")
    x = torch.zeros(2, 8, 4)
    torch.testing.assert_close(m.apply(x), m.params[0]["embeddings"][None]
                               .expand(2, 8, 4))


# --- ring attention ----------------------------------------------------------

def _rank_ring(q, k, v, co, seg, causal, block_size, custom):
    with _mesh():
        ql, kl, vl = (_local(a).requires_grad_() for a in (q, k, v))
        out = ring_attention(
            ql, kl, vl, axis_name="seq", causal=causal,
            block_size=block_size, use_custom_vjp=custom,
            segment_ids=None if seg is None else _local(seg))
        (out * _local(co)).sum().backward()
        return [_gather(t) for t in (out, ql.grad, kl.grad, vl.grad)]


def _rank_ring_shard_map(q, k, v, causal):
    fn = C.shard_map(functools.partial(ring_attention, axis_name="seq",
                                       causal=causal),
                     _mesh(), (P(None, "seq"),) * 3, P(None, "seq"))
    return fn(*(torch.from_numpy(a) for a in (q, k, v))).numpy()


def _jax_ring(q, k, v, co, seg, causal, block_size=None, custom=True):
    """JAX's ring under shard_map: the output and the gradients of
    ``sum(out * co)``."""
    import jax
    import jax.numpy as jnp

    from distkeras_tpu.ops.ring_attention import ring_attention as jring

    def local(q, k, v, *s):
        return jring(q, k, v, axis_name="seq", causal=causal,
                     block_size=block_size, use_custom_vjp=custom,
                     segment_ids=s[0] if s else None)

    extra = () if seg is None else (jnp.asarray(seg),)
    fn = _jax_shard_map(local, n_in=3 + len(extra))

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v, *extra) * co)

    out = jax.jit(fn)(q, k, v, *extra)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(t) for t in (out, *grads)]


@pytest.mark.parametrize("causal", [False, True])
def test_ring_forward_matches_jax(world, causal):
    """JAX ``tests/test_attention.py:99`` on the port: ``shard_map`` of
    ``ring_attention`` over 4 ranks equals JAX's ring and the dense
    attention (1e-5)."""
    from distkeras_tpu.ops.attention import dot_product_attention as jdpa
    q, k, v = _qkv(3, 2, 8 * N, 2, 8, extra=0)
    got = world.run(_rank_ring_shard_map, q, k, v, causal)
    ref = _jax_ring(q, k, v, np.ones_like(q), None, causal)[0]
    dense = np.asarray(jdpa(q, k, v, causal=causal))
    for r in range(N):
        np.testing.assert_allclose(got[r], ref, atol=FWD_TOL)
        np.testing.assert_allclose(got[r], dense, atol=FWD_TOL)


@pytest.mark.parametrize("block_size", [None, 8])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_gradients_match_jax(world, causal, block_size):
    """JAX :116 and :142: the port's second-pass backward and its
    autograd-through-the-loop oracle (``use_custom_vjp=False``) against
    JAX's custom VJP and JAX's own loop (1e-4), at ``block_size`` None
    and 8."""
    q, k, v, co = _qkv(7, 2, 16 * N, 2, 8)
    want = _jax_ring(q, k, v, co, None, causal, block_size)
    want_loop = _jax_ring(q, k, v, co, None, causal, block_size,
                          custom=False)
    for custom in (True, False):
        got = world.run(_rank_ring, q, k, v, co, None, causal, block_size,
                        custom)[0]
        np.testing.assert_allclose(got[0], want[0], atol=FWD_TOL)
        for g, w, wl in zip(got[1:], want[1:], want_loop[1:]):
            np.testing.assert_allclose(g, w, atol=GRAD_TOL)
            np.testing.assert_allclose(g, wl, atol=GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_grouped_kv_heads_match_jax(world, causal):
    """Grouped K/V heads (GQA) go round the ring unrepeated: the port's
    ring on ``Hkv = H / 2`` heads, both backward passes, equals JAX's
    ring on the heads repeated to ``H``, each grouped head's gradient
    the sum over its group (1e-5 forward, 1e-4 gradients)."""
    q, k, v, co = _qkv(29, 2, 8 * N, 4, 8)
    k, v = k[:, :, :2], v[:, :, :2]
    rep = lambda a: np.repeat(a, 2, axis=2)  # noqa: E731
    want = _jax_ring(q, rep(k), rep(v), co, None, causal)
    b, s, _, d = k.shape
    want[2:] = [g.reshape(b, s, 2, 2, d).sum(3) for g in want[2:]]
    for custom in (True, False):
        got = world.run(_rank_ring, q, k, v, co, None, causal, None,
                        custom)[0]
        np.testing.assert_allclose(got[0], want[0], atol=FWD_TOL)
        for g, w in zip(got[1:], want[1:]):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=GRAD_TOL)


def _rank_raises(fn, *args):
    """``fn(*args)``'s ``ValueError`` message on this rank (None if it
    returns): the checks raise before any collective, so the world
    stays up."""
    try:
        fn(*args)
    except ValueError as e:
        return str(e)
    return None


def test_ring_block_size_is_validated(world):
    """``block_size`` is checked as JAX's ``_check_block`` does."""
    q = np.zeros((1, 12 * N, 2, 8), np.float32)
    for bs, match in ((5, "must divide the local shard length 12"),
                      (0, "must be >= 1")):
        msgs = world.run(_rank_raises, _rank_ring, q, q, q, q, None, True,
                         bs, True)
        assert all(match in (m or "") for m in msgs), msgs


def _rank_residuals(shape):
    mesh = _mesh(**dict(shape))
    with mesh:
        rs = np.random.RandomState(0)
        q, k, v = (torch.from_numpy(rs.randn(2, 16, 2, 8).astype(np.float32))
                   .requires_grad_() for _ in range(3))
        out = ring_attention(q, k, v, axis_name="sp", causal=True)
        saved = out.grad_fn.saved_tensors
        return sum(t.numel() * t.element_size() for t in saved
                   if t is not None)


def test_ring_backward_residuals_ring_independent(world):
    """JAX :162: the bytes the forward saves for the backward do not
    depend on the ring size (rings of 1, 2 and 4 ranks with the same
    local shard)."""
    per_rank = {}
    for n in (1, 2, 4):
        shape = (("dp", N // n), ("sp", n))
        sizes = world.run(_rank_residuals, shape)
        assert len(set(sizes)) == 1, sizes
        per_rank[n] = sizes[0]
    assert len(set(per_rank.values())) == 1, per_rank
    # q, k, v and out [2, 16, 2, 8] and lse [2, 2, 16], float32
    assert per_rank[4] == 4 * (2 * 16 * 2 * 8 * 4) + 2 * 2 * 16 * 4


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_with_segments_matches_jax(world, causal):
    """JAX ``tests/test_packed_sequences.py:213``: sorted ids whose
    documents straddle the shard edges; the k-side ids travel with K/V
    in both passes. Forward 1e-5, gradients 1e-4 against JAX's ring and
    the dense segmented oracle."""
    from test_packed_sequences import _segmented_oracle
    b, s, h, d = 2, 8 * N, 2, 8
    rs = np.random.RandomState(21)
    q, k, v = (rs.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    seg = np.sort(rs.randint(0, 5, (b, s)), axis=1).astype(np.int32)
    co = rs.randn(b, s, h, d).astype(np.float32)
    got = world.run(_rank_ring, q, k, v, co, seg, causal, None, True)[0]
    want = _jax_ring(q, k, v, co, seg, causal)
    oracle = np.asarray(_segmented_oracle(q, k, v, seg, causal=causal))
    np.testing.assert_allclose(got[0], want[0], atol=FWD_TOL)
    np.testing.assert_allclose(got[0], oracle, atol=FWD_TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL)


def test_ring_rows_with_no_key_in_a_hop(world):
    """A query whose document lies wholly in its own shard admits no key
    in any other hop (the kernels' empty rows, at ``NEG_INF``): the merge
    gives those hops zero weight, so the ring equals the dense segmented
    oracle (1e-5 forward, 1e-4 gradients), causal and not."""
    from test_packed_sequences import _segmented_oracle
    b, s, h, d = 1, 8 * N, 2, 8
    rs = np.random.RandomState(5)
    q, k, v, co = (rs.randn(b, s, h, d).astype(np.float32)
                   for _ in range(4))
    seg = (np.arange(s) // 8).astype(np.int32)[None]    # one doc a shard
    seg[0, 5:8] = 9                     # and a doc split across shards 0, 2
    seg[0, 16:18] = 9
    for causal in (True, False):
        got = world.run(_rank_ring, q, k, v, co, seg, causal, None,
                        True)[0]
        want = _jax_ring(q, k, v, co, seg, causal)
        oracle = np.asarray(_segmented_oracle(q, k, v, seg, causal=causal))
        np.testing.assert_allclose(got[0], oracle, atol=FWD_TOL)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, w, atol=GRAD_TOL)


def _rank_ring_launches(q, k, v, causal):
    """The flash calls of one ring forward and backward on this rank."""
    import sys
    mod = sys.modules["distkeras_tpu_torch.ops.ring_attention"]
    calls = {"fwd": [], "bwd": []}
    fwd, bwd = mod.flash_forward, mod.flash_backward

    def count_fwd(*a, **kw):
        calls["fwd"].append(kw["causal"])
        return fwd(*a, **kw)

    def count_bwd(*a, **kw):
        calls["bwd"].append(kw["causal"])
        return bwd(*a, **kw)

    mod.flash_forward, mod.flash_backward = count_fwd, count_bwd
    try:
        _rank_ring(q, k, v, q, None, causal, None, True)
    finally:
        mod.flash_forward, mod.flash_backward = fwd, bwd
    return calls


def test_ring_skips_later_shards_under_causal(world):
    """Under ``causal`` rank i runs i + 1 forward and i + 1 backward
    hops, the first (its own shard) causal and the rest full; without,
    every rank runs 4 full hops."""
    q = np.random.RandomState(0).randn(1, 4 * N, 2, 8).astype(np.float32)
    causal = world.run(_rank_ring_launches, q, q, q, True)
    full = world.run(_rank_ring_launches, q, q, q, False)
    for r in range(N):
        assert causal[r] == {"fwd": [True] + [False] * r,
                             "bwd": [True] + [False] * r}
        assert full[r] == {"fwd": [False] * N, "bwd": [False] * N}


# --- Ulysses -----------------------------------------------------------------

def _rank_ulysses(q, k, v, co, seg, causal, impl):
    with _mesh():
        ql, kl, vl = (_local(a).requires_grad_() for a in (q, k, v))
        out = ulysses_attention(
            ql, kl, vl, axis_name="seq", causal=causal, impl=impl,
            segment_ids=None if seg is None else _local(seg))
        (out * _local(co)).sum().backward()
        return [_gather(t) for t in (out, ql.grad, kl.grad, vl.grad)]


def _jax_ulysses(q, k, v, co, seg, causal):
    import jax
    import jax.numpy as jnp

    from distkeras_tpu.ops.ulysses import ulysses_attention as july

    def local(q, k, v, *s):
        return july(q, k, v, axis_name="seq", causal=causal,
                    segment_ids=s[0] if s else None)

    extra = () if seg is None else (jnp.asarray(seg),)
    fn = _jax_shard_map(local, n_in=3 + len(extra))
    out = jax.jit(fn)(q, k, v, *extra)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v, *extra)
                                                     * co),
                             argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(t) for t in (out, *grads)]


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(world, causal, impl):
    """JAX :192 and :208: the head-scatter attention (plain and flash
    inner attention) and its gradients against JAX's Ulysses (1e-5)."""
    q, k, v, co = _qkv(13, 2, 4 * N, N, 8)
    got = world.run(_rank_ulysses, q, k, v, co, None, causal, impl)[0]
    want = _jax_ulysses(q, k, v, co, None, causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=FWD_TOL)


def test_ulysses_with_segments_matches_jax(world):
    """JAX ``tests/test_packed_sequences.py:262``: the ids all-gathered
    beside the head scatter; forward 1e-5, gradients 1e-4."""
    b, s, h, d = 2, 4 * N, N, 8
    rs = np.random.RandomState(22)
    q, k, v = (rs.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    seg = np.sort(rs.randint(0, 4, (b, s)), axis=1).astype(np.int32)
    co = rs.randn(b, s, h, d).astype(np.float32)
    for impl in ("xla", "flash"):
        got = world.run(_rank_ulysses, q, k, v, co, seg, True, impl)[0]
        want = _jax_ulysses(q, k, v, co, seg, True)
        np.testing.assert_allclose(got[0], want[0], atol=FWD_TOL)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, w, atol=GRAD_TOL)


def test_ulysses_rejects_indivisible_heads(world):
    """JAX :229: heads that do not divide over the axis raise
    ``ValueError``."""
    q = np.zeros((1, 2 * N, N + 1, 4), np.float32)
    msgs = world.run(_rank_raises, _rank_ulysses, q, q, q, q, None, False,
                     "xla")
    assert all("divisible" in (m or "") for m in msgs), msgs


# --- the layers --------------------------------------------------------------

def _rank_layer(spec, params, x, seg):
    from distkeras_tpu_torch.models import layer_from_spec
    layer = layer_from_spec(spec)
    model = Model.build(Sequential([layer]), x.shape[1:], device="cpu")
    from_jax_params(model, [params])
    with _mesh(sp=N):
        xl = _local(x, "sp")
        kw = {} if seg is None else {"segment_ids": _local(seg, "sp")}
        y = layer.apply(model.params[0], xl, **kw)
        return _gather(y, "sp")


def _jax_layer(layer, params, x, seg, sharded):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from distkeras_tpu.compat import shard_map
    kw = lambda s: {} if s is None else {"segment_ids": s}  # noqa: E731
    if not sharded:
        return np.asarray(layer.apply(params, {}, jnp.asarray(x),
                                      **kw(seg))[0])
    args = (x,) if seg is None else (x, jnp.asarray(seg))
    fn = shard_map(lambda xs, *s: layer.apply(params, {}, xs,
                                              **kw(s[0] if s else None))[0],
                   mesh=_jax_mesh("sp"),
                   in_specs=(JP(None, "sp"),) * len(args),
                   out_specs=JP(None, "sp"))
    return np.asarray(jax.jit(fn)(*args))


@pytest.mark.parametrize("impl,seg,kv", [("ulysses", False, None),
                                         ("ulysses_flash", False, None),
                                         ("ring", True, None),
                                         ("ring", False, None),
                                         ("ring", False, 2),
                                         ("ulysses", False, 2)],
                         ids=["ulysses", "ulysses_flash", "ring-ids",
                              "ring", "ring-gqa", "ulysses-gqa"])
def test_mha_sequence_parallel_matches_xla(world, impl, seg, kv):
    """JAX :242 and ``tests/test_packed_sequences.py:306``:
    ``MultiHeadAttention(attn_impl=impl, seq_axis_name="sp")`` over the
    sequence shards, global RoPE positions (and ids) included, equals
    the unsharded ``"xla"`` layer of JAX on the same weights and JAX's
    own sharded layer (its ``"ulysses"`` one for ``"ulysses_flash"``)
    (1e-5); ``kv`` grouped K/V heads, which the ring shifts unrepeated
    and Ulysses repeats."""
    import jax

    from distkeras_tpu.models.attention import \
        MultiHeadAttention as JMHA
    from distkeras_tpu.models.core import layer_spec as jax_layer_spec
    b, s, dm = 2, 8 * N, 16
    rs = np.random.RandomState(23)
    x = rs.randn(b, s, dm).astype(np.float32)
    ids = np.sort(rs.randint(0, 3, (b, s)), axis=1).astype(np.int32) \
        if seg else None
    sp = JMHA(num_heads=N, attn_impl=impl, seq_axis_name="sp",
              use_rope=True, num_kv_heads=kv)
    params, _, _ = sp.init(jax.random.PRNGKey(0), (s, dm))
    xla = JMHA(num_heads=N, attn_impl="xla", use_rope=True, num_kv_heads=kv)
    ref = _jax_layer(xla, params, x, ids, sharded=False)
    # JAX's Pallas kernel does not trace under its shard_map's vma check
    # on the CPU: its "ulysses" layer is the sharded twin of the flash one
    twin = sp if impl != "ulysses_flash" else JMHA(
        num_heads=N, attn_impl="ulysses", seq_axis_name="sp", use_rope=True)
    jsp = _jax_layer(twin, params, x, ids, sharded=True)
    got = world.run(_rank_layer, jax_layer_spec(sp),
                    jax.device_get(params), x, ids)
    for r in range(N):
        np.testing.assert_allclose(got[r], ref, atol=FWD_TOL)
        np.testing.assert_allclose(got[r], jsp, atol=FWD_TOL)


def test_mha_sequence_parallel_bad_combinations_raise(world):
    """JAX :150-171: a window with a sequence-parallel implementation,
    or one without ``seq_axis_name``, raises ``ValueError`` at the
    call."""
    x = torch.zeros(1, 8, 16)
    for kw, match in ((dict(attn_impl="ring"), "requires seq_axis_name"),
                      (dict(attn_impl="ulysses"), "requires seq_axis_name"),
                      (dict(attn_impl="ring", seq_axis_name="sp",
                            attn_window=4), "attn_window is not supported")):
        m = Model.build(Sequential([MultiHeadAttention(
            num_heads=2, use_rope=False, **kw)]), (8, 16), device="cpu")
        with pytest.raises(ValueError, match=match):
            m.apply(x)


def _rank_positions(spec, params, x):
    return _rank_layer(spec, params, x, None)


def test_positional_embedding_global_under_seq_sharding(world):
    """JAX :450: under the sequence shards the table is read at the
    GLOBAL positions (1e-6); a table shorter than the global sequence
    raises (JAX :476)."""
    import jax

    from distkeras_tpu.models.attention import \
        PositionalEmbedding as JPE
    from distkeras_tpu.models.core import layer_spec as jax_layer_spec
    d, s = 4, 16
    pe = JPE(s, seq_axis_name="sp")
    params, _, _ = JPE(s).init(jax.random.PRNGKey(0), (s, d))
    x = np.random.RandomState(1).randn(2, s, d).astype(np.float32)
    ref = _jax_layer(JPE(s), params, x, None, sharded=False)
    got = world.run(_rank_positions, jax_layer_spec(pe),
                    jax.device_get(params), x)
    for r in range(N):
        np.testing.assert_allclose(got[r], ref, atol=1e-6)
    small = JPE(s // 2, seq_axis_name="sp")
    small_params, _, _ = small.init(jax.random.PRNGKey(0), (s, d))
    msgs = world.run(_rank_raises, _rank_positions, jax_layer_spec(small),
                     jax.device_get(small_params), x)
    assert all("too small" in (m or "") for m in msgs), msgs


# --- the sequence-parallel LM ------------------------------------------------

V, S_LM = 32, 8 * N
LM_KW = dict(d_model=16, num_heads=N, num_layers=2, mlp_ratio=2)


def _rank_lm(impl, jparams, toks, co):
    pm = Model.build(zoo.transformer_lm(V, attn_impl=impl,
                                        seq_axis_name="sp", **LM_KW),
                     (S_LM,), device="cpu")
    from_jax_params(pm, jparams)
    with _mesh(sp=N):
        logits = pm.module.apply(pm.params, _local(toks, "sp"))
        loss = (logits * _local(co, "sp")).sum()
        grads = C.psum(torch.autograd.grad(loss, tree_leaves(pm.params)),
                       "sp")
        return (_gather(logits, "sp"),
                tree_map(lambda t: t.numpy(),
                         tree_unflatten(pm.params, list(grads))))


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_transformer_lm_sequence_parallel_matches_jax(world, impl):
    """``transformer_lm(attn_impl=impl, seq_axis_name="sp")`` on JAX's
    weights over 4 ranks: logits and the parameter gradients of
    ``sum(logits * co)`` (each rank's psum-ed over ``sp``) against JAX's
    same model under ``shard_map`` (1e-4, relative to each leaf's
    largest |value|)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from distkeras_tpu.compat import shard_map
    from distkeras_tpu.models import Model as JaxModel
    from distkeras_tpu.models import zoo as jax_zoo
    jm = JaxModel.build(jax_zoo.transformer_lm(
        V, attn_impl=impl, seq_axis_name="sp", **LM_KW), (S_LM,), seed=0)
    rs = np.random.RandomState(4)
    toks = rs.randint(0, V, (2, S_LM)).astype(np.int32)
    co = rs.randn(2, S_LM, V).astype(np.float32)
    fn = shard_map(lambda p, t: jm.module.apply(p, jm.state, t)[0],
                   mesh=_jax_mesh("sp"), in_specs=(JP(), JP(None, "sp")),
                   out_specs=JP(None, "sp"))
    ref = np.asarray(jax.jit(fn)(jm.params, toks))
    ref_g = jax.jit(jax.grad(lambda p: jnp.sum(fn(p, toks) * co)))(
        jm.params)
    got = world.run(_rank_lm, impl, jax.device_get(jm.params), toks, co)
    scale = np.abs(ref).max()
    for logits, grads in got:
        assert np.abs(logits - ref).max() <= LM_TOL * scale
        for g, r in zip(jax.tree_util.tree_leaves(grads),
                        jax.tree_util.tree_leaves(ref_g)):
            r = np.asarray(r)
            assert np.abs(g - r).max() <= LM_TOL * np.abs(r).max()


def test_sequence_parallel_configs_round_trip_model_files(tmp_path):
    """A JAX model file of a ring LM loads into the port with JAX's
    spec, and the port's file of it loads into JAX (the same weights)."""
    from distkeras_tpu.models import Model as JaxModel
    from distkeras_tpu.models import load_model as jax_load
    from distkeras_tpu.models import save_model as jax_save
    from distkeras_tpu.models import zoo as jax_zoo
    from distkeras_tpu_torch.models import load_model, save_model
    kw = dict(LM_KW, attn_impl="ring", seq_axis_name="sp", use_rope=False,
              max_len=S_LM)
    jm = JaxModel.build(jax_zoo.transformer_lm(V, **kw), (S_LM,), seed=1)
    jax_save(jm, str(tmp_path / "j"))
    pm = load_model(str(tmp_path / "j"), device="cpu")
    assert pm.module.get_config() == jm.module.get_config()
    save_model(pm, str(tmp_path / "p"))
    back = jax_load(str(tmp_path / "p"))
    assert back.module.get_config() == jm.module.get_config()
    import jax
    ours = jax.tree_util.tree_leaves(
        tree_map(lambda t: t.detach().numpy(), pm.params))
    for a, b in zip(ours, jax.tree_util.tree_leaves(back.params)):
        np.testing.assert_array_equal(a, np.asarray(b))


# --- kv_segment_ids ----------------------------------------------------------

def _masked_einsum(q, k, v, qseg, kseg, causal):
    """float64 masked attention and its lse: the oracle of the plain
    versions."""
    qd, kd, vd = (x.double() for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * q.shape[-1] ** -0.5
    allowed = (qseg[:, :, None] == kseg[:, None, :])[:, None]
    if causal:
        i = torch.arange(q.shape[1])
        allowed = allowed & (i[None, :] <= i[:, None])
    s = s.masked_fill(~allowed, -torch.inf)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).nan_to_num(0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, vd), lse


@pytest.mark.parametrize("causal", [False, True])
def test_kv_segment_ids_plain_versions_match_float64(causal):
    """The plain flash forward and backward with distinct k-side ids
    (a ring hop's) against a float64 masked einsum and its autograd
    (1e-5); a row whose id no key carries gets an lse at ``NEG_INF``
    (what the ring's merge weighs zero)."""
    rs = np.random.RandomState(9)
    b, s, h, d = 2, 12, 2, 8
    q, k, v, co = (torch.from_numpy(rs.randn(b, s, h, d).astype(np.float32))
                   for _ in range(4))
    qseg = rs.randint(0, 3, (b, s)).astype(np.int32)
    kseg = rs.randint(0, 3, (b, s)).astype(np.int32)
    # every row admits a key: ids 0, 1, 2 at keys 0-2, rows 0 and 1 hold
    # ids their keys carry
    kseg[:, :3] = [0, 1, 2]
    qseg[:, :2] = [0, 1]
    qseg, kseg = torch.from_numpy(qseg), torch.from_numpy(kseg)
    kw = dict(scale=d ** -0.5, causal=causal, segment_ids=qseg,
              kv_segment_ids=kseg)
    out, lse = flash_forward(q, k, v, **kw)
    qd, kd, vd = (x.double().requires_grad_() for x in (q, k, v))
    ref, ref_lse = _masked_einsum(qd, kd, vd, qseg, kseg, causal)
    torch.testing.assert_close(out.double(), ref.detach(), atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(lse.double(), ref_lse.detach(), atol=1e-5,
                               rtol=0)
    dead = qseg.clone()
    dead[0, 5] = 7
    _, dead_lse = flash_forward(q, k, v, **dict(kw, segment_ids=dead))
    assert (dead_lse[0, :, 5] < 0.5 * torch.finfo(torch.float32).min).all()
    assert (dead_lse[1] > -1e3).all()
    (ref * co.double()).sum().backward()
    got = flash_backward(q, k, v, out, lse, co, attention_delta(out, co),
                         **kw)
    for g, r in zip(got, (qd.grad, kd.grad, vd.grad)):
        torch.testing.assert_close(g.double(), r, atol=1e-5, rtol=0)
    outr, lser = flash_forward_reference(q, k, v, **kw)
    assert torch.equal(outr, out) and torch.equal(lser, lse)
    back = flash_backward_reference(q, k, v, out, lse, co,
                                    attention_delta(out, co), **kw)
    assert all(torch.equal(a, b_) for a, b_ in zip(back, got))


def test_kv_segment_ids_equal_to_q_side_are_bitwise_unchanged():
    """k-side ids that ARE the q-side ids give bitwise the result of
    none, forward, backward and the differentiable ``flash_attention``;
    k-side ids without q-side ones raise."""
    rs = np.random.RandomState(10)
    b, s, h, d = 2, 16, 2, 8
    q, k, v, co = (torch.from_numpy(rs.randn(b, s, h, d).astype(np.float32))
                   for _ in range(4))
    seg = torch.from_numpy(np.sort(rs.randint(0, 3, (b, s)), 1))
    for causal in (False, True):
        kw = dict(scale=d ** -0.5, causal=causal, segment_ids=seg)
        a = flash_forward(q, k, v, **kw)
        c = flash_forward(q, k, v, kv_segment_ids=seg.clone(), **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, c))
        delta = attention_delta(a[0], co)
        ga = flash_backward(q, k, v, *a, co, delta, **kw)
        gc = flash_backward(q, k, v, *a, co, delta,
                            kv_segment_ids=seg.clone(), **kw)
        assert all(torch.equal(x, y) for x, y in zip(ga, gc))
        grads = []
        for kv in (None, seg.clone()):
            qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
            out = flash_attention(qq, kk, vv, causal=causal,
                                  segment_ids=seg, kv_segment_ids=kv)
            (out * co).sum().backward()
            grads.append((out, qq.grad, kk.grad, vv.grad))
        assert all(torch.equal(x, y) for x, y in zip(*grads))
    with pytest.raises(ValueError, match="need segment_ids"):
        flash_forward(q, k, v, scale=1.0, causal=False, kv_segment_ids=seg)
