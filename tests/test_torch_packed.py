"""Packed sequences in the port against the JAX package: segment-masked
flash attention (forward and all three gradients) and plain attention,
``Sequential.apply(segment_ids=)`` through the 2-layer
``transformer_lm``, cross-segment isolation, the ``Remat`` wrapper,
packed training with the masked loss, the decode path's ``Remat``
unwrap and refusal, and the ``attn_impl`` options.

On the CPU the port's flash wrappers run their plain versions; the JAX
side runs its Pallas kernels in interpret mode (``interpret=True``), as
its own tests do, or its XLA path (what ``attn_impl="auto"`` selects
off a TPU). Inputs are made with numpy from seeds; weights cross with
``from_jax_params``. Every comparison is float32 and states its
tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distkeras_tpu.models import Model as JaxModel
from distkeras_tpu.models import decoding as jd
from distkeras_tpu.models import zoo as jax_zoo
from distkeras_tpu.ops import get_optimizer as jax_get_optimizer
from distkeras_tpu.ops import apply_updates as jax_apply_updates
from distkeras_tpu.ops.attention import \
    dot_product_attention as jax_dpa
from distkeras_tpu.ops.flash_attention import _window_kblocks
from distkeras_tpu.ops.flash_attention import \
    flash_attention as jax_flash_attention
from distkeras_tpu.ops.losses import get_loss as jax_get_loss
from test_packed_sequences import _segmented_oracle

from distkeras_tpu_torch.models import (Model, Sequential,
                                        collect_aux_losses, from_jax_params,
                                        to_jax_params, zoo)
from distkeras_tpu_torch.models.attention import (MultiHeadAttention,
                                                  TransformerBlock)
from distkeras_tpu_torch.models.blocks import Remat
from distkeras_tpu_torch.models.layers import Dense, Embedding
from distkeras_tpu_torch.ops import prng
from distkeras_tpu_torch.ops.attention import dot_product_attention
from distkeras_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_backward,
                                                     flash_forward)
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.ops.optimizers import apply_updates, get_optimizer
from distkeras_tpu_torch.serving import ServingEngine
from distkeras_tpu_torch.utils.tree import (tree_leaves, tree_map,
                                            tree_unflatten)

#: float32 agreement of two summation orders over <= 44 keys of O(1)
#: scores: the JAX suite's own flash tolerance
F32_TOL = 2e-5
MASKED_CE = "masked_sparse_categorical_crossentropy_from_logits"


def _qkv(rs, b, s, h, hkv, d):
    return (rs.randn(b, s, h, d).astype(np.float32),
            rs.randn(b, s, hkv, d).astype(np.float32),
            rs.randn(b, s, hkv, d).astype(np.float32))


def _unsorted_ids(rs, b, s, tail=5):
    """Interleaved, unsorted ids in [0, 3) with a -1 tail: ids compare by
    equality only."""
    seg = rs.randint(0, 3, (b, s))
    seg[:, s - tail:] = -1
    return seg


# --- the flash wrappers -------------------------------------------------------

@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 6)])
@pytest.mark.parametrize("hkv", [3, 1])
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_flash_segments_match_pallas(causal, window, hkv, layout):
    """Forward and dq, dk, dv of the port's ``flash_attention`` with
    unsorted ids (and a -1 tail) against ``jax.grad`` through the Pallas
    kernels in interpret mode at S=44 (ragged against the 16-row
    blocks; the window case has remap-active blocks). JAX is given the
    expanded K/V heads, so its dk/dv are the group sums the port
    computes."""
    rs = np.random.RandomState(11)
    b, s, h, d = 2, 44, 3, 8
    q, k, v = _qkv(rs, b, s, h, hkv, d)
    seg = _unsorted_ids(rs, b, s)
    co = rs.randn(b, s, h, d).astype(np.float32)
    if window is not None:
        assert _window_kblocks(16, 16, 3, window, 3) < 3
    if layout == "bhsd":
        q, k, v, co = (x.transpose(0, 2, 1, 3).copy() for x in (q, k, v, co))
    head_axis = 2 if layout == "bshd" else 1

    def jax_out(a, bb, c):
        bb = jnp.repeat(bb, h // hkv, axis=head_axis)
        c = jnp.repeat(c, h // hkv, axis=head_axis)
        return jax_flash_attention(a, bb, c, causal=causal, window=window,
                                   layout=layout, segment_ids=seg,
                                   interpret=True, bwd="pallas",
                                   block_q=16, block_k=16)

    ref_out = jax_out(q, k, v)
    ref = jax.grad(lambda *a: jnp.sum(jax_out(*a) * co),
                   argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal, window=window,
                          layout=layout, segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               atol=F32_TOL)
    (out * torch.from_numpy(co)).sum().backward()
    for r, t in zip(ref, (tq, tk, tv)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   atol=F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_segments_match_the_segmented_oracle(causal):
    """The JAX suite's own dense oracle (``_segmented_oracle``), sorted
    ids as it draws them, forward and gradients, 2e-5."""
    rs = np.random.RandomState(1)
    q, k, v = _qkv(rs, 2, 44, 2, 2, 8)
    seg = np.sort(rs.randint(0, 3, (2, 44)), axis=1)
    co = rs.randn(*q.shape).astype(np.float32)
    ref_out = _segmented_oracle(q, k, v, jnp.asarray(seg), causal)
    ref = jax.grad(lambda *a: jnp.sum(_segmented_oracle(
        *a, jnp.asarray(seg), causal) * co), argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal,
                          segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               atol=F32_TOL)
    (out * torch.from_numpy(co)).sum().backward()
    for r, t in zip(ref, (tq, tk, tv)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   atol=F32_TOL)


@pytest.mark.parametrize("causal,window,hkv,layout", [
    (True, None, 2, "bshd"), (False, None, 2, "bhsd"), (True, 5, 1, "bshd")])
def test_all_equal_segments_are_bitwise_no_segments(causal, window, hkv,
                                                    layout):
    """One id for every position (any integer dtype) gives exactly the
    output, lse and gradients of ``segment_ids=None``."""
    rs = np.random.RandomState(2)
    q, k, v = _qkv(rs, 2, 37, 4, hkv, 8)
    if layout == "bhsd":
        q, k, v = (x.transpose(0, 2, 1, 3).copy() for x in (q, k, v))
    co = torch.from_numpy(rs.randn(*q.shape).astype(np.float32))
    kw = dict(causal=causal, window=window, layout=layout)
    seg = torch.full((2, 37), 7, dtype=torch.int64)

    def run(ids):
        tq, tk, tv = (torch.from_numpy(x).requires_grad_()
                      for x in (q, k, v))
        out = flash_attention(tq, tk, tv, segment_ids=ids, **kw)
        (out * co).sum().backward()
        _, lse = flash_forward(tq.detach(), tk.detach(), tv.detach(),
                               scale=8 ** -0.5, segment_ids=ids, **kw)
        return [out.detach(), lse, tq.grad, tk.grad, tv.grad]

    for a, b in zip(run(seg), run(None)):
        assert torch.equal(a, b)


def test_segment_ids_refusals():
    x = torch.zeros(2, 6, 2, 8)
    seg = torch.zeros(2, 6, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\[B, Sq\]"):
        flash_attention(x, x, x, causal=True, segment_ids=seg[:, :5])
    with pytest.raises(ValueError, match=r"\[B, Sq\]"):
        flash_attention(x, x, x, causal=True, segment_ids=seg[:1])
    k = torch.zeros(2, 7, 2, 8)
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_attention(x, k, k, causal=False, segment_ids=seg)
    with pytest.raises(ValueError, match="segment_ids on meta"):
        flash_attention(x, x, x, causal=True, segment_ids=seg.to("meta"))
    with pytest.raises(TypeError, match="integers"):
        flash_attention(x, x, x, causal=True, segment_ids=seg.float())
    out, lse = flash_forward(x, x, x, scale=1.0, causal=True)
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_backward(x, k, k, out, lse, x, lse, scale=1.0, causal=False,
                       segment_ids=seg)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 4)])
def test_plain_attention_segments_match_jax(causal, window):
    rs = np.random.RandomState(5)
    q, k, v = _qkv(rs, 2, 17, 3, 3, 8)
    seg = _unsorted_ids(rs, 2, 17, tail=3)
    ref = jax_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, window=window, segment_ids=jnp.asarray(seg))
    got = dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                window=window,
                                segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=F32_TOL)


# --- the model ------------------------------------------------------------

V, S = 29, 24
LM_KW = dict(d_model=32, num_heads=4, num_layers=2, mlp_ratio=2)


def _pair(seed=0, jax_kw=None, **cfg):
    kw = dict(LM_KW, **cfg)
    jm = JaxModel.build(jax_zoo.transformer_lm(V, **kw, **(jax_kw or {})),
                        (S,), seed=seed)
    pm = Model.build(zoo.transformer_lm(V, **kw), (S,), device="cpu")
    from_jax_params(pm, jm.params, jm.state)
    return jm, pm


def _packed_rows(rs, b=2, s=S):
    """Rows of three documents and a pad tail (id -1, label -1), the
    labels each document's next token (-1 on its last)."""
    toks = rs.randint(0, V, (b, s))
    seg = np.full((b, s), -1, np.int32)
    cuts = [0, 7, 13, 20]
    for i in range(3):
        seg[:, cuts[i]:cuts[i + 1]] = i
    labels = np.full((b, s), -1, np.int64)
    for i in range(3):
        labels[:, cuts[i]:cuts[i + 1] - 1] = toks[:, cuts[i] + 1:cuts[i + 1]]
    return toks, seg, labels


def _port_loss_grads(pm, params, toks, seg, labels):
    out = pm.module.apply(params, torch.from_numpy(toks),
                          segment_ids=torch.from_numpy(seg))
    loss = get_loss(MASKED_CE)(torch.from_numpy(labels), out)
    return out, loss, torch.autograd.grad(loss, tree_leaves(params))


#: logits of a float32 2-layer model: attention and matmul reassociation
LOGIT_TOL = 1e-5
#: parameter gradients relative to each leaf's largest |value|
GRAD_REL_TOL = 1e-4


@pytest.mark.parametrize("cfg", [{}, {"num_kv_heads": 2},
                                 {"num_kv_heads": 1, "attn_window": 5}],
                         ids=["mha", "gqa", "mqa-swa"])
def test_model_segments_match_jax(cfg):
    """Logits under ``segment_ids`` and the masked loss's parameter
    gradients against JAX ``module.apply(..., segment_ids=)`` (its XLA
    attention) and ``jax.grad``."""
    jm, pm = _pair(**cfg)
    toks, seg, labels = _packed_rows(np.random.RandomState(3))
    jloss = jax_get_loss(MASKED_CE)

    def jax_loss(params):
        out, _ = jm.module.apply(params, jm.state, jnp.asarray(toks),
                                 segment_ids=jnp.asarray(seg))
        return jloss(jnp.asarray(labels), out), out

    (ref_loss, ref_out), ref_g = jax.value_and_grad(
        jax_loss, has_aux=True)(jm.params)
    out, loss, grads = _port_loss_grads(pm, pm.params, toks, seg, labels)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-6)
    got = tree_map(lambda t: t.numpy(), tree_unflatten(pm.params, grads))
    for g, r in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref_g)):
        r = np.asarray(r)
        err = np.abs(g - r).max()
        assert err <= GRAD_REL_TOL * np.abs(r).max(), err


def test_cross_segment_attention_is_zero_end_to_end():
    """JAX ``test_packed_sequences.py:66-117`` on the port: perturbing
    the EARLIER segment (the later one's causal past) leaves the later
    segment's logits bitwise unchanged, only under ids; a loss over the
    later segment has the same gradients either way (1e-6) but for the
    embedding rows of the perturbed tokens."""
    cut = 10
    pm = Model.build(zoo.transformer_lm(32, **LM_KW), (S,), seed=0,
                     device="cpu")
    rs = np.random.RandomState(2)
    toks = rs.randint(0, 32, (2, S))
    toks2 = toks.copy()
    toks2[:, :cut] = rs.randint(0, 32, (2, cut))
    seg = torch.from_numpy((np.arange(S) >= cut).astype(np.int32))[None] \
        .repeat(2, 1)

    def logits(t, s=seg):
        with torch.no_grad():
            return pm.module.apply(pm.params, torch.from_numpy(t),
                                   segment_ids=s)

    l1, l2 = logits(toks), logits(toks2)
    assert torch.equal(l1[:, cut:], l2[:, cut:])
    assert not torch.allclose(l1[:, :cut], l2[:, :cut])
    u1, u2 = logits(toks, None), logits(toks2, None)
    assert not torch.allclose(u1[:, cut:], u2[:, cut:])

    def seg2_grads(t):
        out = pm.module.apply(pm.params, torch.from_numpy(t),
                              segment_ids=seg)
        loss = out[:, cut:].float().square().sum()
        return torch.autograd.grad(loss, tree_leaves(pm.params))

    for a, b in zip(seg2_grads(toks), seg2_grads(toks2)):
        if a.shape == (32, LM_KW["d_model"]):
            continue                      # the embedding table
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


# --- Remat ------------------------------------------------------------------

def _stack(wrap, policy=None, seed=3):
    blk = TransformerBlock(num_heads=2, mlp_ratio=2, causal=True)
    mid = Remat(blk, policy=policy) if wrap else blk
    return Model.build(Sequential([Embedding(16, 16), mid, Dense(16)]),
                       (12,), seed=seed, device="cpu")


@pytest.mark.parametrize("policy", [None, "nothing", "dots",
                                    "dots_no_batch"])
def test_remat_equals_the_bare_block(policy):
    """Same seed, same parameters; under ids the wrapped block's logits
    and gradients equal the bare block's bitwise (the recompute reruns
    the same operations on the same values), and the ids take effect
    through the wrapper."""
    rs = np.random.RandomState(5)
    toks = torch.from_numpy(rs.randint(0, 16, (2, 12)))
    seg = torch.from_numpy(rs.randint(-1, 3, (2, 12)))
    plain, remat = _stack(False), _stack(True, policy)

    def run(m, ids):
        out = m.module.apply(m.params, toks, segment_ids=ids)
        return [out] + list(torch.autograd.grad(
            out.square().sum(), tree_leaves(m.params)))

    for a, b in zip(run(plain, seg), run(remat, seg)):
        assert torch.equal(a, b)
    assert not torch.allclose(run(remat, seg)[0], run(remat, None)[0])


def test_remat_recomputes_in_the_forward_mode_and_leaves_no_aux_loss():
    """The trainer restores eval mode before the backward: the recompute
    still runs in training mode (an MoE block publishes its balance term
    there), and the term the recompute publishes is dropped."""
    m = Model.build(zoo.transformer_lm(29, **LM_KW, moe_every=1,
                                       num_experts=4,
                                       moe_aux_loss_weight=0.01,
                                       remat="nothing"),
                    (11,), seed=0, device="cpu")
    bare = Model.build(zoo.transformer_lm(29, **LM_KW, moe_every=1,
                                          num_experts=4,
                                          moe_aux_loss_weight=0.01),
                       (11,), seed=0, device="cpu")
    x = torch.from_numpy(np.random.RandomState(1).randint(0, 29, (2, 11)))
    grads = []
    for model in (bare, m):
        model.module.train()
        out = model.module.apply(model.params, x)
        loss = out.float().square().mean() + collect_aux_losses(model.module)
        model.module.eval()
        grads.append(torch.autograd.grad(loss, tree_leaves(model.params)))
        assert collect_aux_losses(model.module) == 0.0
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_jax_remat_tree_loads_through_the_bridge():
    """A JAX ``remat="nothing"`` LM's tree has no wrapper key: it loads
    into the port's remat LM, forwards to JAX's logits and exports back
    to the same tree."""
    jm, pm = _pair(seed=4, remat="nothing")
    assert isinstance(pm.module.layers[1], Remat)
    toks, seg, _ = _packed_rows(np.random.RandomState(4))
    ref, _ = jm.module.apply(jm.params, jm.state, jnp.asarray(toks),
                             segment_ids=jnp.asarray(seg))
    with torch.no_grad():
        got = pm.module.apply(pm.params, torch.from_numpy(toks),
                              segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    back = to_jax_params(pm)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(
            np.asarray, jm.params))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jm.params)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_segment_ids_need_an_accepting_layer():
    m = Model.build(Sequential([Embedding(16, 8), Dense(16)]), (12,),
                    device="cpu")
    toks = torch.zeros(2, 12, dtype=torch.long)
    seg = torch.zeros(2, 12, dtype=torch.int32)
    with pytest.raises(ValueError, match="segment_ids"):
        m.module.apply(m.params, toks, segment_ids=seg)
    with pytest.raises(ValueError, match="segment_ids"):
        m.module(toks, segment_ids=seg)
    assert not Remat(Dense(4)).accepts_segment_ids
    with pytest.raises(ValueError, match="unknown remat policy"):
        Remat(Dense(4), policy="everything")
    with pytest.raises(ValueError, match="unknown remat policy"):
        zoo.transformer_lm(V, **LM_KW, remat="everything")
    with pytest.raises(ValueError, match="not a layer spec"):
        Remat(inner_spec={"class_name": "Dense"})


# --- packed training -----------------------------------------------------------

#: three SGD steps on a float32 2-layer model: each loss and weight
#: agrees up to summation order (plain flash vs XLA softmax)
STEP_LOSS_RTOL = 1e-4
STEP_WEIGHT_TOL = dict(rtol=1e-5, atol=1e-6)


def test_packed_train_steps_match_jax():
    """The hand-written step of JAX ``test_packed_sequences.py:181-189``
    on both sides (masked loss over ``module.apply(..., segment_ids=)``,
    then the optimizer), three steps under SGD from the same weights:
    losses within 1e-4 relative, weights after each step close."""
    jm, pm = _pair(seed=6, num_kv_heads=2)
    toks, seg, labels = _packed_rows(np.random.RandomState(6), b=4)
    jloss = jax_get_loss(MASKED_CE)
    jopt, popt = (jax_get_optimizer("sgd", learning_rate=0.5),
                  get_optimizer("sgd", learning_rate=0.5))

    @jax.jit
    def jstep(params, opt_state):
        def lf(p):
            out, _ = jm.module.apply(p, jm.state, jnp.asarray(toks),
                                     training=True,
                                     segment_ids=jnp.asarray(seg))
            return jloss(jnp.asarray(labels), out)
        loss, g = jax.value_and_grad(lf)(params)
        upd, opt_state = jopt.update(g, opt_state, params)
        return jax_apply_updates(params, upd), opt_state, loss

    jp, js = jm.params, jopt.init(jm.params)
    params = pm.params
    ps = popt.init(params)
    pm.module.train()
    for _ in range(3):
        jp, js, jl = jstep(jp, js)
        _, loss, grads = _port_loss_grads(pm, params, toks, seg, labels)
        with torch.no_grad():
            upd, ps = popt.update(tree_unflatten(params, grads), ps, params)
            apply_updates(params, upd)
        np.testing.assert_allclose(loss.item(), float(jl),
                                   rtol=STEP_LOSS_RTOL)
        for a, b in zip(jax.tree_util.tree_leaves(to_jax_params(pm)),
                        jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(a, np.asarray(b), **STEP_WEIGHT_TOL)


def test_packed_batch_trains_with_masked_loss():
    """JAX ``test_packed_sequences.py:158-197`` on the port: two
    sequences per row and a pad tail labelled -1, the masked loss, adam;
    the copy task's loss halves in 120 steps."""
    m = Model.build(zoo.transformer_lm(16, d_model=32, num_heads=4,
                                       num_layers=1, mlp_ratio=2),
                    (16,), seed=0, device="cpu")
    rs = np.random.RandomState(3)
    X = torch.from_numpy(rs.randint(1, 16, (32, 16)))
    seg = torch.zeros((32, 16), dtype=torch.int32)
    seg[:, 7:13] = 1
    seg[:, 13:] = -1
    Y = X.clone()
    Y[:, 13:] = -1
    loss_fn = get_loss(MASKED_CE)
    opt = get_optimizer("adam", learning_rate=5e-3)
    params = m.params
    state = opt.init(params)
    m.module.train()
    losses = []
    for _ in range(120):
        loss = loss_fn(Y, m.module.apply(params, X, segment_ids=seg))
        grads = torch.autograd.grad(loss, tree_leaves(params))
        with torch.no_grad():
            upd, state = opt.update(tree_unflatten(params, grads), state,
                                    params)
            apply_updates(params, upd)
        losses.append(loss.item())
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])



# --- decoding ------------------------------------------------------------------

def test_remat_lm_decodes_like_jax():
    """A remat-built LM through ``generate()`` and the paged engine is
    token-identical to JAX ``generate()`` on the same weights: the
    decode path unwraps ``Remat``."""
    jm, pm = _pair(seed=3, remat="nothing", num_kv_heads=2)
    jd._resolve_head_dims(jm.module, jm.params)
    prompts = np.random.RandomState(0).randint(0, V, (2, 9)).astype(np.int32)
    ref = jd.generate(jm, prompts, 7)
    np.testing.assert_array_equal(pm.generate(prompts, 7), ref)
    eng = ServingEngine(pm, num_slots=2, max_len=32, page_len=4,
                        prefill_chunk=4, device="cpu")
    rids = [eng.submit(p, 7) for p in prompts]
    out = eng.run(max_steps=300)
    for rid, r in zip(rids, ref):
        np.testing.assert_array_equal(out[rid], r)


def test_decode_refuses_attention_outside_a_block():
    """A bare ``MultiHeadAttention`` in the stack would decode each token
    against itself alone: the cache builders refuse it, as JAX's
    ``init_cache`` does."""
    m = Model.build(Sequential([Embedding(V, 16),
                                MultiHeadAttention(num_heads=2),
                                TransformerBlock(num_heads=2, mlp_ratio=2),
                                Dense(V)]), (8,), device="cpu")
    prompts = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="contains attention"):
        m.generate(prompts, 2)
    eng_err = None
    try:
        ServingEngine(m, num_slots=1, max_len=16, page_len=4, device="cpu")
    except ValueError as e:
        eng_err = e
    assert eng_err is not None and "contains attention" in str(eng_err)


# --- attn_impl ------------------------------------------------------------------

def test_xla_attention_equals_flash_on_the_cpu():
    """``attn_impl="xla"`` (plain softmax attention, K/V heads expanded)
    and ``"flash"`` (the flash kernels' plain versions) agree on logits
    and gradients under ids to float32 reassociation."""
    rs = np.random.RandomState(8)
    toks, seg, labels = _packed_rows(rs)
    runs = []
    for impl in ("xla", "flash"):
        m = Model.build(zoo.transformer_lm(V, **LM_KW, num_kv_heads=2,
                                           attn_impl=impl),
                        (S,), seed=1, device="cpu")
        runs.append(_port_loss_grads(m, m.params, toks, seg, labels))
    (xo, xl, xg), (fo, fl, fg) = runs
    torch.testing.assert_close(xo, fo, atol=1e-5, rtol=1e-5)
    for a, b in zip(xg, fg):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("kw", [dict(attn_impl="ring"),
                                dict(attn_impl="ulysses"),
                                dict(attn_impl="ulysses_flash"),
                                dict(seq_axis_name="sp")],
                         ids=["ring", "ulysses", "ulysses_flash",
                              "seq_axis_name"])
def test_sequence_parallel_attention_raises_naming_the_roadmap(kw):
    """Sequence parallelism is ported (the name is kept from when these
    options raised naming ROADMAP Queue 1 item 10): the options build
    and travel in the configs as JAX's do. Outside a mesh, a
    sequence-parallel implementation without ``seq_axis_name`` raises
    JAX's ``ValueError`` at the call, and ``seq_axis_name`` alone leaves
    the one-device path bitwise as it was
    (``tests/test_torch_seq_parallel.py`` holds the mesh runs)."""
    m = Model.build(zoo.transformer_lm(V, **LM_KW, **kw), (S,), seed=0,
                    device="cpu")
    block = m.module.layers[1].get_config()
    mha = MultiHeadAttention(num_heads=2, **kw).get_config()
    for key, val in kw.items():
        assert block[key] == val and mha[key] == val
    x = torch.from_numpy(np.random.RandomState(0).randint(0, V, (1, S)))
    if "attn_impl" in kw:
        with pytest.raises(ValueError, match="requires seq_axis_name"):
            m.apply(x)
    else:
        base = Model.build(zoo.transformer_lm(V, **LM_KW), (S,), seed=0,
                           device="cpu")
        assert torch.equal(m.apply(x), base.apply(x))


def test_unknown_attn_impl_and_untrainable_dropout():
    with pytest.raises(ValueError, match="unknown attn_impl"):
        zoo.transformer_lm(V, **LM_KW, attn_impl="cudnn")
    # ported: the ring's block size travels in the block's config
    from distkeras_tpu.models.attention import \
        TransformerBlock as JaxTransformerBlock
    blk = TransformerBlock(num_heads=2, ring_block_size=8)
    assert blk.get_config() == JaxTransformerBlock(
        num_heads=2, ring_block_size=8).get_config()
    m = Model.build(Sequential([Embedding(V, 16), TransformerBlock(
        num_heads=2, mlp_ratio=2, dropout_rate=0.1), Dense(V)]), (8,),
        device="cpu")
    x = torch.zeros(1, 8, dtype=torch.long)
    ref = m.apply(x)                  # inference: dropout is the identity
    m.module.train()
    # training without a key is the identity too (JAX's rule); with one
    # the block drops out both residual branches, the same mask for the
    # same key, wrapped in Remat or not
    with torch.no_grad():
        torch.testing.assert_close(m.module(x), ref, rtol=0, atol=0)
        a = m.module.apply(m.params, x, rng=prng.key(3))
        b = m.module.apply(m.params, x, rng=prng.key(3))
        c = m.module.apply(m.params, x, rng=prng.key(4))
    assert torch.equal(a, b) and not torch.equal(a, ref)
    assert not torch.equal(a, c)
    remat = Model.build(Sequential([Embedding(V, 16), Remat(TransformerBlock(
        num_heads=2, mlp_ratio=2, dropout_rate=0.1)), Dense(V)]), (8,),
        device="cpu")
    for p, q in zip(tree_leaves(m.params), tree_leaves(remat.params)):
        assert torch.equal(p, q)        # one seed, one key chain
    remat.module.train()
    xr = torch.randint(0, V, (2, 8), generator=torch.Generator()
                       .manual_seed(0))
    outs = [mm.module.apply(mm.params, xr, rng=prng.key(5))
            for mm in (m, remat)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    loss = outs[1].square().mean()
    grads = torch.autograd.grad(loss, tree_leaves(remat.params))
    assert all(torch.isfinite(g).all() for g in grads)
