"""Mixture-of-experts MLP: the top-k router, the capacity dispatch plan,
three executions of one routing and the router's balance loss, for
serving and for training.

Mirrors ``distkeras_tpu/models/moe.py``: ``_dispatch_plan`` :69,
``MoE.__init__`` :108 with ``build`` as the counterpart of ``init`` :154
(the same leaves and shapes: ``gate [d, E]``, ``w1 [E, d, H]``, ``b1
[E, H]``, ``w2 [E, H, d]``, ``b2 [E, d]``), ``_route`` :173,
``_gate_probs`` :196, ``_balance_loss`` :207, ``_capacity`` :219,
``_expert_mlp`` :242,
``_apply_dispatched`` :291, ``decode_apply`` :407, ``apply`` :449 and
``get_config`` :500.

* ``dispatch="dense"``: every expert on every token, combined with the
  router's top-k weights (the numerics oracle).
* ``dispatch="tokens"``: the capacity-based plan with static shapes:
  one scatter builds the ``[E*C, d]`` dispatch buffer, the stacked
  expert MLP runs on it, a gather and a reshape-sum combine.
* ``dispatch="fused"``: the same plan with the token gather fused into
  the expert up-projection (``ops.moe_kernels``: the K6a kernel on the
  card, its plain version on the CPU; its backward K6b and K6c, or
  their plain versions). Unlike the JAX layer, which falls back to
  ``tokens`` off the TPU, the port always takes this path.

``apply`` trains through all three: in training mode (``module.train()``)
the dispatched paths use the layer's ``_capacity`` (``capacity_factor``;
slots past it are dropped), and a layer with ``aux_loss_weight``
publishes ``aux_loss_weight * _balance_loss`` through ``Layer.
publish_aux_loss``, which ``parallel.worker`` adds to the loss (JAX's
``AUX_LOSS_KEY`` state entry). ``decode_apply`` (the serving engine's
decode and verify steps, inference only) runs the fused path at the
drop-free capacity ``C = N``, whatever the layer's ``dispatch``.
``expert_unroll=True`` computes through the batched path: JAX's unroll
regroups the same per-expert products. Expert parallelism
(``expert_axis_name``, ``moe_all_to_all``) raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import torch

from distkeras_tpu_torch.models.core import (Layer, register_layer,
                                             torch_dtype)
from distkeras_tpu_torch.models.layers import get_activation, init_weights
from distkeras_tpu_torch.ops import prng

#: ROADMAP items the layer's unported options wait for
EXPERT_PARALLEL_ITEM = ("ROADMAP, Queue 1 item 10 (expert-parallel MoE: "
                        "expert_axis_name, ep_mesh, moe_all_to_all)")


def _dispatch_plan(experts, gates, num_experts: int, capacity: int):
    """Static-shape dispatch bookkeeping (JAX :69). ``experts``/``gates``
    ``[N, K]`` top-k expert ids and combine weights per token. Returns
    ``(dest, token, weight, keep)`` flat ``[K*N]`` slot arrays in
    choice-major slot order (slot ``s = k*N + n``: every first choice
    outranks every second choice, ties by token order). A slot's
    position in its expert is the count of earlier slots on that expert:
    one int32 inclusive scan over the expert-major one-hot ``[E, K*N]``
    read as one row (contiguous, so the card runs it as one parallel
    scan), less the slot itself and the slots of lower experts (the scan
    at the end of the previous expert's row). Integer work, so exact; a
    dropped slot gets the unique sentinel ``E*C + s``."""
    n, k = experts.shape
    dev = experts.device
    slot_e = experts.t().reshape(-1).long()
    slot_t = torch.arange(n, dtype=torch.int32, device=dev).repeat(k)
    slot_g = gates.t().reshape(-1)
    onehot = slot_e == torch.arange(num_experts, device=dev)[:, None]
    scan = torch.cumsum(onehot.reshape(-1), 0, dtype=torch.int32)
    scan = scan.reshape(num_experts, n * k)
    lower = torch.cat([scan.new_zeros(1), scan[:-1, -1]])
    pos = scan.gather(0, slot_e[None])[0] - 1 - lower[slot_e]
    keep = pos < capacity
    dest = torch.where(keep, slot_e * capacity + pos,
                       num_experts * capacity
                       + torch.arange(n * k, device=dev))
    return dest, slot_t, slot_g, keep


@register_layer
class MoE(Layer):
    """Top-k gated mixture of expert MLPs over ``[B, S, d_model]``."""

    def __init__(self, num_experts: int, hidden_dim: int, top_k: int = 2,
                 activation: str = "gelu", dtype: str = "float32",
                 expert_axis_name: Optional[str] = None,
                 kernel_init: str = "glorot_uniform",
                 aux_loss_weight: float = 0.0,
                 dispatch: str = "dense",
                 capacity_factor: float = 1.25,
                 expert_unroll: bool = False):
        super().__init__()
        if expert_axis_name is not None:
            raise NotImplementedError(
                f"MoE(expert_axis_name={expert_axis_name!r}) is not ported "
                f"yet: {EXPERT_PARALLEL_ITEM}")
        if dispatch not in ("dense", "tokens", "fused"):
            raise ValueError("dispatch must be 'dense', 'tokens' or 'fused', "
                             f"got {dispatch!r}")
        self.num_experts = int(num_experts)
        self.hidden_dim = int(hidden_dim)
        self.top_k = int(top_k)
        get_activation(activation)
        self.activation = activation
        self.dtype = dtype
        self.expert_axis_name = expert_axis_name
        self.kernel_init = kernel_init
        #: the Switch/GShard balance-loss coefficient: a training-mode
        #: forward publishes ``aux_loss_weight * _balance_loss``
        self.aux_loss_weight = float(aux_loss_weight)
        self.dispatch = dispatch
        self.capacity_factor = float(capacity_factor)
        self.expert_unroll = bool(expert_unroll)

    def build(self, input_shape, rng):
        d = input_shape[-1]
        e, hid = self.num_experts, self.hidden_dim
        kg, k1, k2 = prng.split(rng, 3)
        self.add_param("gate", init_weights(self.kernel_init, kg, (d, e)))
        # one key per expert, so each expert has the fans of a [d, H]
        # matrix and its own draw, as in JAX (:154-171)
        self.add_param("w1", torch.stack([
            init_weights(self.kernel_init, k, (d, hid))
            for k in prng.split(k1, e)]))
        self.add_param("b1", torch.zeros(e, hid, device=rng.device))
        self.add_param("w2", torch.stack([
            init_weights(self.kernel_init, k, (hid, d))
            for k in prng.split(k2, e)]))
        self.add_param("b2", torch.zeros(e, d, device=rng.device))
        return tuple(input_shape)

    def _route(self, x, gate):
        """``(full, topi, gates, mask)``: the full router softmax ``[B, S,
        E]``, the top-k expert ids and their renormalised weights ``[B,
        S, K]``, and the top-k slot mask ``[B, S, E]`` for the balance
        loss (``None`` at ``top_k == num_experts``). The router runs in
        float32. Top-k comes from a stable descending sort, so tied
        logits go to the lower expert id, as ``lax.top_k`` orders
        them."""
        logits = torch.einsum("bsd,de->bse", x.float(), gate.float())
        full = torch.softmax(logits, dim=-1)
        topv, topi = torch.sort(logits, dim=-1, descending=True, stable=True)
        topv, topi = topv[..., :self.top_k], topi[..., :self.top_k]
        mask = None
        if self.top_k < self.num_experts:
            mask = torch.nn.functional.one_hot(
                topi, self.num_experts).amax(dim=-2).bool()
        return full, topi, torch.softmax(topv, dim=-1), mask

    def _gate_probs(self, x, gate):
        """``(probs, full, mask)``: the routing weights ``[B, S, E]`` (the
        top-k weights at their experts, 0 elsewhere: the dense path's
        view of ``_route``) with the full softmax and the slot mask."""
        full, topi, gates, mask = self._route(x, gate)
        onehot = torch.nn.functional.one_hot(topi, self.num_experts)
        probs = torch.einsum("bske,bsk->bse", onehot.to(gates.dtype), gates)
        return probs, full, mask

    def _balance_loss(self, full, mask):
        """``E * sum_e f_e * P_e`` (Switch eq. 4, GShard; JAX :207): ``f_e``
        the fraction of routing slots expert ``e`` won (the mask's mean
        over tokens over ``top_k``), ``P_e`` its mean router
        probability. 1 at uniform routing. Under a placement that shards
        the batch (``parallel.sharding``) both are the global batch's."""
        from distkeras_tpu_torch.parallel.sharding import data_mean
        e = self.num_experts
        if mask is None:            # top_k == E: every slot hits every expert
            frac = torch.full((e,), 1.0 / e, device=full.device)
        else:
            frac = data_mean(mask.float().mean(dim=(0, 1))) / self.top_k
        return e * torch.sum(frac * data_mean(full.mean(dim=(0, 1))))

    def _publish_balance_loss(self, full, mask):
        """Publish the weighted balance loss in training mode; clear the
        layer's term otherwise, so an eval forward publishes nothing."""
        self.publish_aux_loss(
            self.aux_loss_weight * self._balance_loss(full, mask)
            if self.training and self.aux_loss_weight else None)

    def _capacity(self, n_tokens: int) -> int:
        per = -(-self.top_k * n_tokens // self.num_experts)
        return max(1, int(per * self.capacity_factor))

    def _weights(self, p, dt):
        return tuple(p[k].to(dt) for k in ("w1", "b1", "w2", "b2"))

    def _expert_mlp(self, xe, p):
        """The stacked expert MLP on ``[E, C, d]`` in the compute dtype
        (``expert_unroll`` computes the same products batched)."""
        dt = torch_dtype(self.dtype)
        w1, b1, w2, b2 = self._weights(p, dt)
        act = get_activation(self.activation)
        h = act(torch.einsum("ecd,edf->ecf", xe, w1) + b1[:, None, :])
        return torch.einsum("ecf,efd->ecd", h, w2) + b2[:, None, :]

    def _apply_dispatched(self, p, x, *, fused=False, capacity=None,
                          return_routing=False):
        """The capacity dispatch (JAX :291): the plan from ``_route``,
        then the ``tokens`` execution (scatter, stacked MLP, gather
        combine) or, with ``fused``, ``ops.moe_kernels.fused_moe_apply``.
        ``capacity`` overrides ``_capacity`` (the decode path passes the
        token count). Returns ``(out, full, mask)``; ``return_routing``
        returns ``(out, (topi, full))``."""
        dt = torch_dtype(self.dtype)
        b, s, d = x.shape
        n = b * s
        e, k = self.num_experts, self.top_k
        c = self._capacity(n) if capacity is None else int(capacity)
        full, topi, gates, mask = self._route(x, p["gate"])
        dest, _, sg, keep = _dispatch_plan(topi.reshape(n, k),
                                           gates.reshape(n, k), e, c)
        xt = x.reshape(n, d).to(dt)
        from distkeras_tpu_torch.ops.moe_kernels import (combine,
                                                         fused_moe_apply)
        if fused:
            out = fused_moe_apply(xt, *self._weights(p, dt), sg, dest, keep,
                                  capacity=c, activation=self.activation)
        else:
            # the buffer build: one scatter into E*C rows plus the dropped
            # slots' unique sentinel rows, which are then cut off
            src = xt.repeat(k, 1)
            xe = torch.zeros((e * c + k * n, d), dtype=dt, device=x.device)
            xe.index_copy_(0, dest, src)
            ye = self._expert_mlp(xe[:e * c].reshape(e, c, d), p)
            out = combine(ye.reshape(e * c, d), dest, keep, sg, n)
        out = out.reshape(b, s, d)
        if return_routing:
            return out, (topi, full)
        return out, full, mask

    def decode_apply(self, p, x, *, return_routing=False):
        """The serving engine's decode and verify MoE (JAX :407): ``x``
        is the ``[S, W, d]`` slot-token batch of one step. Capacity is
        the token count ``S * W``: a token's top-k experts are distinct,
        so no expert receives more, the dispatch never drops and the
        output equals dense routing whatever shares the batch. Runs the
        fused path (K6a on the card) whatever the layer's ``dispatch``.
        With ``return_routing`` also returns ``(topi [S, W, K], full
        [S, W, E])`` for the expert-load telemetry."""
        b, s, _ = x.shape
        out, routing = self._apply_dispatched(p, x, fused=True,
                                              capacity=b * s,
                                              return_routing=True)
        out = out.to(x.dtype)
        return (out, routing) if return_routing else out

    def apply(self, p, x):
        """The layer in its configured dispatch (JAX :449). In training
        mode a layer with ``aux_loss_weight`` publishes its weighted
        balance loss; an eval-mode forward publishes nothing."""
        if self.dispatch != "dense":
            out, full, mask = self._apply_dispatched(
                p, x, fused=self.dispatch == "fused")
            self._publish_balance_loss(full, mask)
            return out.to(x.dtype)
        dt = torch_dtype(self.dtype)
        probs, full, mask = self._gate_probs(x, p["gate"])
        w1, b1, w2, b2 = self._weights(p, dt)
        act = get_activation(self.activation)
        h = act(torch.einsum("bsd,edf->besf", x.to(dt), w1)
                + b1[None, :, None, :])
        y = torch.einsum("besf,efd->besd", h, w2) + b2[None, :, None, :]
        out = torch.einsum("bse,besd->bsd", probs.to(dt), y)
        self._publish_balance_loss(full, mask)
        return out.to(x.dtype)

    def get_config(self):
        return {"num_experts": self.num_experts,
                "hidden_dim": self.hidden_dim, "top_k": self.top_k,
                "activation": self.activation, "dtype": self.dtype,
                "expert_axis_name": self.expert_axis_name,
                "kernel_init": self.kernel_init,
                "aux_loss_weight": self.aux_loss_weight,
                "dispatch": self.dispatch,
                "capacity_factor": self.capacity_factor,
                "expert_unroll": self.expert_unroll}


def moe_all_to_all(moe: MoE, params, x, *, axis_name: str):
    """Token-sharded expert parallelism (JAX :549): waits for the
    expert-parallel item."""
    raise NotImplementedError(
        f"moe_all_to_all is not ported yet: {EXPERT_PARALLEL_ITEM}")
