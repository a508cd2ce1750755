"""The fused MoE dispatch: the token gather fused into the expert
up-projection (K6a, ``csrc/moe_gemm.cu``), the fused block's backward
(K6b and K6c, ``csrc/moe_bwd.cu``), their plain PyTorch versions, and
the fused expert block around them as one autograd node.

Replaces ``distkeras_tpu/ops/moe_kernels.py`` ``_gather_gemm1`` (:188,
the ``pl.pallas_call`` at :214, body ``_fwd_kernel`` :178), ``_bwd_dx``
(:256, the call at :297, body ``_bwd_dx_kernel`` :225) and ``_bwd_dw1``
(:327, the call at :353, body ``_bwd_dw1_kernel`` :310), and ports the
custom VJP around them: the forward ``_fused_fwd`` (:393: the plan
inversion :400-405, K6a, the down-projection, the stacked einsum JAX
also leaves outside the kernel :411, and the structured combine
:415-419) and the backward ``_fused_bwd`` (:423-452).
``fused_moe_apply`` (:458) is the entry point ``models.moe.MoE`` calls.

For each expert ``e`` and capacity row ``r`` K6a computes
``h[e, r] = act(xt[src_tok[e*C + r]] @ w1[e] + b1[e])`` with a float32
accumulator, bias and activation, and writes ``[E, C, H]`` in the input
dtype; a row no slot won (``src_tok < 0``) gathers zeros, so its value
is ``act(b1[e])``. The ``[E*C, d]`` dispatch buffer of the ``tokens``
path never exists. bf16 inputs run on the tensor cores (``wgmma``: the
gathered rows by ``cp.async``, ``w1[e]`` by TMA, 64 capacity rows a
warpgroup, one or two warpgroups a block); float32 inputs on the CUDA
cores (``split_plan``), since TF32 would break the float32 checks.
``gemm1_plan`` makes the choice from the dtype, the shapes and the SM
count alone, so the same inputs give the same bits. The backward's
transposes are gathers too: K6b gathers each capacity row's output
cotangent ``g`` and token ``x`` by the same ``src_tok`` and emits ``dxr
= dz @ w1[e]^T``, ``dz = act'(z) * (gy @ w2[e]^T)`` (``z`` recomputed),
``gy = g * row_gate`` and the router's per-row ``<y, g>``; K6c sums
``x[src_tok]^T @ dz`` over the capacity rows into ``dw1`` in float32.
``dw2`` (``_dw2``) is a library product outside any kernel, as in JAX.

Each wrapper launches its kernel for tensors on the card and takes the
plain version (``gather_gemm1_reference``, ``bwd_dx_reference``,
``bwd_dw1_reference``) for tensors on the CPU; neither falls back to
the other. The Mosaic tiling rules of the TPU kernels
(``kernel_capacity``'s %8 row pad, ``_pad_slots``, ``choose_block_c``,
``MAX_BLOCK_C``) are not carried over: the kernels take every capacity.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from distkeras_tpu_torch import kernels
from distkeras_tpu_torch.models.layers import get_activation

#: output columns one block of the CUDA-core kernel owns (32 threads x 8
#: columns)
BLOCK_N = 256
#: capacity rows one warpgroup of the tensor-core kernel owns: a block
#: runs one warpgroup at capacities up to this, else two (128-row tiles)
TC_WG_ROWS = 64
#: rows of w1 one block's warps stride over at a time
ROW_GROUPS = 8
#: blocks per SM the d split aims for
BLOCKS_PER_SM = 2
#: capacity rows one block holds per launch tile
ROW_TILES = (1, 2, 4, 8)
#: activation name -> the kernels' epilogue code
ACTIVATION_CODES = {"linear": 0, None: 0, "relu": 1, "gelu": 2, "silu": 3}
#: d columns per row of K6b's row-dot partials: 64, the narrowest d tile
#: of ``csrc/moe_bwd.cu`` (the bf16 kernels' 128-wide tiles fill fewer
#: rows; the launcher counts its own)
BWD_TILE = 64


# --- the dispatch plan, inverted ---------------------------------------------


def _slot_tokens(kn: int, n_tokens: int, device) -> torch.Tensor:
    """Choice-major slot -> token map: ``tile(arange(N), K)`` (slot ``s =
    k*N + n``)."""
    return torch.arange(n_tokens, dtype=torch.int32,
                        device=device).repeat(kn // n_tokens)


def src_tokens(dest, n_tokens: int, num_experts: int,
               capacity: int) -> torch.Tensor:
    """``src_tok [E*C]`` int32: the token row that won each expert slot,
    or -1. One scatter of the plan's ``dest`` [K*N] into a buffer that
    also holds the dropped slots' sentinels (``E*C + slot``, unique and
    in range), then the first ``E*C`` rows: fixed shapes, no host
    sync."""
    kn = dest.shape[0]
    ec = num_experts * capacity
    buf = torch.full((ec + kn,), -1, dtype=torch.int32, device=dest.device)
    buf.scatter_(0, dest.long(), _slot_tokens(kn, n_tokens, dest.device))
    return buf[:ec]


def row_gates(dest, keep, sg, num_experts: int,
              capacity: int) -> torch.Tensor:
    """``row_gate [E*C]`` float32: each expert slot's gate, or 0 (a
    dropped slot's gate masked first). What the backward (K6b) reads."""
    kn = dest.shape[0]
    ec = num_experts * capacity
    sgk = torch.where(keep, sg.float(), torch.zeros((), device=sg.device))
    buf = torch.zeros((ec + kn,), dtype=torch.float32, device=dest.device)
    buf.scatter_(0, dest.long(), sgk)
    return buf[:ec]


# --- what the kernels take ---------------------------------------------------


def _gather_rows(a, tok):
    """``a[tok]`` as float32 for ``tok [E, C]`` row ids, zeros where
    ``tok < 0``."""
    return torch.where((tok >= 0)[..., None], a[tok.clamp(min=0)].float(),
                       torch.zeros((), device=a.device))


def _require_cuda(what, xt):
    if xt.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, got "
                         f"{xt.device}")


def _activation_code(kernel, activation) -> int:
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"the {kernel} kernel has no epilogue for "
                         f"activation {activation!r}; it takes "
                         f"{sorted(k for k in ACTIVATION_CODES if k)}")
    return ACTIVATION_CODES[activation]


def _check(kernel, xt, src_tok, rows: int, same: dict, f32: dict):
    """What a kernel takes: ``xt [N, d]`` float32 or bfloat16, the
    ``same`` operands ``{name: (tensor, shape)}`` in its dtype, the
    ``f32`` ones in float32, ``src_tok [rows]`` int32, all on one
    device."""
    if xt.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{kernel}: xt must be float32 or bfloat16, got "
                        f"{xt.dtype}")
    if src_tok.dtype != torch.int32:
        raise TypeError(f"{kernel}: src_tok must be int32, got "
                        f"{src_tok.dtype}")
    for group, want in ((same, xt.dtype), (f32, torch.float32)):
        for name, (t, _) in group.items():
            if t.dtype != want:
                raise TypeError(f"{kernel}: {name} must be {want}, got "
                                f"{t.dtype}")
    shapes = {name: (tuple(t.shape), tuple(shape))
              for name, (t, shape) in {**same, **f32}.items()}
    if xt.ndim != 2 or tuple(src_tok.shape) != (rows,) or any(
            got != want for got, want in shapes.values()):
        raise ValueError(f"{kernel}: shapes do not match: xt "
                         f"{tuple(xt.shape)}, src_tok "
                         f"{tuple(src_tok.shape)} (want ({rows},)), "
                         f"{ {k: v[0] for k, v in shapes.items()} } (want "
                         f"{ {k: v[1] for k, v in shapes.items()} })")
    devs = {xt.device, src_tok.device} | {
        t.device for t, _ in {**same, **f32}.values()}
    if len(devs) != 1:
        raise ValueError(f"{kernel}: all operands must be on one device, "
                         f"got {devs}")


# --- K6a and its plain version -----------------------------------------------


def gather_gemm1_reference(xt, src_tok, w1, b1, capacity: int,
                           activation="gelu") -> torch.Tensor:
    """The plain version of K6a: gather the token rows (zeros for -1),
    ``x @ w1[e]`` with float32 products and sums, the bias and the
    activation in float32, the result cast to ``xt``'s dtype."""
    xg = _gather_rows(xt, src_tok.long().reshape(w1.shape[0], capacity))
    z = torch.bmm(xg, w1.float()) + b1.float()[:, None, :]
    return get_activation(activation)(z).to(xt.dtype)


def gather_gemm1(xt, src_tok, w1, b1, capacity: int,
                 activation="gelu") -> torch.Tensor:
    """``[N, d]`` tokens + ``src_tok [E*C]`` -> ``[E, C, H]`` activated
    hidden rows: K6a for tensors on the card, the plain version for
    tensors on the CPU."""
    if xt.device.type == "cpu":
        return gather_gemm1_reference(xt, src_tok, w1, b1, capacity,
                                      activation)
    _require_cuda("gather_gemm1", xt)
    return _launch(xt, src_tok, w1, b1, int(capacity), activation)


def split_plan(capacity: int, d: int, hid: int, num_experts: int,
               num_sms: int):
    """``(rt, ksplit, kchunk)`` of the CUDA-core kernel (float32
    inputs): the capacity rows per block tile, and how the d rows of
    ``w1[e]`` are cut across blocks. Enough d splits that the grid fills
    the card's ``num_sms`` SMs ``BLOCKS_PER_SM`` deep, none shorter than
    32 rows; a chunk is a multiple of ``ROW_GROUPS``. A function of the
    shapes and the card alone, so the same inputs give the same bits."""
    rt = next((t for t in ROW_TILES if t >= capacity), ROW_TILES[-1])
    blocks = -(-hid // BLOCK_N) * -(-capacity // rt) * num_experts
    ksplit = max(1, min(-(-BLOCKS_PER_SM * num_sms // blocks), d // 32))
    kchunk = -(-d // ksplit)
    kchunk = -(-kchunk // ROW_GROUPS) * ROW_GROUPS
    return rt, -(-d // kchunk), kchunk


def gemm1_plan(capacity: int, d: int, hid: int, num_experts: int,
               num_sms: int, bf16: bool):
    """``(wg, rt, ksplit, kchunk)``, the launch K6a makes: bf16 inputs
    take the tensor-core kernel with ``wg`` warpgroups a block (one up
    to ``TC_WG_ROWS`` capacity rows, where the grid has as many blocks
    either way and a 128-row tile would multiply twice the zero rows;
    two above; the last three fields unused), float32 inputs the
    CUDA-core kernel (``wg`` 0 and ``split_plan``). A function of the
    shapes and the card alone, so the same inputs give the same bits."""
    if bf16:
        return (1 if capacity <= TC_WG_ROWS else 2), 1, 1, d
    return (0,) + split_plan(capacity, d, hid, num_experts, num_sms)


def _launch(xt, src_tok, w1, b1, capacity: int, activation):
    code = _activation_code("K6a", activation)
    e, d, hid = w1.shape
    _check("K6a", xt, src_tok, e * capacity,
           {"xt": (xt, (xt.shape[0], d)), "w1": (w1, (e, d, hid)),
            "b1": (b1, (e, hid))}, {})
    xt, src_tok, w1, b1 = (t.contiguous() for t in (xt, src_tok, w1, b1))
    out = torch.empty((e, capacity, hid), dtype=xt.dtype, device=xt.device)
    if out.numel() == 0:
        return out
    wg, rt, ksplit, kchunk = gemm1_plan(capacity, d, hid, e,
                                        kernels.num_sms(xt.device.index),
                                        xt.dtype == torch.bfloat16)
    part = out if wg or ksplit == 1 else torch.empty(
        (ksplit, e * capacity, hid), dtype=torch.float32, device=xt.device)
    name = "moe_gather_gemm1"
    lib = kernels.library(name)
    err = lib.dkt_moe_gather_gemm1(
        xt.data_ptr(), int(xt.dtype == torch.bfloat16), src_tok.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), out.data_ptr(), part.data_ptr(),
        xt.shape[0], d, hid, e, capacity, code, wg, rt,
        ksplit, kchunk, torch.cuda.current_stream(xt.device).cuda_stream)
    kernels.check(lib, err, name)
    kernels.count_launch(name)
    return out


# --- K6b, K6c and their plain versions --------------------------------------


def _activation_jvp(activation, z, dz):
    """``act'(z) * dz``: the derivative of the port's activation (what
    ``jax.jvp(get_activation(name))`` gives), through ``torch.func``."""
    return torch.func.jvp(get_activation(activation), (z,), (dz,))[1]


def bwd_dx_reference(xt, g, src_tok, row_gate, w1, b1, w2, b2, h,
                     capacity: int, activation="gelu"):
    """The plain version of K6b, per expert ``e`` and capacity row: the
    output cotangent and token rows gathered by ``src_tok`` (zeros for
    -1), ``gy = g * row_gate``, ``rowdot = <h @ w2[e] + b2[e], g>``, ``dz
    = act'(x @ w1[e] + b1[e]) * (gy @ w2[e]^T)`` and ``dxr = dz @
    w1[e]^T``, all float32 products and sums; ``(dxr [E, C, d], dz [E,
    C, H], gy [E, C, d])`` cast to ``xt``'s dtype and ``rowdot [E, C,
    1]`` float32, as JAX ``_bwd_dx_kernel`` rounds them (``dxr`` from
    the float32 ``dz``)."""
    e = w1.shape[0]
    tok = src_tok.long().reshape(e, capacity)
    xg, gg = _gather_rows(xt, tok), _gather_rows(g, tok)
    gy = gg * row_gate.float().reshape(e, capacity, 1)
    y = torch.bmm(h.float(), w2.float()) + b2.float()[:, None, :]
    rowdot = (y * gg).sum(dim=-1, keepdim=True)
    dh = torch.bmm(gy, w2.float().transpose(1, 2))
    z = torch.bmm(xg, w1.float()) + b1.float()[:, None, :]
    dz = _activation_jvp(activation, z, dh)
    dxr = torch.bmm(dz, w1.float().transpose(1, 2))
    dt = xt.dtype
    return dxr.to(dt), dz.to(dt), gy.to(dt), rowdot


def bwd_dw1_reference(xt, dz, src_tok, capacity: int) -> torch.Tensor:
    """The plain version of K6c: ``dw1[e] = x[src_tok]^T @ dz[e]`` over
    every capacity row of the expert (zeros for -1), float32 ``[E, d,
    H]``."""
    e = dz.shape[0]
    xg = _gather_rows(xt, src_tok.long().reshape(e, capacity))
    return torch.bmm(xg.transpose(1, 2), dz.float())


def bwd_dx(xt, g, src_tok, row_gate, w1, b1, w2, b2, h, capacity: int,
           activation="gelu"):
    """``(dxr, dz, gy, rowdot)`` of the fused block's backward: K6b for
    tensors on the card, the plain version for tensors on the CPU. In
    bf16, K6b runs on the tensor cores and takes ``dxr`` from the bf16
    ``dz`` it writes, and applies the row gate after ``g @ w2[e]^T``;
    the plain version takes ``dxr`` from the float32 ``dz`` (one bf16
    rounding of ``dz`` apart, within phase 22's 2e-2)."""
    if xt.device.type == "cpu":
        return bwd_dx_reference(xt, g, src_tok, row_gate, w1, b1, w2, b2,
                                h, capacity, activation)
    _require_cuda("bwd_dx", xt)
    code = _activation_code("K6b", activation)
    e, d, hid = w1.shape
    c = int(capacity)
    _check("K6b", xt, src_tok, e * c,
           {"xt": (xt, (xt.shape[0], d)), "g": (g, (xt.shape[0], d)),
            "w1": (w1, (e, d, hid)), "b1": (b1, (e, hid)),
            "w2": (w2, (e, hid, d)), "b2": (b2, (e, d)),
            "h": (h, (e, c, hid))},
           {"row_gate": (row_gate, (e * c,))})
    xt, g, src_tok, row_gate, w1, b1, w2, b2, h = (
        t.contiguous() for t in (xt, g, src_tok, row_gate, w1, b1, w2, b2,
                                 h))
    dev, dt = xt.device, xt.dtype
    dxr = torch.empty((e, c, d), dtype=dt, device=dev)
    dz = torch.empty((e, c, hid), dtype=dt, device=dev)
    gy = torch.empty((e, c, d), dtype=dt, device=dev)
    rowdot = torch.empty((e, c, 1), dtype=torch.float32, device=dev)
    # the per-column-tile partial row dots
    part = torch.empty((-(-d // BWD_TILE), e * c), dtype=torch.float32,
                       device=dev)
    name = "moe_bwd_dx"
    lib = kernels.library(name)
    err = lib.dkt_moe_bwd_dx(
        xt.data_ptr(), g.data_ptr(), src_tok.data_ptr(), row_gate.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        h.data_ptr(), dxr.data_ptr(), dz.data_ptr(), gy.data_ptr(),
        rowdot.data_ptr(), part.data_ptr(),
        int(dt == torch.bfloat16), xt.shape[0], d, hid, e, c, code,
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(lib, err, name)
    kernels.count_launch(name)
    return dxr, dz, gy, rowdot


def bwd_dw1(xt, dz, src_tok, capacity: int) -> torch.Tensor:
    """``dw1 [E, d, H]`` float32 of the fused block's backward: K6c for
    tensors on the card, the plain version for tensors on the CPU."""
    if xt.device.type == "cpu":
        return bwd_dw1_reference(xt, dz, src_tok, capacity)
    _require_cuda("bwd_dw1", xt)
    c = int(capacity)
    e, _, hid = dz.shape
    d = xt.shape[-1]
    _check("K6c", xt, src_tok, e * c, {"dz": (dz, (e, c, hid))}, {})
    xt, dz, src_tok = (t.contiguous() for t in (xt, dz, src_tok))
    dw1 = torch.empty((e, d, hid), dtype=torch.float32, device=xt.device)
    name = "moe_bwd_dw1"
    lib = kernels.library(name)
    err = lib.dkt_moe_bwd_dw1(
        xt.data_ptr(), dz.data_ptr(), src_tok.data_ptr(), dw1.data_ptr(),
        int(xt.dtype == torch.bfloat16), xt.shape[0], d, hid, e, c,
        torch.cuda.current_stream(xt.device).cuda_stream)
    kernels.check(lib, err, name)
    kernels.count_launch(name)
    return dw1


# --- the fused expert block --------------------------------------------------


def _fused_forward(xt, w1, b1, w2, b2, sg, dest, keep, capacity: int,
                   activation):
    """The forward (JAX :393): ``(out, src_tok, h)``."""
    e = w1.shape[0]
    n, d = xt.shape
    src_tok = src_tokens(dest, n, e, capacity)
    h = gather_gemm1(xt, src_tok, w1, b1, capacity, activation)
    # the down-projection: the stacked batched product, outside the kernel
    # as in the JAX package
    y = torch.einsum("ech,ehd->ecd", h, w2) + b2[:, None, :]
    return combine(y.reshape(e * capacity, d), dest, keep, sg, n), src_tok, h


def combine(ye_flat, dest, keep, sg, n_tokens: int) -> torch.Tensor:
    """The structured combine (JAX :415-419) of the ``[E*C, d]`` expert
    rows into ``[N, d]``, in their dtype: a gather at the plan's
    ``dest`` (a dropped slot's sentinel clamped into range), masked with
    ``keep`` BEFORE the gate multiply so a non-finite row cannot reach a
    dropped slot, then the choice-major reshape-sum."""
    contrib = _slot_rows(ye_flat, dest, keep) * sg[:, None].to(ye_flat.dtype)
    return contrib.reshape(-1, n_tokens, ye_flat.shape[1]).sum(dim=0)


def _slot_rows(rows, dest, keep):
    """``rows[dest]`` per slot, exact zeros where the slot was dropped
    (its sentinel clamped into range for the gather)."""
    got = rows[dest.long().clamp(max=rows.shape[0] - 1)]
    mask = keep.reshape(keep.shape + (1,) * (got.ndim - 1))
    return torch.where(mask, got, torch.zeros((), dtype=rows.dtype,
                                              device=rows.device))


def _dw2(h, gy) -> torch.Tensor:
    """``dw2 [E, H, d] = h[e]^T @ gy[e]`` in float32, outside any kernel
    as in JAX (:446-447). bf16 operands on the card multiply on the
    tensor cores with float32 accumulation (the products of two bf16
    values are exact in float32, so only the order of the sum differs
    from the float32 product); anything else is the float32 einsum."""
    if h.is_cuda and h.dtype == torch.bfloat16:
        return torch.bmm(h.transpose(1, 2), gy, out_dtype=torch.float32)
    return torch.einsum("ech,ecd->ehd", h.float(), gy.float())


class _FusedExperts(torch.autograd.Function):
    """The fused expert block as one autograd node (JAX's custom VJP):
    the forward saves what JAX's residual tuple holds (:420), the
    backward is ``_fused_bwd`` (:423-452): K6b, the slot cotangents as
    gathers masked by ``keep``, K6c, and ``dw2`` (``_dw2``), ``db2`` and
    ``db1`` as stacked contractions outside any kernel, summed in
    float32."""

    @staticmethod
    def forward(ctx, xt, w1, b1, w2, b2, sg, dest, keep, capacity,
                activation):
        out, src_tok, h = _fused_forward(xt, w1, b1, w2, b2, sg, dest, keep,
                                         capacity, activation)
        row_gate = row_gates(dest, keep, sg, w1.shape[0], capacity)
        ctx.save_for_backward(xt, w1, b1, w2, b2, sg, dest, keep, src_tok,
                              row_gate, h)
        ctx.capacity, ctx.activation = capacity, activation
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (xt, w1, b1, w2, b2, sg, dest, keep, src_tok, row_gate,
         h) = ctx.saved_tensors
        c, act = ctx.capacity, ctx.activation
        n, d = xt.shape
        dxr, dz, gy, rowdot = bwd_dx(xt, grad.to(xt.dtype), src_tok,
                                     row_gate, w1, b1, w2, b2, h, c, act)
        # slot cotangents: both transposes are gathers of the per-row
        # kernel outputs, masked by keep as in the forward
        dx = _slot_rows(dxr.reshape(-1, d), dest, keep).reshape(
            -1, n, d).sum(dim=0)
        dsg = _slot_rows(rowdot.reshape(-1), dest, keep)
        dw1 = bwd_dw1(xt, dz, src_tok, c)
        db1 = dz.float().sum(dim=1)
        dw2 = _dw2(h, gy)
        db2 = gy.float().sum(dim=1)
        return (dx.to(xt.dtype), dw1.to(w1.dtype), db1.to(b1.dtype),
                dw2.to(w2.dtype), db2.to(b2.dtype), dsg.to(sg.dtype), None,
                None, None, None)


def fused_moe_apply(xt, w1, b1, w2, b2, sg, dest, keep, *, capacity: int,
                    activation="gelu") -> torch.Tensor:
    """Dispatch + expert MLP + combine with the token gather fused into
    the up-projection, differentiable in ``xt``, the weights and ``sg``.
    ``xt`` [N, d] tokens in the compute dtype, stacked expert weights
    ``w1`` [E, d, H] / ``b1`` [E, H] / ``w2`` [E, H, d] / ``b2`` [E, d]
    in the same dtype, and the ``models.moe._dispatch_plan`` arrays
    ``sg``/``dest``/``keep`` [K*N] (choice-major slot order). Returns
    the combined [N, d] output."""
    get_activation(activation)          # fail early on unknown names
    args = (xt, w1, b1, w2, b2, sg, dest, keep, int(capacity), activation)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xt, w1, b1, w2, b2, sg)):
        return _FusedExperts.apply(*args)
    return _fused_forward(*args)[0]
