"""The fused MoE dispatch: the token gather fused into the expert
up-projection (K6a, ``csrc/moe_gemm.cu``), its plain PyTorch version,
and the forward of the fused expert block around it.

Replaces ``distkeras_tpu/ops/moe_kernels.py`` ``_gather_gemm1`` (:188,
the ``pl.pallas_call`` at :214, body ``_fwd_kernel`` :178) and ports the
forward of ``_fused_fwd`` (:393): the plan inversion (:400-405), K6a,
the down-projection (the stacked einsum JAX also leaves outside the
kernel, :411) and the structured combine (:415-419).
``fused_moe_apply`` (:458) is the entry point ``models.moe.MoE`` calls.

For each expert ``e`` and capacity row ``r`` K6a computes
``h[e, r] = act(xt[src_tok[e*C + r]] @ w1[e] + b1[e])`` with a float32
accumulator, bias and activation, and writes ``[E, C, H]`` in the input
dtype; a row no slot won (``src_tok < 0``) gathers zeros, so its value
is ``act(b1[e])``. The ``[E*C, d]`` dispatch buffer of the ``tokens``
path never exists.

The wrapper launches K6a for tensors on the card and takes the plain
version (``gather_gemm1_reference``) for tensors on the CPU; neither
falls back to the other. The Mosaic tiling rules of the TPU kernel
(``kernel_capacity``'s %8 row pad, ``_pad_slots``, ``choose_block_c``,
``MAX_BLOCK_C``) are not carried over: the kernel takes every capacity.
The backward (K6b, K6c) is not ported yet: a gradient through the fused
block raises.
"""

from __future__ import annotations

import torch

from distkeras_tpu_torch import kernels
from distkeras_tpu_torch.models.layers import get_activation

#: output columns one block owns (32 threads x 8 columns)
BLOCK_N = 256
#: rows of w1 one block's warps stride over at a time
ROW_GROUPS = 8
#: blocks per SM the d split aims for
BLOCKS_PER_SM = 2
#: capacity rows one block holds per launch tile
ROW_TILES = (1, 2, 4, 8)
#: activation name -> the kernel's epilogue code
ACTIVATION_CODES = {"linear": 0, None: 0, "relu": 1, "gelu": 2, "silu": 3}

#: what a gradient through the fused block waits for
BACKWARD_ITEM = ("ROADMAP, Queue 1 item 2 (MoE training, with the "
                 "backward kernels K6b and K6c)")


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


# --- K6a and its plain version -----------------------------------------------


def gather_gemm1_reference(xt, src_tok, w1, b1, capacity: int,
                           activation="gelu") -> torch.Tensor:
    """The plain version of K6a: gather the token rows (zeros for -1),
    ``x @ w1[e]`` with float32 products and sums, the bias and the
    activation in float32, the result cast to ``xt``'s dtype."""
    e, d, hid = w1.shape
    tok = src_tok.long().reshape(e, capacity)
    xg = torch.where((tok >= 0)[..., None], xt[tok.clamp(min=0)].float(),
                     torch.zeros((), device=xt.device))
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
    if xt.device.type != "cuda":
        raise ValueError(f"gather_gemm1 runs on cuda or cpu tensors, got "
                         f"{xt.device}")
    return _launch(xt, src_tok, w1, b1, int(capacity), activation)


def split_plan(capacity: int, d: int, hid: int, num_experts: int,
               num_sms: int):
    """``(rt, ksplit, kchunk)``: the capacity rows per block tile, and how
    the d rows of ``w1[e]`` are cut across blocks. Enough d splits that
    the grid fills the card's ``num_sms`` SMs ``BLOCKS_PER_SM`` deep,
    none shorter than 32 rows; a chunk is a multiple of ``ROW_GROUPS``.
    A function of the shapes and the card alone, so the same inputs
    give the same bits."""
    rt = next((t for t in ROW_TILES if t >= capacity), ROW_TILES[-1])
    blocks = -(-hid // BLOCK_N) * -(-capacity // rt) * num_experts
    ksplit = max(1, min(-(-BLOCKS_PER_SM * num_sms // blocks), d // 32))
    kchunk = -(-d // ksplit)
    kchunk = -(-kchunk // ROW_GROUPS) * ROW_GROUPS
    return rt, -(-d // kchunk), kchunk


def _launch(xt, src_tok, w1, b1, capacity: int, activation):
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"the K6a kernel has no epilogue for activation "
                         f"{activation!r}; it takes "
                         f"{sorted(k for k in ACTIVATION_CODES if k)}")
    if xt.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"xt must be float32 or bfloat16, got {xt.dtype}")
    if w1.dtype != xt.dtype or b1.dtype != xt.dtype:
        raise TypeError(f"w1 and b1 must have xt's dtype {xt.dtype}, got "
                        f"{w1.dtype} and {b1.dtype}")
    if src_tok.dtype != torch.int32:
        raise TypeError(f"src_tok must be int32, got {src_tok.dtype}")
    e, d, hid = w1.shape
    if xt.ndim != 2 or xt.shape[1] != d or tuple(b1.shape) != (e, hid) \
            or tuple(src_tok.shape) != (e * capacity,):
        raise ValueError(
            f"shapes do not match: xt {tuple(xt.shape)}, w1 "
            f"{tuple(w1.shape)}, b1 {tuple(b1.shape)}, src_tok "
            f"{tuple(src_tok.shape)} with capacity {capacity}")
    devs = {xt.device, src_tok.device, w1.device, b1.device}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")
    xt, src_tok, w1, b1 = (t.contiguous() for t in (xt, src_tok, w1, b1))
    out = torch.empty((e, capacity, hid), dtype=xt.dtype, device=xt.device)
    if out.numel() == 0:
        return out
    rt, ksplit, kchunk = split_plan(capacity, d, hid, e,
                                     kernels.num_sms(xt.device.index))
    part = out if ksplit == 1 else torch.empty(
        (ksplit, e * capacity, hid), dtype=torch.float32, device=xt.device)
    name = "moe_gather_gemm1"
    lib = kernels.library(name)
    err = lib.dkt_moe_gather_gemm1(
        xt.data_ptr(), int(xt.dtype == torch.bfloat16), src_tok.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), out.data_ptr(), part.data_ptr(),
        xt.shape[0], d, hid, e, capacity, ACTIVATION_CODES[activation], rt,
        ksplit, kchunk, torch.cuda.current_stream(xt.device).cuda_stream)
    kernels.check(lib, err, name)
    kernels.count_launch(name)
    return out


# --- the fused expert block (forward) ----------------------------------------


def _fused_forward(xt, w1, b1, w2, b2, sg, dest, keep, capacity: int,
                   activation):
    e = w1.shape[0]
    n, d = xt.shape
    src_tok = src_tokens(dest, n, e, capacity)
    h = gather_gemm1(xt, src_tok, w1, b1, capacity, activation)
    # the down-projection: the stacked batched product, outside the kernel
    # as in the JAX package
    y = torch.einsum("ech,ehd->ecd", h, w2) + b2[:, None, :]
    return combine(y.reshape(e * capacity, d), dest, keep, sg, n)


def combine(ye_flat, dest, keep, sg, n_tokens: int) -> torch.Tensor:
    """The structured combine (JAX :415-419) of the ``[E*C, d]`` expert
    rows into ``[N, d]``, in their dtype: a gather at the plan's
    ``dest`` (a dropped slot's sentinel clamped into range), masked with
    ``keep`` BEFORE the gate multiply so a non-finite row cannot reach a
    dropped slot, then the choice-major reshape-sum."""
    ec, d = ye_flat.shape
    rows = ye_flat[dest.long().clamp(max=ec - 1)]
    safe = torch.where(keep[:, None], rows,
                       torch.zeros((), dtype=ye_flat.dtype,
                                   device=ye_flat.device))
    contrib = safe * sg[:, None].to(ye_flat.dtype)
    return contrib.reshape(-1, n_tokens, d).sum(dim=0)


class _FusedExperts(torch.autograd.Function):
    """The fused expert block as one autograd node: its forward is the
    ported one, its backward (K6b/K6c) is not ported yet and raises, so
    a gradient through the fused path fails loudly."""

    @staticmethod
    def forward(ctx, xt, w1, b1, w2, b2, sg, dest, keep, capacity,
                activation):
        return _fused_forward(xt, w1, b1, w2, b2, sg, dest, keep, capacity,
                              activation)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            f"the backward of the fused MoE block is not ported yet: "
            f"{BACKWARD_ITEM}")


def fused_moe_apply(xt, w1, b1, w2, b2, sg, dest, keep, *, capacity: int,
                    activation="gelu") -> torch.Tensor:
    """Dispatch + expert MLP + combine with the token gather fused into
    the up-projection (forward only). ``xt`` [N, d] tokens in the
    compute dtype, stacked expert weights ``w1`` [E, d, H] / ``b1`` [E,
    H] / ``w2`` [E, H, d] / ``b2`` [E, d] in the same dtype, and the
    ``models.moe._dispatch_plan`` arrays ``sg``/``dest``/``keep`` [K*N]
    (choice-major slot order). Returns the combined [N, d] output."""
    get_activation(activation)          # fail early on unknown names
    args = (xt, w1, b1, w2, b2, sg, dest, keep, int(capacity), activation)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xt, w1, b1, w2, b2, sg)):
        return _FusedExperts.apply(*args)
    return _fused_forward(*args)
