"""Slot-based continuous-batching engine over the port's paged (or
slab) decode path.

Mirrors the synchronous paged loop of
``distkeras_tpu/serving/engine.py``: requests queue with a priority
(``PriorityScheduler``); a request admits when a slot and the pages of
its context fit the free-page budget, after matching its prompt
against the prefix cache (``_admit`` :1823, ``_page_plan`` :1853,
``_match_prefix`` :1917, ``_apply_page_plan`` :1964); its prompt
prefills into a batch-1 staging cache one chunk per iteration
(``_advance_prefill`` :2577, ``_prefill_fn`` :1778, first token as
``_sample_first_fn`` :1806) and the filled pages are inserted into the
pool; every iteration then runs ONE decode step over all slots
(``_advance_decode`` :2737, ``_decode_fn`` :1297: an argmax-only
variant for all-greedy batches, the per-slot sampler otherwise), or
with a draft source one speculative verify over all slots (below),
growing pages first (``_ensure_decode_pages`` :2107) and preempting the
youngest lowest-priority stream when the pool runs dry
(``_preempt_victim`` :1997, ``_preempt`` :2027); a preempted stream
re-prefills its context on re-admission and continues
token-identically. ``_finish`` :3027 returns a slot's pages.

Speculative decoding (``draft=NgramDraft()`` or ``DraftModel(model)``):
a speculating stream's draft proposes ``spec_k`` tokens (``_spec_step``
:2814) and one verify window of ``spec_k + 1`` positions scores them
(the paged kernel's window-causal rows); with ``spec_tree=True`` the
draft proposes a token tree of up to ``1 + spec_k * spec_width`` nodes
(``_spec_tree_step`` :2914), verified through the kernel's ancestor-mask
variant, walked (``tree_walk``) and its accepted path committed
(``commit_tree_path``). Pages are grown first for every position a slot
may consume (``_ensure_decode_pages(lookahead)`` :2107). A per-request
acceptance EMA turns speculation off for a stream the draft cannot
predict (``_observe_acceptance`` :1706, ``spec_disable_below`` after
``spec_warmup`` verifies), ``spec_reprobe`` lets it back in on a crc32
coin (``_maybe_reprobe`` :1678), and ``_adapt_tree`` :1741 resizes each
stream's tree. Greedy speculative streams equal plain decode's; a
sampled stream splits its key once per emitted token, so it equals the
plain sampled stream.

Greedy outputs are token-identical per request to the JAX package's
``generate()`` on the same weights (the CPU tests hold the port to
it), also with an int8 or int4 KV cache at the same cache dtype, and
with ``weight_quant`` to the JAX engine's. Sampled draws follow JAX's
key chain (``ops.prng``, the threefry port): ``req.rng = PRNGKey(seed)``
at submit (:1269), ``rng, sub = split(rng)`` for the first token
(``_sample_first_fn`` :1806), one ``split`` of every slot's key per
decode step, drawing with the second half and carrying the first
(:1358-1361), the same per step of a fused window, one per emitted
token in a speculative walk; the per-slot keys live on the device and
chain from the unit in flight as the tokens do (``_merge_keys`` :1056),
with a host mirror that the lagged fetch updates. So a sampled stream
is the JAX engine's, byte for byte. On the card the prefill
attention runs the flash kernel and the decode readout the paged kernel
(its int8/int4 variant for a quantized pool); quantized weights run the
K5 matmul kernel, ``fused_sampling`` the K4 sampling epilogue.

An MoE model (``zoo.transformer_lm(moe_every=, num_experts=)``) decodes
and verifies through ``MoE.decode_apply`` (``moe_decode="dispatched"``,
the drop-free fused dispatch: the K6a kernel on the card) or through
each layer's own ``apply`` (``"dense"``, the baseline). A dispatched
engine also keeps expert telemetry (``_note_moe_route`` :819: per-expert
load and router entropy read every ``_MOE_STATS_EVERY``-th step, and a
smoothed routing concentration) and asks for admission headroom under
concentrated routing (``_moe_admit_extra`` :852).

The loop is JAX's zero-bubble loop (docs/serving.md §Zero-bubble
loop). With ``overlap=True`` (the default) an iteration launches its
decode unit before it consumes the previous one: the input tokens chain
from the in-flight unit's output on the device (``_launch_step`` :1096),
host arrays reach the card as non-blocking copies from pinned memory,
and the host reads a unit's tokens one iteration late, in ``_fetch``
:903, the loop's one host sync (``_process_step`` :927: a stream is
stepped at most once past its stop, and a slot recycled since its
launch discards its tokens). ``fuse_steps=K`` runs K decode steps as
one unit when the batch is quiescent (``_fuse_window`` :1069,
``decode_fused_slots``), with the stop masks on the device. Metrics
samples are recorded every ``_HOST_WINDOW`` iterations, before every
terminal and on a metrics swap (``_flush_host_window`` :988), so counts
stay exact. ``overlap=False`` is the synchronous loop: launch, then
consume. Greedy streams are token-identical, sampled ones byte-identical
between the loops: a sampled row draws once per step from its request's
own key, in the same order. A speculative iteration drains the
pipeline first and stays synchronous.

The slab layout (``kv_layout="slab"``, JAX :484-489) keeps one
``max_len`` row per slot (``KVPool``): FCFS admission into free slots
(``FIFOScheduler``), no page budget, no preemption and no prefix cache;
a prompt's prefill ``insert``s only the positions it filled (:2675), and
the decode and verify steps (``decode_step_slots``, ``verify_step_slots``)
write each slot's row in place, a free slot's write landing in the sink
row, and read the rows through ``_slot_attn_readout`` (no attention
kernel, as JAX's slab engine keeps its einsum path). Speculation, fused
windows, sampled streams, ``weight_quant`` and MoE models run on it as
on the paged pool.

Host KV offload (``host_kv_pages``, JAX :2042-2105, :1863-1996,
:2583-2615): a preempted decoding stream's private pages swap out to the
pool's host tier (a device snapshot whose copy to pinned memory is
queued, no host sync) and its prefix-resident pages are held instead of
copied; re-admission funds exactly the swapped pages, and the prefill
turn copies them back (``_swap_in``, byte for byte) instead of
re-prefilling. A full host tier falls back to the re-prefill resume.
``_drop_swap`` releases a snapshot whose request ends first; the prefix
cache spills its cold pages to the same tier. The metrics count the
traffic and time the two resume paths apart.

Degradation (JAX :2309-2355, :2473): ``submit(deadline_s=)`` is a
submit-to-finish budget on the metrics clock; an expired request ends
``TIMED_OUT`` at the next ``step()`` (``_expire_deadlines``), and
``cancel(rid)`` ends one ``CANCELLED``; both land the unit in flight
first (its tokens stay; a request it finishes stays FINISHED) and
recycle the slot (``_terminate``). ``run()`` raises ``DegradedRequest``
for such a request, or with ``on_degraded="return"`` returns its
partial tokens. ``hbm_budget`` sizes the page pool from a byte budget
less the resident weights (:457-471), ``weights_dtype`` sets the
serving tree's dtype (:359-361), ``decode_kernel`` picks the paged
readout (:434-451: ``"off"`` is the gather path, no paged kernel) and
``engine_id`` names the engine (:547-569).

Replica handoff (JAX :2359-2471): ``transfer_out(rid)`` detaches a live
request through the preemption path (the unit in flight lands, pages
freed, the key taken from the slot's mirror, any swap snapshot dropped)
and ``transfer_in(req)`` admits it on another paged engine, which
re-prefills its context head-less and continues its stream: the
serving router's prefill->decode handoff, rebalance and failover
(``serving.router``).

Observability and resilience (JAX :571-611, :693-707): the engine runs
a request tracer (``obs.tracing``, on the metrics clock, shared with
the scheduler, which records admissions), the process-global flight
recorder (an iteration entry before the iteration's work, preemptions,
sheds), SLO objectives evaluated every ``_SLO_EVAL_EVERY`` iterations
and a time series of its live metrics registry scraped on the host
window; ``obs.disable()`` (or ``DKT_TELEMETRY=0``) turns them into
no-ops. The tracer's ticks and the recorder's steady-state entries ride
the deferred host window, built from what the host already holds: no
hook reads a device tensor. A request whose own work fails (its
prefill; ``faults.point("serving.prefill")``) ends ``CANCELLED`` with
``error`` set while every other stream goes on untouched (``_poison``,
JAX :2329); a decode failure is batch-wide and propagates before any
state of the iteration changes. The engine joins
``obs.telemetry_snapshot()`` as a component (``obs.attach``). The
expert-parallel mesh (``ep_mesh``) raises ``NotImplementedError``
naming its ROADMAP item.
"""

from __future__ import annotations

import itertools
import math
import weakref
import zlib
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from distkeras_tpu_torch import obs
from distkeras_tpu_torch.compat import resolve_device
from distkeras_tpu_torch.models.core import Model, Sequential, torch_dtype
from distkeras_tpu_torch.models.decoding import (_decode_block_of,
                                                 _sample_vec,
                                                 attn_compute_dtype,
                                                 commit_tree_path,
                                                 decode_fused_slots,
                                                 decode_step_slots,
                                                 decode_step_slots_paged,
                                                 fuse_qkv_params, prefill,
                                                 prefill_chunk_step,
                                                 serving_params, tree_walk,
                                                 verify_step_slots,
                                                 verify_step_slots_paged)
from distkeras_tpu_torch.models.moe import MoE
from distkeras_tpu_torch.obs.recorder import resolve_recorder
from distkeras_tpu_torch.obs.slo import SLOEngine
from distkeras_tpu_torch.obs.timeseries import TimeSeries
from distkeras_tpu_torch.obs.tracing import resolve_tracer
from distkeras_tpu_torch.ops import prng
from distkeras_tpu_torch.ops.paged_attention import check_rows
from distkeras_tpu_torch.ops.quant_matmul import (quantize_params_tree,
                                                  tree_quant_errors)
from distkeras_tpu_torch.ops.sampling import sample_tokens
from distkeras_tpu_torch.resilience import faults
from distkeras_tpu_torch.serving.kv_pool import (KVPool, PagedKVPool,
                                                 PrefixCache, stage)
from distkeras_tpu_torch.serving.metrics import ServingMetrics
from distkeras_tpu_torch.serving.scheduler import (AdmissionRejected,
                                                   FIFOScheduler,
                                                   PriorityScheduler,
                                                   Request, RequestState,
                                                   TERMINAL_STATES)
from distkeras_tpu_torch.serving.speculation import (DraftSource,
                                                     tree_ancestors)
from distkeras_tpu_torch.utils.tree import tree_leaves

#: options of the JAX engine that later slices port: name -> (value that
#: means "off", ROADMAP item)
_NOT_PORTED = {
    "ep_mesh": (None, "Queue 1 item 10 (expert-parallel MoE serving)"),
}


class DegradedRequest(RuntimeError):
    """``run()`` drained a request that did NOT finish normally
    (``TIMED_OUT``, ``CANCELLED``; JAX :120-133). Raised by default so
    a degraded result never passes for a complete one in ``run()``'s
    plain ``{rid: tokens}``; the terminal ``Request`` (state, partial
    tokens, ``error`` cause) rides on ``.request``."""

    def __init__(self, request: Request):
        cause = (f": {request.error!r}" if request.error is not None
                 else "")
        super().__init__(
            f"request {request.rid} ended {request.state.value}{cause} "
            "- drive with step() to observe terminal states, or "
            "run(on_degraded='return') to accept partial tokens")
        self.request = request


def _host_stats(moe):
    """A synchronous step's trailing MoE output (empty, or ``[None |
    dict]``) as host arrays, or None."""
    if not moe or moe[0] is None:
        return None
    return {key: x.cpu().numpy() for key, x in moe[0].items()}


class _PendingStep:
    """One launched, not yet consumed decode unit, a single step or a
    fused window (JAX :149). ``last`` is the ``[S]`` device feedback the
    next launch chains from; ``host`` holds the outputs' host copies
    (the ``[S]`` tokens of a step or the ``[S, K]`` block of a window,
    then the read step's MoE stats), in flight behind ``event`` on the
    card (on the CPU the outputs themselves and no event); ``keys`` the
    ``[S, 2]`` post-split per-slot keys on the device that the next
    launch chains from (None for a greedy unit; their host copy follows
    the tokens in ``host``); ``slots`` pins the (slot, rid) pairs at
    launch, so a slot recycled since discards its stale tokens;
    ``count`` is the tokens a covered slot gets."""

    __slots__ = ("last", "keys", "host", "event", "slots", "count",
                 "launch_t")

    def __init__(self, last, keys, host, event, slots, count, launch_t):
        self.last = last
        self.keys = keys
        self.host = host
        self.event = event
        self.slots = slots                   # tuple of (slot, rid)
        self.count = count
        self.launch_t = launch_t


class ServingEngine:
    """Continuous-batching serving of one ``zoo.transformer_lm`` model.
    ``submit()`` enqueues, ``step()`` runs one scheduler iteration,
    ``run()`` drains. ``max_len`` is the per-request capacity
    (``len(prompt) + max_new_tokens <= max_len``); ``kv_layout`` is
    ``"paged"`` (the default) or ``"slab"`` (one ``max_len`` row per
    slot, FCFS, no preemption, no prefix cache; ``host_kv_pages``,
    ``hbm_budget`` and ``decode_kernel`` raise ``ValueError`` there);
    ``page_len`` and ``num_pages`` size the paged pool (default:
    worst-case parity with one ``max_len`` row per slot);
    ``host_kv_pages`` adds that many pages of host memory, where
    preemption victims swap out and cold prefix pages spill;
    ``cache_dtype`` is the pages' dtype
    (default: the model's compute dtype; ``"int8"``/``"int4"`` quantize
    the pages per token and head, int4 packing two positions per byte,
    and the decode readout takes the kernel's quantized variant);
    ``prefill_chunk`` bounds the
    prompt positions one iteration ingests; ``prefix_cache`` shares
    identical prompt prefixes between requests, and
    ``prefix_granularity`` rounds a partial-page (copy-on-write) match
    down to a multiple of that many tokens. The engine runs on ``device``
    (default: the CUDA card; raises when there is none unless
    ``device="cpu"``), which must be the model's. ``on_logits(kind,
    logits, slots)`` (optional) sees every prefill (``kind="prefill"``),
    decode (``"decode"``) and verify (``"verify"``, ``[S, W, V]``)
    logits tensor with the slots whose rows are live.

    ``weight_quant`` (``"int8"``/``"int4"``) serves from per-channel
    quantized weights (int4 nibble-packed), the only weight copy the
    engine holds: the decode and verify steps' projections, MLP and head
    run the K5 quantized matmul, a prefill chunk dequantizes one leaf at
    a time; it composes with quantized pages and with speculation (a
    ``DraftModel`` keeps its own float weights). ``fused_sampling`` draws
    the decode steps' sampled tokens through the K4 epilogue, token for
    token the unfused sampler's.

    ``moe_decode`` (``"dispatched"``, the default, or ``"dense"``)
    chooses how an MoE model's decode and verify steps run its MoE
    blocks: ``MoE.decode_apply`` (the K6a kernel on the card) or each
    layer's own ``apply``. Under ``weight_quant`` the stacked expert
    leaves are quantized too and dequantized one layer at a time just
    before the layer runs. ``health()["moe"]`` and
    ``metrics.summary()["moe"]`` report them.

    ``overlap`` (default True) pipelines the decode loop: each unit is
    launched before the previous one is consumed, its input tokens
    chained on the device, and the host reads tokens one iteration late
    (``req.generated`` and the metrics lag by at most one iteration
    while a stream decodes); ``overlap=False`` is the synchronous loop.
    ``fuse_steps`` (>= 2 engages) runs that many decode steps as one
    unit whenever the batch is quiescent: nothing queued or prefilling,
    no speculating stream, every stream's remaining budget covering the
    window; the window's pages are grown first, and if that preempts a
    stream the iteration runs one step instead. Either way the streams
    are those of the synchronous loop. ``fetch_seconds`` totals the
    time the host waited for tokens.

    ``draft`` (a ``DraftSource``: ``NgramDraft()``, ``DraftModel(m)``)
    turns on speculative decoding: ``spec_k`` drafts per slot and
    iteration; ``spec_disable_below``/``spec_warmup`` the per-request
    acceptance-EMA floor and the verifies before it applies;
    ``spec_reprobe`` (tokens) lets a disabled stream re-probe;
    ``spec_tree``/``spec_width`` verify token trees of up to ``1 +
    spec_k * spec_width`` nodes. On the card a window of W positions
    with G query heads per kv head needs ``W * G <= 64`` (the paged
    kernel's rows per kv head).

    ``hbm_budget`` (bytes; instead of ``num_pages``) sizes the pool to
    whole pages of what the budget leaves after the served weight tree
    (``param_bytes()``, quantized or not): the same ``num_pages`` as the
    JAX engine; the sink page adds ``page_bytes`` more
    (``pool.allocated_bytes()``). ``weights_dtype`` is the serving
    tree's matrix dtype: ``"auto"`` the compute dtype when it is not
    float32, None the float32 masters, or a float dtype; ``weight_quant``
    wins over it. ``decode_kernel``: ``"auto"`` and ``"paged"`` read the
    pages through the paged kernel (K3 on the card, its plain version on
    the CPU), ``"off"`` through the gather readout (the A/B baseline: no
    paged kernel on any device). ``engine_id`` names the engine
    (``health()["engine_id"]``): None gives ``"serving"`` to the first
    live engine and ``"serving[<hex>]"`` to later ones; an id a live
    engine already holds gets a ``"#<hex>"`` suffix."""

    def __init__(self, model: Model, *, num_slots: int = 4,
                 max_len: int = 256, prefill_chunk: Optional[int] = None,
                 cache_dtype=None,
                 metrics: Optional[ServingMetrics] = None,
                 max_queue: Optional[int] = None, kv_layout: str = "paged",
                 page_len: int = 16, num_pages: Optional[int] = None,
                 prefix_cache: bool = True, prefix_granularity: int = 1,
                 device=None, on_logits: Optional[Callable] = None,
                 overlap: bool = True, fuse_steps: int = 0, draft=None,
                 weight_quant: Optional[str] = None,
                 fused_sampling: bool = False, ep_mesh=None,
                 host_kv_pages: int = 0, spec_k: int = 4,
                 spec_disable_below: float = 0.1, spec_warmup: int = 8,
                 spec_reprobe: Optional[int] = None,
                 spec_tree: bool = False, spec_width: int = 1,
                 moe_decode: str = "dispatched", hbm_budget=None,
                 weights_dtype="auto", decode_kernel: str = "auto",
                 engine_id: Optional[str] = None, tracer=None, slo=None,
                 timeseries=None):
        given = {"ep_mesh": ep_mesh}
        for name, (off, item) in _NOT_PORTED.items():
            if given[name] != off:
                raise NotImplementedError(
                    f"{name}={given[name]!r} is not ported yet: ROADMAP, "
                    f"{item}")
        if kv_layout not in ("paged", "slab"):
            raise ValueError(
                f"kv_layout must be 'paged' or 'slab', got {kv_layout!r}")
        if decode_kernel not in ("auto", "paged", "off"):
            raise ValueError(f"decode_kernel must be 'auto', 'paged' or "
                             f"'off', got {decode_kernel!r}")
        if kv_layout == "slab":
            # paged-only options must not silently no-op (JAX :444-455)
            if host_kv_pages:
                raise ValueError(
                    "host_kv_pages needs kv_layout='paged' (the slab pool "
                    "has no page-granular offload)")
            if decode_kernel != "auto":
                raise ValueError(
                    "decode_kernel applies to the paged readout only; a "
                    "slab engine always uses the einsum path")
            if hbm_budget is not None:
                raise ValueError("hbm_budget needs kv_layout='paged' (the "
                                 "slab pool has no page budget to size)")
        self.kv_layout = kv_layout
        self._paged = kv_layout == "paged"
        #: the paged readout: the kernel's path ("auto", "paged") or the
        #: gather path ("off")
        self.decode_kernel = decode_kernel
        self._paged_kernel = decode_kernel != "off"
        module = model.module
        if not isinstance(module, Sequential) or not any(
                _decode_block_of(layer) is not None
                for layer in module.layers):
            raise TypeError("ServingEngine expects a Sequential transformer "
                            f"LM (got {type(module).__name__})")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device}, the engine "
                             f"on {self.device}: build the model there")
        self.model = model
        self.module = module
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        if prefill_chunk is not None:
            prefill_chunk = int(prefill_chunk)
            if prefill_chunk < 1:
                raise ValueError(
                    f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.prefill_chunk = prefill_chunk
        # matrices pre-cast to the compute dtype once (the JAX engine's
        # "auto" weight policy), q/k/v fused into one projection; built
        # outside autograd, since the model's parameters require grad
        compute_dt = attn_compute_dtype(module)
        if cache_dtype is None:
            cache_dtype = compute_dt
        self._init_moe(moe_decode)
        self._init_weights(weight_quant, weights_dtype, compute_dt)
        #: decode steps draw through ``ops.sampling.sample_tokens`` (the
        #: K4 epilogue on the card); the first token and the speculative
        #: walks keep the unfused sampler, as in the JAX engine
        self.fused_sampling = bool(fused_sampling)

        self._init_pool(cache_dtype, page_len, num_pages, host_kv_pages,
                        hbm_budget, prefix_cache, prefix_granularity,
                        max_queue)
        self._init_pipeline(overlap, fuse_steps)
        self._init_engine_id(engine_id)
        # ONE reusable staging cache: stale positions past the current
        # context are never inserted and never read before being written
        self._staging = self.pool.make_request_cache()
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self._init_obs(tracer, slo, timeseries)
        self.on_logits = on_logits
        self._requests: Dict[int, Request] = {}
        self._rid = itertools.count()
        s = self.num_slots
        self._tok = np.zeros(s, np.int64)
        #: max_len is the free-slot sentinel: the decode write misses
        #: every page and the slot's logits are discarded
        self._t = np.full(s, self.max_len, np.int32)
        #: host mirror of the per-slot PRNG keys (``PRNGKey(0)`` until a
        #: request takes the slot): the launch reads it where the host
        #: owns a slot, the lagged fetch writes the chained keys back
        self._keys = np.zeros((s, 2), np.int64)
        self._init_speculation(draft, spec_k, spec_disable_below,
                               spec_warmup, spec_reprobe, spec_tree,
                               spec_width)
        # the current metrics window joins obs.telemetry_snapshot() under
        # the engine's name; the bound method is held weakly, so a
        # dropped engine detaches itself
        obs.attach(self._component_name, self._telemetry_summary,
                   owner=self)

    def _init_pool(self, cache_dtype, page_len, num_pages, host_kv_pages,
                   hbm_budget, prefix_cache, prefix_granularity,
                   max_queue) -> None:
        """The KV pool and the scheduler of the layout (JAX :456-500):
        the paged pool (with its host tier, ``host_kv_pages``), the
        prefix cache and priority admission with preemption; or the slab
        pool, FCFS admission, no preemption and no prefix cache."""
        #: the host tier's odometers at the last metrics flush
        self._off_seen = (0, 0, 0)
        if not self._paged:
            self.pool = KVPool(self.module, self.num_slots, self.max_len,
                               cache_dtype, self.device)
            self.page_len = None
            self.prefix = None
            self.scheduler = FIFOScheduler(self.num_slots,
                                           max_queue=max_queue)
            return
        # hbm_budget: the resident weights come off the top, the rest
        # becomes whole pages
        self.pool = PagedKVPool(
            self.module, self.num_slots, self.max_len, page_len=page_len,
            num_pages=num_pages, dtype=cache_dtype, device=self.device,
            host_pages=host_kv_pages, hbm_budget=hbm_budget,
            reserve_bytes=0 if hbm_budget is None else self.param_bytes())
        self.page_len = self.pool.page_len
        self.prefix = PrefixCache(self.pool) if prefix_cache else None
        if prefix_granularity < 1:
            raise ValueError(f"prefix_granularity must be >= 1, "
                             f"got {prefix_granularity}")
        self._prefix_granularity = int(prefix_granularity)
        self.scheduler = PriorityScheduler(self.num_slots,
                                           max_queue=max_queue)

    def _init_pipeline(self, overlap: bool, fuse_steps: int) -> None:
        """The zero-bubble loop's state (JAX :503-540)."""
        self.overlap = bool(overlap)
        fuse_steps = int(fuse_steps)
        if fuse_steps < 0:
            raise ValueError(f"fuse_steps must be >= 0, got {fuse_steps}")
        #: fused multi-step decode window (engaged when >= 2)
        self.fuse_steps = fuse_steps
        #: the launched, not yet consumed decode unit (the lag-1 pipeline)
        self._pending: Optional[_PendingStep] = None
        #: slots whose next input token the HOST owns (True), not the
        #: in-flight unit's device output
        self._chain_dirty = np.ones(self.num_slots, bool)
        #: requests finished by a pipeline flush outside the decode phase
        #: (a preemption, a metrics swap); step() returns them
        self._finish_buf: List[Request] = []
        #: seconds the host spent blocked in the lagged fetch
        self.fetch_seconds = 0.0
        # deferred metrics samples, recorded every _host_window
        # iterations and before every terminal: counts stay exact, only
        # their recording leaves the per-iteration path
        self._host_window = self._HOST_WINDOW if self.overlap else 1
        self._iter_buf: List = []        # (queue_depth, occupied)
        self._decode_buf: List = []      # (n_slots, dt, n_tokens)
        self._spec_buf: List = []        # (proposed, accepted)
        self._spec_tree_buf: List = []   # (width, path_len, depth)
        #: the tracer's deferred decode ticks (rid -> tokens) since the
        #: last flush, the window's start, and the speculation outcomes
        #: (rid -> [proposed, accepted(, width, path_len)])
        self._trace_decode: Dict[int, int] = {}
        self._trace_decode_t0: Optional[float] = None
        self._trace_spec: Dict[int, List[int]] = {}
        #: batch-composition version: bumped on admit, to-decoding,
        #: finish, preempt and terminate, so steady-state iterations reuse
        #: the recorder's rid lists
        self._comp_ver = 0
        self._rec_cache = (-1, None)
        self._iters = 0

    def _init_engine_id(self, engine_id) -> None:
        """The engine's name (JAX :547-569), which tags its tracer
        timelines and flight-recorder entries and names its
        ``obs.telemetry_snapshot()`` component: None gives "serving" to
        the first live engine and "serving[<hex>]" to later ones; an
        explicit id a live engine already holds gets a "#<hex>" suffix,
        so no two live engines share one."""
        if engine_id is None:
            name = "serving"
            if name in obs.components():
                name = f"serving[{id(self):x}]"
            self.engine_id = name
        else:
            self.engine_id = str(engine_id)
            name = f"serving[{self.engine_id}]"
            if name in obs.components():
                self.engine_id = f"{self.engine_id}#{id(self):x}"
                name = f"serving[{self.engine_id}]"
        self._component_name = name

    def _init_obs(self, tracer, slo, timeseries) -> None:
        """Request-level observability (JAX :571-611): the tracer shares
        the metrics clock (timeline durations and measured latencies
        compare directly) and the scheduler, which records admissions;
        the flight recorder is the process-global ring (NULL while obs
        is disabled); ``slo`` takes an ``SLOEngine`` or a sequence of
        ``Objective``; ``timeseries`` None builds a scraper that follows
        the CURRENT metrics window across swaps (through a weak
        reference: the scraper must not keep the engine alive), False
        turns it off, a ``TimeSeries`` is used as it is, and a number is
        the scrape interval in seconds."""
        self.tracer = resolve_tracer(tracer, clock=self.metrics.clock,
                                     engine=self.engine_id)
        self.scheduler.tracer = (self.tracer if self.tracer.enabled
                                 else None)
        self.recorder = resolve_recorder()
        if slo is None or isinstance(slo, SLOEngine):
            self.slo = slo
        else:
            self.slo = SLOEngine(list(slo), clock=self.metrics.clock)
        if timeseries is False:
            self.timeseries = None
        elif isinstance(timeseries, TimeSeries):
            self.timeseries = timeseries
        else:
            ref = weakref.ref(self)

            def live_registry():
                eng = ref()
                return None if eng is None else eng._metrics.registry

            self.timeseries = TimeSeries(
                live_registry, clock=self.metrics.clock,
                interval_s=0.0 if timeseries is None else float(timeseries),
                tags={"engine": self.engine_id})
        #: the kernel libraries loaded after warm-up are the port's
        #: recompiles (checked every ``_RECOMPILE_CHECK_EVERY`` iterations)
        self._recompile = obs.RecompileDetector()
        self._recompile.watch("serving.kernels",
                              obs.collectors.KERNEL_LIBRARIES)
        self._warm = False

    def _init_moe(self, moe_decode: str) -> None:
        """MoE serving (JAX :406-423): the model's MoE MLPs in layer
        order, the decode dispatch and the telemetry state."""
        if moe_decode not in ("dispatched", "dense"):
            raise ValueError(f"moe_decode must be 'dispatched' or 'dense', "
                             f"got {moe_decode!r}")
        self.moe_decode = moe_decode
        #: the model's MoE MLPs (inside TransformerBlocks), in layer order
        self._moe = [blk.mlp for blk in map(_decode_block_of,
                                            self.module.layers)
                     if blk is not None and isinstance(blk.mlp, MoE)]
        self._moe_dispatched = bool(self._moe) and moe_decode == "dispatched"
        # expert telemetry rides only on the dispatched path
        self._moe_stats_on = self._moe_dispatched
        self._moe_conc: Optional[float] = None   # routing-concentration EMA
        self._moe_iter = 0                       # stats-throttle counter

    def _init_weights(self, weight_quant, weights_dtype, compute_dt) -> None:
        """The serving tree: the matrices cast to ``weights_dtype`` (JAX
        :359-361: ``"auto"`` the compute dtype unless float32, None the
        float32 masters) with q/k/v fused, or with ``weight_quant`` (JAX
        :372-399, which wins over ``weights_dtype``) the qdict tree of
        ``ops.quant_matmul.quantize_params_tree`` (int8, or int4
        nibble-packed along axis 0), the only weight copy the engine
        holds, with its per-leaf ``weight_quant_error``."""
        if weight_quant not in (None, "int8", "int4"):
            raise ValueError(f"weight_quant must be None, 'int8' or 'int4', "
                             f"got {weight_quant!r}")
        if weights_dtype == "auto":
            weights_dtype = (compute_dt if compute_dt is not None
                             and compute_dt != torch.float32 else None)
        wdt = torch.float32 if weights_dtype is None \
            else torch_dtype(weights_dtype)
        if not wdt.is_floating_point:
            raise ValueError(f"weights_dtype must be 'auto', None or a "
                             f"float dtype, got {weights_dtype!r}")
        self.weight_quant = weight_quant
        #: path-keyed per-leaf quantization error (max_abs_err, rel_rms)
        self.weight_quant_error = None
        with torch.no_grad():
            if weight_quant is None:
                self._params = fuse_qkv_params(
                    self.module, serving_params(self.model.params, wdt))
                return
            self._params = quantize_params_tree(
                self.model.params, bits=4 if weight_quant == "int4" else 8)
        self.weight_quant_error = tree_quant_errors(self.model.params,
                                                    self._params)

    def param_bytes(self) -> int:
        """Bytes of the parameter tree the engine serves from (the
        quantized bytes and scales under ``weight_quant``)."""
        return sum(t.numel() * t.element_size()
                   for t in tree_leaves(self._params))

    def _init_speculation(self, draft, spec_k, spec_disable_below,
                          spec_warmup, spec_reprobe, spec_tree,
                          spec_width) -> None:
        """The speculation knobs, validated as the JAX engine does
        (:636-690), plus the paged kernel's row budget on the card."""
        if draft is not None and not isinstance(draft, DraftSource):
            raise TypeError(
                f"draft must be a DraftSource (NgramDraft / DraftModel / "
                f"custom), got {type(draft).__name__}")
        self._draft = draft
        self.spec_k = int(spec_k)
        if self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if not 0.0 <= float(spec_disable_below) <= 1.0:
            raise ValueError(f"spec_disable_below must be in [0, 1], got "
                             f"{spec_disable_below}")
        self.spec_disable_below = float(spec_disable_below)
        self.spec_warmup = int(spec_warmup)
        if spec_reprobe is not None:
            spec_reprobe = int(spec_reprobe)
            if spec_reprobe < 1:
                raise ValueError(
                    f"spec_reprobe must be >= 1, got {spec_reprobe}")
        self.spec_reprobe = spec_reprobe
        self.spec_tree = bool(spec_tree)
        self.spec_width = int(spec_width)
        if self.spec_width < 1:
            raise ValueError(f"spec_width must be >= 1, got {spec_width}")
        if self.spec_width > 1 and not self.spec_tree:
            raise ValueError("spec_width > 1 needs spec_tree=True (the "
                             "linear verify window has no branch columns)")
        if self.spec_tree and draft is None:
            raise ValueError("spec_tree=True needs a draft source "
                             "(ServingEngine(draft=...))")
        #: verify-window width: a tree window holds the full node budget
        self.spec_window = (1 + self.spec_k * self.spec_width
                            if self.spec_tree else self.spec_k + 1)
        if draft is None:
            return
        # the paged kernel's row limit holds on the card only
        if self.device.type == "cuda":  # lint: allow-device-fork
            block = next(b for b in map(_decode_block_of, self.module.layers)
                         if b is not None)
            check_rows(self.spec_window,
                       block.attn.num_heads // block.attn.kv_heads)
        draft.bind(self)

    # --- request intake ---------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *,
               temperature: float = 0.0, top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               stop_token: Optional[int] = None, seed: int = 0,
               deadline_s: Optional[float] = None, priority: int = 1,
               speculate: Optional[bool] = None) -> int:
        """Enqueue one request; returns its id. ``temperature=0`` is
        greedy; ``None`` knobs are disabled. ``priority``: lower admits
        first (0 interactive, 1 standard, 2 batch). ``speculate``: join
        the draft-and-verify iterations (None: whenever the engine has a
        draft; True on a draftless engine raises). Raises
        ``AdmissionRejected`` when the bounded queue is full.
        ``deadline_s`` is a submit-to-finish budget on the metrics clock:
        a request still unfinished when it expires ends ``TIMED_OUT`` at
        the next ``step()``, keeping its tokens so far. ``seed`` keys
        the request's draws (``PRNGKey(seed)``, JAX's)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the slot capacity "
                f"max_len={self.max_len}")
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if deadline_s is not None and float(deadline_s) <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        if self._paged:
            worst = self.pool.pages_for(prompt.size + max_new_tokens)
            if worst > self.pool.num_pages:
                raise ValueError(
                    f"request needs up to {worst} pages but the pool "
                    f"holds {self.pool.num_pages}; raise num_pages or "
                    "lower max_new_tokens")
        if speculate and self._draft is None:
            raise ValueError(
                "speculate=True needs an engine built with a draft source "
                "(ServingEngine(draft=NgramDraft()) or DraftModel(...))")
        req = Request(
            rid=next(self._rid), prompt=prompt,
            max_new_tokens=max_new_tokens, temperature=float(temperature),
            top_k=0 if top_k is None else int(top_k),
            top_p=1.0 if top_p is None else float(top_p),
            stop_token=-1 if stop_token is None else int(stop_token),
            seed=int(seed), priority=int(priority),
            deadline_s=None if deadline_s is None else float(deadline_s),
            speculate=(self._draft is not None if speculate is None
                       else bool(speculate)))
        req.rng = prng.key(req.seed).numpy()
        req.submit_t = self.metrics.clock()
        try:
            self.scheduler.submit(req)
        except AdmissionRejected:
            self.metrics.record_rejected()
            self.tracer.on_reject()
            # enough sheds since the last dump snapshot the ring
            self.recorder.note_rejection(
                rid=req.rid, engine=self.engine_id,
                queue_depth=self.scheduler.queue_depth,
                max_queue=self.scheduler.max_queue)
            raise
        self._requests[req.rid] = req
        self.metrics.record_submit(req.rid)
        self.tracer.on_submit(req.rid, self.scheduler.queue_depth)
        return req.rid

    def __getitem__(self, rid: int) -> Request:
        """In-flight request lookup (finished requests are evicted)."""
        return self._requests[rid]

    # --- paged admission / page budget ------------------------------------

    def _admit(self) -> List[Request]:
        """Admit the highest-priority queued requests while a slot and
        their context pages are available; a strictly-higher-priority
        arrival that cannot be funded preempts lower-priority streams.
        A slab engine admits FCFS into free slots (JAX :1830)."""
        if not self._paged:
            admitted = self.scheduler.admit()
            if admitted:
                self._comp_ver += 1
            return admitted
        admitted: List[Request] = []
        sch = self.scheduler
        while sch.free_slots:
            req = sch.peek()
            if req is None:
                break
            plan = self._page_plan(req)
            if plan is not None:
                sch.admit_one(req)
                self._comp_ver += 1
                self._apply_page_plan(req, plan)
                admitted.append(req)
                continue
            if not self._preempt_victim(beneficiary=req,
                                        strict_priority=True):
                break
        return admitted

    def _page_plan(self, req: Request) -> Optional[Dict]:
        """Fund ``req``'s (re)admission: prefix-match its context,
        reclaim cache-only pages if the private remainder does not fit,
        allocate. None when it cannot be funded. Matched pages are
        incref'd before any reclaim, so the sweep cannot eat them. A
        victim whose pages were swapped out needs exactly its swapped
        page count back (no prefix match, no growth page: the snapshot
        covers its next write), and resumes by a copy (JAX :1869)."""
        pool = self.pool
        if req.swap is not None:
            n = len(req.swap["host"])
            need = n + self._moe_admit_extra(req, n)
            if pool.free_pages < need and self.prefix is not None:
                deficit = need - pool.free_pages
                if self.prefix.evictable_pages() >= deficit:
                    self.prefix.reclaim(deficit)
            if pool.free_pages < need:
                return None
            return {"restore": True,
                    "priv": [pool.alloc_page() for _ in range(n)]}
        toks = req.context_tokens
        # context + 1: the first decode write must land on a page
        n_logical = pool.pages_for(len(toks) + 1)
        if self.prefix is not None:
            full, shared_len, donor = self._match_prefix(toks)
        else:
            full, shared_len, donor = [], 0, None
        for pid in full:
            pool.incref(pid)
        if donor is not None:
            pool.incref(donor)
        n_private = n_logical - len(full)
        # under concentrated routing the free-page budget must also show
        # headroom pages (required free, never allocated)
        need = n_private + self._moe_admit_extra(req, n_logical)
        if pool.free_pages < need and self.prefix is not None:
            deficit = need - pool.free_pages
            if self.prefix.evictable_pages() >= deficit:
                self.prefix.reclaim(deficit)
        if pool.free_pages < need:
            for pid in full:
                pool.decref(pid)
            if donor is not None:
                pool.decref(donor)
            return None
        priv = [pool.alloc_page() for _ in range(n_private)]
        return {"full": full, "priv": priv, "shared_len": shared_len,
                "donor": donor}

    def _match_prefix(self, toks):
        """``PrefixCache.match`` with the partial-match length rounded
        down to a multiple of ``prefix_granularity``."""
        full, shared_len, donor = self.prefix.match(toks)
        g = self._prefix_granularity
        if donor is not None and g > 1:
            base = len(full) * self.pool.page_len
            m = ((shared_len - base) // g) * g
            shared_len = base + m
            if m == 0:
                donor = None
        return full, shared_len, donor

    def _rematch_at_prefill(self, req: Request) -> None:
        """Adopt prefix pages registered between this request's admission
        and its prefill turn (by requests ahead of it in the prefill
        stream): swap the private pages the longer chain covers for the
        shared ones."""
        pool = self.pool
        full, shared_len, donor = self._match_prefix(req.context_tokens)
        if shared_len <= req.shared_len:
            return
        slot = req.slot
        for j in range(req.n_shared_full, len(full)):
            old = int(pool.tables[slot, j])
            pool.incref(full[j])
            pool.assign(slot, j, full[j])
            pool.decref(old)
        if req.donor_ref is not None:
            pool.decref(req.donor_ref)
            req.donor_ref = None
        if donor is not None:
            pool.incref(donor)
            req.donor_ref = donor
        req.shared_len = shared_len
        req.n_shared_full = len(full)
        req.load_pages = list(full) + ([donor] if donor is not None
                                        else [])

    def _apply_page_plan(self, req: Request, plan: Dict) -> None:
        slot = req.slot
        if plan.get("restore"):
            # swap resume (JAX :1968): the fresh pages take the logical
            # pages the snapshot captured, and the prefix-resident pages
            # come back under the snapshot's hold, now the slot's; the
            # copy runs at the request's prefill turn
            for lp, pid in zip(req.swap["logical"], plan["priv"]):
                self.pool.assign(slot, int(lp), pid)
            for lp, pid in req.swap["shared"]:
                self.pool.assign(slot, int(lp), int(pid))
            return
        for j, pid in enumerate(plan["full"]):
            self.pool.assign(slot, j, pid)
        for i, pid in enumerate(plan["priv"]):
            self.pool.assign(slot, len(plan["full"]) + i, pid)
        req.shared_len = plan["shared_len"]
        req.n_shared_full = len(plan["full"])
        req.donor_ref = plan["donor"]
        req.load_pages = list(plan["full"]) + (
            [plan["donor"]] if plan["donor"] is not None else [])

    def _preempt_victim(self, beneficiary: Request,
                        strict_priority: bool) -> bool:
        """Preempt ONE admitted request (decoding or mid-prefill): the
        lowest-priority, youngest. ``strict_priority`` (admission) only
        takes strictly lower-priority streams; decode growth also takes
        the beneficiary itself when it ranks last. The best-ranked
        stream is never a victim, so it always finishes."""
        victim = None
        for r in list(self.scheduler.running.values()) \
                + list(self.scheduler.prefilling):
            if strict_priority and (r is beneficiary
                                    or r.priority <= beneficiary.priority):
                continue
            if victim is None \
                    or (r.priority, r.rid) > (victim.priority, victim.rid):
                victim = r
        if victim is None:
            return False
        self._preempt(victim)
        return True

    def _preempt(self, victim: Request) -> None:
        """Evict an admitted request's pages back to the queue. Its
        generated tokens stay (the re-prefill context); a decoding
        victim's key is snapshotted from the slot's mirror (JAX :2041),
        so a sampled stream resumes where it left off (a prefilling one
        keeps its submit-time key). The in-flight unit is consumed first
        (JAX :2036): the context and the key must hold its tokens, and it
        may finish the victim instead. With a host tier a decoding
        victim's pages swap out first (``_swap_out``)."""
        self._flush_pending()
        if victim.state in TERMINAL_STATES:
            return
        slot = victim.slot
        swapped = 0
        if victim.state is RequestState.DECODING:
            victim.rng = self._keys[slot].copy()
            if self.pool.host_cache is not None:
                swapped = self._swap_out(victim)
        elif victim.swap is not None:
            # admitted for a swap-in, preempted before its turn: its host
            # pages still hold the snapshot, and the slot's holds on the
            # prefix-resident pages go back to it (JAX drops them here)
            for _lp, pid in victim.swap["shared"]:
                self.pool.incref(pid)
        self.scheduler.preempt(victim)
        self._comp_ver += 1
        self._chain_dirty[slot] = True
        if self._draft is not None:
            self._draft.end_slot(slot)   # draft KV freed with the slot
        freed = self.pool.release_slot(slot)
        self._t[slot] = self.max_len
        if victim.donor_ref is not None:
            self.pool.decref(victim.donor_ref)
            victim.donor_ref = None
        victim.shared_len = 0
        victim.n_shared_full = 0
        victim.load_pages = []
        self.metrics.record_preemption(victim.rid)
        self.tracer.on_preempt(victim.rid, len(victim.generated))
        if self.recorder.enabled:
            self.recorder.record(
                "serving.preempted", engine=self.engine_id,
                rid=victim.rid, slot=slot,
                n_generated=len(victim.generated), pages_freed=freed,
                pages_free=self.pool.free_pages, pages_swapped=swapped)

    def _swap_out(self, victim: Request) -> None:
        """Queue a decoding victim's pages for the host tier (JAX
        :2042-2081), so it resumes by a copy instead of a re-prefill.
        Pages the prefix cache holds are not copied: the snapshot takes a
        hold on them, which the resume turns into the slot's. When the
        host tier is full nothing is held and the victim re-prefills.
        Returns the pages swapped out."""
        pool = self.pool
        row = pool.tables[victim.slot]
        shared, priv = [], []
        for lp in np.flatnonzero(row < pool.num_pages).tolist():
            pid = int(row[lp])
            if self.prefix is not None and self.prefix.resident(pid):
                shared.append((lp, pid))
            else:
                priv.append(lp)
        hids = pool.offload_pages(row[priv].tolist()) if priv else []
        if hids is None:
            return 0
        for _lp, pid in shared:
            pool.incref(pid)
        victim.swap = {"host": hids, "logical": priv, "shared": shared,
                       "t": int(self._t[victim.slot])}
        self.tracer.on_swap_out(victim.rid, len(hids))
        return len(hids)

    def _drop_swap(self, req: Request) -> None:
        """Release a swap snapshot that no resume will read (JAX :3014):
        its host pages (a queued batch freed whole is never fenced) and
        the holds on its prefix-resident pages."""
        if req.swap is None:
            return
        self.pool.free_host(req.swap["host"])
        for _lp, pid in req.swap["shared"]:
            self.pool.decref(int(pid))
        req.swap = None

    def _ensure_decode_pages(self, lookahead=None) -> None:
        """Before a decode step: every running slot whose next write
        crosses into an unallocated page gets one, from the free list,
        then by evicting cache-only prefix pages, then by preempting the
        youngest lowest-priority stream. Oldest-highest-priority first.
        ``lookahead`` (``[S]``, speculative iterations): the verify also
        writes positions ``t+1 .. t+lookahead[slot]``, so every page under
        that span is allocated too (an accepted draft's dropped write
        would corrupt its K/V); the engine passes only what a slot can
        consume."""
        pool = self.pool
        running = self.scheduler.running
        if not running:
            return
        cap = pool.pages_per_slot * pool.page_len - 1
        slots = np.fromiter(running.keys(), np.int64, len(running))
        t = self._t[slots].astype(np.int64)
        hi = t if lookahead is None else t + lookahead[slots]
        hi = np.minimum(hi, cap)
        lp = np.arange(pool.pages_per_slot)
        span = (lp >= (np.minimum(t, cap) // pool.page_len)[:, None]) \
            & (lp <= (hi // pool.page_len)[:, None])
        if not (span & (pool.tables[slots] >= pool.num_pages)).any():
            return
        for req in sorted(running.values(),
                          key=lambda r: (r.priority, r.rid)):
            if req.state is not RequestState.DECODING:
                continue                      # preempted this pass
            slot = req.slot
            t = min(int(self._t[slot]), cap)
            hi = t if lookahead is None else t + int(lookahead[slot])
            hi = min(hi, cap)
            for page in range(t // pool.page_len, hi // pool.page_len + 1):
                if req.state is not RequestState.DECODING:
                    break                     # it preempted itself
                while pool.tables[slot, page] >= pool.num_pages:
                    pid = pool.alloc_page()
                    if pid is not None:
                        pool.assign(slot, page, pid)
                        break
                    if self.prefix is not None and self.prefix.evict_one():
                        continue
                    if not self._preempt_victim(beneficiary=req,
                                                strict_priority=False):
                        raise RuntimeError(
                            "page pool exhausted: no free page, nothing "
                            "evictable, no preemptable stream")
                    if req.state is not RequestState.DECODING:
                        break                 # it preempted itself

    def _fragmentation(self) -> float:
        """``1 - used / allocated`` positions over live slots."""
        pool = self.pool
        sch = self.scheduler
        used = alloc = 0
        for req in list(sch.running.values()) + list(sch.prefilling):
            alloc += int((pool.tables[req.slot] < pool.num_pages).sum())
            used += (int(self._t[req.slot]) if req.state is
                     RequestState.DECODING else req.prefill_pos)
        if alloc == 0:
            return 0.0
        return max(0.0, 1.0 - used / (alloc * pool.page_len))

    # --- the scheduler iteration ------------------------------------------

    @torch.inference_mode()
    def step(self) -> List[Request]:
        """One iteration: expire deadlines, admit, advance ONE prefill
        chunk, run one decode unit over all slots (under ``overlap``:
        launch it, then consume the previous one). Returns the requests
        that reached a terminal state (FINISHED, TIMED_OUT or CANCELLED:
        check ``req.state``). Runs under ``torch.inference_mode``:
        serving records no autograd graph, even for a model whose
        parameters require grad.

        Error isolation (JAX :2200-2213): an exception while advancing
        ONE request's prefill cancels that request (``_poison``) and
        recycles its slot; the decode streams go on token-identically.
        A decode error is batch-wide and propagates, raised before any
        state of the iteration changes."""
        finished: List[Request] = []
        if self._finish_buf:
            # ended by a pipeline flush since the last step (a cancel, a
            # metrics swap)
            finished.extend(self._finish_buf)
            self._finish_buf.clear()
        self._expire_deadlines(finished)
        admitted = self._admit()
        # the flight recorder's entry, before the iteration's work: a
        # fault dump holds the failing iteration itself
        self._record_iteration(admitted)
        clock = self.metrics.clock
        req = self.scheduler.next_prefill()
        if req is not None:
            t0 = clock()
            with obs.span("serving.prefill"):
                try:
                    self._advance_prefill(req, finished)
                except Exception as e:
                    self._poison(req, e, finished)
            self.metrics.record_phase("prefill", clock() - t0)
        if self.scheduler.running:
            t0 = clock()
            with obs.span("serving.decode"):
                self._advance_decode(finished)
            self.metrics.record_phase("decode", clock() - t0)
        self._iter_buf.append((self.scheduler.queue_depth,
                               self.scheduler.occupied))
        self._iters += 1
        if self._iters % self._host_window == 0 \
                or not self.scheduler.pending:
            self._flush_host_window()
            if self.timeseries is not None:
                # on the flush just paid: host reads of the registry only
                self.timeseries.maybe_sample(iteration=self._iters)
        if self._iters % self._RECOMPILE_CHECK_EVERY == 0:
            if not self._warm:
                self._recompile.mark_warm()
                self._warm = True
            self._recompile.check()
        if self.slo is not None \
                and self._iters % self._SLO_EVAL_EVERY == 0:
            self._flush_host_window()
            self.slo.evaluate(self.metrics)
        if self._finish_buf:
            # finished by a flush inside this iteration (a preemption)
            finished.extend(self._finish_buf)
            self._finish_buf.clear()
        return finished

    @torch.inference_mode()
    def run(self, max_steps: Optional[int] = None,
            on_degraded: str = "raise") -> Dict[int, np.ndarray]:
        """Drive ``step()`` until every request reached a terminal state;
        returns ``{rid: tokens}`` (prompt + continuation) for the requests
        drained in this call. A request that ends TIMED_OUT or CANCELLED
        raises ``DegradedRequest`` (``on_degraded="raise"``, the
        default), or with ``"return"`` its partial tokens are returned
        (JAX :2270-2300)."""
        if on_degraded not in ("raise", "return"):
            raise ValueError(f"on_degraded must be 'raise' or 'return', "
                             f"got {on_degraded!r}")
        out: Dict[int, np.ndarray] = {}
        steps = 0
        while self.scheduler.pending:
            for r in self.step():
                if r.state is not RequestState.FINISHED \
                        and on_degraded == "raise":
                    # the ring's state before the degraded drain surfaces
                    self.recorder.auto_dump(
                        f"degraded_request:{r.state.value}")
                    raise DegradedRequest(r)
                out[r.rid] = r.tokens
            steps += 1
            if max_steps is not None and steps >= max_steps \
                    and self.scheduler.pending:
                raise RuntimeError(
                    f"engine made no full drain in {max_steps} steps "
                    f"(queue={self.scheduler.queue_depth}, "
                    f"occupied={self.scheduler.occupied})")
        return out

    # --- degradation paths ------------------------------------------------

    def _expire_deadlines(self, finished: List[Request]) -> None:
        """End every in-flight request whose ``deadline_s`` has expired
        on the metrics clock ``TIMED_OUT`` (JAX :2309-2327), freeing its
        slot. The unit in flight lands first: a timed-out request keeps
        every token it generated, and one the flush finishes stays
        FINISHED."""
        now = self.metrics.clock()
        expired = [r for r in self._requests.values()
                   if r.deadline_s is not None
                   and now - r.submit_t >= r.deadline_s]
        if not expired:
            return
        self._flush_pending(finished)
        for r in expired:
            if r.rid not in self._requests:
                continue                 # finished by the flush
            self._terminate(r, RequestState.TIMED_OUT, finished)
            self.metrics.record_timeout(r.rid)

    def _poison(self, req: Request, err: Exception,
                finished: List[Request]) -> None:
        """Per-request work failed (JAX :2329): THIS request ends
        CANCELLED with ``req.error`` holding the cause, its slot is
        recycled, and every other stream goes on untouched. (An injected
        fault has dumped the flight recorder's ring as it fired.)"""
        if req.state in TERMINAL_STATES:
            raise err    # already terminal: nothing to isolate
        self._terminate(req, RequestState.CANCELLED, finished, error=err)
        self.metrics.record_cancelled(req.rid)

    def cancel(self, rid: int) -> Request:
        """Cancel an in-flight request by id (JAX :2339-2355); returns
        the terminal Request, evicted from the engine. The unit in flight
        lands first (its tokens are part of the result); if it finished
        the request, the FINISHED record is returned instead."""
        req = self._requests[rid]
        self._flush_pending()
        if rid not in self._requests:
            for i, r in enumerate(self._finish_buf):
                if r.rid == rid:
                    return self._finish_buf.pop(i)
            raise KeyError(rid)
        out: List[Request] = []
        self._terminate(req, RequestState.CANCELLED, out)
        self.metrics.record_cancelled(rid)
        return out[0]

    # --- replica handoff --------------------------------------------------

    def transfer_out(self, rid: int) -> Optional[Request]:
        """Detach a live request so another engine can ``transfer_in`` it
        (JAX :2359; the router's prefill->decode handoff and drain
        rebalance). An admitted request leaves through ``_preempt``: the
        unit in flight lands, its pages are freed and a decoding stream's
        key is taken from the slot's host mirror. Then it leaves the
        queue and the engine. Returns the request (QUEUED, slotless), or
        None when landing the unit in flight FINISHED it instead (this
        engine's next ``step()`` returns it)."""
        req = self._requests[rid]
        if req.state in (RequestState.PREFILLING, RequestState.DECODING):
            if not self._paged:
                raise RuntimeError(
                    "transfer_out of an admitted request needs the "
                    "paged engine (the resumable re-prefill path)")
            self._preempt(req)
            if req.state in TERMINAL_STATES:
                return None
        # a swap snapshot lives in THIS engine's host tier (and holds its
        # prefix-resident pages): the handoff resumes by re-prefill
        self._drop_swap(req)
        if req.state is not RequestState.QUEUED:
            raise RuntimeError(
                f"cannot transfer request {rid} in state "
                f"{req.state.value!r}")
        self.scheduler.waiting.remove(req)
        del self._requests[rid]
        self.metrics.record_transfer(rid)
        # ticks precede terminals: the deferred window may hold this
        # request's decode ticks, and on_terminal retires its timeline
        self._flush_host_window()
        self.tracer.on_terminal(rid, "transferred", len(req.generated))
        if self.recorder.enabled:
            self.recorder.record(
                "serving.transferred", engine=self.engine_id, rid=rid,
                n_generated=len(req.generated))
        return req

    def transfer_in(self, req: Request) -> int:
        """Admit a request detached from another engine (``transfer_out``)
        or rebuilt by the router after a replica's death (JAX :2407). It
        re-enters as a preempted request resumes: ``prompt +
        generated[:-1]`` re-prefills head-less here and decode continues
        from ``req.rng``, token for token (byte for byte when sampled)
        the single engine's stream. Returns a fresh LOCAL rid. A
        ``deadline_s`` restarts on this engine's clock (the router carries
        the remaining budget). Raises ``AdmissionRejected`` when the
        bounded queue is full."""
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("request prompt is empty")
        if prompt.size + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds the slot capacity "
                f"max_len={self.max_len}")
        if req.generated and not self._paged:
            raise ValueError(
                "transfer_in of a decode-progress request needs the "
                "paged engine (the resumable re-prefill path)")
        if self._paged:
            worst = self.pool.pages_for(prompt.size + req.max_new_tokens)
            if worst > self.pool.num_pages:
                raise ValueError(
                    f"request needs up to {worst} pages but the pool "
                    f"holds {self.pool.num_pages}")
        req.prompt = prompt
        req.rid = next(self._rid)
        req.slot = None
        req.prefill_pos = 0
        req.error = None
        # the source engine's page ids, shared lengths, donor and swap
        # snapshot refer to ITS pools: none of them may reach this one
        req.shared_len = 0
        req.n_shared_full = 0
        req.load_pages = []
        req.donor_ref = None
        req.swap = None
        if req.rng is None:
            req.rng = prng.key(req.seed).numpy()
        try:
            self.scheduler.submit(req)
        except AdmissionRejected:
            self.metrics.record_rejected()
            self.tracer.on_reject()
            self.recorder.note_rejection(
                rid=req.rid, engine=self.engine_id,
                queue_depth=self.scheduler.queue_depth,
                max_queue=self.scheduler.max_queue)
            raise
        self._requests[req.rid] = req
        req.submit_t = self.metrics.clock()
        self.metrics.record_submit(req.rid)
        self.tracer.on_submit(req.rid, self.scheduler.queue_depth)
        return req.rid

    def _terminate(self, req: Request, state: RequestState,
                   finished: List[Request],
                   error: Optional[BaseException] = None) -> None:
        """The degradation paths' terminal transition (JAX :2473): the
        request leaves the scheduler (its slot freed, pages returned, the
        slot's decode position parked on the sentinel so no later unit
        writes for it) and the engine; the caller owns it from here, as
        after ``_finish``. A unit launched before holds the slot's old
        (slot, rid) pair, so its tokens for the slot are discarded."""
        had_slot = req.state in (RequestState.PREFILLING,
                                 RequestState.DECODING)
        self.scheduler.cancel(req, state)
        self._comp_ver += 1
        if had_slot:
            self._t[req.slot] = self.max_len
            self._chain_dirty[req.slot] = True
            if self._draft is not None:
                self._draft.end_slot(req.slot)
            if self._paged:
                self.pool.release_slot(req.slot)
        if req.donor_ref is not None:
            # admitted with a copy-on-write donor hold but ended before
            # its prefill turn consumed it
            self.pool.decref(req.donor_ref)
            req.donor_ref = None
        # swapped out on a preemption, then ended before its swap-in
        self._drop_swap(req)
        req.error = error
        self.tracer.on_terminal(req.rid, state.value, len(req.generated))
        del self._requests[req.rid]
        finished.append(req)

    def health(self) -> Dict:
        """Readiness snapshot (JAX :2507-2571): accepting work, queue
        depth, slots, request tallies, the SLO status and the unified
        ``obs.telemetry_snapshot()``, and on a paged engine the pages
        (with the host tier's, None when it is off) and the prefix
        cache. ``status`` is "ok", "saturated" once the bounded queue is
        full, or "degraded" while accepting in breach of an SLO. The SLO
        evaluation here is a read (``record=False``): it appends no
        history and counts no breach, so polling cannot move the
        numbers. The deferred metrics samples are recorded first."""
        self._flush_host_window()
        sch = self.scheduler
        accepting = (sch.max_queue is None
                     or sch.queue_depth < sch.max_queue)
        m = self.metrics
        slo_status = (None if self.slo is None
                      else self.slo.evaluate(m, record=False))
        breaching = bool(slo_status) and any(
            st["breach"] for st in slo_status.values())
        out = {
            "status": ("saturated" if not accepting
                       else "degraded" if breaching else "ok"),
            "accepting": accepting,
            "slo": slo_status,
            "engine_id": self.engine_id,
            "device": str(self.device),
            "queue_depth": sch.queue_depth,
            "max_queue": sch.max_queue,
            "slots": {"total": self.num_slots, "occupied": sch.occupied,
                      "free": self.num_slots - sch.occupied},
            "requests": {"in_flight": len(self._requests),
                         "finished": m.requests_finished,
                         "rejected": m.requests_rejected,
                         "timed_out": m.requests_timed_out,
                         "cancelled": m.requests_cancelled,
                         "preempted": m.requests_preempted},
            "telemetry": obs.telemetry_snapshot(),
            "moe": (None if not self._moe else {
                "decode": self.moe_decode, "layers": len(self._moe),
                "concentration": (None if self._moe_conc is None
                                  else round(self._moe_conc, 4)),
                "expert_parallel": None}),
        }
        if self._paged:
            pool = self.pool
            out["pages"] = {
                "total": pool.num_pages, "free": pool.free_pages,
                "shared": pool.shared_pages, "page_len": pool.page_len,
                "fragmentation": round(self._fragmentation(), 4),
                "host": (None if pool.host_cache is None else {
                    "total": pool.host_pages,
                    "free": pool.host_free_pages,
                    "offloaded": pool.pages_offloaded,
                    "restored": pool.pages_restored})}
            out["prefix_cache"] = (None if self.prefix is None else {
                "nodes": len(self.prefix), "hit_rate": m.prefix_hit_rate})
        return out

    def _telemetry_summary(self) -> Dict:
        """The ``obs.attach`` provider (JAX :872-883): the CURRENT metrics
        window's summary plus the per-request timelines, the latest SLO
        status and the time series' descriptor."""
        self._flush_host_window()    # deferred samples land first
        snap = self.metrics.summary()
        if self.tracer.enabled:
            snap["requests"] = self.tracer.summaries()
        if self.slo is not None:
            snap["slo"] = self.slo.status()
        if self.timeseries is not None:
            snap["timeseries"] = self.timeseries.summary()
        return snap

    def _record_iteration(self, admitted: List[Request]) -> None:
        """The flight recorder's iteration entry (JAX :1164-1195),
        written before the iteration's prefill and decode run. The rid
        lists are rebuilt only when the batch composition changed
        (``_comp_ver``); a steady-state iteration writes an entry only on
        the host-window cadence. Everything recorded is host state."""
        if not self.recorder.enabled:
            return
        sch = self.scheduler
        if self._comp_ver != self._rec_cache[0]:
            self._rec_cache = (self._comp_ver, (
                [r.rid for r in sch.running.values()],
                [r.rid for r in sch.prefilling]))
        elif self._iters % self._host_window:
            return                      # steady state: window cadence
        decoding, prefilling = self._rec_cache[1]
        extra = {}
        if self._paged:
            extra["pages_free"] = self.pool.free_pages
            if self.pool.host_cache is not None:
                extra["host_pages_free"] = self.pool.host_free_pages
        self.recorder.record(
            "serving.iteration", engine=self.engine_id, iter=self._iters,
            queue_depth=sch.queue_depth, occupied=sch.occupied,
            decoding=decoding, prefilling=prefilling,
            admitted=[r.rid for r in admitted], **extra)

    # --- internals --------------------------------------------------------

    def _set_slot(self, req: Request, token: int, t: int) -> None:
        self._tok[req.slot] = token
        self._t[req.slot] = t         # where the next decode step writes
        self._keys[req.slot] = req.rng
        self._chain_dirty[req.slot] = True   # the host owns the input
        self._comp_ver += 1           # called as the request joins decode

    @staticmethod
    def _knob_arrays(rows, reqs, n: int):
        """The per-row sampling knobs ``(temperature, top_k, top_p)`` of
        ``n`` rows as host arrays: each request's on its rows, greedy
        elsewhere."""
        temp = np.zeros(n, np.float32)
        top_k = np.zeros(n, np.int64)
        top_p = np.ones(n, np.float32)
        for row, r in zip(rows, reqs):
            temp[row], top_k[row], top_p[row] = (r.temperature, r.top_k,
                                                 r.top_p)
        return [temp, top_k, top_p]

    def _sample(self, logits, rows: List[int], reqs: List[Request],
                fused: bool = False, keys=None):
        """Next tokens ``[n]`` for the logits rows, on their device:
        argmax for an all-greedy batch, else the per-row sampler with
        ``keys`` (``[n, 2]`` per-row keys, or one key for one row):
        ``_sample_vec``, or with ``fused`` the fused epilogue, which
        gives the same tokens. Reads nothing back from the card."""
        if all(r.temperature <= 0.0 for r in reqs):
            return torch.argmax(logits, dim=-1)
        knobs = stage(self._knob_arrays(rows, reqs, logits.shape[0]),
                      logits.device)
        sampler = sample_tokens if fused else _sample_vec
        return sampler(logits, *knobs, keys)

    def _sample_first(self, logits, req: Request) -> int:
        """A request's first token from its prefill logits ``[1, V]``
        (JAX ``_sample_first_fn`` :1806): ``rng, sub = split(req.rng)``,
        then the unfused sampler with ``sub``; ``req.rng`` becomes
        ``rng``. A greedy request's key draws nothing and stays. One read
        of the card: the token and the new key together."""
        if req.temperature <= 0.0:
            return int(self._sample(logits, [0], [req])[0])
        pair = prng.split(stage([req.rng], self.device)[0])
        tok = self._sample(logits, [0], [req], keys=pair[1])
        host = torch.cat([tok.view(1), pair[0]]).cpu().numpy()
        req.rng = host[1:].copy()
        return int(host[0])

    def _swap_in(self, req: Request) -> None:
        """The swap-in resume (JAX :2583-2615): the snapshot's host pages
        are copied into the pages ``_apply_page_plan`` wired into the
        table, byte for byte, and the stream rejoins decode where it
        left off. No prefill chunk runs."""
        t0 = self.metrics.clock()
        swap = req.swap
        row = self.pool.tables[req.slot]
        self.pool.restore_pages(swap["host"],
                                [int(row[int(lp)]) for lp in swap["logical"]])
        self.pool.free_host(swap["host"])
        req.swap = None
        self.scheduler.to_decoding(req)
        self._set_slot(req, req.generated[-1], swap["t"])
        self._begin_draft(req, req.context_tokens)
        self.metrics.record_swap_resume(self.metrics.clock() - t0,
                                        len(req.context_tokens))
        self.tracer.on_swap_in(req.rid, len(swap["host"]))
        self.tracer.on_resume(req.rid)

    def _advance_prefill(self, req: Request, finished: List[Request]):
        # chaos hook (JAX :2581): a raise here is the poisoned request
        # step() isolates; a stall is the slow prefill
        faults.point("serving.prefill")
        if req.swap is not None:
            self._swap_in(req)
            return
        if not self._paged:
            self._advance_prefill_slab(req, finished)
            return
        toks = req.context_tokens
        p_len = len(toks)
        resume = bool(req.generated)
        if resume and req.prefill_pos == 0 and req.resume_t0 is None:
            # the re-prefill resume's clock: first chunk to rejoining
            req.resume_t0 = self.metrics.clock()
        if req.prefill_pos == 0:
            if self.prefix is not None:
                self._rematch_at_prefill(req)
                self.metrics.record_prefix_lookup(req.shared_len, p_len)
            if req.shared_len:
                # prefix-cache hit: the shared pages (and the
                # copy-on-write donor) become the staging prefix; their
                # prefill compute never runs
                self._staging = self.pool.load_prefix(
                    self._staging, req.load_pages, req.shared_len)
                req.prefill_pos = req.shared_len
                self.tracer.on_prefix_hit(req.rid, req.shared_len)
            if req.donor_ref is not None:
                self.pool.decref(req.donor_ref)
                req.donor_ref = None
        logits, final = self._prefill_chunk(req, toks, resume)
        if not final:
            return
        # write ONLY the pages the context fills, minus the shared ones
        self.pool.insert_pages(self._staging, req.slot, req.n_shared_full,
                               p_len)
        if self.prefix is not None:
            self.prefix.register(toks, self.pool.tables[req.slot])
        if resume:
            self.scheduler.to_decoding(req)
            self._set_slot(req, req.generated[-1], p_len)
            self._begin_draft(req, toks)
            if req.resume_t0 is not None:
                self.metrics.record_reprefill_resume(
                    self.metrics.clock() - req.resume_t0,
                    p_len - req.shared_len)
                req.resume_t0 = None
            self.tracer.on_resume(req.rid)
            return
        self._first_token(req, logits, toks, finished)

    def _advance_prefill_slab(self, req: Request, finished: List[Request]):
        """A slab engine's prefill turn (JAX :2617-2675): the prompt's
        chunks into the staging cache, then ``insert`` writes only the
        positions it filled into the slot's row. No prefix cache, no
        preemption, so no resume."""
        logits, final = self._prefill_chunk(req, req.prompt, False)
        if not final:
            return
        self.pool.insert(self._staging, req.slot, n_pos=len(req.prompt))
        self._first_token(req, logits, req.prompt, finished)

    def _prefill_chunk(self, req: Request, toks, resume: bool):
        """Run the request's next prefill chunk into the staging cache;
        returns ``(logits, final)``. A resume re-prefill runs head-less:
        its tokens are decided."""
        p_len = len(toks)
        t0 = req.prefill_pos
        if self.prefill_chunk is None:
            q_len, final = p_len - t0, True
        else:
            q_len = min(self.prefill_chunk, p_len - t0)
            final = t0 + q_len >= p_len
        head = final and not resume
        chunk = torch.as_tensor(toks[None, t0:t0 + q_len],
                                dtype=torch.long, device=self.device)
        if t0 == 0 and head:
            logits, self._staging = prefill(self.module, self._params,
                                            self._staging, chunk)
        else:
            logits, self._staging = prefill_chunk_step(
                self.module, self._params, self._staging, chunk, t0,
                final=head)
        req.prefill_pos = t0 + q_len
        self.metrics.record_prefill_chunk()
        self.tracer.on_prefill_chunk(req.rid, t0, q_len)
        return logits, final

    def _first_token(self, req: Request, logits, toks,
                     finished: List[Request]) -> None:
        """Sample a request's first token from its prefill logits and
        start its decode (or finish it)."""
        p_len = len(toks)
        if self.on_logits is not None:
            self.on_logits("prefill", logits, [0])
        token = self._sample_first(logits, req)            # prefill's sync
        req.generated.append(token)
        self.metrics.record_first_token(req.rid)
        self.tracer.on_first_token(req.rid)
        if req.done:
            self._finish(req, finished)
            return
        self.scheduler.to_decoding(req)
        self._set_slot(req, token, p_len)
        self._begin_draft(req, toks)

    def _advance_decode(self, finished: List[Request]):
        """The decode phase (JAX :2737): grow pages, then a speculative
        iteration (synchronous, the pipeline drained first) or ONE decode
        unit, a step or a fused window. Under ``overlap`` the unit is
        launched before the previous one is consumed; without it the
        unit is consumed at once."""
        # chaos hook (JAX :2743), before any state of this iteration
        # changes: a decode error leaves the iteration retryable whole
        faults.point("serving.decode")
        spec = self._draft is not None and bool(self._spec_slots())
        if spec:
            # the drafts read the host's tokens: drain the pipeline, then
            # the verify's own fetch is this iteration's sync
            self._flush_pending(finished)
            if not self.scheduler.running:
                return
        fuse = 0 if spec else self._fuse_window()
        if spec and self.spec_tree:
            # the page lookahead depends on the proposed tree, so the
            # proposal comes before page growth: the whole iteration
            # lives in _spec_tree_step
            self._spec_tree_step(finished)
            return
        running = self.scheduler.running
        look = None
        if spec:
            look = np.zeros(self.num_slots, np.int64)
            for slot, r in running.items():
                if self._spec_eligible(r):
                    look[slot] = min(self.spec_k, r.max_new_tokens
                                     - len(r.generated) - 1)
        elif fuse:
            # every position the window writes (the frontier _t already
            # counts the unit in flight)
            look = np.zeros(self.num_slots, np.int64)
            look[list(running)] = fuse - 1
        if self._paged:
            # a slab row holds every position: nothing to grow
            self._ensure_decode_pages(look)
        if not running:
            return
        t0 = self.metrics.clock()
        if spec and self._spec_slots():  # growth may have preempted them
            self._spec_step(finished, t0)
            return
        if fuse and self.scheduler.queue_depth:
            # funding the window preempted a stream: quiescence is gone,
            # one step now, the window rejoins later (the grown pages are
            # real write positions)
            fuse = 0
        greedy_only = all(r.temperature <= 0.0 for r in running.values())
        prev = self._pending
        pend = self._launch_step(greedy_only, fuse, prev, t0)
        if self.overlap:
            # the new unit runs while the host consumes the previous one
            self._pending = pend
            if prev is not None:
                self._process_step(prev, finished, t0)
        else:
            self._process_step(pend, finished, t0)

    # --- the zero-bubble loop: pipelined dispatch, deferred host work ------

    #: iterations between deferred metrics flushes under ``overlap``
    #: (the synchronous loop flushes every iteration); terminals and
    #: metrics swaps flush at once, so counts stay exact
    _HOST_WINDOW = 8
    #: iterations between recompile-detector polls
    _RECOMPILE_CHECK_EVERY = 64
    #: iterations between SLO evaluations (when ``slo`` is set)
    _SLO_EVAL_EVERY = 32

    @property
    def metrics(self) -> ServingMetrics:
        return self._metrics

    @metrics.setter
    def metrics(self, value: ServingMetrics) -> None:
        """Swapping the metrics window (one per reporting interval) first
        drains the pipeline and the deferred samples into the OLD window
        (JAX :888-901), so no sample crosses windows."""
        if getattr(self, "_metrics", None) is not None:
            self._flush_pending(self._finish_buf)
            self._flush_host_window()
        self._metrics = value

    def _post(self, outputs):
        """Queue a launched unit's outputs for the host: on the card,
        non-blocking copies into pinned buffers behind the unit's
        kernels and an event after them; on the CPU the outputs are
        already there. Returns ``(host tensors, event or None)``."""
        if self.device.type != "cuda":  # lint: allow-device-fork (staging)
            return outputs, None
        host = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                for x in outputs]
        for h, x in zip(host, outputs):
            h.copy_(x, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _fetch(self, p: _PendingStep):
        """THE decode loop's host sync (JAX :903): wait for a launched
        unit's host copies and read them, ``(tokens [S, count], keys [S,
        2] or None, MoE stats or None)``. ``fetch_seconds`` totals the
        time blocked here."""
        t0 = self._metrics.clock()
        if p.event is not None:
            p.event.synchronize()  # lint: allow-host-sync (the lagged read)
        # views of the pinned host copies (np.asarray of a CUDA tensor
        # raises, so it can hide no sync)
        host = [np.asarray(h) for h in p.host]
        self.fetch_seconds += self._metrics.clock() - t0
        toks = host.pop(0)
        toks = toks if toks.ndim == 2 else toks[:, None]
        keys = None if p.keys is None else host.pop(0)
        stats = None if not host else {"expert_load": host[0],
                                       "router_entropy": host[1]}
        return toks, keys, stats

    def _flush_pending(self, out: Optional[List[Request]] = None) -> None:
        """Consume the in-flight unit, if any (JAX :915); the requests it
        finishes go to ``out`` (default: ``_finish_buf``). After it the
        host owns every slot's next input token."""
        p = self._pending
        if p is None:
            return
        self._pending = None
        self._process_step(p, self._finish_buf if out is None else out)
        self._chain_dirty[:] = True

    def _process_step(self, p: _PendingStep, finished: List[Request],
                      t0: Optional[float] = None) -> None:
        """Consume one launched unit (JAX :927): fetch its tokens, append
        each covered stream's up to its stop or budget, finish what is
        done. A slot whose request changed since the launch (finished,
        preempted, recycled) discards its tokens: at lag 1 a stream is
        stepped at most once past its stop, and that token and its cache
        write are never read. ``t0`` is the consuming iteration's decode
        start (the decode sample spans dispatch, fetch and consume, as
        the synchronous loop's does); an out-of-band flush records from
        the launch."""
        running = self.scheduler.running
        if not any(running.get(s) is not None and running[s].rid == r
                   for s, r in p.slots):
            return            # every covered stream retired: drop it whole
        toks, keys, stats = self._fetch(p)
        if keys is not None:
            # chain-live slots take the unit's post-split keys; a slot
            # the host took over since its launch keeps its mirror
            live = ~self._chain_dirty
            self._keys[live] = keys[live]
        self._note_moe_route(stats)
        now = self._metrics.clock()
        trace_on = self.tracer.enabled
        done: List[Request] = []
        n_emitted = 0
        for slot, rid in p.slots:
            req = running.get(slot)
            if req is None or req.rid != rid:
                continue                     # recycled slot: discard
            n_app = 0
            for j in range(p.count):
                req.generated.append(int(toks[slot, j]))
                n_app += 1
                if req.done:
                    break                    # stop or budget mid-window
            n_emitted += n_app
            self._tok[slot] = req.generated[-1]
            if trace_on and n_app:
                self._trace_tick(rid, n_app, now)
            if req.done:
                done.append(req)
        self._decode_buf.append(
            (len(p.slots), now - (p.launch_t if t0 is None else t0),
             n_emitted))
        if done:
            self._flush_host_window()        # samples precede terminals
            for req in done:
                self._finish(req, finished)

    def _flush_host_window(self) -> None:
        """Record the deferred samples in the live metrics window (JAX
        :988): iteration samples and the page gauges, decode token and
        time totals, the speculation counters. Runs every
        ``_host_window`` iterations, before every terminal, on a metrics
        swap and when the engine drains."""
        m = self._metrics
        if self._iter_buf:
            for qd, occ in self._iter_buf:
                m.record_iteration(qd, occ, self.num_slots)
            self._iter_buf.clear()
            if self._paged:
                pool = self.pool
                m.record_pages(pool.free_pages, pool.shared_pages,
                               self._fragmentation())
                # the host tier's odometers are cumulative: the metrics
                # window gets the deltas since the last flush
                odo = (pool.pages_offloaded, pool.pages_restored,
                       pool.offload_bytes)
                if odo[0] > self._off_seen[0] or odo[1] > self._off_seen[1]:
                    m.record_offload(*(a - b for a, b in
                                       zip(odo, self._off_seen)))
                    self._off_seen = odo
        for n, dt, n_tok in self._decode_buf:
            m.record_decode(n, dt, n_tokens=n_tok)
        self._decode_buf.clear()
        for proposed, accepted in self._spec_buf:
            m.record_spec_verify(proposed, accepted)
        self._spec_buf.clear()
        for width, path_len, depth in self._spec_tree_buf:
            m.record_spec_tree(width, path_len, depth)
        self._spec_tree_buf.clear()
        if self._trace_decode:
            if self.tracer.enabled:
                self.tracer.on_decode_batch(self._trace_decode,
                                            t0=self._trace_decode_t0)
            self._trace_decode = {}
            self._trace_decode_t0 = None
        if self._trace_spec:
            if self.tracer.enabled:
                # linear entries [proposed, accepted]; tree entries add
                # [tree_width, accepted_path_len]
                self.tracer.on_spec_verify(
                    [(rid, *pa) for rid, pa in self._trace_spec.items()])
            self._trace_spec = {}

    def _trace_tick(self, rid: int, n: int, now: float) -> None:
        """Defer ``n`` decode ticks of ``rid`` to the next host-window
        flush (the tracer sees one batch a window)."""
        self._trace_decode[rid] = self._trace_decode.get(rid, 0) + n
        if self._trace_decode_t0 is None:
            self._trace_decode_t0 = now

    def _inflight(self) -> Dict[int, int]:
        """slot -> tokens in flight for the slot's CURRENT request (JAX
        :1042); a pending unit older than the occupant counts none."""
        p = self._pending
        if p is None:
            return {}
        running = self.scheduler.running
        return {slot: p.count for slot, rid in p.slots
                if running.get(slot) is not None
                and running[slot].rid == rid}

    def _fuse_window(self) -> int:
        """This iteration's fused-window size (JAX :1069): ``fuse_steps``
        when the batch is quiescent, else 0 (one step). Quiescent:
        nothing queued or prefilling (admission would wait K steps) and
        every stream's remaining budget, net of its tokens in flight,
        covering the window (the stop masks run on the device; the budget
        has none), and no deadline in the batch (expiry is checked once
        per iteration)."""
        k = self.fuse_steps
        if k < 2:
            return 0
        sch = self.scheduler
        if sch.queue_depth or sch.prefilling or not sch.running:
            return 0
        infl = self._inflight()
        for slot, r in sch.running.items():
            if r.deadline_s is not None:
                return 0
            if r.max_new_tokens - len(r.generated) - infl.get(slot, 0) < k:
                return 0
        return k

    def _launch_step(self, greedy_only: bool, fuse: int,
                     prev: Optional[_PendingStep],
                     t0: float) -> _PendingStep:
        """Launch one decode unit, a step or a ``fuse``-wide window,
        WITHOUT waiting for it (JAX :1096). The input tokens chain on the
        device from the in-flight unit's feedback (``prev.last``) where
        the chain is live, and come from the host for slots the host
        took over since (a new stream, a flush); a sampled unit's
        per-slot keys chain the same way (``prev.keys``, else the host
        mirror: JAX's ``_merge_keys`` :1056). Host arrays go through
        ``stage`` (pinned, non-blocking), the outputs' host copies are
        queued behind the kernels: on the card the launch never waits
        for it. The host frontier ``_t`` moves past the positions the
        unit writes, so page growth and the next launch see it."""
        running = self.scheduler.running
        dirty = self._chain_dirty
        slots = tuple((slot, r.rid) for slot, r in running.items())
        live, reqs = list(running), list(running.values())
        own = prev is None or dirty.all()    # the host's tokens only
        mix = not own and dirty.any()        # the host's where dirty
        sampled = not greedy_only
        # the keys chain from the unit in flight only if it carried some
        own_keys = own or prev.keys is None
        host = [self._t] + ([self._tok] if own or mix else []) \
            + ([dirty] if mix else [])
        if sampled:
            if fuse:
                host += self._knob_arrays(live, reqs, self.num_slots)
            if own_keys or mix:
                host.append(self._keys)
        if fuse:
            stop = np.full(self.num_slots, -1, np.int64)
            for slot, r in running.items():
                stop[slot] = r.stop_token
            host.append(stop)
        staged = iter(stage(host, self.device))
        t_dev = next(staged)
        if own:
            tok = next(staged)
        elif mix:
            tok = next(staged)
            dirty_dev = next(staged)
            tok = torch.where(dirty_dev, tok, prev.last)
        else:
            tok = prev.last
        keys = None
        if sampled:
            knobs = [next(staged) for _ in range(3)] if fuse else None
            if own_keys:
                keys = next(staged)
            elif mix:
                keys = torch.where(dirty_dev[:, None], next(staged),
                                   prev.keys)
            else:
                keys = prev.keys
        tables = self._tables()
        kw = self._moe_step_kw()
        on_logits = None
        if self.on_logits is not None:
            def on_logits(logits):
                self.on_logits("decode", logits, live)
        if fuse:
            knob_kw = {}
            if sampled:
                knob_kw = dict(zip(("temperature", "top_k", "top_p"), knobs),
                               keys=keys, sampler=(
                                   sample_tokens if self.fused_sampling
                                   else _sample_vec))
            nxt, _, keys, stats = decode_fused_slots(
                self.module, self._params, self.pool.cache, tok, t_dev,
                next(staged), fuse, tables, self.page_len,
                on_logits=on_logits, paged_kernel=self._paged_kernel,
                **knob_kw, **kw)
            last, count = nxt[:, -1], fuse
        else:
            logits, _, *moe = self._decode_step(tok, t_dev, tables, **kw)
            if on_logits is not None:
                on_logits(logits)
            if sampled:
                # one split of every slot's key: the second half draws,
                # the first carries (JAX :1358-1361)
                pair = prng.split(keys)
                keys = pair[:, 0]
            nxt = self._sample(logits, live, reqs, self.fused_sampling,
                               None if keys is None else pair[:, 1])
            stats = moe[0] if moe else None
            last, count = nxt, 1
        outputs = [nxt] + ([keys] if keys is not None else []) \
            + ([] if stats is None else [stats["expert_load"],
                                         stats["router_entropy"]])
        host_out, event = self._post(outputs)
        for slot, _ in slots:
            self._t[slot] += count
            dirty[slot] = False          # the chain is live until overridden
        return _PendingStep(last, keys, host_out, event, slots, count, t0)

    def _tables(self):
        """The page tables on the device, or None for a slab engine."""
        return self.pool.device_tables() if self._paged else None

    def _decode_step(self, tok, t, tables, **kw):
        """One decode step over every slot: the paged step, or the slab
        step (JAX :1319-1325)."""
        if tables is None:
            return decode_step_slots(self.module, self._params,
                                     self.pool.cache, tok, t, **kw)
        return decode_step_slots_paged(
            self.module, self._params, self.pool.cache, tok, t, tables,
            self.page_len, paged_kernel=self._paged_kernel, **kw)

    def _verify_step(self, toks, t, tables, **kw):
        """One verify window over every slot: the paged window, or the
        slab window (JAX :1480-1487)."""
        if tables is None:
            return verify_step_slots(self.module, self._params,
                                     self.pool.cache, toks, t, **kw)
        return verify_step_slots_paged(
            self.module, self._params, self.pool.cache, toks, t, tables,
            self.page_len, paged_kernel=self._paged_kernel, **kw)

    # --- MoE routing telemetry / admission cost ----------------------------

    #: EMA smoothing of the routing-concentration estimate
    _MOE_CONC_ALPHA = 0.25
    #: decode iterations between MoE routing-stats reads; the first one
    #: always reads. Only those steps compute the stats and fetch them:
    #: the engine's decode step is host bound
    _MOE_STATS_EVERY = 16
    #: admission headroom per unit concentration (pages, as a fraction
    #: of the request's context pages)
    _MOE_ADMIT_ALPHA = 0.5

    def _moe_step_kw(self) -> Dict:
        """The MoE keywords of one decode or verify step: the dispatch,
        and ``moe_stats`` (the live-position bound) on the steps whose
        stats are read, every ``_MOE_STATS_EVERY``-th from the first."""
        if not self._moe:
            return {}
        kw = {"moe_dispatched": self._moe_dispatched}
        if self._moe_stats_on:
            n = self._moe_iter
            self._moe_iter = n + 1
            if n % self._MOE_STATS_EVERY == 0:
                kw["moe_stats"] = self.max_len
        return kw

    def _note_moe_route(self, stats) -> None:
        """Host sink of one read step's routing stats (JAX :819; ``stats``
        the host copies ``{"expert_load", "router_entropy"}``, or None):
        the expert-load and entropy gauges and the concentration EMA the
        admission reads (0 = balanced routing, 1 = every assignment on
        one expert)."""
        if stats is None:
            return
        load = np.asarray(stats["expert_load"], np.float64)
        entropy = float(stats["router_entropy"])
        total = float(load.sum())
        e = len(load)
        share = float(load.max()) / total if total > 0 else 0.0
        if total > 0 and e > 1:
            conc = max(0.0, (share - 1.0 / e) / (1.0 - 1.0 / e))
            a = self._MOE_CONC_ALPHA
            self._moe_conc = (conc if self._moe_conc is None
                              else (1.0 - a) * self._moe_conc + a * conc)
        self.metrics.record_moe_route(load, entropy, self._moe_conc or 0.0)
        if self.tracer.enabled:
            self.tracer.on_moe_route(
                [r.rid for r in self.scheduler.running.values()],
                entropy, share)

    def _moe_admit_extra(self, req: Request, n_logical: int) -> int:
        """Pages of headroom (beyond the request's own) the free-page
        budget must show before this admission, in proportion to the
        smoothed routing concentration (JAX :852). Capped so a feasible
        request always admits into an idle pool."""
        if not self._moe_stats_on or not self._moe_conc:
            return 0
        extra = int(math.ceil(
            self._MOE_ADMIT_ALPHA * self._moe_conc * n_logical))
        worst = self.pool.pages_for(len(req.prompt) + req.max_new_tokens)
        return max(0, min(extra, self.pool.num_pages - worst))

    # --- speculation --------------------------------------------------------

    #: EMA smoothing of the per-request acceptance rate
    _SPEC_EMA_ALPHA = 0.25
    #: re-probe coin odds: one in this many eligible positions fires (a
    #: crc32 of (seed, rid, position), not an RNG draw)
    _SPEC_REPROBE_ONE_IN = 8
    #: adaptive tree controller: an EMA at or above this widens a stream
    #: toward (spec_k, spec_width), below the demote line it narrows
    _TREE_PROMOTE_EMA = 0.6
    _TREE_DEMOTE_EMA = 0.25

    def _spec_eligible(self, req: Request) -> bool:
        """Could this request speculate (knob on, not disabled)?"""
        return (self._draft is not None and req.speculate
                and not req.spec_disabled)

    def _spec_slots(self) -> List[int]:
        """Decoding slots that speculate this iteration; a disabled
        stream gets its re-probe chance here."""
        out = []
        for slot, r in self.scheduler.running.items():
            if r.spec_disabled and self.spec_reprobe is not None:
                self._maybe_reprobe(r)
            if self._spec_eligible(r):
                out.append(slot)
        return out

    def _spec_disable(self, req: Request) -> None:
        """Kill switch: the stream decodes plainly from here on (sticky
        unless ``spec_reprobe``)."""
        req.spec_disabled = True
        req.spec_disabled_at = len(req.generated)
        self.metrics.record_spec_disabled()
        if self._draft is not None and req.slot is not None:
            self._draft.end_slot(req.slot)

    def _maybe_reprobe(self, req: Request) -> None:
        """Once a disabled stream has generated ``spec_reprobe`` more
        tokens, each position flips a deterministic coin; on success it
        rejoins with a fresh warm-up (the draft must re-adopt the slot,
        or the stream is disabled again)."""
        if self._draft is None or not req.speculate or req.slot is None:
            return
        since = len(req.generated) - (req.spec_disabled_at or 0)
        if since < self.spec_reprobe:
            return
        coin = zlib.crc32(
            f"{req.seed}:{req.rid}:{len(req.generated)}".encode())
        if coin % self._SPEC_REPROBE_ONE_IN:
            return
        req.spec_disabled = False
        req.spec_disabled_at = None
        req.spec_ema = None
        req.spec_checks = 0
        if self._draft.begin_slot(req.slot, req.context_tokens):
            self.metrics.record_spec_reenabled()
        else:
            self._spec_disable(req)

    def _observe_acceptance(self, req: Request, rate: float) -> None:
        """Update the acceptance EMA; below ``spec_disable_below`` after
        ``spec_warmup`` verifies the stream goes back to plain decode."""
        a = self._SPEC_EMA_ALPHA
        req.spec_ema = (rate if req.spec_ema is None
                        else (1.0 - a) * req.spec_ema + a * rate)
        req.spec_checks += 1
        if req.spec_checks >= self.spec_warmup \
                and req.spec_ema < self.spec_disable_below:
            self._spec_disable(req)

    def _tree_shape(self, req: Request):
        """The stream's (depth, width) for the next tree verify, depth
        clamped to ``remaining - 1`` (the last emitted token is always the
        free one); depth < 1 rides the window as a plain decode step."""
        if req.tree_depth is None:
            req.tree_depth = self.spec_k
            req.tree_width = self.spec_width
        remaining = req.max_new_tokens - len(req.generated)
        return min(req.tree_depth, remaining - 1), req.tree_width

    def _adapt_tree(self, req: Request) -> None:
        """Resize a stream's tree from its EMA after the warm-up: hot
        streams deepen, then widen; cold ones shed width, then depth."""
        ema = req.spec_ema
        if ema is None or req.spec_checks < self.spec_warmup:
            return
        if ema >= self._TREE_PROMOTE_EMA:
            if req.tree_depth < self.spec_k:
                req.tree_depth += 1
            elif req.tree_width < self.spec_width:
                req.tree_width += 1
        elif ema < self._TREE_DEMOTE_EMA:
            if req.tree_width > 1:
                req.tree_width -= 1
            elif req.tree_depth > 1:
                req.tree_depth -= 1

    def _begin_draft(self, req: Request, context) -> None:
        """Hand the draft source the request's context as it joins
        decode; a source that cannot serve the slot disables speculation
        for this request only."""
        if not self._spec_eligible(req):
            return
        if not self._draft.begin_slot(req.slot, context):
            self._spec_disable(req)

    def _walk(self, logits, toks, parents):
        """``tree_walk`` over the verify logits: greedy for an all-greedy
        batch, else from the slots' keys (the host mirror: a speculative
        iteration runs with the pipeline drained), one split per emitted
        token; the walked keys become the mirror (JAX :1519-1530)."""
        running = self.scheduler.running
        if all(r.temperature <= 0.0 for r in running.values()):
            return tree_walk(logits, toks, parents)[:3]
        temp, top_k, top_p, keys = stage(
            self._knob_arrays(list(running), list(running.values()),
                              self.num_slots) + [self._keys], self.device)
        emitted, n_emit, path, keys = tree_walk(
            logits, toks, parents, temperature=temp, top_k=top_k,
            top_p=top_p, keys=keys)
        self._keys = keys.cpu().numpy().copy()
        return emitted, n_emit, path

    def _spec_step(self, finished: List[Request], t0: float) -> None:
        """One linear draft-and-verify iteration over the decode batch:
        the ``[S, k+1]`` window ``[tok, d_1 .. d_k]`` in one verify pass,
        accepted as the longest prefix of drafts the target's own choices
        match (the walk of a chain). Non-speculating slots get no drafts,
        so for them the verify is a plain decode step."""
        k = self.spec_k
        running = self.scheduler.running
        active = np.zeros(self.num_slots, bool)
        for slot, r in running.items():
            active[slot] = self._spec_eligible(r)
        drafts = np.zeros((self.num_slots, k), np.int32)
        self._draft.propose(dict(running), self._tok, self._t, drafts,
                            active)
        toks = np.concatenate([self._tok[:, None], drafts], axis=1) \
            .astype(np.int64)
        parents = np.full((self.num_slots, k + 1), -1, np.int64)
        parents[active, 1:] = np.arange(k)
        toks_d, t_d = stage([toks, self._t], self.device)
        logits, _, *moe = self._verify_step(toks_d, t_d, self._tables(),
                                            **self._moe_step_kw())
        self._note_moe_route(_host_stats(moe))
        if self.on_logits is not None:
            self.on_logits("verify", logits, list(running.keys()))
        emitted, n_emit, _ = self._walk(logits, toks, parents)

        def note(slot, req, trace_on):
            m = int(n_emit[slot]) - 1
            self._spec_buf.append((k, m))
            self._observe_acceptance(req, m / k)
            if trace_on:
                pa = self._trace_spec.setdefault(req.rid, [0, 0])
                pa[0] += k
                pa[1] += m

        self._consume_spec(emitted, n_emit, active, note, finished, t0)

    def _spec_tree_step(self, finished: List[Request]) -> None:
        """One tree draft-and-verify iteration: (1) each eligible stream's
        tree from ``propose_tree`` under its adaptive shape and a node
        budget capped by the slot's capacity; (2) pages for the proposed
        node span (the verify writes window columns ``t .. t + n_nodes -
        1``); (3) the tree-masked verify, the walk and the commit of the
        accepted path; (4) the host consume, the EMA on the longest-chain
        basis (``path_len / depth``) and ``_adapt_tree``. The decode
        time recorded covers the proposal too, as the linear step's
        does."""
        t0 = self.metrics.clock()
        w_len = self.spec_window
        running = self.scheduler.running
        s_n = self.num_slots
        toks = np.zeros((s_n, w_len), np.int64)
        toks[:, 0] = self._tok
        parents = np.full((s_n, w_len), -1, np.int64)
        active = np.zeros(s_n, bool)
        depth_v = np.zeros(s_n, np.int32)
        width_v = np.ones(s_n, np.int32)
        budget_v = np.zeros(s_n, np.int32)
        for slot, r in running.items():
            if not self._spec_eligible(r):
                continue
            d, w = self._tree_shape(r)
            if d < 1:
                continue
            active[slot] = True
            depth_v[slot] = d
            width_v[slot] = w
            budget_v[slot] = min(d * w,
                                 self.max_len - 1 - int(self._t[slot]))
        if active.any():
            self._draft.propose_tree(dict(running), self._tok, self._t,
                                     toks, parents, active, depth_v,
                                     width_v, budget_v)
        depth, anc, n_nodes = tree_ancestors(parents)
        if self._paged:
            self._ensure_decode_pages(
                np.where(active, n_nodes - 1, 0).astype(np.int64))
        running = self.scheduler.running
        if not running:
            return
        toks_d, t_dev, depth_d, anc_d = stage([toks, self._t, depth, anc],
                                              self.device)
        tables = self._tables()
        logits, _, kv_win, *moe = self._verify_step(
            toks_d, t_dev, tables, tree={"depth": depth_d, "anc": anc_d},
            **self._moe_step_kw())
        self._note_moe_route(_host_stats(moe))
        if self.on_logits is not None:
            self.on_logits("verify", logits, list(running.keys()))
        emitted, n_emit, path = self._walk(logits, toks, parents)
        commit_tree_path(self.pool.cache, kv_win, path, t_dev, n_emit,
                         tables, self.page_len)

        def note(slot, req, trace_on):
            nd = int(n_nodes[slot]) - 1         # draft nodes offered
            m = int(n_emit[slot]) - 1           # accepted path length
            self._spec_buf.append((nd, m))
            self._spec_tree_buf.append((int(width_v[slot]), m,
                                        int(depth_v[slot])))
            self._observe_acceptance(req, m / max(1, int(depth_v[slot])))
            self._adapt_tree(req)
            if trace_on:
                pa = self._trace_spec.setdefault(req.rid, [0, 0, 0, 0])
                pa[0] += nd
                pa[1] += m
                pa[2] = max(pa[2], int(width_v[slot]))
                pa[3] = max(pa[3], m)

        self._consume_spec(emitted, n_emit, active, note, finished, t0)

    def _consume_spec(self, emitted, n_emit, active, note,
                      finished: List[Request], t0: float) -> None:
        """Append ``emitted[slot, :n_emit[slot]]`` to each running request
        up to its stop token or budget (mid-window), advance the slot
        mirrors, defer the tracer's ticks, run ``note(slot, req,
        trace_on)`` for each speculating slot, then finish the requests
        that are done (the deferred work lands first: the last verify's
        outcome belongs on the timeline the terminal retires)."""
        running = self.scheduler.running
        now = self.metrics.clock()
        trace_on = self.tracer.enabled
        n_emitted = 0
        done = []
        for slot, req in list(running.items()):
            appended = 0
            for token in emitted[slot, :int(n_emit[slot])]:
                req.generated.append(int(token))
                appended += 1
                if req.done:
                    break               # stop token / budget mid-window
            n_emitted += appended
            self._tok[slot] = req.generated[-1]
            self._t[slot] += appended
            if trace_on:
                self._trace_tick(req.rid, appended, now)
            if active[slot]:
                note(slot, req, trace_on)
            if req.done:
                done.append(req)
        self._decode_buf.append((len(running), now - t0, n_emitted))
        if done:
            self._flush_host_window()        # samples precede terminals
        for req in done:
            self._finish(req, finished)

    def _finish(self, req: Request, finished: List[Request]):
        slot = req.slot
        self.scheduler.release(req)
        self._comp_ver += 1
        if self._draft is not None:
            self._draft.end_slot(slot)
        self._t[slot] = self.max_len
        self._chain_dirty[slot] = True
        if self._paged:
            # pages return to the budget; registered prefix pages survive
            # under the prefix cache's own reference
            self.pool.release_slot(slot)
        self.metrics.record_finish(req.rid, len(req.generated))
        self.tracer.on_terminal(req.rid, RequestState.FINISHED.value,
                                len(req.generated))
        del self._requests[req.rid]
        finished.append(req)
