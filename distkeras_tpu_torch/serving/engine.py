"""Slot-based continuous-batching engine over the port's paged decode
path.

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
variant for all-greedy batches, the per-slot sampler otherwise),
growing pages first (``_ensure_decode_pages`` :2107) and preempting the
youngest lowest-priority stream when the pool runs dry
(``_preempt_victim`` :1997, ``_preempt`` :2027); a preempted stream
re-prefills its context on re-admission and continues
token-identically. ``_finish`` :3027 returns a slot's pages.

Greedy outputs are token-identical per request to the JAX package's
``generate()`` on the same weights (the CPU tests hold the port to
it), also with an int8 or int4 KV cache at the same cache dtype. On the
card the prefill attention runs the flash kernel and the decode readout
the paged kernel (its int8/int4 variant for a quantized pool).

Only the synchronous loop is ported. Options of the JAX engine that
belong to later slices raise ``NotImplementedError`` naming the ROADMAP
item; the tracer, flight recorder, SLOs and time series wait for the
observability slice.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from distkeras_tpu_torch.compat import resolve_device
from distkeras_tpu_torch.models.core import Model, Sequential
from distkeras_tpu_torch.models.decoding import (_decode_block_of,
                                                 _sample_vec,
                                                 attn_compute_dtype,
                                                 decode_step_slots_paged,
                                                 fuse_qkv_params, prefill,
                                                 prefill_chunk_step,
                                                 serving_params)
from distkeras_tpu_torch.serving.kv_pool import PagedKVPool, PrefixCache
from distkeras_tpu_torch.serving.metrics import ServingMetrics
from distkeras_tpu_torch.serving.scheduler import (AdmissionRejected,
                                                   PriorityScheduler,
                                                   Request, RequestState)

#: options of the JAX engine that later slices port: name -> (value that
#: means "off", ROADMAP item)
_NOT_PORTED = {
    "overlap": (False, "overlapped dispatch (zero-bubble loop)"),
    "fuse_steps": (0, "fused multi-step decode"),
    "draft": (None, "speculative decoding"),
    "weight_quant": (None, "quantized weights, kernel queue item K5"),
    "fused_sampling": (False, "fused sampling, kernel queue item K4"),
    "ep_mesh": (None, "expert-parallel MoE serving"),
    "host_kv_pages": (0, "host KV offload"),
}


class ServingEngine:
    """Continuous-batching serving of one ``zoo.transformer_lm`` model.
    ``submit()`` enqueues, ``step()`` runs one scheduler iteration,
    ``run()`` drains. ``max_len`` is the per-request capacity
    (``len(prompt) + max_new_tokens <= max_len``); ``page_len`` and
    ``num_pages`` size the paged pool (default: worst-case parity with
    one ``max_len`` row per slot); ``cache_dtype`` is the pages' dtype
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
    logits, slots)`` (optional) sees every prefill (``kind="prefill"``)
    and decode (``"decode"``) logits tensor with the slots whose rows
    are live."""

    def __init__(self, model: Model, *, num_slots: int = 4,
                 max_len: int = 256, prefill_chunk: Optional[int] = None,
                 cache_dtype=None,
                 metrics: Optional[ServingMetrics] = None,
                 max_queue: Optional[int] = None, kv_layout: str = "paged",
                 page_len: int = 16, num_pages: Optional[int] = None,
                 prefix_cache: bool = True, prefix_granularity: int = 1,
                 device=None, on_logits: Optional[Callable] = None,
                 overlap: bool = False, fuse_steps: int = 0, draft=None,
                 weight_quant: Optional[str] = None,
                 fused_sampling: bool = False, ep_mesh=None,
                 host_kv_pages: int = 0):
        given = {"overlap": overlap, "fuse_steps": fuse_steps,
                 "draft": draft, "weight_quant": weight_quant,
                 "fused_sampling": fused_sampling, "ep_mesh": ep_mesh,
                 "host_kv_pages": host_kv_pages}
        for name, (off, item) in _NOT_PORTED.items():
            if given[name] != off:
                raise NotImplementedError(
                    f"{name}={given[name]!r} is not ported yet: ROADMAP, "
                    f"{item}")
        if kv_layout != "paged":
            raise NotImplementedError(
                f"kv_layout={kv_layout!r} is not ported yet: ROADMAP, "
                "Queue 1, the slab serving engine (kv_layout='slab')")
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
        with torch.no_grad():
            self._params = fuse_qkv_params(
                module, serving_params(model.params, compute_dt))

        self.pool = PagedKVPool(module, self.num_slots, self.max_len,
                                page_len=page_len, num_pages=num_pages,
                                dtype=cache_dtype, device=self.device)
        self.page_len = self.pool.page_len
        self.prefix = PrefixCache(self.pool) if prefix_cache else None
        if prefix_granularity < 1:
            raise ValueError(f"prefix_granularity must be >= 1, "
                             f"got {prefix_granularity}")
        self._prefix_granularity = int(prefix_granularity)
        self.scheduler = PriorityScheduler(self.num_slots,
                                           max_queue=max_queue)
        # ONE reusable staging cache: stale positions past the current
        # context are never inserted and never read before being written
        self._staging = self.pool.make_request_cache()
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.on_logits = on_logits
        self._requests: Dict[int, Request] = {}
        self._rid = itertools.count()
        s = self.num_slots
        self._tok = np.zeros(s, np.int64)
        #: max_len is the free-slot sentinel: the decode write misses
        #: every page and the slot's logits are discarded
        self._t = np.full(s, self.max_len, np.int32)

    # --- request intake ---------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *,
               temperature: float = 0.0, top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               stop_token: Optional[int] = None, seed: int = 0,
               priority: int = 1) -> int:
        """Enqueue one request; returns its id. ``temperature=0`` is
        greedy; ``None`` knobs are disabled. ``priority``: lower admits
        first (0 interactive, 1 standard, 2 batch). Raises
        ``AdmissionRejected`` when the bounded queue is full."""
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
        worst = self.pool.pages_for(prompt.size + max_new_tokens)
        if worst > self.pool.num_pages:
            raise ValueError(
                f"request needs up to {worst} pages but the pool holds "
                f"{self.pool.num_pages}; raise num_pages or lower "
                "max_new_tokens")
        req = Request(
            rid=next(self._rid), prompt=prompt,
            max_new_tokens=max_new_tokens, temperature=float(temperature),
            top_k=0 if top_k is None else int(top_k),
            top_p=1.0 if top_p is None else float(top_p),
            stop_token=-1 if stop_token is None else int(stop_token),
            seed=int(seed), priority=int(priority))
        if req.temperature > 0.0:
            req.rng = torch.Generator(device=self.device).manual_seed(
                req.seed)
        req.submit_t = self.metrics.clock()
        try:
            self.scheduler.submit(req)
        except AdmissionRejected:
            self.metrics.record_rejected()
            raise
        self._requests[req.rid] = req
        self.metrics.record_submit(req.rid)
        return req.rid

    def __getitem__(self, rid: int) -> Request:
        """In-flight request lookup (finished requests are evicted)."""
        return self._requests[rid]

    # --- paged admission / page budget ------------------------------------

    def _admit(self) -> List[Request]:
        """Admit the highest-priority queued requests while a slot and
        their context pages are available; a strictly-higher-priority
        arrival that cannot be funded preempts lower-priority streams."""
        admitted: List[Request] = []
        sch = self.scheduler
        while sch.free_slots:
            req = sch.peek()
            if req is None:
                break
            plan = self._page_plan(req)
            if plan is not None:
                sch.admit_one(req)
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
        incref'd before any reclaim, so the sweep cannot eat them."""
        pool = self.pool
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
        need = n_logical - len(full)
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
        priv = [pool.alloc_page() for _ in range(need)]
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
        generated tokens stay (the re-prefill context) and so does its
        generator, so a sampled stream resumes where it left off."""
        slot = victim.slot
        self.scheduler.preempt(victim)
        self.pool.release_slot(slot)
        self._t[slot] = self.max_len
        if victim.donor_ref is not None:
            self.pool.decref(victim.donor_ref)
            victim.donor_ref = None
        victim.shared_len = 0
        victim.n_shared_full = 0
        victim.load_pages = []
        self.metrics.record_preemption(victim.rid)

    def _ensure_decode_pages(self) -> None:
        """Before a decode step: every running slot whose next write
        crosses into an unallocated page gets one, from the free list,
        then by evicting cache-only prefix pages, then by preempting the
        youngest lowest-priority stream. Oldest-highest-priority first."""
        pool = self.pool
        running = self.scheduler.running
        if not running:
            return
        slots = np.fromiter(running.keys(), np.int64, len(running))
        lp = np.minimum(self._t[slots].astype(np.int64),
                        pool.pages_per_slot * pool.page_len - 1) \
            // pool.page_len
        if not (pool.tables[slots, lp] >= pool.num_pages).any():
            return
        for req in sorted(running.values(),
                          key=lambda r: (r.priority, r.rid)):
            if req.state is not RequestState.DECODING:
                continue                      # preempted this pass
            slot = req.slot
            t = min(int(self._t[slot]),
                    pool.pages_per_slot * pool.page_len - 1)
            page = t // pool.page_len
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
                    break                     # it preempted itself

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
        """One iteration: admit, advance ONE prefill chunk, run one decode
        step over all slots. Returns the requests that finished. Runs
        under ``torch.inference_mode``: serving records no autograd graph,
        even for a model whose parameters require grad."""
        finished: List[Request] = []
        self._admit()
        clock = self.metrics.clock
        req = self.scheduler.next_prefill()
        if req is not None:
            t0 = clock()
            self._advance_prefill(req, finished)
            self.metrics.record_phase("prefill", clock() - t0)
        if self.scheduler.running:
            t0 = clock()
            self._advance_decode(finished)
            self.metrics.record_phase("decode", clock() - t0)
        self.metrics.record_iteration(self.scheduler.queue_depth,
                                      self.scheduler.occupied,
                                      self.num_slots)
        self.metrics.record_pages(self.pool.free_pages,
                                  self.pool.shared_pages,
                                  self._fragmentation())
        return finished

    @torch.inference_mode()
    def run(self, max_steps: Optional[int] = None) -> Dict[int, np.ndarray]:
        """Drive ``step()`` until every request finished; returns
        ``{rid: tokens}`` (prompt + continuation)."""
        out: Dict[int, np.ndarray] = {}
        steps = 0
        while self.scheduler.pending:
            for r in self.step():
                out[r.rid] = r.tokens
            steps += 1
            if max_steps is not None and steps >= max_steps \
                    and self.scheduler.pending:
                raise RuntimeError(
                    f"engine made no full drain in {max_steps} steps "
                    f"(queue={self.scheduler.queue_depth}, "
                    f"occupied={self.scheduler.occupied})")
        return out

    def health(self) -> Dict:
        """Readiness snapshot: accepting work, queue depth, slots,
        request tallies, pages and the prefix cache."""
        sch = self.scheduler
        accepting = (sch.max_queue is None
                     or sch.queue_depth < sch.max_queue)
        m = self.metrics
        pool = self.pool
        return {
            "status": "ok" if accepting else "saturated",
            "accepting": accepting,
            "device": str(self.device),
            "queue_depth": sch.queue_depth,
            "max_queue": sch.max_queue,
            "slots": {"total": self.num_slots, "occupied": sch.occupied,
                      "free": self.num_slots - sch.occupied},
            "requests": {"in_flight": len(self._requests),
                         "finished": m.requests_finished,
                         "rejected": m.requests_rejected,
                         "preempted": m.requests_preempted},
            "pages": {"total": pool.num_pages, "free": pool.free_pages,
                      "shared": pool.shared_pages,
                      "page_len": pool.page_len,
                      "fragmentation": round(self._fragmentation(), 4)},
            "prefix_cache": (None if self.prefix is None else {
                "nodes": len(self.prefix), "hit_rate": m.prefix_hit_rate}),
        }

    # --- internals --------------------------------------------------------

    def _set_slot(self, req: Request, token: int, t: int) -> None:
        self._tok[req.slot] = token
        self._t[req.slot] = t         # where the next decode step writes

    @staticmethod
    def _sample(logits, rows: List[int], reqs: List[Request]):
        """Next tokens for logits ``rows`` on the host: argmax for an
        all-greedy batch, else the per-row sampler (each sampled row
        draws from its request's own generator)."""
        if all(r.temperature <= 0.0 for r in reqs):
            return torch.argmax(logits, dim=-1).cpu().numpy()
        n = logits.shape[0]
        temp = np.zeros(n, np.float32)
        top_k = np.zeros(n, np.int64)
        top_p = np.ones(n, np.float32)
        gens = [None] * n
        for row, r in zip(rows, reqs):
            temp[row], top_k[row], top_p[row] = (r.temperature, r.top_k,
                                                 r.top_p)
            gens[row] = r.rng
        dev = logits.device
        nxt = _sample_vec(logits, torch.from_numpy(temp).to(dev),
                          torch.from_numpy(top_k).to(dev),
                          torch.from_numpy(top_p).to(dev), gens)
        return nxt.cpu().numpy()

    def _advance_prefill(self, req: Request, finished: List[Request]):
        toks = req.context_tokens
        p_len = len(toks)
        resume = bool(req.generated)
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
            if req.donor_ref is not None:
                self.pool.decref(req.donor_ref)
                req.donor_ref = None
        t0 = req.prefill_pos
        if self.prefill_chunk is None:
            q_len, final = p_len - t0, True
        else:
            q_len = min(self.prefill_chunk, p_len - t0)
            final = t0 + q_len >= p_len
        # a resume re-prefill runs head-less: its tokens are decided
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
            return
        if self.on_logits is not None:
            self.on_logits("prefill", logits, [0])
        token = int(self._sample(logits, [0], [req])[0])
        req.generated.append(token)
        self.metrics.record_first_token(req.rid)
        if req.done:
            self._finish(req, finished)
            return
        self.scheduler.to_decoding(req)
        self._set_slot(req, token, p_len)

    def _advance_decode(self, finished: List[Request]):
        self._ensure_decode_pages()
        running = self.scheduler.running
        if not running:
            return
        t0 = self.metrics.clock()
        dev = self.device
        logits, _ = decode_step_slots_paged(
            self.module, self._params, self.pool.cache,
            torch.from_numpy(self._tok).to(dev),
            torch.from_numpy(self._t).to(dev), self.pool.device_tables(),
            self.page_len)
        slots = list(running.keys())
        reqs = list(running.values())
        if self.on_logits is not None:
            self.on_logits("decode", logits, slots)
        nxt = self._sample(logits, slots, reqs)
        done = []
        for slot, req in zip(slots, reqs):
            token = int(nxt[slot])
            req.generated.append(token)
            self._tok[slot] = token
            self._t[slot] += 1
            if req.done:
                done.append(req)
        self.metrics.record_decode(len(slots), self.metrics.clock() - t0)
        for req in done:
            self._finish(req, finished)

    def _finish(self, req: Request, finished: List[Request]):
        slot = req.slot
        self.scheduler.release(req)
        self._t[slot] = self.max_len
        # pages return to the budget; registered prefix pages survive
        # under the prefix cache's own reference
        self.pool.release_slot(slot)
        self.metrics.record_finish(req.rid, len(req.generated))
        del self._requests[req.rid]
        finished.append(req)
