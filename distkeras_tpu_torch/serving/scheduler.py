"""Request scheduling for the continuous-batching engine: admission,
the per-request state machine, slot allocation, preemption.

Mirrors ``distkeras_tpu/serving/scheduler.py`` (:55-364, the
speculation fields of ``Request`` :117-130). ``FIFOScheduler`` (:164) is
the slab engine's policy: FCFS admission into free slots. Its subclass
``PriorityScheduler`` (:287) is the paged engine's: priority classes
(lower ``priority`` admits first, FCFS within a class, preempted
requests at the front of their class), admission gated by the engine on
the free-page budget, and preemption of an admitted request back to the
queue with its generated tokens kept. Both run ONE prefill stream (the
oldest admitted request advances one prompt chunk per iteration) and
the terminal states of the degradation paths (``TIMED_OUT`` for an
expired ``deadline_s``, ``CANCELLED`` for ``ServingEngine.cancel``;
``cancel`` :250-265). Pure host-side bookkeeping.
"""

from __future__ import annotations

import enum
import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


class AdmissionRejected(RuntimeError):
    """Submit refused: the bounded admission queue is full."""

    def __init__(self, queue_depth: int, max_queue: int):
        super().__init__(
            f"admission queue full ({queue_depth}/{max_queue} waiting); "
            "request shed")
        self.queue_depth = queue_depth
        self.max_queue = max_queue


class RequestState(enum.Enum):
    QUEUED = "queued"            # submitted, waiting for a slot
    PREFILLING = "prefilling"    # slot assigned, prompt chunks running
    DECODING = "decoding"        # in the slot-batched decode loop
    FINISHED = "finished"        # stop token or length limit reached
    TIMED_OUT = "timed_out"      # per-request deadline_s expired
    CANCELLED = "cancelled"      # cancelled by API


#: states a request never leaves
TERMINAL_STATES = frozenset(
    {RequestState.FINISHED, RequestState.TIMED_OUT,
     RequestState.CANCELLED})


@dataclass(eq=False)
class Request:
    """One serving request and its progress. Sampling knobs use the
    engine's per-slot sentinels (``temperature 0`` = greedy, ``top_k 0``
    = no truncation, ``top_p 1.0`` = no nucleus cut, ``stop_token -1`` =
    never stop). ``rng`` is the request's own PRNG key
    (``ops.prng.key(seed)``, a host ``[2]`` array of uint32 words): a
    preemption keeps the slot's key there, so a sampled stream draws the
    same tokens whatever the schedule. ``deadline_s`` is a submit-to-
    finish budget on the engine's metrics clock; ``error`` the cause of
    a degraded end (None)."""

    rid: int
    prompt: np.ndarray                   # [P] int32
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    stop_token: int = -1
    seed: int = 0
    priority: int = 1                    # lower admits first
    state: RequestState = RequestState.QUEUED
    slot: Optional[int] = None
    prefill_pos: int = 0                 # context positions ingested
    generated: List[int] = field(default_factory=list)
    rng: object = None
    deadline_s: Optional[float] = None
    submit_t: float = 0.0
    error: Optional[BaseException] = None
    n_preempted: int = 0
    # the router's count of this stream's moves between replicas, stamped
    # when it delivers the terminal request (JAX :111-116)
    n_handoffs: int = 0                  # planned moves (disagg/rebalance)
    n_failovers: int = 0                 # replica-death re-admissions
    # engine bookkeeping of the admission plan: positions served by
    # shared prefix pages, how many of those pages are whole, the pages
    # to load into the staging cache and the copy-on-write donor's hold
    shared_len: int = 0
    n_shared_full: int = 0
    load_pages: List[int] = field(default_factory=list)
    donor_ref: Optional[int] = None
    #: a preemption's swap-out (host KV offload): ``{"host": host page
    #: ids, "logical": their logical pages, "shared": [(logical, page)]
    #: prefix-resident pages held instead of copied, "t": the decode
    #: position}``; None when the resume re-prefills
    swap: Optional[dict] = None
    #: the metrics clock at a re-prefill resume's first chunk
    resume_t0: Optional[float] = None
    #: (rank, arrival) order inside a priority class (scheduler-owned)
    order: tuple = (1, 0)
    # speculative decoding: whether the request joins draft-and-verify
    # iterations, its acceptance EMA and the kill switch the engine
    # throws for a stream the draft cannot predict; the adaptive tree
    # shape (seeded from spec_k/spec_width at first use). All of them
    # survive preemption.
    speculate: bool = False
    spec_disabled: bool = False
    spec_ema: Optional[float] = None     # EMA of per-verify accept rate
    spec_checks: int = 0                 # verify steps observed
    spec_disabled_at: Optional[int] = None  # generated count at demotion
    tree_depth: Optional[int] = None
    tree_width: Optional[int] = None

    @property
    def stopped(self) -> bool:
        return (self.stop_token >= 0 and bool(self.generated)
                and self.generated[-1] == self.stop_token)

    @property
    def done(self) -> bool:
        return self.stopped or len(self.generated) >= self.max_new_tokens

    @property
    def context_tokens(self) -> np.ndarray:
        """Every token whose KV must be in cache before this request can
        (re)join decode: the prompt, plus after a preemption every
        generated token but the last (the pending decode input)."""
        if not self.generated:
            return self.prompt
        return np.concatenate(
            [self.prompt,
             np.asarray(self.generated[:-1], self.prompt.dtype)])

    @property
    def tokens(self) -> np.ndarray:
        """Prompt + generated continuation."""
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, self.prompt.dtype)])


class FIFOScheduler:
    """Queue + slot allocator + state machine, FCFS (the slab engine's
    policy)."""

    def __init__(self, num_slots: int, max_queue: Optional[int] = None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if max_queue is not None and int(max_queue) < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.num_slots = int(num_slots)
        self.max_queue = None if max_queue is None else int(max_queue)
        self.waiting: deque = deque()          # QUEUED
        self.prefilling: deque = deque()       # PREFILLING, FIFO
        self.running: Dict[int, Request] = {}  # slot -> DECODING request
        #: the engine binds its request tracer here, so admissions are
        #: recorded where they are made (None: nothing is recorded)
        self.tracer = None
        # pop() hands out slot 0 first: deterministic placement
        self._free = list(range(self.num_slots))[::-1]

    # --- queue ------------------------------------------------------------

    def submit(self, req: Request) -> None:
        if self.max_queue is not None \
                and len(self.waiting) >= self.max_queue:
            raise AdmissionRejected(len(self.waiting), self.max_queue)
        req.state = RequestState.QUEUED
        self.waiting.append(req)

    def admit(self) -> List[Request]:
        """Move queued requests into free slots, FCFS; returns them."""
        admitted = []
        while self.waiting and self._free:
            req = self.waiting.popleft()
            self._take_slot(req)
            admitted.append(req)
        return admitted

    def _take_slot(self, req: Request) -> None:
        req.slot = self._free.pop()
        req.state = RequestState.PREFILLING
        req.prefill_pos = 0
        self.prefilling.append(req)
        if self.tracer is not None:
            # the queue depth AT admission: requests still waiting
            self.tracer.on_admit(req.rid, req.slot, len(self.waiting))

    def next_prefill(self) -> Optional[Request]:
        """The single request whose chunks advance (the oldest admitted)."""
        return self.prefilling[0] if self.prefilling else None

    # --- transitions ------------------------------------------------------

    def to_decoding(self, req: Request) -> None:
        if not self.prefilling or req is not self.prefilling[0]:
            raise RuntimeError("prefill completes FCFS")
        self.prefilling.popleft()
        req.state = RequestState.DECODING
        self.running[req.slot] = req

    def _evict(self, req: Request) -> None:
        """Remove an in-flight request from its live structure and free
        its slot; a request holding no slot raises (a double release
        would hand one slot to two requests)."""
        if req.state is RequestState.DECODING:
            del self.running[req.slot]
        elif req.state is RequestState.PREFILLING:
            self.prefilling.remove(req)
        else:
            raise RuntimeError(
                f"cannot release request {req.rid} in state "
                f"{req.state.value!r}: it holds no slot")
        self._free.append(req.slot)

    def release(self, req: Request) -> None:
        """Finish a request and free its slot."""
        self._evict(req)
        req.state = RequestState.FINISHED

    def cancel(self, req: Request,
               state: RequestState = RequestState.CANCELLED) -> None:
        """Terminate a request from any live state (the degradation
        paths: ``TIMED_OUT``, ``CANCELLED``): a queued request leaves
        the queue, an admitted one also frees its slot. Another target
        state raises ``ValueError``; a terminal request raises (the
        double-release guard)."""
        if state not in (RequestState.CANCELLED, RequestState.TIMED_OUT):
            raise ValueError(
                f"cancel() target state must be CANCELLED or TIMED_OUT, "
                f"got {state}")
        if req.state is RequestState.QUEUED:
            self.waiting.remove(req)
        else:
            self._evict(req)
        req.state = state

    # --- introspection ----------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    @property
    def occupied(self) -> int:
        return self.num_slots - len(self._free)

    @property
    def pending(self) -> bool:
        """Any request not yet finished."""
        return bool(self.waiting or self.prefilling or self.running)

    @property
    def free_slots(self) -> int:
        return len(self._free)


class PriorityScheduler(FIFOScheduler):
    """The paged engine's policy over the same state machine: priority
    classes, admission the engine funds first (``admit_one``), and
    preemption back to the queue. ``waiting`` is the base deque, ordered
    at ``peek()`` time by ``(priority, order)``."""

    def __init__(self, num_slots: int, max_queue: Optional[int] = None):
        super().__init__(num_slots, max_queue=max_queue)
        self._order = itertools.count()        # arrival order in a class
        self._front = itertools.count()        # requeue order (preempted)

    def submit(self, req: Request) -> None:
        # fresh arrivals sort after every preempted request of the class
        req.order = (1, next(self._order))
        super().submit(req)

    def peek(self) -> Optional[Request]:
        """The request admission would take next, without taking it."""
        if not self.waiting:
            return None
        return min(self.waiting, key=lambda r: (r.priority, r.order))

    def admit_one(self, req: Request) -> None:
        """Admit one queued request into a free slot (the engine calls
        this only after funding its pages)."""
        if not self._free:
            raise RuntimeError("admit_one with no free slot")
        self.waiting.remove(req)
        self._take_slot(req)

    def admit(self) -> List[Request]:
        """Unfunded admission: fill free slots in priority order."""
        admitted = []
        while self.waiting and self._free:
            req = self.peek()
            self.admit_one(req)
            admitted.append(req)
        return admitted

    def preempt(self, req: Request) -> None:
        """Evict an admitted request back to the queue: slot freed,
        generated tokens kept (its re-prefill context), resumed ahead of
        its class peers."""
        self._evict(req)
        req.slot = None
        req.state = RequestState.QUEUED
        req.prefill_pos = 0
        req.n_preempted += 1
        req.order = (0, next(self._front))
        self.waiting.append(req)
