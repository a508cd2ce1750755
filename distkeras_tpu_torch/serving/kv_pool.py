"""The KV pools of the serving engine and the prefix cache.

Mirrors ``distkeras_tpu/serving/kv_pool.py``. ``KVPool`` (:82-142, the
slab pool of ``kv_layout="slab"``) holds one ``[S, Hkv, max_len, Dh]``
row per slot; ``insert`` (:110) copies a batch-1 staging cache's first
``n_pos`` positions into a slot's row. Its planes are one row longer:
the sink row, where the slab write sends a free slot's entries
(``models.decoding.slab_write_index``). ``PagedKVPool`` holds one
``[num_pages, Hkv, page_len, Dh]`` page tensor per layer (k and v) on
the device, per-slot page tables ``[S, P]`` on the host (an entry of
``num_pages`` is the unallocated sentinel), host-side refcounts, the
staging transfers ``insert_pages`` (:594, ``_write_pages`` :143) and
``load_prefix`` (:606, ``_load_pages`` :196), ``page_bytes`` (:361) and
``device_tables`` (:395). Each plane holds one page more than the pool:
the sink, where the fixed-shape paged write sends its dead entries;
``cache`` hands out views of the ``num_pages`` pages every reader sees
(``models.decoding.sink_views``). Host arrays reach the card through
``stage``: one non-blocking copy from pinned memory, no host sync. An
int8 pool (``dtype="int8"``) adds float32
``k_scale``/``v_scale`` planes ``[num_pages, Hkv, page_len]``; an int4
pool packs its payload two positions per byte into ``[num_pages, Hkv,
page_len/2, Dh]`` (``pack_int4``'s half-split, even ``page_len``) while
its staging cache stays unpacked. ``PrefixCache`` hash-conses full prompt
pages under a chained token key (``match`` :726, ``register`` :794,
``evict_one`` :860, ``reclaim`` :949), serving a partial page match
copy-on-write. ``hbm_budget`` sizes the pool from a byte budget
(:245-290): whole pages of ``hbm_budget - reserve_bytes``, the same
``num_pages`` as JAX's for the same budget; the sink page comes on top
(``sink_bytes``).

The host tier (``host_pages``, :480-592) mirrors the page planes in
host memory (pinned when the pool is on the card). ``offload_pages``
gathers the pages into a fresh device snapshot (later writes cannot
reach it) and queues its copy into pinned buffers with a non-blocking
copy and a CUDA event: no host sync. The fence (``_fence_host``) waits
on that event and moves the batch into the host rows only at the first
``restore_pages``/``free_host`` that touches it; a batch freed whole is
dropped unfenced. ``restore_pages`` sends the rows back through pinned
memory with a non-blocking copy into pages already allocated, byte for
byte. Pinned memory that cannot be had raises: there is no pageable
fallback. The prefix cache spills its LRU cache-only pages to the host
tier before it drops any (``evict_one``), and ``match`` restores a
spilled node onto a fresh device page.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from distkeras_tpu_torch.models.decoding import (CACHE_PLANES, cache_kind,
                                                 init_cache, pack_int4,
                                                 sink_views, unpack_int4)

#: numpy -> torch dtypes of the arrays ``stage`` moves
_TORCH_DTYPES = {np.dtype(np.bool_): torch.bool,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.int64): torch.int64,
                 np.dtype(np.float32): torch.float32}


def stage(arrays, device) -> List[torch.Tensor]:
    """Private device copies of host numpy ``arrays``, made without a
    host sync. On the card: the arrays packed (8-byte aligned) into one
    fresh pinned buffer and sent by ONE non-blocking copy, then viewed
    back per array; PyTorch's pinned-memory cache hands that buffer out
    again only after the copy that reads it has completed, so the caller
    may change its arrays at once. On the CPU: plain copies."""
    device = torch.device(device)
    if device.type != "cuda":  # lint: allow-device-fork (pinned staging)
        return [torch.from_numpy(np.array(a, copy=True)) for a in arrays]
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offs, n = [], 0
    for a in arrays:
        offs.append(n)
        n += -(-a.nbytes // 8) * 8
    host = torch.empty(max(n, 8), dtype=torch.uint8, pin_memory=True)
    buf = host.numpy()
    for a, o in zip(arrays, offs):
        buf[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = host.to(device, non_blocking=True)
    return [dev[o:o + a.nbytes].view(_TORCH_DTYPES[a.dtype]).reshape(
        a.shape) for a, o in zip(arrays, offs)]


class KVPool:
    """S-slot slab pool over ``module``'s attention layers (JAX :82):
    ``cache`` is the per-layer list of ``{"k", "v"}`` row views ``[S,
    Hkv, max_len, Dh]`` (plus the scale planes and the ``"q4"`` marker
    of a quantized pool; an int4 row holds one byte per entry) that the
    slot steps read and write in place, over planes one row longer (the
    sink row, ``"sink"``)."""

    def __init__(self, module, num_slots: int, max_len: int,
                 dtype=torch.float32, device=None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {max_len}")
        self._module = module
        self.device = torch.device(device)
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.dtype = dtype
        full = init_cache(module, self.num_slots + 1, self.max_len, dtype,
                          self.device)
        self.cache = [None if kv is None else sink_views(kv, self.num_slots)
                      for kv in full]

    def make_request_cache(self):
        """A batch-1 cache with the rows' layout: what a request's prefill
        fills and ``insert`` consumes."""
        return init_cache(self._module, 1, self.max_len, self.dtype,
                          self.device)

    @torch.no_grad()
    def insert(self, req_cache, slot: int,
               n_pos: Optional[int] = None) -> None:
        """Copy a batch-1 request cache into row ``slot``: only its first
        ``n_pos`` positions (the whole row when None), the ones the
        prompt filled; the stale tail past them is written by the slot's
        own decode before any mask admits it."""
        if not 0 <= slot < self.num_slots:
            raise ValueError(
                f"slot {slot} out of range [0, {self.num_slots})")
        if n_pos is None:
            n_pos = self.max_len
        if not 0 < n_pos <= self.max_len:
            raise ValueError(
                f"n_pos must be in (0, {self.max_len}], got {n_pos}")
        for pool_kv, st_kv in zip(self.cache, req_cache):
            if pool_kv is None:
                continue
            for key in CACHE_PLANES:
                if key in pool_kv:
                    pool_kv[key][slot, :, :n_pos] = \
                        st_kv[key][0, :, :n_pos].to(pool_kv[key].dtype)


class PagedKVPool:
    """Fixed pool of ``num_pages`` KV pages per layer + per-slot page
    tables + refcounted allocation. ``cache`` is the per-layer list of
    ``{"k", "v"}`` page tensors (plus the scale planes and the ``"q4"``
    marker of a quantized pool) the decode step reads and writes in
    place; ``tables`` the host ``[S, P]`` int32 array. ``host_pages``
    adds the host tier: ``host_cache`` holds that many pages of every
    plane in host memory (pinned for a pool on the card)."""

    def __init__(self, module, num_slots: int, max_len: int, *,
                 page_len: int = 16, num_pages: Optional[int] = None,
                 dtype=torch.float32, device=None, host_pages: int = 0,
                 hbm_budget: Optional[int] = None, reserve_bytes: int = 0):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {max_len}")
        if page_len < 1:
            raise ValueError(f"page_len must be >= 1, got {page_len}")
        self._module = module
        self.device = torch.device(device)
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.page_len = int(page_len)
        self._int4 = cache_kind(dtype) == "int4"
        if self._int4 and self.page_len % 2:
            raise ValueError(
                f"int4 pages nibble-pack two positions per byte; "
                f"page_len must be even, got {page_len}")
        #: logical pages per slot: the page-table width (covers max_len)
        self.pages_per_slot = -(-self.max_len // self.page_len)
        #: bytes one physical page takes across every layer's planes:
        #: payload (int4: packed) and scale planes
        self.page_bytes = self._page_bytes(module, self.page_len, dtype,
                                           self.max_len)
        if hbm_budget is not None:
            # whole pages of what the budget leaves after the reserve
            # (the engine's resident weights)
            if num_pages is not None:
                raise ValueError("pass num_pages or hbm_budget, not both")
            num_pages = (int(hbm_budget) - int(reserve_bytes)) \
                // self.page_bytes
            if num_pages < 1:
                raise ValueError(
                    f"hbm_budget {hbm_budget} - reserve {reserve_bytes} "
                    f"does not fit one {self.page_bytes}-byte page")
        if num_pages is None:
            num_pages = self.num_slots * self.pages_per_slot
        self.num_pages = int(num_pages)
        if self.num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {self.num_pages}")
        self.dtype = dtype
        # the page axis is init_cache's batch axis, one page longer for
        # the sink; the position table is validated against max_len
        full = init_cache(module, self.num_pages + 1, self.page_len, dtype,
                          self.device, check_len=self.max_len)
        if self._int4:
            for kv in full:
                if kv is not None:
                    for key in ("k", "v"):
                        n, h, pl, d = kv[key].shape
                        kv[key] = torch.zeros((n, h, pl // 2, d),
                                              dtype=torch.int8,
                                              device=self.device)
        self.cache = [None if kv is None else sink_views(kv, self.num_pages)
                      for kv in full]
        self.tables = np.full((self.num_slots, self.pages_per_slot),
                              self.num_pages, np.int32)
        self.ref = np.zeros(self.num_pages, np.int64)
        # pop() hands out page 0 first (deterministic placement)
        self._free = list(range(self.num_pages))[::-1]
        self._tables_dev = None
        self._init_host_tier(host_pages)

    def _init_host_tier(self, host_pages: int) -> None:
        """The host offload tier (JAX :327-358): ``host_pages`` pages of
        every plane in host memory, pinned for a pool on the card (an
        allocation that cannot be pinned raises), the free list, the
        batches whose copy is queued but not fenced, and the odometers
        (cumulative; the engine publishes per-window deltas)."""
        self.host_pages = int(host_pages)
        if self.host_pages < 0:
            raise ValueError(f"host_pages must be >= 0, got {host_pages}")
        self._pinned = self.device.type == "cuda"  # lint: allow-device-fork
        self.host_cache = None
        self._host_free: List[int] = []
        if self.host_pages:
            self.host_cache = [
                None if kv is None else {
                    key: torch.empty((self.host_pages,)
                                     + tuple(kv[key].shape[1:]),
                                     dtype=kv[key].dtype,
                                     pin_memory=self._pinned)
                    for key in CACHE_PLANES if key in kv}
                for kv in self.cache]
            self._host_free = list(range(self.host_pages))[::-1]
        self.pages_offloaded = 0
        self.pages_restored = 0
        self.offload_bytes = 0
        #: queued swap-outs: {"hids", "host" (per-layer plane copies, in
        #: flight behind "event" on the card), "event", "dev" (the device
        #: snapshot the copy reads)}
        self._pending_host: List[Dict] = []
        #: fences run (tests hold the laziness to it)
        self.host_fences = 0

    def allocated_bytes(self) -> int:
        """Bytes the pool's page planes hold on the device: ``num_pages``
        pages and the sink page, ``(num_pages + 1) * page_bytes``."""
        return sum(x.numel() * x.element_size() for kv in self.cache
                   if kv is not None for x in kv["sink"].values())

    @staticmethod
    def _page_bytes(module, page_len: int, dtype, max_len: int) -> int:
        """Per-physical-page bytes across all layers, from a one-page
        probe on the meta device (nothing allocated): payload planes
        (int4: halved, two nibbles per byte) plus scale planes."""
        probe = init_cache(module, 1, page_len, dtype, "meta",
                           check_len=max_len)
        int4 = cache_kind(dtype) == "int4"
        total = 0
        for kv in probe:
            if kv is None:
                continue
            for key in CACHE_PLANES:
                if key in kv:
                    n = kv[key].numel() * kv[key].element_size()
                    total += n // 2 if int4 and key in ("k", "v") else n
        return total

    # -- device views -------------------------------------------------------

    def make_request_cache(self):
        """The batch-1 prefill staging cache: ``pages_per_slot *
        page_len`` positions, so page loads/inserts reshape exactly."""
        return init_cache(self._module, 1,
                          self.pages_per_slot * self.page_len, self.dtype,
                          self.device, check_len=self.max_len)

    def device_tables(self) -> torch.Tensor:
        """The ``[S, P]`` int32 page tables on the device (cached; any
        table mutation invalidates the copy, and the next call stages a
        new one)."""
        if self._tables_dev is None:
            self._tables_dev, = stage([self.tables], self.device)
        return self._tables_dev

    def _dirty(self):
        self._tables_dev = None

    # -- allocation ---------------------------------------------------------

    def pages_for(self, n_positions: int) -> int:
        return -(-int(n_positions) // self.page_len)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def shared_pages(self) -> int:
        """Physical pages with more than one holder."""
        return int((self.ref > 1).sum())

    def alloc_page(self) -> Optional[int]:
        """One free page with ``ref = 1`` (the caller's), or None."""
        if not self._free:
            return None
        pid = self._free.pop()
        self.ref[pid] = 1
        return pid

    def incref(self, pid: int) -> None:
        self.ref[pid] += 1

    def decref(self, pid: int) -> None:
        self.ref[pid] -= 1
        if self.ref[pid] < 0:
            raise RuntimeError(
                f"page {pid} refcount went negative (double free)")
        if self.ref[pid] == 0:
            self._free.append(pid)

    def assign(self, slot: int, logical: int, pid: int) -> None:
        """Point ``tables[slot, logical]`` at ``pid`` (the caller has
        arranged the refcount)."""
        self.tables[slot, logical] = pid
        self._dirty()

    def release_slot(self, slot: int) -> int:
        """Drop the slot's hold on every page it references and reset
        its row to the sentinel; returns the number of pages released."""
        row = self.tables[slot]
        pages = row[row < self.num_pages]
        if pages.size:
            self.ref[pages] -= 1              # a row never repeats a page
            if (self.ref[pages] < 0).any():
                raise RuntimeError(
                    f"slot {slot} release drove a page refcount negative")
            self._free.extend(pages[self.ref[pages] == 0].tolist())
        self.tables[slot] = self.num_pages
        self._dirty()
        return int(pages.size)

    # -- host offload tier --------------------------------------------------

    @property
    def host_free_pages(self) -> int:
        return len(self._host_free)

    @torch.no_grad()
    def offload_pages(self, page_ids) -> Optional[List[int]]:
        """Queue the device pages ``page_ids`` for the host (JAX :483):
        returns the host page ids (the caller's until ``free_host``), or
        None when the tier is off or lacks room. The pages are gathered
        into a fresh device snapshot, and on the card its copy into
        pinned buffers is queued with a non-blocking copy and an event:
        nothing waits (no host sync). The fence runs at the first
        ``restore_pages``/``free_host`` that touches these host pages."""
        n = len(page_ids)
        if self.host_cache is None or n == 0 or len(self._host_free) < n:
            return None
        ids, = stage([np.asarray(page_ids, np.int64)], self.device)
        dev = [None if kv is None else
               {key: kv[key][ids] for key in CACHE_PLANES if key in kv}
               for kv in self.cache]
        host, event = dev, None
        if self._pinned:
            host = []
            for planes in dev:
                if planes is None:
                    host.append(None)
                    continue
                out = {}
                for key, x in planes.items():
                    out[key] = torch.empty(x.shape, dtype=x.dtype,
                                           pin_memory=True)
                    out[key].copy_(x, non_blocking=True)
                host.append(out)
            event = torch.cuda.Event()
            event.record()
        for planes in dev:
            if planes is not None:
                self.offload_bytes += sum(x.numel() * x.element_size()
                                          for x in planes.values())
        hids = [self._host_free.pop() for _ in range(n)]
        self._pending_host.append({"hids": list(hids), "host": host,
                                   "event": event, "dev": dev})
        self.pages_offloaded += n
        return hids

    @property
    def host_swap_pending(self) -> int:
        """Host pages whose payload is queued but not fenced yet."""
        return sum(len(p["hids"]) for p in self._pending_host)

    def _fence_host(self, host_ids) -> None:
        """Land every queued batch that covers any of ``host_ids`` in the
        host rows (whole batches; JAX :522): wait for its copy's event,
        then copy it into its rows."""
        need = {int(h) for h in host_ids}
        if not need or not self._pending_host:
            return
        keep = []
        for pend in self._pending_host:
            if need.isdisjoint(pend["hids"]):
                keep.append(pend)
                continue
            self.host_fences += 1
            if pend["event"] is not None:
                pend["event"].synchronize()
            hsel = torch.as_tensor(pend["hids"], dtype=torch.long)
            for kv_host, planes in zip(self.host_cache, pend["host"]):
                if kv_host is not None:
                    for key, rows in kv_host.items():
                        rows[hsel] = planes[key]
        self._pending_host = keep

    @torch.no_grad()
    def restore_pages(self, host_ids, dev_ids) -> None:
        """Host pages -> the given (already allocated) device pages, byte
        for byte (JAX :544), fencing their swap-out first. On the card
        the rows go through pinned buffers with a non-blocking copy. The
        host pages stay the caller's (``free_host``)."""
        if self.host_cache is None:
            raise RuntimeError(
                "no host page pool (construct with host_pages > 0)")
        if len(host_ids) != len(dev_ids):
            raise ValueError(
                f"host/device page counts differ: {len(host_ids)} "
                f"vs {len(dev_ids)}")
        if not len(host_ids):
            return
        self._fence_host(host_ids)
        hsel = torch.as_tensor(np.asarray(host_ids, np.int64))
        dst, = stage([np.asarray(dev_ids, np.int64)], self.device)
        for kv, kv_host in zip(self.cache, self.host_cache):
            if kv is None:
                continue
            for key, rows in kv_host.items():
                buf = torch.empty((len(host_ids),) + tuple(rows.shape[1:]),
                                  dtype=rows.dtype, pin_memory=self._pinned)
                torch.index_select(rows, 0, hsel, out=buf)
                kv[key][dst] = buf.to(self.device, non_blocking=True)
        self.pages_restored += len(host_ids)

    def free_host(self, host_ids) -> None:
        """Return host pages to the free list (JAX :569). A queued batch
        the free covers whole is dropped without a fence (nothing will
        read it); a batch freed in part is fenced first, so its other
        pages land. A double free raises."""
        need = {int(h) for h in host_ids}
        if need and self._pending_host:
            self._pending_host = [
                pend for pend in self._pending_host
                if not (pend["hids"] and set(pend["hids"]) <= need)]
            self._fence_host(need)
        for h in host_ids:
            h = int(h)
            if h in self._host_free:
                raise RuntimeError(f"host page {h} double-freed")
            self._host_free.append(h)

    # -- staging transfers --------------------------------------------------

    def _page_view(self, staging_plane):
        """``[1, H, P*page_len, ...]`` staging (a payload or a scale
        plane) -> ``[P, H, page_len, ...]``."""
        x = staging_plane[0]
        h, length = x.shape[:2]
        return x.reshape((h, length // self.page_len, self.page_len)
                         + tuple(x.shape[2:])).transpose(0, 1)

    @torch.no_grad()
    def insert_pages(self, staging, slot: int, skip_pages: int,
                     n_pos: int) -> None:
        """Copy the staging cache's logical pages ``[skip_pages,
        pages_for(n_pos))`` into the slot's physical pages: only the
        pages the context fills and that are not already shared (an int4
        pool packs the payload here)."""
        n_needed = self.pages_for(n_pos)
        logical = np.arange(skip_pages, n_needed)
        phys = self.tables[slot, skip_pages:n_needed]
        keep = phys < self.num_pages
        if not keep.any():
            return
        src, dst = stage([logical[keep].astype(np.int64),
                          phys[keep].astype(np.int64)], self.device)
        for pool_kv, st_kv in zip(self.cache, staging):
            if pool_kv is None:
                continue
            for key in CACHE_PLANES:
                if key not in pool_kv:
                    continue
                pages = self._page_view(st_kv[key])[src]
                if self._int4 and key in ("k", "v"):
                    pages = pack_int4(pages)
                pool_kv[key][dst] = pages.to(pool_kv[key].dtype)

    @torch.no_grad()
    def load_prefix(self, staging, page_ids: List[int], n_tokens: int):
        """Materialise a shared prefix into the staging cache: pages
        ``page_ids`` (full shared pages, plus a copy-on-write donor last)
        become staging positions ``[0, n_tokens)`` (the donor's tail is
        overwritten by the prefill chunks; an int4 pool's pages unpack
        here). Returns the staging cache."""
        n_load = self.pages_for(n_tokens)
        if len(page_ids) < n_load:
            raise ValueError(
                f"{len(page_ids)} pages cannot cover {n_tokens} shared "
                f"tokens ({n_load} pages)")
        src, = stage([np.asarray(page_ids[:n_load], np.int64)],
                     self.device)
        for st_kv, pool_kv in zip(staging, self.cache):
            if st_kv is None:
                continue
            for key in CACHE_PLANES:
                if key not in pool_kv:
                    continue
                pages = pool_kv[key][src]
                if self._int4 and key in ("k", "v"):
                    pages = unpack_int4(pages)
                self._page_view(st_kv[key])[:n_load] = pages.to(
                    st_kv[key].dtype)
        return staging


# --- prefix cache -----------------------------------------------------------


class _Node:
    __slots__ = ("nid", "page", "parent", "key", "last_used", "host")

    def __init__(self, nid, page, parent, key, last_used):
        self.nid = nid
        self.page = page          # device page id, or None when spilled
        self.host = None          # the host page id of a spilled node
        self.parent = parent
        self.key = key
        self.last_used = last_used


class PrefixCache:
    """Hash-consed shared prompt prefixes over a ``PagedKVPool``: a trie
    keyed by page-sized token runs, node ``(parent, tokens)`` owning the
    physical page of those positions. ``register()`` installs a
    request's full (immutable) context pages; ``match()`` walks the
    longest shared chain plus the best partial match among the last
    node's children (the copy-on-write donor), capped at ``len - 1`` (the
    last position is always recomputed: its logits seed the first
    token). Eviction is LRU over pages only the cache holds: with a host
    tier the victim SPILLS (its page goes to the host, the node stays
    matchable, and ``match()`` restores it onto a fresh device page);
    without host room the LRU leaf drops, and when every droppable leaf
    is already on the host the oldest spilled leaves drop first (JAX
    :860-909). Sharing is exact up to chunked-prefill reassociation of
    the softmax sums."""

    def __init__(self, pool: PagedKVPool):
        self._pool = pool
        self._nodes: Dict[int, _Node] = {}
        #: parent nid -> {page-token bytes -> node}; 0 is the root
        self._children: Dict[int, Dict[bytes, _Node]] = {0: {}}
        #: parent nid -> {first token -> [nodes]}: partial-match index
        self._first: Dict[int, Dict[int, List[_Node]]] = {}
        #: device page id -> its node: the residency probe the engine's
        #: swap-out reads (a resident page is held, not copied)
        self._by_page: Dict[int, _Node] = {}
        #: the router's affinity signal (JAX :684-687): root page-token
        #: bytes -> how many times ``match()`` served a chain rooted there;
        #: an entry dies with its root node (``_drop``)
        self._hits: Dict[bytes, int] = {}
        self._nid = itertools.count(1)
        self._tick = itertools.count()

    def __len__(self) -> int:
        return len(self._nodes)

    def resident(self, pid: int) -> bool:
        """Is device page ``pid`` held by a cache node now?"""
        return int(pid) in self._by_page

    def affinity_key(self, tokens) -> bytes:
        """The prompt's placement key for prefix-affinity routing (JAX
        :705): the bytes of its first page-sized token run, the trie's
        root edge. A prompt shorter than a page gets its short run back,
        which ``probe()`` never finds."""
        toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
        return toks[:self._pool.page_len].tobytes()

    def probe(self, key: bytes) -> Optional[int]:
        """Side-effect-free affinity probe (JAX :715; no LRU touch, no
        counter bump): None when no registered chain starts with ``key``,
        else how many times ``match()`` served a chain rooted at it (0:
        resident, not yet reused)."""
        if key not in self._children.get(0, {}):
            return None
        return self._hits.get(key, 0)

    def match(self, tokens) -> Tuple[List[int], int, Optional[int]]:
        """``(full_pages, shared_len, donor_page)``: the chained full-page
        hits, the shared length including the best partial page, and the
        page to copy-on-write for it (None for a page-aligned match). A
        spilled node on the way is restored onto a fresh device page;
        the walk stops where none can be had."""
        pl = self._pool.page_len
        toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
        n = len(toks)
        tick = next(self._tick)
        pages: List[int] = []
        parent = 0
        pos = 0
        while pos + pl < n:
            key = toks[pos:pos + pl].tobytes()
            node = self._children.get(parent, {}).get(key)
            if node is None:
                break
            if node.page is None and not self._restore_node(node):
                break                    # spilled, and no device page
            node.last_used = tick
            if parent == 0:
                # the chain's root page served a match (JAX :752)
                self._hits[key] = self._hits.get(key, 0) + 1
            pages.append(node.page)
            parent = node.nid
            pos += pl
        donor = None
        best = 0
        limit = min(pl, n - 1 - pos)
        if limit > 0:
            for node in self._first.get(parent, {}).get(int(toks[pos]), []):
                cand = np.frombuffer(node.key, np.int32)[:limit]
                m = int(np.cumprod(cand == toks[pos:pos + limit]).sum())
                if m > best:
                    best, donor = m, node
        if donor is not None and donor.page is None \
                and not self._restore_node(donor):
            donor = None                 # spilled donor, pool full
        if donor is not None:
            donor.last_used = tick
            return pages, pos + best, donor.page
        return pages, pos, None

    def _restore_node(self, node: _Node) -> bool:
        """Bring a spilled node back onto a fresh device page (the cache's
        hold), byte for byte; False when no page can be allocated."""
        pool = self._pool
        pid = pool.alloc_page()
        if pid is None:
            return False
        pool.restore_pages([node.host], [pid])
        pool.free_host([node.host])
        node.host = None
        node.page = pid
        self._by_page[pid] = node
        return True

    def register(self, tokens, table_row) -> int:
        """Install every full page of ``tokens`` (physical ids from
        ``table_row``); pages already registered along the chain stay as
        they are, except that a node spilled since the request's match
        adopts the request's own copy of the page (its host copy is
        freed). Each new node increfs its page. Returns the number of
        pages newly registered."""
        pool = self._pool
        pl = pool.page_len
        toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
        tick = next(self._tick)
        parent = 0
        added = 0
        for j in range(len(toks) // pl):
            key = toks[j * pl:(j + 1) * pl].tobytes()
            ch = self._children.setdefault(parent, {})
            node = ch.get(key)
            pid = int(table_row[j])
            if node is not None and node.page is None \
                    and pid < pool.num_pages:
                node.page = pid
                pool.incref(pid)
                self._by_page[pid] = node
                pool.free_host([node.host])
                node.host = None
            if node is None:
                if pid >= pool.num_pages:
                    break                # unallocated: nothing to share
                node = _Node(next(self._nid), pid, parent, key, tick)
                ch[key] = node
                self._children[node.nid] = {}
                self._nodes[node.nid] = node
                self._first.setdefault(parent, {}).setdefault(
                    int(toks[j * pl]), []).append(node)
                pool.incref(pid)
                self._by_page[pid] = node
                added += 1
            node.last_used = tick
            parent = node.nid
        return added

    def _drop(self, node: _Node) -> None:
        """Remove a node, releasing its device or host page."""
        del self._children[node.parent][node.key]
        del self._children[node.nid]
        del self._nodes[node.nid]
        if node.parent == 0:
            self._hits.pop(node.key, None)
        tok0 = int(np.frombuffer(node.key, np.int32)[0])
        bucket = self._first.get(node.parent, {}).get(tok0, [])
        if node in bucket:
            bucket.remove(node)
        if node.page is not None:
            self._by_page.pop(node.page, None)
            self._pool.decref(node.page)
        else:
            self._pool.free_host([node.host])

    def evict_one(self) -> bool:
        """Free ONE device page held only by the cache: spill the LRU such
        node to the host tier, else drop the LRU such leaf, else drop the
        oldest spilled leaf and try again. False when no device page can
        be freed."""
        pool = self._pool
        while True:
            spill = drop = host_leaf = None
            for node in self._nodes.values():
                leaf = not self._children.get(node.nid)
                if node.page is None:
                    if leaf and (host_leaf is None
                                 or node.last_used < host_leaf.last_used):
                        host_leaf = node
                    continue
                if pool.ref[node.page] != 1:
                    continue                  # a slot still reads it
                if spill is None or node.last_used < spill.last_used:
                    spill = node
                if leaf and (drop is None or node.last_used < drop.last_used):
                    drop = node
            if spill is not None and pool.host_free_pages > 0:
                hids = pool.offload_pages([spill.page])
                if hids is not None:
                    self._by_page.pop(spill.page, None)
                    pool.decref(spill.page)
                    spill.page = None
                    spill.host = hids[0]
                    return True
            if drop is not None:
                self._drop(drop)
                return True
            if spill is None or host_leaf is None:
                return False
            # the host tier is full and no device leaf is droppable:
            # dropping the oldest spilled leaf frees host room
            self._drop(host_leaf)

    def evictable_pages(self) -> int:
        """Device pages the cache could free under pressure (JAX :911):
        cache-only nodes whose subtree is all cache-only or spilled
        (dropping is leaf-first), plus the cache-only nodes that can only
        spill, at most the host tier's free pages."""
        memo: Dict[int, bool] = {}
        ref = self._pool.ref

        def ok(nid: int) -> bool:
            got = memo.get(nid)
            if got is not None:
                return got
            node = self._nodes[nid]
            memo[nid] = res = (
                (node.page is None or ref[node.page] == 1)
                and all(ok(c.nid)
                        for c in self._children.get(nid, {}).values()))
            return res

        droppable = spill_only = 0
        for node in self._nodes.values():
            if node.page is None or ref[node.page] != 1:
                continue
            if ok(node.nid):
                droppable += 1
            else:
                spill_only += 1
        return droppable + min(spill_only, self._pool.host_free_pages)

    def reclaim(self, n_pages: int) -> int:
        """Evict until ``n_pages`` pages were freed (or nothing more is
        evictable); returns the number freed."""
        freed = 0
        while freed < n_pages and self.evict_one():
            freed += 1
        return freed
