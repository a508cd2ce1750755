"""The paged KV pool of the serving engine and its prefix cache.

Mirrors ``distkeras_tpu/serving/kv_pool.py``: ``PagedKVPool`` holds one
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
(``sink_bytes``). The host offload tier (``host_pages``) is not ported
yet: it raises naming its ROADMAP item.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from distkeras_tpu_torch.models.decoding import (CACHE_PLANES, cache_kind,
                                                 init_cache, pack_int4,
                                                 sink_views, unpack_int4)

_HOST_OFFLOAD = "Queue 1 item 8 (host KV offload)"

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
    if device.type != "cuda":
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


class PagedKVPool:
    """Fixed pool of ``num_pages`` KV pages per layer + per-slot page
    tables + refcounted allocation. ``cache`` is the per-layer list of
    ``{"k", "v"}`` page tensors (plus the scale planes and the ``"q4"``
    marker of a quantized pool) the decode step reads and writes in
    place; ``tables`` the host ``[S, P]`` int32 array."""

    def __init__(self, module, num_slots: int, max_len: int, *,
                 page_len: int = 16, num_pages: Optional[int] = None,
                 dtype=torch.float32, device=None, host_pages: int = 0,
                 hbm_budget: Optional[int] = None, reserve_bytes: int = 0):
        # the JAX pool's host tier is a later slice: its "off" value passes
        if host_pages != 0:
            raise NotImplementedError(
                f"PagedKVPool(host_pages={host_pages!r}) is not ported "
                f"yet: ROADMAP, {_HOST_OFFLOAD}")
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
    __slots__ = ("nid", "page", "parent", "key", "last_used")

    def __init__(self, nid, page, parent, key, last_used):
        self.nid = nid
        self.page = page
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
    token). Eviction is LRU over leaves whose page only the cache holds.
    Sharing is exact up to chunked-prefill reassociation of the softmax
    sums."""

    def __init__(self, pool: PagedKVPool):
        self._pool = pool
        self._nodes: Dict[int, _Node] = {}
        #: parent nid -> {page-token bytes -> node}; 0 is the root
        self._children: Dict[int, Dict[bytes, _Node]] = {0: {}}
        #: parent nid -> {first token -> [nodes]}: partial-match index
        self._first: Dict[int, Dict[int, List[_Node]]] = {}
        self._nid = itertools.count(1)
        self._tick = itertools.count()

    def __len__(self) -> int:
        return len(self._nodes)

    def match(self, tokens) -> Tuple[List[int], int, Optional[int]]:
        """``(full_pages, shared_len, donor_page)``: the chained full-page
        hits, the shared length including the best partial page, and the
        page to copy-on-write for it (None for a page-aligned match)."""
        pl = self._pool.page_len
        toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
        n = len(toks)
        tick = next(self._tick)
        pages: List[int] = []
        parent = 0
        pos = 0
        while pos + pl < n:
            node = self._children.get(parent, {}).get(
                toks[pos:pos + pl].tobytes())
            if node is None:
                break
            node.last_used = tick
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
        if donor is not None:
            donor.last_used = tick
            return pages, pos + best, donor.page
        return pages, pos, None

    def register(self, tokens, table_row) -> int:
        """Install every full page of ``tokens`` (physical ids from
        ``table_row``); pages already registered along the chain stay as
        they are. Each new node increfs its page. Returns the number of
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
            if node is None:
                pid = int(table_row[j])
                if pid >= pool.num_pages:
                    break                # unallocated: nothing to share
                node = _Node(next(self._nid), pid, parent, key, tick)
                ch[key] = node
                self._children[node.nid] = {}
                self._nodes[node.nid] = node
                self._first.setdefault(parent, {}).setdefault(
                    int(toks[j * pl]), []).append(node)
                pool.incref(pid)
                added += 1
            node.last_used = tick
            parent = node.nid
        return added

    def _drop(self, node: _Node) -> None:
        del self._children[node.parent][node.key]
        del self._children[node.nid]
        del self._nodes[node.nid]
        tok0 = int(np.frombuffer(node.key, np.int32)[0])
        bucket = self._first.get(node.parent, {}).get(tok0, [])
        if node in bucket:
            bucket.remove(node)
        self._pool.decref(node.page)

    def evict_one(self) -> bool:
        """Free ONE device page held only by the cache: the LRU leaf whose
        page no slot reads. False when there is none."""
        pool = self._pool
        drop = None
        for node in self._nodes.values():
            if self._children.get(node.nid) or pool.ref[node.page] != 1:
                continue
            if drop is None or node.last_used < drop.last_used:
                drop = node
        if drop is None:
            return False
        self._drop(drop)
        return True

    def evictable_pages(self) -> int:
        """Pages the cache could eventually free: nodes whose page only
        the cache holds and whose whole subtree is the same (dropping is
        leaf-first)."""
        memo: Dict[int, bool] = {}

        def ok(nid: int) -> bool:
            got = memo.get(nid)
            if got is not None:
                return got
            node = self._nodes[nid]
            memo[nid] = res = (
                self._pool.ref[node.page] == 1
                and all(ok(c.nid)
                        for c in self._children.get(nid, {}).values()))
            return res

        return sum(1 for node in self._nodes.values() if ok(node.nid))

    def reclaim(self, n_pages: int) -> int:
        """Evict until ``n_pages`` pages were freed (or nothing more is
        evictable); returns the number freed."""
        freed = 0
        while freed < n_pages and self.evict_one():
            freed += 1
        return freed
