"""Draft sources for speculative decoding in the port's serving engine.

Mirrors ``distkeras_tpu/serving/speculation.py``: a DRAFT proposes
``d_1..d_k`` per slot, the target scores the whole ``[tok, d_1, ..,
d_k]`` window in one verify pass (``models.decoding
.verify_step_slots_paged``) and the longest prefix of drafts matching
the target's own choices is accepted, plus the target's next token for
free: between 1 and ``k + 1`` tokens per target pass. With tree
speculation a source proposes a token TREE (``propose_tree``), verified
through one tree-masked window (the ancestor mask of the paged kernel).

- ``NgramDraft`` (:201): prompt-lookup self-drafting, a numpy suffix
  match over the stream's own prompt and generated tokens; trees branch
  on the distinct historical continuations of the matched suffix.
- ``DraftModel`` (:369): a small target-compatible LM decoded greedily
  ``k`` steps ahead through its own ``PagedKVPool`` (worst-case pages
  per slot, allocated eagerly at ``begin_slot``); trees are beam-style
  (the greedy chain plus the top-``width`` runner-ups as one-node side
  branches), and ``_heal`` replays committed tokens where a side branch
  was accepted.

Drafts are deterministic (argmax or lookup): sampling from the target
and accepting while it equals the draft is then exact rejection
sampling, and a sampled stream stays the plain sampled stream (one split
of the request's key per emitted token).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from distkeras_tpu_torch.models.core import Sequential
from distkeras_tpu_torch.models.decoding import (attn_compute_dtype,
                                                 decode_step_slots_paged,
                                                 fuse_qkv_params,
                                                 prefill_chunk_step,
                                                 serving_params)
from distkeras_tpu_torch.serving.kv_pool import PagedKVPool

__all__ = ["DraftSource", "NgramDraft", "DraftModel", "tree_ancestors",
           "build_token_tree"]


def tree_ancestors(parents: np.ndarray):
    """Parent-index vectors ``[S, W]`` (node 0 = root, ``parents[s, 0] =
    -1``, unused nodes -1) -> ``(depth [S, W] int32, anc [S, W, W] bool,
    n_nodes [S] int64)``. ``anc[s, i, j]`` is True iff node j is i or an
    ancestor of i; ``depth`` is each node's root-path offset; ``n_nodes``
    counts root + used nodes (the window columns ``t .. t + n_nodes - 1``
    the verify writes). Parents must be topologically ordered."""
    parents = np.asarray(parents, np.int64)
    s_n, w_len = parents.shape
    depth = np.zeros((s_n, w_len), np.int32)
    anc = np.zeros((s_n, w_len, w_len), bool)
    anc[:, 0, 0] = True
    rows = np.arange(s_n)
    for j in range(1, w_len):
        p = parents[:, j]
        used = p >= 0
        pc = np.where(used, p, 0)
        anc[:, j] = np.where(used[:, None], anc[rows, pc], False)
        anc[rows, j, j] = used
        depth[:, j] = np.where(used, depth[rows, pc] + 1, 0)
    n_nodes = (parents >= 0).sum(axis=1) + 1
    return depth, anc, n_nodes


def build_token_tree(chains, toks_row: np.ndarray,
                     parents_row: np.ndarray, max_nodes: int) -> int:
    """Merge candidate continuation ``chains`` (best first) into one
    slot's tree arrays: shared prefixes hash-cons onto one node, under a
    ``max_nodes`` draft-node budget (later chains truncate first).
    ``toks_row[0]`` (the root) is the caller's; returns the number of
    draft nodes used."""
    index = {}
    nxt = 1
    cap = min(int(max_nodes), len(toks_row) - 1)
    for chain in chains:
        par = 0
        for tokv in chain:
            key = (par, int(tokv))
            nid = index.get(key)
            if nid is None:
                if nxt > cap:
                    break
                nid = nxt
                nxt += 1
                index[key] = nid
                toks_row[nid] = int(tokv)
                parents_row[nid] = par
            par = nid
    return nxt - 1


class DraftSource:
    """What the serving engine drives. Implementations fill a ``[S, k]``
    draft buffer per iteration; every hook runs on the engine's thread.
    ``begin_slot`` returns False when the source cannot draft for the
    request (its own pool is dry): the engine then disables speculation
    for that request only."""

    def bind(self, engine) -> None:
        """Called once from ``ServingEngine.__init__`` with the engine."""

    def begin_slot(self, slot: int, context: np.ndarray) -> bool:
        """A request joined decode in ``slot`` with ``context`` tokens in
        the target cache. Returns whether this source drafts for it."""
        return True

    def end_slot(self, slot: int) -> None:
        """The slot's request left decode; tolerates slots never begun."""

    def propose(self, requests: Dict[int, object], tok: np.ndarray,
                t: np.ndarray, out: np.ndarray,
                active: np.ndarray) -> None:
        """Fill ``out[slot, :k]`` with drafts continuing ``tok[slot]``
        (the pending input at position ``t[slot]``) for every slot with
        ``active[slot]``; ``requests`` maps slot -> Request."""
        raise NotImplementedError

    def propose_tree(self, requests: Dict[int, object], tok: np.ndarray,
                     t: np.ndarray, toks: np.ndarray,
                     parents: np.ndarray, active: np.ndarray,
                     depth: np.ndarray, width: np.ndarray,
                     max_nodes: np.ndarray) -> None:
        """Fill per-slot token trees ``toks``/``parents`` ``[S, W]`` (node
        0 holds the pending input with parent -1; unused nodes keep -1)
        with up to ``max_nodes[slot]`` draft nodes shaped by ``depth``
        and ``width``. The default lays the linear proposal out as a
        width-1 root path."""
        k = toks.shape[1] - 1
        buf = np.zeros((toks.shape[0], k), np.int32)
        self.propose(requests, tok, t, buf, active)
        cols = np.arange(k)
        use = active[:, None] & (
            cols[None, :] < np.minimum(depth, max_nodes)[:, None])
        toks[:, 1:] = np.where(use, buf, 0)
        parents[:, 1:] = np.where(use, cols[None, :], -1)


class NgramDraft(DraftSource):
    """Prompt-lookup self-drafting: for suffix lengths ``max_ngram`` down
    to ``min_ngram``, propose the ``k`` tokens that followed the most
    recent earlier occurrence of the stream's suffix, over at most
    ``max_context`` recent tokens. No weights and no device work."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 max_context: int = 4096):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"{min_ngram}/{max_ngram}")
        if max_context < max_ngram + 1:
            raise ValueError(
                f"max_context ({max_context}) must exceed max_ngram")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        self.max_context = int(max_context)

    def _context(self, req) -> np.ndarray:
        """The most recent ``max_context`` tokens of prompt + generated
        (sliced before concatenating, so the copy is bounded too)."""
        cap = self.max_context
        gen = req.generated[-cap:]
        head = req.prompt[-max(0, cap - len(gen)):] \
            if len(gen) < cap else req.prompt[:0]
        return np.concatenate([head, np.asarray(gen, np.int32)])

    def propose(self, requests, tok, t, out, active):
        k = out.shape[1]
        for slot, req in requests.items():
            if not active[slot]:
                continue
            out[slot] = self.lookup(self._context(req), k)

    def lookup(self, ctx: np.ndarray, k: int) -> np.ndarray:
        """The k-token proposal continuing ``ctx`` (ending with the
        pending input); zeros when no suffix re-occurs."""
        buf = np.zeros(k, np.int32)
        n_hi = min(self.max_ngram, len(ctx) - 1)
        for n in range(n_hi, self.min_ngram - 1, -1):
            suffix = ctx[-n:]
            win = np.lib.stride_tricks.sliding_window_view(ctx[:-1], n)
            hits = np.flatnonzero((win == suffix).all(axis=1))
            if not hits.size:
                continue
            # most recent occurrence, preferring one with a full k-token
            # continuation
            full = hits[hits + n + k <= len(ctx)]
            i = int(full[-1] if full.size else hits[-1])
            cont = ctx[i + n:i + n + k]
            buf[:len(cont)] = cont
            if 0 < len(cont) < k:
                buf[len(cont):] = cont[-1]
            return buf
        return buf

    def continuations(self, ctx: np.ndarray, m: int):
        """The ``m`` most recent distinct next tokens following the
        current suffix of ``ctx`` (most recent first); empty when nothing
        re-occurs."""
        if m < 1:
            return []
        n_hi = min(self.max_ngram, len(ctx) - 1)
        for n in range(n_hi, self.min_ngram - 1, -1):
            suffix = ctx[-n:]
            win = np.lib.stride_tricks.sliding_window_view(ctx[:-1], n)
            hits = np.flatnonzero((win == suffix).all(axis=1))
            if not hits.size:
                continue
            out = []
            for h in hits[::-1]:
                tv = int(ctx[h + n])
                if tv not in out:
                    out.append(tv)
                    if len(out) >= m:
                        break
            return out
        return []

    def propose_tree(self, requests, tok, t, toks, parents, active,
                     depth, width, max_nodes):
        for slot, req in requests.items():
            if not active[slot]:
                continue
            self._grow(self._context(req), toks[slot], parents[slot],
                       int(depth[slot]), int(width[slot]),
                       int(max_nodes[slot]))

    def _grow(self, ctx, toks_row, parents_row, depth: int, width: int,
              max_nodes: int) -> int:
        """Grow one slot's tree; returns the draft nodes placed. Budget
        order: the primary chain (the most recent continuation at every
        node, the linear draft's bet) to full depth, then alternates
        shallow-first, each extended by its own primary chain. Each
        expansion re-scans ``ctx`` extended by the node's root path."""
        cap = min(int(max_nodes), len(toks_row) - 1)
        if cap < 1 or depth < 1:
            return 0
        used = 0
        alternates = deque()

        def chain(par: int, path, depth_left: int):
            nonlocal used
            while depth_left > 0 and used < cap:
                ctx_ext = (np.concatenate(
                    [ctx, np.asarray(path, np.int32)]) if path else ctx)
                conts = self.continuations(ctx_ext, width)
                if not conts:
                    return
                for tv in conts[1:]:
                    alternates.append((par, list(path), tv, depth_left))
                used += 1
                nid = used
                toks_row[nid] = conts[0]
                parents_row[nid] = par
                par = nid
                path = path + [conts[0]]
                depth_left -= 1

        chain(0, [], depth)
        while alternates and used < cap:
            par, path, tv, depth_left = alternates.popleft()
            used += 1
            nid = used
            toks_row[nid] = tv
            parents_row[nid] = par
            chain(nid, path + [tv], depth_left - 1)
        return used


class DraftModel(DraftSource):
    """A target-compatible LM (same vocabulary) drafting ``k`` greedy
    steps ahead through its own paged pool. The pool is built at
    ``bind`` (default: worst-case parity, ``num_slots * ceil(max_len /
    page_len)`` pages); ``begin_slot`` allocates a slot's worst case
    eagerly and returns False when the pool is dry. The model must live
    on the engine's device."""

    def __init__(self, model, *, page_len: int = 16,
                 num_pages: Optional[int] = None, cache_dtype=None,
                 weights_dtype="auto"):
        module = model.module
        if not isinstance(module, Sequential):
            raise TypeError("DraftModel expects a Sequential LM "
                            f"(got {type(module).__name__})")
        self.model = model
        self.module = module
        compute_dt = attn_compute_dtype(module) or torch.float32
        self._cache_dtype = compute_dt if cache_dtype is None \
            else cache_dtype
        # "auto" casts matrices to the compute dtype, as the engine does;
        # None keeps the model's own float32 weights
        dt = {"auto": compute_dt, None: torch.float32}.get(
            weights_dtype, weights_dtype)
        with torch.no_grad():
            self._params = fuse_qkv_params(
                module, serving_params(model.params, dt))
        self._page_len = int(page_len)
        self._num_pages = num_pages
        self.pool = None                     # built at bind()
        self._staging = None
        self._active = set()                 # slots with live draft KV
        #: slot -> (t0, [tokens]): what the last draft round wrote into
        #: the draft KV at positions t0.. (the greedy chain), for _heal
        self._written = {}

    def bind(self, engine) -> None:
        if self.model.device != engine.device:
            raise ValueError(f"the draft model lives on {self.model.device}, "
                             f"the engine on {engine.device}")
        self.pool = PagedKVPool(self.module, engine.num_slots,
                                engine.max_len, page_len=self._page_len,
                                num_pages=self._num_pages,
                                dtype=self._cache_dtype,
                                device=engine.device)
        self._staging = self.pool.make_request_cache()

    def begin_slot(self, slot: int, context: np.ndarray) -> bool:
        self.end_slot(slot)                  # tolerate re-begin
        pool = self.pool
        pids = []
        for _ in range(pool.pages_per_slot):
            pid = pool.alloc_page()
            if pid is None:
                for p in pids:
                    pool.decref(p)
                return False                 # draft pool dry: no drafting
            pids.append(pid)
        for j, pid in enumerate(pids):
            pool.assign(slot, j, pid)
        n = len(context)
        chunk = torch.as_tensor(np.asarray(context, np.int64)[None],
                                device=pool.device)
        # head-less: the draft only needs the context's cache entries
        _, self._staging = prefill_chunk_step(self.module, self._params,
                                              self._staging, chunk, 0,
                                              final=False)
        pool.insert_pages(self._staging, slot, 0, n)
        self._active.add(slot)
        return True

    def end_slot(self, slot: int) -> None:
        if self.pool is not None and slot in self._active:
            self.pool.release_slot(slot)
            self._active.discard(slot)
        self._written.pop(slot, None)

    def _step(self, cur, tt, tables, width: int):
        """One draft decode step over all slots: the ``[S, width]`` top
        ids (column 0 the argmax; ties to the lower index, as
        ``lax.top_k`` orders them)."""
        logits, _ = decode_step_slots_paged(self.module, self._params,
                                            self.pool.cache, cur, tt,
                                            tables, self.pool.page_len)
        if width == 1:
            return torch.argmax(logits, dim=-1)[:, None]
        return torch.sort(logits, dim=-1, descending=True,
                          stable=True).indices[:, :width]

    def _heal(self, requests, tok, t) -> None:
        """Rewrite draft-KV positions where the stream committed a token
        other than the one the last draft round wrote there (an accepted
        tree side branch), replaying the committed tokens through the
        ordinary draft step, batched over slots."""
        s_n = len(t)
        start = np.full(s_n, -1, np.int64)
        stop = np.zeros(s_n, np.int64)
        actual = {}
        for slot, req in requests.items():
            rec = self._written.get(slot)
            if slot not in self._active or rec is None:
                continue
            t0, chain = rec
            ctx = np.concatenate(
                [req.prompt, np.asarray(req.generated, np.int32)])
            hi = min(int(t[slot]), t0 + len(chain), len(ctx))
            d = t0
            while d < hi and chain[d - t0] == int(ctx[d]):
                d += 1
            if d < hi:
                start[slot] = d
                stop[slot] = hi
                actual[slot] = ctx
        if (start < 0).all():
            return
        dev = self.pool.device
        tables = self.pool.device_tables()
        n_heal = int((stop - np.maximum(start, 0)).max())
        for j in range(n_heal):
            pos = start + j
            live = (start >= 0) & (pos < stop)
            tt = np.where(live, pos, self.pool.max_len).astype(np.int32)
            cur = np.zeros(s_n, np.int64)
            for slot in actual:
                if live[slot]:
                    cur[slot] = int(actual[slot][pos[slot]])
            self._step(torch.from_numpy(cur).to(dev),
                       torch.from_numpy(tt).to(dev), tables, 1)

    def _draft_steps(self, requests, tok, t, k: int, width: int):
        """``k`` greedy draft steps feeding the argmax forward; returns
        the per-step ``[S, width]`` top-id matrices (numpy). Slots
        without live draft KV run at the inert sentinel. Heals first,
        and records what this round writes for the next heal."""
        self._heal(requests, tok, t)
        dev = self.pool.device
        tables = self.pool.device_tables()
        live = np.array([s in self._active for s in range(len(t))])
        tt = torch.from_numpy(np.where(live, t, self.pool.max_len)
                              .astype(np.int32)).to(dev)
        cur = torch.from_numpy(np.asarray(tok, np.int64)).to(dev)
        tops = []
        for _ in range(k):
            ids = self._step(cur, tt, tables, width)
            tops.append(ids)
            cur = ids[:, 0]
            tt = tt + 1
        # the draft model's per-step read: drafting is host-driven
        tops = list(torch.stack(tops).cpu().numpy()  # lint: allow-host-sync
                    .astype(np.int32))
        for slot in self._active:
            self._written[slot] = (
                int(t[slot]),
                [int(tok[slot])] + [int(ids[slot, 0]) for ids in tops[:-1]])
        return tops

    def propose(self, requests, tok, t, out, active):
        if not self._active:
            return
        tops = self._draft_steps(requests, tok, t, out.shape[1], 1)
        for j, ids in enumerate(tops):
            out[:, j] = ids[:, 0]

    def propose_tree(self, requests, tok, t, toks, parents, active,
                     depth, width, max_nodes):
        """Beam-style tree: the greedy chain carries the depth, and at
        every chain position the draft's top-``width`` runner-ups hang
        off as one-node side branches."""
        if not self._active:
            return
        k = int(depth.max()) if depth.size else 0
        w = int(width.max()) if width.size else 1
        if k < 1:
            return
        tops = self._draft_steps(requests, tok, t, k, max(1, w))
        for slot in range(toks.shape[0]):
            if not active[slot] or slot not in self._active:
                continue
            d = int(depth[slot])
            wd = int(width[slot])
            greedy_chain = np.asarray(
                [tops[j][slot, 0] for j in range(d)], np.int32)
            chains = [greedy_chain]
            for j in range(d):
                for r in range(1, min(wd, tops[j].shape[1])):
                    chains.append(np.concatenate(
                        [greedy_chain[:j],
                         tops[j][slot, r:r + 1]]).astype(np.int32))
            build_token_tree(chains, toks[slot], parents[slot],
                             int(max_nodes[slot]))
