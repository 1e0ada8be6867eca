"""Radix prefix cache: COW KV sharing over the page pool (DESIGN.md §12).

Identical token prefix ⇒ identical KV (the losslessness invariant every
lossless-serving stack shares), so KV pages computed for one request can
back any later request whose prompt starts with the same tokens. The tree
indexes token-id sequences at *page* granularity: each node owns exactly
one full page of `page_size` tokens, keyed by that page's token tuple, and
holds its own incref on the page in the shared `PagePool`. Matching,
insertion and eviction therefore only ever deal in immutable full pages —
the copy-on-write discipline is structural:

  match    walks full-page keys; a hit hands back shared page ids that the
           admission path increfs into the request's BlockTable. The match
           is capped below the prompt's last token (`max_pages`), so every
           request prefills at least one uncached token (the logits that
           seed its first sampled token) and never *writes* a shared page —
           growth past the matched prefix allocates fresh pages.
  insert   adopts a finished request's committed pages node-by-node
           (increfs keep them alive after the request's table releases);
           pages already keyed in the tree are kept (first writer wins —
           both copies hold identical KV by the invariant above).
  evict    LRU leaves first, refcount-pinned pages skipped: a page some
           live BlockTable still shares (refcount > the tree's own hold)
           frees no memory if dropped, so eviction reclaims only pages the
           tree is the sole owner of. Under pool pressure cached pages are
           the *first* thing reclaimed — before any live request is
           preempted (scheduler/_grow_active ordering, DESIGN.md §10).

The tree is substrate-agnostic: over the scheduler's bookkeeping pool it
tracks which simulated pages are reusable; over the engine's real pool the
same structure carries actual K/V bytes (serving/backend.EngineBackend).

The port's copy of ``repro.prefixcache.radix``, the flight recorder's
prefix.hit / prefix.insert / prefix.evict instants included, with the
imports pointed at the port.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.kvcache.pool import PagePool
from repro_torch.obs import trace as tr_ev
from repro_torch.obs.trace import get_tracer
from repro_torch.prefixcache.digest import (ROOT_SEED, PrefixDigest,
                                            chain_hash)


class _Node:
    """One cached page: `key` is its page_size-token tuple, `page` the
    physical page id the tree holds an incref on. `cum` is the cumulative
    chain hash H(parent.cum, key) — it pins down the node's entire root
    path in one integer and is what digest() exports (digest.py)."""
    __slots__ = ("key", "page", "children", "parent", "last_use", "cum")

    def __init__(self, key: Optional[Tuple[int, ...]], page: Optional[int],
                 parent: Optional["_Node"]):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.last_use = 0
        self.cum = ROOT_SEED if parent is None \
            else chain_hash(parent.cum, key)


class RadixPrefixCache:
    """Token-prefix -> shared KV pages, over a two-tier PagePool."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self._root = _Node(None, None, None)
        self._clock = 0
        self._n_pages = 0
        self._cum: Dict[int, int] = {}  # chain hash -> node count (hash
                                        # collisions keep both alive)
        # cumulative counters (benchmark / metrics surface)
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.inserted_pages = 0
        self.evicted_pages = 0

    # -- introspection -----------------------------------------------------------
    @property
    def n_pages(self) -> int:
        """Pages the tree currently holds an incref on."""
        return self._n_pages

    def cached_tokens(self) -> int:
        return self._n_pages * self.page_size

    def digest(self) -> PrefixDigest:
        """Router-side snapshot: the cumulative chain hash of every cached
        node (digest.py). O(cached pages) to build, O(prompt pages) to
        query — no token tuples leave the tree."""
        return PrefixDigest(self.page_size, self._cum)

    def _keys(self, tokens: Sequence[int], n_pages: int):
        ps = self.page_size
        for j in range(n_pages):
            yield tuple(int(t) for t in tokens[j * ps:(j + 1) * ps])

    # -- match -------------------------------------------------------------------
    def match(self, tokens: Sequence[int],
              max_pages: Optional[int] = None) -> Tuple[List[int], int]:
        """Longest cached page-aligned prefix of `tokens`. Returns
        (shared page ids, matched token count). `max_pages` caps the walk
        (admission caps it at (prompt_len - 1) // page_size so at least
        one prompt token is always left to prefill)."""
        self._clock += 1
        self.lookups += 1
        cap = len(tokens) // self.page_size
        if max_pages is not None:
            cap = min(cap, max_pages)
        node, pages = self._root, []
        for key in self._keys(tokens, cap):
            child = node.children.get(key)
            if child is None:
                break
            child.last_use = self._clock
            pages.append(child.page)
            node = child
        if pages:
            self.hits += 1
            self.hit_tokens += len(pages) * self.page_size
            tr = get_tracer()
            if tr is not None:
                tr.instant(tr_ev.PREFIX_HIT, track=tr_ev.TRACK_PREFIX,
                           args={"pages": len(pages),
                                 "tokens": len(pages) * self.page_size})
        return pages, len(pages) * self.page_size

    # -- insert ------------------------------------------------------------------
    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               n_tokens: Optional[int] = None) -> int:
        """Adopt the full pages of `tokens[:n_tokens]` (token j*ps..(j+1)*ps
        backed by pages[j] — a BlockTable's positional layout). Pages whose
        key already exists are skipped (the tree keeps its copy); new nodes
        incref their page so it outlives the donating table. Returns pages
        newly adopted."""
        self._clock += 1
        n = len(tokens) if n_tokens is None else min(n_tokens, len(tokens))
        n_pages = min(n // self.page_size, len(pages))
        node, new = self._root, 0
        for j, key in enumerate(self._keys(tokens, n_pages)):
            child = node.children.get(key)
            if child is None:
                self.pool.incref_page(pages[j])
                child = _Node(key, pages[j], node)
                node.children[key] = child
                self._cum[child.cum] = self._cum.get(child.cum, 0) + 1
                self._n_pages += 1
                new += 1
            child.last_use = self._clock
            node = child
        self.inserted_pages += new
        if new:
            tr = get_tracer()
            if tr is not None:
                tr.instant(tr_ev.PREFIX_INSERT, track=tr_ev.TRACK_PREFIX,
                           args={"pages": new, "total": self._n_pages})
        return new

    # -- evict -------------------------------------------------------------------
    def _drop(self, node: _Node) -> None:
        node.parent.children.pop(node.key)
        self.pool.decref_page(node.page)
        left = self._cum.get(node.cum, 1) - 1
        if left:
            self._cum[node.cum] = left
        else:
            self._cum.pop(node.cum, None)
        self._n_pages -= 1
        self.evicted_pages += 1

    def evict(self, n_pages: int, tier: Optional[str] = None) -> int:
        """Drop up to `n_pages` LRU leaves whose page the tree solely owns
        (refcount == 1 — dropping a page a live table still shares frees
        nothing). `tier` restricts eviction to pages resident there: a
        caller starved for *device* pages gains nothing from freeing
        host-tier leaves (planner delegation can park cached pages on the
        host). Unlinking a leaf can expose its parent; the sweep repeats
        until the target is met or every remaining leaf is pinned/
        off-tier. Returns pages actually freed."""
        freed = 0
        while freed < n_pages:
            leaves = [n for n in self._iter_nodes() if not n.children]
            progress = False
            for leaf in sorted(leaves, key=lambda n: n.last_use):
                if freed >= n_pages:
                    break
                if self.pool.alloc.refcount(leaf.page) != 1:
                    continue            # pinned: shared with a live table
                if tier is not None and self.pool.tier_of(leaf.page) != tier:
                    continue            # frees the wrong tier's capacity
                self._drop(leaf)
                freed += 1
                progress = True
            if not progress:
                break
        if freed:
            tr = get_tracer()
            if tr is not None:
                tr.instant(tr_ev.PREFIX_EVICT, track=tr_ev.TRACK_PREFIX,
                           args={"pages": freed, "total": self._n_pages})
        return freed

    def release_all(self) -> int:
        """Drop every node regardless of pinning (shutdown / pool teardown);
        returns pages released."""
        n = 0
        for node in list(self._iter_nodes()):
            self.pool.decref_page(node.page)
            n += 1
        self._root.children.clear()
        self._cum.clear()
        self._n_pages = 0
        return n

    def _iter_nodes(self):
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())
