"""Page-granular KV admission: the scheduler-facing facade (counterpart
of ``repro.kvcache.manager``).

Worst-case reservation admits a request only if `prompt + max_new` tokens
fit the budget for its whole lifetime. Page-granular admission allocates
ceil((prompt+1)/page_size) pages up front and one page per `page_size`
generated tokens after that, so co-residency is bounded by actual
occupancy. The pool can then run dry mid-generation; the manager exposes
the two standard outs:

  spill      preempt a victim by migrating its whole table to the host
             tier (kept warm; resume = fetch back, priced in bytes)
  recompute  drop the victim's pages entirely; resume re-prefills
             prompt + generated-so-far (priced in compute by the backend)

Victim choice is the caller's policy (the scheduler preempts the
latest-admitted request); the manager keeps the bookkeeping honest: a
request is resident (all pages DEVICE), suspended (its solely-owned pages
HOST, or none) or released. The JAX package's code, unchanged.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.kvcache.allocator import BlockTable, OutOfPages
from repro_torch.kvcache.pool import DEVICE, HOST, PagePool

SPILL = "spill"
RECOMPUTE = "recompute"


class PagedKVManager:
    def __init__(self, pool: PagePool):
        self.pool = pool
        self._tables: Dict[int, BlockTable] = {}
        self._suspended: Dict[int, bool] = {}

    # -- introspection -----------------------------------------------------------
    @property
    def page_size(self) -> int:
        return self.pool.page_size

    def table(self, rid: int) -> BlockTable:
        return self._tables[rid]

    def tokens_of(self, rid: int) -> int:
        return self._tables[rid].tokens

    def pages_of(self, rid: int) -> int:
        return len(self._tables[rid].pages)

    def device_pages_in_use(self) -> int:
        return self.pool.pages_in_use(DEVICE)

    def is_suspended(self, rid: int) -> bool:
        return self._suspended.get(rid, False)

    # -- admission ---------------------------------------------------------------
    def can_admit(self, n_tokens: int, headroom_pages: int = 0) -> bool:
        """`headroom_pages`: free device pages that must remain *after*
        the allocation (admission watermark: each resident request wants
        another page within page_size steps)."""
        need = self.pool.pages_for(n_tokens) + max(headroom_pages, 0)
        return self.pool.can_alloc(need, DEVICE)

    def admit(self, rid: int, n_tokens: int) -> bool:
        """Allocate a fresh table holding `n_tokens` (prompt + first token).
        False (and no side effects) when the device tier can't hold it."""
        if rid in self._tables:
            raise ValueError(f"request {rid} already admitted")
        if not self.can_admit(n_tokens):
            return False
        t = BlockTable(self.pool.page_size)
        self.pool.extend_table(t, n_tokens, DEVICE)
        self._tables[rid] = t
        self._suspended[rid] = False
        return True

    # -- prefix-cache admission --------------------------------------------------
    def can_admit_prefix(self, n_tokens: int, prefix_pages: List[int],
                         headroom_pages: int = 0) -> bool:
        """Admission check for a radix prefix hit: only the uncached
        suffix needs fresh device pages, plus one device slot for every
        matched page currently on the host tier."""
        new = self.pool.pages_for(n_tokens) - len(prefix_pages)
        host = sum(1 for p in prefix_pages
                   if self.pool.tier_of(p) == HOST)
        need = max(new, 0) + host + max(headroom_pages, 0)
        return self.pool.free_pages(DEVICE) >= need \
            and self.pool.alloc.can_alloc(max(new, 0))

    def admit_with_prefix(self, rid: int, prefix_pages: List[int],
                          prefix_tokens: int, n_tokens: int) -> float:
        """Admit `rid` copy-on-write over a matched radix prefix; returns
        bytes fetched back from the host tier."""
        if rid in self._tables:
            raise ValueError(f"request {rid} already admitted")
        t = BlockTable(self.pool.page_size)
        for pid in prefix_pages:
            self.pool.incref_page(pid)
        t.pages = list(prefix_pages)
        t.tokens = prefix_tokens
        try:
            moved = self.pool.migrate(prefix_pages, DEVICE)
            self.pool.extend_table(t, n_tokens, DEVICE)
        except OutOfPages:              # caller raced can_admit_prefix
            for pid in t.pages:
                self.pool.decref_page(pid)
            raise
        self._tables[rid] = t
        self._suspended[rid] = False
        return moved

    def extend(self, rid: int, n_tokens: Optional[int] = None) -> bool:
        """Grow `rid` to `n_tokens` (default: +1 token). False on a dry
        pool: the caller preempts someone and retries."""
        t = self._tables[rid]
        target = t.tokens + 1 if n_tokens is None else n_tokens
        try:
            self.pool.extend_table(t, target, DEVICE)
            return True
        except OutOfPages:
            return False

    def truncate(self, rid: int, n_tokens: int) -> int:
        """Roll back `rid` to `n_tokens` (speculative decoding rejected a
        drafted suffix); frees the pages past the kept prefix. Returns
        pages dropped."""
        return self.pool.truncate_table(self._tables[rid], n_tokens)

    def release(self, rid: int) -> None:
        t = self._tables.pop(rid)
        self._suspended.pop(rid, None)
        self.pool.release_table(t)

    # -- preemption / resumption -------------------------------------------------
    def preempt(self, rid: int, mode: str = SPILL) -> float:
        """Suspend `rid`; returns bytes moved (0 for recompute). A spill
        that finds the host tier full degrades to recompute: the victim's
        pages are dropped, not leaked; callers see an empty table."""
        t = self._tables[rid]
        self._suspended[rid] = True
        if mode == SPILL:
            try:
                return self.pool.spill_table(t)
            except OutOfPages:
                mode = RECOMPUTE
        if mode != RECOMPUTE:
            raise ValueError(f"unknown preemption mode {mode!r}")
        tokens = t.tokens
        self.pool.release_table(t)
        t.tokens = tokens               # remember how much to re-prefill
        return 0.0

    def can_resume(self, rid: int, headroom_pages: int = 0) -> bool:
        t = self._tables[rid]
        if t.pages:                     # spilled: fetch back
            need = len(t.pages) - self.pool.device_pages_of(t) \
                + max(headroom_pages, 0)
            return self.pool.free_pages(DEVICE) >= need
        # recompute: fresh allocation
        return self.can_admit(t.tokens, headroom_pages)

    def resume(self, rid: int) -> Optional[float]:
        """Back to resident; returns bytes fetched (0.0 for recompute
        re-allocation) or None when the device tier still can't hold it."""
        t = self._tables[rid]
        if not self.can_resume(rid):
            return None
        self._suspended[rid] = False
        if t.pages:
            return self.pool.fetch_table(t)
        tokens, t.tokens = t.tokens, 0
        self.pool.extend_table(t, tokens, DEVICE)
        return 0.0

    # -- Eq. 8 mapping: token volumes -> page migrations -------------------------
    def delegate_tail(self, rid: int, n_tokens: int) -> float:
        """Migrate the pages backing `rid`'s trailing `n_tokens` to the
        host tier (the paper's KV-transfer volume as page movement).
        Partial pages round down; returns bytes moved."""
        t = self._tables[rid]
        n_pages = min(n_tokens // self.pool.page_size, len(t.pages))
        if n_pages <= 0:
            return 0.0
        return self.pool.migrate(t.pages[-n_pages:], HOST)

    def resident_tokens(self, rid: int) -> int:
        """Tokens whose pages are on-device (delegated tail excluded)."""
        t = self._tables[rid]
        if not t.pages:
            return 0
        dev = self.pool.device_pages_of(t)
        if dev == len(t.pages):
            return t.tokens
        return min(dev * self.pool.page_size, t.tokens)

    def active_requests(self) -> List[int]:
        return [rid for rid, s in self._suspended.items() if not s]
