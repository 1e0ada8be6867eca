"""Page allocator + per-request block tables (DESIGN.md §10).

The KV cache is carved into fixed-size pages of `page_size` token slots.
A request's cache is then a *block table* — an ordered list of page ids —
instead of a contiguous reservation, so admission can be page-granular
(vLLM-style paged attention, the natural counterpart to LIME's
token-granular Eq. 5/Eq. 8 accounting):

  PageAllocator   free-list over a fixed pool of page ids, with per-page
                  refcounts so a page can back more than one block table
                  (prefix sharing: fork() increfs every page of a prefix).
  BlockTable      one request's ordered pages + its token count. The last
                  page is usually partially filled; `capacity_tokens`
                  rounds up, `tokens` is exact.

Allocation is LIFO (`free` pushes back onto the stack), so recently
released pages are reused first — the hot end of HBM stays hot, and tests
get deterministic, non-contiguous tables for free.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional


class OutOfPages(RuntimeError):
    """Raised when an allocation cannot be satisfied from the free list."""


class PageAllocator:
    """Free-list allocator over `n_pages` fixed-size pages."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 0 or page_size <= 0:
            raise ValueError(f"bad pool geometry ({n_pages=}, {page_size=})")
        self.n_pages = n_pages
        self.page_size = page_size
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._ref = [0] * n_pages

    # -- capacity ---------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold `n_tokens` token slots (ceil)."""
        return -(-max(n_tokens, 0) // self.page_size)

    def can_alloc(self, n: int) -> bool:
        return len(self._free) >= n

    def add_pages(self, n: int) -> None:
        """Extend the pool with `n` fresh page ids (online adaptation:
        HBM returned by weight retiering becomes KV pages — DESIGN.md
        §13). Existing ids, refcounts, and tables are untouched."""
        if n <= 0:
            return
        start = self.n_pages
        self.n_pages += n
        self._ref.extend([0] * n)
        self._free.extend(range(start + n - 1, start - 1, -1))

    # -- alloc / refcount --------------------------------------------------------
    def alloc(self) -> int:
        if not self._free:
            raise OutOfPages(f"pool exhausted ({self.n_pages} pages)")
        pid = self._free.pop()
        self._ref[pid] = 1
        return pid

    def alloc_many(self, n: int) -> List[int]:
        """All-or-nothing: either n pages or OutOfPages (no partial grab)."""
        if not self.can_alloc(n):
            raise OutOfPages(
                f"need {n} pages, {len(self._free)} free of {self.n_pages}")
        return [self.alloc() for _ in range(n)]

    def incref(self, pid: int) -> None:
        if self._ref[pid] <= 0:
            raise ValueError(f"incref on free page {pid}")
        self._ref[pid] += 1

    def decref(self, pid: int) -> None:
        if self._ref[pid] <= 0:
            raise ValueError(f"decref on free page {pid}")
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            self._free.append(pid)

    def refcount(self, pid: int) -> int:
        return self._ref[pid]


@dataclasses.dataclass
class BlockTable:
    """One request's ordered pages. `tokens` counts filled slots; the last
    page holds `tokens - (len(pages)-1) * page_size` of them."""
    page_size: int
    pages: List[int] = dataclasses.field(default_factory=list)
    tokens: int = 0

    @property
    def capacity_tokens(self) -> int:
        return len(self.pages) * self.page_size

    def extend_to(self, n_tokens: int, alloc: PageAllocator) -> List[int]:
        """Grow the table to hold `n_tokens`; returns the newly allocated
        page ids (all-or-nothing — raises OutOfPages leaving the table
        unchanged). Shrinking is not supported (tokens only grow)."""
        if n_tokens < self.tokens:
            raise ValueError(f"cannot shrink table ({self.tokens} -> "
                             f"{n_tokens} tokens)")
        need = alloc.pages_for(n_tokens) - len(self.pages)
        new = alloc.alloc_many(need) if need > 0 else []
        self.pages.extend(new)
        self.tokens = n_tokens
        return new

    def append_token(self, alloc: PageAllocator) -> Optional[int]:
        """Room for one more token; returns the new page id if a page
        boundary was crossed, else None."""
        new = self.extend_to(self.tokens + 1, alloc)
        return new[0] if new else None

    def truncate_to(self, n_tokens: int, alloc: PageAllocator) -> List[int]:
        """Shrink the table to hold `n_tokens` (speculative-decoding
        rollback: reject a drafted suffix, DESIGN.md §11). Pages past
        ceil(n_tokens/page_size) are decrefed; returns the page ids this
        table dropped (freed iff refcount hit zero)."""
        if n_tokens > self.tokens:
            raise ValueError(f"truncate_to past end ({self.tokens} -> "
                             f"{n_tokens} tokens)")
        keep = alloc.pages_for(n_tokens)
        dropped = self.pages[keep:]
        for pid in dropped:
            alloc.decref(pid)
        self.pages = self.pages[:keep]
        self.tokens = max(n_tokens, 0)
        return dropped

    def release(self, alloc: PageAllocator) -> None:
        for pid in self.pages:
            alloc.decref(pid)
        self.pages = []
        self.tokens = 0

    def fork(self, alloc: PageAllocator) -> "BlockTable":
        """Copy-on-write prefix share: the fork references the same pages
        (increfed). Callers must copy-out before writing a shared page —
        the allocator only tracks lifetime, not mutability."""
        for pid in self.pages:
            alloc.incref(pid)
        return BlockTable(self.page_size, list(self.pages), self.tokens)

    def slot_of(self, pos: int) -> tuple:
        """(page_id, offset) of absolute token position `pos`."""
        if not 0 <= pos < self.tokens:
            raise IndexError(f"pos {pos} outside [0, {self.tokens})")
        return self.pages[pos // self.page_size], pos % self.page_size
