"""Two-tier page pool: device tier + host/"delegated" tier (DESIGN.md §10).

LIME's KV-transfer protocol (paper §IV-D, Eq. 8) sizes a token volume each
low-threshold device delegates to a high-threshold target; its online
planner (Eq. 5) fires offload plans on KV *occupancy*. Both are statements
about where KV bytes live. The PagePool makes that concrete: every page is
resident in exactly one tier —

  DEVICE   counts against the accelerator KV budget (admission currency)
  HOST     delegated / swapped out: off the device, still owned by its
           request, a fetch away from being attended again

Migrations move pages between tiers and return the byte volume moved, so
the discrete-event simulator can price the wire time (Eq. 8's transfer)
and benchmarks can report spill/fetch traffic. Capacity is enforced per
tier; page identity (and the owning BlockTable's entries) never changes
across a migration — only the residency bit does.

The port's copy of ``repro.kvcache.pool``, the flight recorder's
kv.grow / kv.shrink / kv.spill / kv.fetch instants included, with the
imports pointed at the port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List

from repro_torch.kvcache.allocator import BlockTable, OutOfPages, PageAllocator
from repro_torch.obs import trace as tr_ev
from repro_torch.obs.trace import get_tracer

DEVICE = "device"
HOST = "host"


@dataclasses.dataclass(frozen=True)
class PagedKVConfig:
    """Geometry of a paged KV pool.

    page_size:        token slots per page (64 keeps the Pallas kernel's
                      kv-block sublane-aligned for f32/bf16 tiles)
    device_pages:     device-tier capacity
    host_pages:       host/delegated-tier capacity (0 = no spill target)
    page_bytes:       bytes per page across all layers (for pricing
                      migrations; 0 = unpriced)
    """
    page_size: int = 64
    device_pages: int = 0
    host_pages: int = 0
    page_bytes: float = 0.0

    @staticmethod
    def for_budget(budget_tokens: int, *, page_size: int = 64,
                   host_frac: float = 1.0,
                   bytes_per_token: float = 0.0) -> "PagedKVConfig":
        """Size the device tier to a token budget (floor — a page is only
        usable if *all* its slots fit the budget) and the host tier to
        `host_frac` of it."""
        dev = max(budget_tokens, 0) // page_size
        return PagedKVConfig(page_size=page_size, device_pages=dev,
                             host_pages=int(dev * host_frac),
                             page_bytes=bytes_per_token * page_size)


class PagePool:
    """Allocator + tier residency + migration accounting."""

    def __init__(self, cfg: PagedKVConfig):
        self.cfg = cfg
        total = cfg.device_pages + cfg.host_pages
        self.alloc = PageAllocator(total, cfg.page_size)
        self._tier: Dict[int, str] = {}
        self._count = {DEVICE: 0, HOST: 0}
        self._cap = {DEVICE: cfg.device_pages, HOST: cfg.host_pages}
        # cumulative migration traffic (benchmark / metrics counters)
        self.spilled_pages = 0
        self.fetched_pages = 0
        self.migrated_bytes = 0.0
        self._spare = 0       # capacity withdrawn by shrink(), ids parked

    # -- capacity ----------------------------------------------------------------
    @property
    def page_size(self) -> int:
        return self.cfg.page_size

    def pages_in_use(self, tier: str = DEVICE) -> int:
        return self._count[tier]

    def free_pages(self, tier: str = DEVICE) -> int:
        return self._cap[tier] - self._count[tier]

    def pages_for(self, n_tokens: int) -> int:
        return self.alloc.pages_for(n_tokens)

    def can_alloc(self, n_pages: int, tier: str = DEVICE) -> bool:
        return self.free_pages(tier) >= n_pages \
            and self.alloc.can_alloc(n_pages)

    def grow(self, n_pages: int, tier: str = DEVICE) -> int:
        """Raise a tier's capacity by `n_pages` pages (online memory
        adaptation: retiered weights return their HBM as KV pages —
        DESIGN.md §13). Capacity previously withdrawn by shrink() is
        reused before minting fresh allocator ids, so grow/shrink
        oscillation is bounded by the high-water mark. Returns the pages
        added."""
        if n_pages <= 0:
            return 0
        reuse = min(self._spare, n_pages)
        self._spare -= reuse
        fresh = n_pages - reuse
        if fresh:
            self.alloc.add_pages(fresh)
        self._cap[tier] += n_pages
        tr = get_tracer()
        if tr is not None:
            tr.instant(tr_ev.KV_GROW, track=tr_ev.TRACK_KV,
                       args={"pages": n_pages, "tier": tier})
        return n_pages

    def shrink(self, n_pages: int, tier: str = DEVICE) -> int:
        """Lower a tier's capacity (promotion reclaims its HBM). Only free
        capacity can be withdrawn — pages in use stay until released; the
        orphaned allocator ids are parked for the next grow() (capacity,
        not identity, gates usage). Returns the pages withdrawn."""
        take = max(min(n_pages, self.free_pages(tier)), 0)
        self._cap[tier] -= take
        self._spare += take
        if take:
            tr = get_tracer()
            if tr is not None:
                tr.instant(tr_ev.KV_SHRINK, track=tr_ev.TRACK_KV,
                           args={"pages": take, "tier": tier})
        return take

    # -- allocation --------------------------------------------------------------
    def alloc_pages(self, n: int, tier: str = DEVICE) -> List[int]:
        if self.free_pages(tier) < n:
            raise OutOfPages(f"{tier} tier full "
                             f"({self._count[tier]}/{self._cap[tier]})")
        pids = self.alloc.alloc_many(n)
        for pid in pids:
            self._tier[pid] = tier
        self._count[tier] += n
        return pids

    def extend_table(self, table: BlockTable, n_tokens: int,
                     tier: str = DEVICE) -> List[int]:
        """Grow a block table within a tier's capacity (all-or-nothing)."""
        need = self.alloc.pages_for(n_tokens) - len(table.pages)
        if need > 0 and self.free_pages(tier) < need:
            raise OutOfPages(f"{tier} tier full "
                             f"({self._count[tier]}/{self._cap[tier]})")
        new = table.extend_to(n_tokens, self.alloc)
        for pid in new:
            self._tier[pid] = tier
        self._count[tier] += len(new)
        return new

    def truncate_table(self, table: BlockTable, n_tokens: int) -> int:
        """Shrink a table to `n_tokens` (speculative rollback): pages past
        the kept prefix leave their tier when this table was the last
        owner. Returns the number of pages dropped."""
        if not 0 <= n_tokens <= table.tokens:   # validate BEFORE touching
            raise ValueError(                   # tier accounting
                f"truncate_table to {n_tokens} outside [0, {table.tokens}]")
        keep = self.alloc.pages_for(n_tokens)
        for pid in table.pages[keep:]:
            if self.alloc.refcount(pid) == 1:   # last owner frees the slot
                self._count[self._tier.pop(pid)] -= 1
        return len(table.truncate_to(n_tokens, self.alloc))

    def release_table(self, table: BlockTable) -> None:
        for pid in table.pages:
            if self.alloc.refcount(pid) == 1:   # last owner frees the slot
                self._count[self._tier.pop(pid)] -= 1
        table.release(self.alloc)

    # -- page-level sharing (radix prefix cache, DESIGN.md §12) ------------------
    def incref_page(self, pid: int) -> None:
        """Add an owner to an allocated page (tier unchanged)."""
        self.alloc.incref(pid)

    def decref_page(self, pid: int) -> None:
        """Drop one owner; the last owner's decref frees the tier slot
        (the page-level twin of release_table's per-page bookkeeping)."""
        if self.alloc.refcount(pid) == 1:
            self._count[self._tier.pop(pid)] -= 1
        self.alloc.decref(pid)

    # -- migration ---------------------------------------------------------------
    def tier_of(self, pid: int) -> str:
        return self._tier[pid]

    def migrate(self, pids: Iterable[int], dst: str) -> float:
        """Move pages to tier `dst`; returns bytes moved (0 for pages
        already there). All-or-nothing on destination capacity."""
        moving = [p for p in pids if self._tier[p] != dst]
        if self.free_pages(dst) < len(moving):
            raise OutOfPages(f"{dst} tier full "
                             f"({self._count[dst]}/{self._cap[dst]})")
        for pid in moving:
            src = self._tier[pid]
            self._tier[pid] = dst
            self._count[src] -= 1
            self._count[dst] += 1
        nbytes = len(moving) * self.cfg.page_bytes
        if dst == HOST:
            self.spilled_pages += len(moving)
        else:
            self.fetched_pages += len(moving)
        self.migrated_bytes += nbytes
        if moving:
            tr = get_tracer()
            if tr is not None:
                tr.instant(tr_ev.KV_SPILL if dst == HOST else tr_ev.KV_FETCH,
                           track=tr_ev.TRACK_KV,
                           args={"pages": len(moving), "bytes": nbytes})
        return nbytes

    def migrate_any(self, n: int, dst: str) -> float:
        """Move up to `n` in-use pages (caller doesn't care which —
        volume-level Eq. 8 accounting) into tier `dst`, clamped to source
        supply and destination capacity. Returns bytes moved."""
        src = HOST if dst == DEVICE else DEVICE
        n = min(n, self._count[src], self.free_pages(dst))
        if n <= 0:
            return 0.0
        pids = [p for p, t in self._tier.items() if t == src][:n]
        return self.migrate(pids, dst)

    def spill_table(self, table: BlockTable) -> float:
        """Whole-table spill to the host tier (preempt-and-swap). Pages
        the table shares with another owner (the radix tree or a
        co-resident COW fork, refcount > 1) stay put: migrating them
        would pull KV out from under a resident request that still
        attends it and overstate free device capacity. resume() is
        tier-aware (fetch_table moves only what left), so a partially
        spilled table round-trips correctly."""
        return self.migrate([p for p in table.pages
                             if self.alloc.refcount(p) == 1], HOST)

    def fetch_table(self, table: BlockTable) -> float:
        """Bring every page of a table back to the device tier."""
        return self.migrate(table.pages, DEVICE)

    def device_pages_of(self, table: BlockTable) -> int:
        return sum(1 for p in table.pages if self._tier[p] == DEVICE)
