"""Prefix digest: a router-side summary of a radix cache's contents
(DESIGN.md §16).

A fleet router wants to send a request to the replica already holding its
prompt's KV pages, but shipping each replica's whole radix tree (token
tuples!) to the router would cost more than the routing decision saves.
Instead every cached page is summarized by a *cumulative chain hash*:

  cum(node) = H(cum(parent), page_key)

maintained incrementally on insert/evict, so a node's hash pins down the
entire root path — the full token prefix — in one integer. A replica's
digest is just the set of those integers. The router re-derives the same
chain over a candidate prompt's pages and counts the longest run present
in the set: exactly the page-aligned prefix length `RadixPrefixCache.match`
would find, without touching the tree. Hash collisions can only overstate
the overlap (an admission-time `match` still does the exact walk), never
break losslessness.

The digest is also *optimistically extendable*: the router adds the chain
of a prompt it just routed (`add_prompt`) so follow-up requests with the
same template stick to that replica before the first one even finishes.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

# arbitrary non-zero chain seed (golden-ratio constant) — shared by the
# tree side (radix.py node hashes) and the router side (chain_hashes)
ROOT_SEED = 0x9E3779B97F4A7C15


def chain_hash(parent_cum: int, key: Sequence[int]) -> int:
    """One chain link: H(parent cumulative hash, page token tuple).
    CPython's int/tuple hashing is deterministic (PYTHONHASHSEED only
    perturbs str/bytes), so chains are stable across processes."""
    return hash((parent_cum, tuple(key)))


def chain_hashes(tokens: Sequence[int], page_size: int,
                 max_pages: Optional[int] = None) -> List[int]:
    """Cumulative hash per full page of `tokens` (root chain order)."""
    cap = len(tokens) // page_size
    if max_pages is not None:
        cap = min(cap, max_pages)
    cum, out = ROOT_SEED, []
    for j in range(cap):
        key = tuple(int(t) for t in tokens[j * page_size:(j + 1) * page_size])
        cum = chain_hash(cum, key)
        out.append(cum)
    return out


class PrefixDigest:
    """Set of cumulative page hashes + the page size they were chained at."""
    __slots__ = ("page_size", "_hashes")

    def __init__(self, page_size: int, hashes: Iterable[int] = ()):
        self.page_size = page_size
        self._hashes = set(hashes)

    def __len__(self) -> int:
        return len(self._hashes)

    def __contains__(self, h: int) -> bool:
        return h in self._hashes

    def add_prompt(self, tokens: Sequence[int],
                   max_pages: Optional[int] = None) -> None:
        """Optimistic extension: assume `tokens` is (or will be) cached."""
        self._hashes.update(chain_hashes(tokens, self.page_size, max_pages))

    def match_tokens(self, tokens: Sequence[int],
                     max_pages: Optional[int] = None) -> int:
        """Longest page-aligned prefix of `tokens` present in the digest,
        in tokens — the router's estimate of RadixPrefixCache.match."""
        n = 0
        for h in chain_hashes(tokens, self.page_size, max_pages):
            if h not in self._hashes:
                break
            n += 1
        return n * self.page_size
