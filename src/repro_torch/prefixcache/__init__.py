"""Radix prefix cache of the port (counterpart of ``repro.prefixcache``).

A radix tree over token-id sequences whose nodes own full, immutable,
ref-counted KV pages in a `PagePool`: match on admission forks the cached
prefix copy-on-write into a request's BlockTable (only the uncached suffix
is prefilled), insert on finish donates the request's committed pages back,
and LRU eviction reclaims unpinned cached pages first under pool pressure.
"""
from repro_torch.prefixcache.digest import PrefixDigest, chain_hashes  # noqa: F401
from repro_torch.prefixcache.radix import RadixPrefixCache  # noqa: F401
