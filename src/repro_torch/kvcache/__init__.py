"""Paged KV cache of the port (counterpart of ``repro.kvcache``).

allocator (free-list pages + block tables) -> pool (device / host tiers,
migration byte accounting) -> layout (dense <-> paged K/V movement on the
device) -> paged_decode (the single-device decode, verify and chunked
prefill over a pool through block tables). The JAX package's manager
(paged admission, spill and recompute preemption) comes with the
scheduler's paged policy.
"""
from repro_torch.kvcache.allocator import (BlockTable, OutOfPages,  # noqa: F401
                                           PageAllocator)
from repro_torch.kvcache.pool import (DEVICE, HOST, PagedKVConfig,  # noqa: F401
                                      PagePool)
