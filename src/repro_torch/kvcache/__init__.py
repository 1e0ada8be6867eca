"""Paged KV cache of the port (counterpart of ``repro.kvcache``).

allocator (free-list pages + block tables) -> pool (device / host tiers,
migration byte accounting) -> layout (dense <-> paged K/V movement on the
device) -> paged_decode (the single-device decode, verify and chunked
prefill over a pool through block tables) -> manager (the scheduler's
page-granular admission, spill and recompute preemption, resume).
"""
from repro_torch.kvcache.allocator import (BlockTable, OutOfPages,  # noqa: F401
                                           PageAllocator)
from repro_torch.kvcache.manager import (RECOMPUTE, SPILL,  # noqa: F401
                                         PagedKVManager)
from repro_torch.kvcache.pool import (DEVICE, HOST, PagedKVConfig,  # noqa: F401
                                      PagePool)
