"""Lossless speculative decoding of the port (counterpart of
``repro.specdec``).

Draft cheap, verify exact: a draft provider proposes k tokens, one
multi-query pass of the target scores all of them (one weight stream in
the interleaved engine), and the acceptance walk commits a prefix
distributed exactly as autoregressive sampling. The rejected suffix rolls
back by resetting the decode position (dense caches) or truncating block
tables (paged KV).

  draft.py          n-gram (prompt lookup) and small-model drafts
  resident_draft.py the resident-tier self-draft over a truncated stack,
                    and DepthController (draft depth per retier rung)
  sampler.py        greedy acceptance and rejection sampling
  controller.py     SpecConfig and the per-slot propose/verify/commit loop
"""
from repro_torch.specdec.controller import (SpecConfig,  # noqa: F401
                                            SpecDecodeController, SpecStats)
from repro_torch.specdec.draft import (NgramDraft,  # noqa: F401
                                       SmallModelDraft, make_draft_provider)
from repro_torch.specdec.resident_draft import (  # noqa: F401
    DepthController, ResidentDraft, default_resident_ids, truncate_stack)
from repro_torch.specdec.sampler import (greedy_verify,  # noqa: F401
                                         rejection_verify, target_probs)
