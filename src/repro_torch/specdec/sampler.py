"""Greedy acceptance (counterpart of ``repro.specdec.sampler``'s
``greedy_verify``).

At temperature 0, drafted token i is accepted iff it is the target's
argmax at its position; the first mismatch commits the argmax instead
(the token sequential decode would have emitted) and stops, and full
acceptance commits the bonus argmax. Every committed token is the
sequential argmax, so the stream is the non-speculative one. Rejection
sampling (temperature > 0) is not ported yet.
"""
from __future__ import annotations

from typing import List

import numpy as np


def greedy_verify(logits: np.ndarray, draft: np.ndarray,
                  real_vocab: int) -> List[int]:
    """logits: (k+1, PV); draft: (k,) proposed tokens. Returns the
    committed tokens (1..k+1 of them)."""
    am = np.asarray(logits)[:, :real_vocab].argmax(axis=-1)
    out: List[int] = []
    for i, d in enumerate(np.asarray(draft)):
        if int(am[i]) != int(d):
            out.append(int(am[i]))
            return out
        out.append(int(d))
    out.append(int(am[len(draft)]))
    return out
