"""Lossless acceptance (counterpart of ``repro.specdec.sampler``).

Given the target's logits for q_len = k+1 positions (row i is the
distribution of the token drafted token i claims to be; the last row is
the bonus position past the draft), commit a token sequence distributed
exactly as autoregressive sampling would have produced it:

  greedy      temperature 0: drafted token i is accepted iff it is the
              argmax; the first mismatch commits the argmax instead (the
              token sequential decode would have emitted) and stops; full
              acceptance commits the bonus argmax
  stochastic  temperature > 0: rejection sampling [Leviathan'23, Chen'23].
              Draft token x ~ q is accepted with probability
              min(1, p(x)/q(x)); a rejection commits a draw from the
              residual max(p - q, 0), renormalized, and stops. The
              committed marginal is p at every position for any q,
              including the point mass of a deterministic draft (n-gram
              lookup), where acceptance is p(x)

p is ``target_probs``: the softmax over the same filtered logits
``serving.sampling.sample`` draws from (temperature, top-k, top-p), so
the stream is lossless with respect to the serving sampler. The walk is
host-side numpy with an explicit ``np.random.Generator``, as in the JAX
package: the same p, draft, q and seed commit the same tokens in both.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.serving.sampling import SamplerConfig, filter_logits

_EPS = 1e-12


def target_probs(logits, cfg: SamplerConfig, real_vocab: int) -> np.ndarray:
    """logits: (..., PV) array or tensor (filtered where it lies: a card's
    logits on the card) -> (..., real_vocab) float64 rows summing to 1:
    the serving sampler's token distribution."""
    lv = filter_logits(torch.as_tensor(logits), cfg, real_vocab)
    lv = lv.cpu().numpy().astype(np.float64)
    lv -= lv.max(axis=-1, keepdims=True)
    p = np.exp(lv)
    return p / p.sum(axis=-1, keepdims=True)


def greedy_verify(logits: np.ndarray, draft: np.ndarray,
                  real_vocab: int) -> List[int]:
    """logits: (k+1, PV) array or tensor (its argmax taken where it lies);
    draft: (k,) proposed tokens. Returns the committed tokens (1..k+1 of
    them): the accepted prefix, then the correcting argmax at the first
    mismatch or the bonus argmax after full acceptance."""
    am = logits[:, :real_vocab].argmax(-1)
    am = am.cpu().numpy() if isinstance(am, torch.Tensor) else am
    out: List[int] = []
    for i, d in enumerate(np.asarray(draft)):
        if int(am[i]) != int(d):
            out.append(int(am[i]))
            return out
        out.append(int(d))
    out.append(int(am[len(draft)]))
    return out


def rejection_verify(rng: np.random.Generator, p: np.ndarray,
                     draft: np.ndarray,
                     q: Optional[np.ndarray] = None) -> List[int]:
    """p: (k+1, V) target probabilities (target_probs); draft: (k,)
    proposed tokens; q: (k, V) proposal probabilities, or None for a
    point-mass draft (q(draft[i]) = 1). Returns the committed tokens
    (1..k+1): the accepted prefix, then a residual draw at the first
    rejection or a bonus draw after full acceptance."""
    p = np.asarray(p, np.float64)
    draft = np.asarray(draft)
    out: List[int] = []
    for i, d in enumerate(draft):
        d = int(d)
        pi = p[i]
        qi_d = 1.0 if q is None else float(q[i][d])
        if rng.random() < min(1.0, pi[d] / max(qi_d, _EPS)):
            out.append(d)
            continue
        # rejected: draw from the residual max(p - q, 0), renormalized,
        # the distribution that mixes accepted and rejected back to p
        if q is None:
            resid = pi.copy()
            resid[d] = 0.0
        else:
            resid = np.maximum(pi - np.asarray(q[i], np.float64), 0.0)
        z = resid.sum()
        if z <= _EPS:          # p = q at this position: acceptance was
            resid, z = pi, pi.sum()   # certain; a defensive fallback
        out.append(int(rng.choice(len(pi), p=resid / z)))
        return out
    out.append(int(rng.choice(p.shape[-1], p=p[len(draft)])))
    return out
