"""Token sampling + the speculative rejection sampler (Leviathan et al. '23).

The rejection sampler is the correctness-critical piece of speculative
decoding: accepted-token streams must be distributed exactly as if sampled
from the target model alone. The numpy samplers are the JAX package's own, so
the same probabilities and the same numpy RNG give the same draws."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch


def logits_to_probs(logits: torch.Tensor, temperature: float = 1.0
                    ) -> torch.Tensor:
    if temperature <= 0.0:  # greedy: delta at argmax
        v = logits.shape[-1]
        return torch.nn.functional.one_hot(logits.argmax(-1), v).float()
    return torch.softmax(logits.float() / temperature, dim=-1)


def sample_token(rng: np.random.Generator, probs: np.ndarray) -> int:
    probs = np.asarray(probs, np.float64)
    probs = np.maximum(probs, 0)
    s = probs.sum()
    if s <= 0:
        return int(np.argmax(probs))
    return int(rng.choice(len(probs), p=probs / s))


@dataclass
class RejectionResult:
    accepted: List[int]       # accepted draft tokens (prefix)
    next_token: int           # bonus token (all accepted) or resampled token
    n_accepted: int           # == len(accepted)


def rejection_sample(rng: np.random.Generator,
                     target_probs: np.ndarray,   # [K+1, V]
                     draft_tokens: List[int],    # K proposed tokens
                     draft_probs: Optional[np.ndarray] = None,  # [K, V]
                     ) -> RejectionResult:
    """Leviathan speculative sampling.

    target_probs[i] is the target distribution for the position of
    draft_tokens[i]; target_probs[K] is the bonus position. draft_probs=None
    means the drafter is deterministic (n-gram): q is a point mass at the
    proposed token, so acceptance probability reduces to p(d_i)."""
    k = len(draft_tokens)
    accepted: List[int] = []
    for i, d in enumerate(draft_tokens):
        p = np.asarray(target_probs[i], np.float64)
        if draft_probs is None:
            q_d = 1.0
        else:
            q_d = float(draft_probs[i][d])
        p_d = float(p[d])
        if q_d <= 0.0:
            ratio = 1.0 if p_d > 0 else 0.0
        else:
            ratio = min(1.0, p_d / q_d)
        if rng.random() < ratio:
            accepted.append(int(d))
            continue
        # rejected: resample from the residual max(p - q, 0)
        if draft_probs is None:
            resid = p.copy()
            resid[d] = 0.0
        else:
            resid = np.maximum(p - np.asarray(draft_probs[i], np.float64), 0.0)
        if resid.sum() <= 0:
            resid = p
        tok = sample_token(rng, resid)
        return RejectionResult(accepted, tok, len(accepted))
    # all K accepted: bonus token from the last target distribution
    tok = sample_token(rng, np.asarray(target_probs[k], np.float64))
    return RejectionResult(accepted, tok, len(accepted))


def greedy_verify(target_logits: np.ndarray, draft_tokens: List[int]
                  ) -> RejectionResult:
    """Deterministic verification: accept drafts while they match the target
    argmax; emit the first mismatching argmax (or the bonus argmax)."""
    argmaxes = np.argmax(np.asarray(target_logits, np.float32), axis=-1)
    accepted: List[int] = []
    for i, d in enumerate(draft_tokens):
        if int(argmaxes[i]) == int(d):
            accepted.append(int(d))
        else:
            return RejectionResult(accepted, int(argmaxes[i]), len(accepted))
    return RejectionResult(accepted, int(argmaxes[len(draft_tokens)]),
                           len(accepted))
