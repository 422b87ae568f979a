"""Drafters: n-gram prompt-lookup (the paper's main technique, model-free).

A drafter proposes up to K tokens given the token history. It may return
fewer than K (n-gram returns none when no match exists) — the engine treats
the actual proposal length as this iteration's effective K."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class Drafter:
    """Interface."""
    #: active params fetched per drafted token (cost-model input); 0 => free
    active_params: int = 0
    #: hard cap on proposal length, if the drafter has one (None = only the
    #: engine's K bounds it); the engine's KV-ring guard falls back to this
    #: when the controller exposes no k_max
    max_propose: Optional[int] = None

    def reset(self) -> None:
        pass

    def propose(self, history: List[int], k: int, rng=None
                ) -> Tuple[List[int], Optional[np.ndarray]]:
        """Return (draft_tokens, draft_probs or None). Stochastic drafters
        sample from `rng` (np.random.Generator); deterministic drafters
        return draft_probs=None (point-mass q)."""
        raise NotImplementedError


class NGramDrafter(Drafter):
    """Prompt-lookup decoding (Saxena '23 [38]): find the longest recent
    n-gram suffix that occurred earlier in the history and propose the
    tokens that followed it. Deterministic — draft_probs is None.

    The scan is bounded to the last `max_scan` tokens of the history
    (0 = unbounded). The unbounded form rebuilt a sliding-window view of the
    *entire* history every iteration — O(len(history)) per proposal, so a
    long generation paid quadratic total drafting cost. On histories no
    longer than `max_scan` the bounded scan is exact (identical proposals);
    on longer ones it keeps the most recent occurrences, which is also where
    prompt-lookup hits live."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 max_scan: int = 512):
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.max_scan = max_scan

    def propose(self, history: List[int], k: int, rng=None):
        if k <= 0 or len(history) < self.min_ngram + 1:
            return [], None
        n_hist = len(history)
        base = max(0, n_hist - self.max_scan) if self.max_scan else 0
        h = np.asarray(history[base:])
        n_win = len(h)
        if n_win < self.min_ngram + 1:
            return [], None
        for n in range(min(self.max_ngram, n_win - 1), self.min_ngram - 1, -1):
            suffix = h[-n:]
            # vectorized rolling-window match: windows[i] == h[i:i+n]
            windows = np.lib.stride_tricks.sliding_window_view(
                h[:-1], n)                       # exclude the suffix itself
            hits = np.nonzero((windows == suffix).all(axis=1))[0]
            # latest earlier occurrence with a non-empty continuation
            hits = hits[hits + n < n_win]
            if hits.size:
                start = int(hits[-1])
                cont = h[start + n:start + n + k]
                if cont.size:
                    return [int(c) for c in cont], None
        return [], None
