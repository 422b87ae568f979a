"""Drafters: n-gram prompt-lookup (the paper's main technique, model-free)
and a learned draft-model drafter (EAGLE stand-in — the paper's EAGLE case
study uses a feature-level drafter available only for Mixtral; this is the
general draft-model form with the same engine interface).

A drafter proposes up to K tokens given the token history. It may return
fewer than K (n-gram returns none when no match exists) — the engine treats
the actual proposal length as this iteration's effective K."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as T


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


class DraftModelDrafter(Drafter):
    """A small autoregressive target-family-agnostic draft model with its own
    KV cache, kept in sync with the request's token history. Drafted tokens
    are rolled back after each proposal (only externally-committed tokens
    stay in the drafter's cache).

    `decode_step` writes the drafted tokens' K/V into the ring in place;
    the rollback is metadata only (their positions are invalidated), as in
    the JAX package, which rolls back the cache its drafting returned, so
    a draft that wraps the ring overwrites the same committed slots in
    both. A recurrent stack (RWKV-6 "W", RecurrentGemma "P") is refused:
    the drafted tokens would stay in its recurrent state, which a rollback
    without staged states cannot undo (the JAX package's drafter keeps
    them there). `params` must lie on `device` (the card unless the caller
    passes device="cpu")."""

    def __init__(self, cfg, params, max_len: int = 4096,
                 temperature: float = 1.0, device=None):
        kind = T._stack_kind(cfg)
        if kind == "X":
            raise ValueError(f"{cfg.name}: a draft model needs a "
                             f"decoder-only stack (no encoder output)")
        if kind != "A":
            raise ValueError(
                f"{cfg.name}: a draft model needs an attention stack; a "
                f"recurrent stack ({kind!r}) would keep the drafted tokens "
                f"in its state after the rollback")
        self.device = resolve_device(device)
        p_dev = params["embed"]["embedding"].device
        if p_dev.type != self.device.type:
            raise ValueError(f"params lie on {p_dev}, drafter runs on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.temperature = temperature
        self.active_params = cfg.active_param_count()
        self.reset()

    def reset(self):
        self.cache = None
        self.synced = 0  # tokens of history already in the drafter cache
        self._last_logits = None

    def _decode(self, cache, tokens: List[int]):
        """(float32 logits of the last token on the host, new cache)."""
        arr = torch.tensor([tokens], dtype=torch.int32, device=self.device)
        logits, cache = T.decode_step(self.cfg, self.params, cache, arr)[:2]
        return logits[0, -1].float().cpu().numpy(), cache

    def _feed(self, tokens: List[int]):
        """Advance the drafter cache over committed tokens."""
        if not tokens:
            return
        if self.cache is None:
            self.cache = T.init_cache(self.cfg, 1, self.max_len,
                                      device=self.device)
        self._last_logits, self.cache = self._decode(self.cache, tokens)
        self.synced += len(tokens)

    def propose(self, history: List[int], k: int, rng=None):
        self._feed(history[self.synced:])
        if k <= 0 or self._last_logits is None:
            return [], None
        greedy = self.temperature <= 0 or rng is None
        drafts: List[int] = []
        probs: List[np.ndarray] = []
        logits = self._last_logits
        cache = self.cache
        for _ in range(k):
            if greedy:
                tok = int(np.argmax(logits))
            else:
                x = np.asarray(logits, np.float64) / self.temperature
                x -= x.max()
                p = np.exp(x)
                p /= p.sum()
                tok = int(rng.choice(len(p), p=p))
                probs.append(p.astype(np.float32))
            drafts.append(tok)
            logits, cache = self._decode(cache, [tok])
        # roll back: drafted tokens are speculative; keep only synced prefix
        # (attention cache rollback is metadata-only)
        self.cache = T.rollback_cache(self.cfg, cache, None, 0, self.synced)
        return drafts, (np.stack(probs) if probs else None)
