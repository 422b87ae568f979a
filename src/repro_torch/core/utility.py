"""Speculation-utility telemetry (paper §4).

Definition 4.1:  U = benefit / cost
    benefit = ETR_spec            (tokens emitted per target iteration)
    cost    = t_iter_spec / t_iter_base

Theorem 4.2:     TPOT_spec = TPOT_base / U
(so maximizing utility minimizes time-per-output-token; verified by a
property test in tests/test_core.py).

The UtilityAnalyzer mirrors the paper's vLLM implementation: it tracks
recent per-iteration (tokens, time) samples, maintains a no-speculation
baseline iteration time measured from the first few decode iterations and
refreshed infrequently (§5.3), and reports windowed utility."""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Optional, Tuple


@dataclass
class IterationRecord:
    k: int              # speculation length used (0 = no speculation)
    tokens: int         # tokens emitted this iteration (>=1)
    t_iter: float       # iteration time (seconds, wall-clock or cost model)
    t_draft: float = 0.0
    t_verify: float = 0.0   # under batching: this request's attributed share
    t_sample: float = 0.0
    batch: int = 1      # requests sharing the verification pass


@dataclass
class UtilityAnalyzer:
    """Per-request utility tracker.

    Parameters mirror §5.3: `baseline_iters` no-spec iterations measured at
    request start, refreshed every `baseline_refresh` iterations."""

    baseline_iters: int = 4
    baseline_refresh: int = 100
    window: int = 16

    _records: Deque[IterationRecord] = field(default_factory=lambda: deque(maxlen=512))
    _baseline_samples: Deque[float] = field(default_factory=lambda: deque(maxlen=16))
    _iters_since_refresh: int = 0
    total_iters: int = 0

    # ------------------------------------------------------------------ #

    def observe(self, rec: IterationRecord) -> None:
        self._records.append(rec)
        self.total_iters += 1
        self._iters_since_refresh += 1
        if rec.k == 0:
            self._baseline_samples.append(rec.t_iter)
            self._iters_since_refresh = 0

    @property
    def baseline_time(self) -> Optional[float]:
        """Average no-speculation iteration time (None until measured)."""
        if not self._baseline_samples:
            return None
        return sum(self._baseline_samples) / len(self._baseline_samples)

    def needs_baseline(self) -> bool:
        """True while the manager should run no-spec iterations to (re)measure
        the baseline (first `baseline_iters`, then every `baseline_refresh`)."""
        if len(self._baseline_samples) < self.baseline_iters:
            return True
        return self._iters_since_refresh >= self.baseline_refresh

    # ------------------------------------------------------------------ #

    def _window_records(self, n: Optional[int] = None, k: Optional[int] = None):
        n = n or self.window
        recs = [r for r in self._records if k is None or r.k == k]
        return recs[-n:]

    def etr(self, n: Optional[int] = None, k: Optional[int] = None) -> float:
        recs = self._window_records(n, k)
        if not recs:
            return 1.0
        return sum(r.tokens for r in recs) / len(recs)

    def cost(self, n: Optional[int] = None, k: Optional[int] = None) -> float:
        """Mean iteration time over window / baseline time."""
        base = self.baseline_time
        recs = self._window_records(n, k)
        if not recs or not base:
            return 1.0
        return (sum(r.t_iter for r in recs) / len(recs)) / base

    def utility(self, n: Optional[int] = None, k: Optional[int] = None) -> float:
        """Definition 4.1 over the last `n` iterations (optionally only those
        run at speculation length `k`)."""
        c = self.cost(n, k)
        return self.etr(n, k) / max(c, 1e-9)

    def accept_rate(self, n: Optional[int] = None) -> Optional[float]:
        """Windowed per-draft acceptance estimate: accepted draft tokens /
        drafted tokens over the last `n` records that speculated (k > 0) —
        filtered *before* windowing, so a run of K=0 iterations (a
        backed-off set phase, planner preemptions) does not blank out the
        estimate while real speculative history exists. None until a
        speculative record exists — callers fall back to their prior.
        `tokens` counts the bonus token, so accepted = tokens - 1; a
        stop-token-truncated iteration undercounts, deliberately: the
        planner should not bank on tokens past a stop. Capped below 1 so
        geometric-series consumers stay finite."""
        recs = [r for r in self._records if r.k > 0][-(n or self.window):]
        drafted = sum(r.k for r in recs)
        if drafted <= 0:
            return None
        accepted = sum(min(max(r.tokens - 1, 0), r.k) for r in recs)
        return min(accepted / drafted, 0.999)

    def accept_curve(self, max_k: int, n: Optional[int] = None
                     ) -> Optional[list]:
        """Per-position conditional acceptance over the last `n`
        speculative records: curve[p] = P(draft p+1 accepted | position
        reached). No extra recording is needed — speculative verification
        accepts a *prefix*, so a record (k, tokens) pins down every
        position's outcome: positions 0..tokens-2 were reached and
        accepted, position tokens-1 was reached and rejected (when it was
        drafted, tokens-1 < k), and positions past the first rejection
        were never reached (and must not count — that truncation is
        exactly why a flat mean over-estimates deep drafts: acceptance
        decays with depth, the ROADMAP's acceptance-model item).

        Positions with no observations fall back to the flat windowed
        `accept_rate`; None until any speculative record exists (callers
        fall back to their prior). Stop-token-truncated iterations
        undercount deliberately, like `accept_rate`. Values capped below
        1 so geometric consumers stay finite."""
        recs = [r for r in self._records if r.k > 0][-(n or self.window):]
        flat = self.accept_rate(n)
        if flat is None or max_k <= 0:
            return None
        curve = []
        for p in range(max_k):
            reached = sum(1 for r in recs
                          if r.k > p and min(r.tokens - 1, r.k) >= p)
            accepted = sum(1 for r in recs
                           if r.k > p and min(r.tokens - 1, r.k) > p)
            curve.append(min(accepted / reached, 0.999) if reached
                         else flat)
        return curve

    def trial_utility(self, trial_records) -> float:
        """Utility of an explicit list of records (one test-phase trial)."""
        base = self.baseline_time
        if not trial_records or not base:
            return 1.0
        etr = sum(r.tokens for r in trial_records) / len(trial_records)
        cost = (sum(r.t_iter for r in trial_records) / len(trial_records)) / base
        return etr / max(cost, 1e-9)

    # -- diagnostics ---------------------------------------------------- #

    def breakdown(self, n: Optional[int] = None) -> Tuple[float, float, float]:
        recs = self._window_records(n)
        if not recs:
            return (0.0, 0.0, 0.0)
        m = len(recs)
        return (sum(r.t_draft for r in recs) / m,
                sum(r.t_verify for r in recs) / m,
                sum(r.t_sample for r in recs) / m)
