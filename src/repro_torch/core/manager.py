"""Cascade speculation manager (paper §5): the test-and-set state machine
with dynamic disable, adaptive back-off, and hill-climbing K search.

Per-request FSM:

    BASELINE --(baseline measured)--> TEST --(trials done)--> SET --+
        ^                                                           |
        +--------------------(set phase expires)--------------------+

  * BASELINE: run `baseline_iters` iterations at K=0 to measure the
    no-speculation iteration time (§5.3); re-entered when the analyzer's
    refresh interval expires.
  * TEST: up to `max_trials` trials of `trial_len` iterations each; the K
    for each trial comes from hill-climbing on (K, utility) of previous
    trials (§5.6) with three early exits: monotone utility decline,
    K reaching the floor with U<1, and successive utilities within 10%.
  * SET: hold best-K for `set_len` iterations; if best utility < 1, hold
    K=0 instead (§5.4) and double the set length — adaptive back-off (§5.5).

Ablation switches (`enable_disable`, `enable_backoff`, `enable_hillclimb`)
reproduce the paper's Fig. 18 increments."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .slo import tpot_within
from .utility import IterationRecord, UtilityAnalyzer

BASELINE, TEST, SET = "baseline", "test", "set"


@dataclass
class CascadeConfig:
    trial_len: int = 4          # t  (§6)
    max_trials: int = 4         # M; T = M*t = 16
    set_len: int = 16           # S
    max_set_len: int = 512      # back-off ceiling
    k_start: int = 3            # first-ever trial K (§7.4: default static-K)
    k_max: int = 8
    k_min: int = 1
    converge_tol: float = 0.10  # early-exit (3): utilities within 10%
    enable_disable: bool = True
    enable_backoff: bool = True
    enable_hillclimb: bool = True
    baseline_iters: int = 4
    baseline_refresh: int = 100
    # beyond-paper (§8.3 discussion): per-request TPOT SLO. Trial/set K
    # values whose *measured* per-K TPOT estimate exceeds the bound are
    # excluded; K=0 (TPOT = t_base) always satisfies any SLO >= t_base.
    slo_tpot: Optional[float] = None
    # beyond-paper: probe k_max as the second trial before hill-climbing.
    # Fixes the non-monotone utility landscapes of multi-branch (tree)
    # drafters, where the paper's directional search from k_start descends
    # into K=0 and misses a high-K peak (EXPERIMENTS.md §Beyond-paper 7).
    multi_start: bool = False


@dataclass
class SpeculationManager:
    cfg: CascadeConfig = field(default_factory=CascadeConfig)
    analyzer: Optional[UtilityAnalyzer] = None

    phase: str = BASELINE
    _phase_left: int = 0
    _k_now: int = 0
    # test-phase bookkeeping
    _trials: List[Tuple[int, float]] = field(default_factory=list)  # (k, U)
    _trial_records: List[IterationRecord] = field(default_factory=list)
    _trials_done: int = 0
    # set-phase bookkeeping
    _set_len_now: int = 0
    _last_set_k: Optional[int] = None
    # batch-planner phase hook: when True the upcoming iteration is an
    # off-schedule filler (a postponed TEST trial) — observe() feeds the
    # analyzer but freezes the FSM for that iteration
    _held: bool = False
    # history of (k, utility) across whole request, for K_start selection
    history: List[Tuple[int, float]] = field(default_factory=list)

    def __post_init__(self):
        if self.analyzer is None:
            self.analyzer = UtilityAnalyzer(
                baseline_iters=self.cfg.baseline_iters,
                baseline_refresh=self.cfg.baseline_refresh)
        self._set_len_now = self.cfg.set_len
        self._enter_baseline()

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #

    def next_k(self) -> int:
        """Speculation length to use for the upcoming iteration."""
        if not self.cfg.enable_disable:
            # Fig. 18 'no optimizations': static K = k_start (after baseline)
            return 0 if self.phase == BASELINE else self.cfg.k_start
        return self._k_now

    def hold(self) -> int:
        """Batch-planner phase hook: postpone the upcoming TEST-phase trial
        iteration by one step (the planner staggers trials so at most one
        request runs an off-policy K per shared pass — a concurrent trial
        would pollute every other request's attributed-cost signal).

        The postponed iteration runs at the steady-state K instead — the
        last set-phase K, or 0 before one exists — and its record feeds the
        analyzer (k-tagged, so windowed stats stay honest) but does NOT
        count toward the trial: the FSM is frozen for exactly one observe().
        Outside TEST this is just `next_k()` — there is nothing to stagger.
        """
        if not self.cfg.enable_disable or self.phase != TEST:
            return self.next_k()
        self._held = True
        k = self._last_set_k if self._last_set_k is not None else 0
        return max(0, min(k, self.cfg.k_max))

    def observe(self, rec: IterationRecord) -> None:
        """Feed back the completed iteration; advances the FSM (unless this
        iteration was a planner-held filler — see `hold`)."""
        self.analyzer.observe(rec)
        if self._held:
            self._held = False
            return
        if not self.cfg.enable_disable:
            # static mode: only track the initial baseline measurement
            if self.phase == BASELINE:
                self._phase_left -= 1
                if self._phase_left <= 0:
                    self.phase = SET
            return
        if self.phase == TEST:
            self._trial_records.append(rec)
        self._phase_left -= 1
        if self._phase_left <= 0:
            self._advance()

    # ------------------------------------------------------------------ #
    # FSM transitions
    # ------------------------------------------------------------------ #

    def _enter_baseline(self):
        self.phase = BASELINE
        self._k_now = 0
        self._phase_left = self.cfg.baseline_iters

    def _enter_test(self):
        self.phase = TEST
        self._trials = []
        self._trials_done = 0
        self._trial_records = []
        self._k_now = self._pick_k_start()
        self._phase_left = self.cfg.trial_len

    def _enter_set(self, k: int):
        self.phase = SET
        self._k_now = k
        if k == 0 and self.cfg.enable_backoff:
            self._set_len_now = min(self._set_len_now * 2,
                                    self.cfg.max_set_len)
        elif k > 0:
            self._set_len_now = self.cfg.set_len
        self._last_set_k = k
        self._phase_left = self._set_len_now

    def _advance(self):
        if self.phase == BASELINE:
            self._enter_test()
            return
        if self.phase == SET:
            if self.analyzer.needs_baseline():
                self._enter_baseline()
            else:
                self._enter_test()
            return
        # TEST: a trial just finished
        u = self.analyzer.trial_utility(self._trial_records)
        self._trials.append((self._k_now, u))
        self.history.append((self._k_now, u))
        self._trial_records = []
        self._trials_done += 1

        nxt = self._next_trial_k()
        if nxt is None or self._trials_done >= self.cfg.max_trials:
            self._enter_set(self._choose_set_k())
        else:
            self._k_now = nxt
            self._phase_left = self.cfg.trial_len

    # ------------------------------------------------------------------ #
    # hill-climbing search (§5.6)
    # ------------------------------------------------------------------ #

    def _pick_k_start(self) -> int:
        """§5.3: scan recent history for the non-zero K with highest utility;
        §5.4: after a disabled set phase, restart conservatively at K=1."""
        if self._last_set_k == 0:
            return self.cfg.k_min
        recent = [h for h in self.history[-12:] if h[0] > 0]
        if recent:
            k = max(recent, key=lambda h: h[1])[0]
            return max(self.cfg.k_min, min(k, self.cfg.k_max))
        return max(self.cfg.k_min, min(self.cfg.k_start, self.cfg.k_max))

    def _slo_allows(self, k: int) -> bool:
        """True if K's measured TPOT estimate satisfies the SLO (unknown Ks
        are allowed — testing them is how we learn). The comparison itself
        is `slo.tpot_within`, the one predicate shared with the batch
        planner's predicted-TPOT grant constraint (docs/slo.md)."""
        if self.cfg.slo_tpot is None or k == 0:
            return True
        base = self.analyzer.baseline_time
        if base is None:
            return True
        recs = [r for r in self.analyzer._records if r.k == k][-8:]
        if not recs:
            return True
        tpot = (sum(r.t_iter for r in recs) / max(
            sum(r.tokens for r in recs), 1))
        return tpot_within(self.cfg.slo_tpot, tpot)

    def _next_trial_k(self) -> Optional[int]:
        """Next K to trial, or None to exit the test phase early."""
        k_cur, u_cur = self._trials[-1]

        # multi-start: second trial probes the far end of the K range
        if (self.cfg.multi_start and len(self._trials) == 1
                and k_cur != self.cfg.k_max and self.cfg.k_max > 1):
            return self.cfg.k_max

        # early exit: at the conservative floor and still losing -> disable
        if u_cur < 1.0 and k_cur <= self.cfg.k_min:
            return None

        if not self.cfg.enable_hillclimb:
            return None  # single trial at K_start (Fig. 18 increments)

        if len(self._trials) == 1:
            direction = 1 if u_cur >= 1.0 else -1
        else:
            k_prev, u_prev = self._trials[-2]
            # early exit: utilities converged within 10%
            if u_prev > 0 and abs(u_cur - u_prev) / u_prev < self.cfg.converge_tol:
                return None
            # early exit: monotone decline past the peak
            if len(self._trials) >= 3:
                u3 = [u for _, u in self._trials[-3:]]
                if u3[0] > u3[1] > u3[2]:
                    return None
            move = k_cur - k_prev
            improved = u_cur >= u_prev
            if move == 0:
                direction = 1 if improved else -1
            else:
                direction = (1 if move > 0 else -1) * (1 if improved else -1)

        nxt = k_cur + direction
        if nxt < self.cfg.k_min:
            return None  # would leave the valid range downward -> disable
        nxt = min(nxt, self.cfg.k_max)
        if any(k == nxt for k, _ in self._trials):
            return None  # revisiting -> converged
        while nxt > self.cfg.k_min and not self._slo_allows(nxt):
            nxt -= 1     # SLO: climb no higher than the latency bound allows
        if not self._slo_allows(nxt):
            # the downclimb bottomed out at k_min and even k_min violates
            # the bound: trialing it anyway would knowingly run an
            # SLO-breaking K for trial_len iterations. Disable instead —
            # _choose_set_k's SLO filter then settles on K=0.
            return None
        if any(k == nxt for k, _ in self._trials):
            return None
        return nxt

    def _choose_set_k(self) -> int:
        trials = [t for t in self._trials if self._slo_allows(t[0])]
        if not trials:
            return 0  # no K satisfies the SLO -> no speculation
        best_k, best_u = max(trials, key=lambda t: t[1])
        if best_u < 1.0:
            return 0  # §5.4: disable speculation for the set phase
        return best_k
