"""CascadeController: the per-request composition of utility analyzer and
speculation manager — the object the serving engine talks to.

    ctl = CascadeController(CascadeConfig())
    k = ctl.next_k()                 # draft k tokens (0 = no speculation)
    ... run draft + verify ...
    ctl.observe(tokens_emitted, t_iter, t_draft, t_verify, t_sample)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .manager import CascadeConfig, SpeculationManager
from .utility import IterationRecord, UtilityAnalyzer


@dataclass
class CascadeController:
    config: CascadeConfig = field(default_factory=CascadeConfig)
    manager: Optional[SpeculationManager] = None
    _last_k: int = 0

    def __post_init__(self):
        if self.manager is None:
            self.manager = SpeculationManager(cfg=self.config)

    # ------------------------------------------------------------------ #

    @property
    def analyzer(self) -> UtilityAnalyzer:
        return self.manager.analyzer

    @property
    def phase(self) -> str:
        return self.manager.phase

    def next_k(self) -> int:
        self._last_k = self.manager.next_k()
        return self._last_k

    def hold(self) -> int:
        """Batch-planner phase hook: postpone a TEST-phase trial by one
        iteration and run the steady-state K instead (see
        `SpeculationManager.hold`). A no-op `next_k()` outside TEST."""
        self._last_k = self.manager.hold()
        return self._last_k

    def observe(self, tokens: int, t_iter: float, *, t_draft: float = 0.0,
                t_verify: float = 0.0, t_sample: float = 0.0,
                k: Optional[int] = None, batch: int = 1) -> None:
        """Feed back one completed iteration. Under continuous batching the
        times are this request's *attributed* share of the shared pass
        (cost_model.batch_iteration_time's marginal-bytes split), so the
        utility signal keeps meaning 'what this request's speculation costs
        the cluster' even when B requests verify together."""
        rec = IterationRecord(k=self._last_k if k is None else k,
                              tokens=tokens, t_iter=t_iter, t_draft=t_draft,
                              t_verify=t_verify, t_sample=t_sample,
                              batch=batch)
        self.manager.observe(rec)

    def utility(self, n: Optional[int] = None) -> float:
        return self.analyzer.utility(n)


class StaticKController:
    """Baseline controller: fixed speculation length (the paper's static-K
    comparison points, with K=0 being the no-speculation baseline).

    Under `BatchedEngine`'s default policy="joint" the batch planner may
    cap or preempt these fixed asks at B>1 like any other request's (there
    is no TEST phase to protect — 'static' is the ask, not a grant
    guarantee). A faithful static-K *measurement* therefore needs
    `BatchedEngine(policy="independent")` (as `--batch-sweep` pins) or the
    single-request `ServingEngine`."""

    def __init__(self, k: int):
        self.k = k
        self.analyzer = UtilityAnalyzer()
        self.phase = "static"

    def next_k(self) -> int:
        return self.k

    def observe(self, tokens: int, t_iter: float, *, t_draft: float = 0.0,
                t_verify: float = 0.0, t_sample: float = 0.0,
                k: Optional[int] = None, batch: int = 1) -> None:
        self.analyzer.observe(IterationRecord(
            k=self.k if k is None else k, tokens=tokens, t_iter=t_iter,
            t_draft=t_draft, t_verify=t_verify, t_sample=t_sample,
            batch=batch))

    def utility(self, n: Optional[int] = None) -> float:
        return self.analyzer.utility(n)
