"""Per-request service-level objectives (beyond-paper; the §8.3 discussion
made concrete).

A `RequestSLO` rides on `serving.Request` through the engine's slot table
into the batch planner: TPOT/TTFT bounds become *constraints on the joint
allocation* (docs/slo.md), not just the per-request `CascadeConfig.slo_tpot`
check — under continuous batching a grant to one request lengthens the
shared verification pass for every co-scheduled request, so a latency-tier
request can be pushed past its bound by someone else's speculation, which
no per-request gate can see.

`tpot_within` is the ONE comparison rule every SLO consumer shares: the
manager's measured-TPOT trial gate (`SpeculationManager._slo_allows`), the
planner's predicted-TPOT grant constraint (`planner.SLOTpotConstraint`),
and the serving-side violation counters. None-bounds and None-estimates
always pass — an unknown is not a violation."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

#: scheduling tiers: latency-tier requests are admitted ahead of FIFO and
#: weight the planner's water level; throughput-tier is the default
LATENCY, THROUGHPUT = "latency", "throughput"


def tpot_within(bound: Optional[float], tpot: Optional[float]) -> bool:
    """True when a TPOT estimate satisfies a bound. The shared predicate:
    no bound, or no estimate yet, always passes (testing/observing is how
    bounds get learned; absence of data must not read as a violation)."""
    if bound is None or tpot is None:
        return True
    return tpot <= bound


def ttft_violated(bound: Optional[float], ttft: Optional[float]) -> bool:
    """True when a request's TTFT violated its bound. TTFT is an *outcome*,
    not an estimate, so the no-data rule is the OPPOSITE of `tpot_within`:
    a bounded request that never produced a first token (shed, or still
    queued at the replay horizon — ttft None or <= 0) has by construction
    blown any finite TTFT bound. Mapping "never served" to "no violation"
    is exactly the silent-zero-violation failure mode this predicate
    exists to close. No bound still always passes."""
    if bound is None:
        return False
    if ttft is None or ttft <= 0:
        return True
    return ttft > bound


@dataclass(frozen=True)
class RequestSLO:
    """Per-request latency objective.

    tpot  — mean seconds per output token the request may experience
            (experienced = it waits out the whole shared pass between its
            token batches; see `RequestTelemetry.experienced_tpot`).
    ttft  — seconds from submit to first token; enforced on the admission
            side (latency-tier requests jump the FIFO queue) and counted,
            not enforced, by the planner (a queued request has no grants
            to constrain).
    tier  — "latency" requests are admitted ahead of FIFO and raise the
            planner's water level (`PlannerConfig.latency_tier_weight`);
            "throughput" (default) is plain FIFO + break-even planning.
    """
    tpot: Optional[float] = None
    ttft: Optional[float] = None
    tier: str = THROUGHPUT

    def __post_init__(self):
        if self.tier not in (LATENCY, THROUGHPUT):
            raise ValueError(f"unknown SLO tier {self.tier!r} "
                             f"(expected {LATENCY!r} or {THROUGHPUT!r})")
        for name in ("tpot", "ttft"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"slo {name} bound must be positive, "
                                 f"got {v!r}")

    @property
    def is_latency_tier(self) -> bool:
        return self.tier == LATENCY

    @classmethod
    def latency(cls, tpot: Optional[float] = None,
                ttft: Optional[float] = None) -> "RequestSLO":
        """Convenience constructor for a latency-tier objective."""
        return cls(tpot=tpot, ttft=ttft, tier=LATENCY)
