"""Per-iteration serving telemetry: the measurement substrate Cascade's
utility analyzer feeds on (the paper's 'utility analysis telemetry', §6)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class IterationTelemetry:
    iteration: int
    k_requested: int           # controller's K
    k_drafted: int             # tokens the drafter actually proposed
    tokens_emitted: int        # accepted + 1
    t_iter: float              # total iteration seconds (virtual or wall);
                               # under batching, this request's attributed share
    t_draft: float
    t_verify: float
    t_sample: float
    unique_experts: float = 0.0   # mean per layer (MoE only); under batching,
                                  # this request's own tokens only
    context_len: int = 0
    phase: str = ""            # cascade phase when the iteration ran
    utility: float = 0.0       # analyzer's running utility after observe
    # -- continuous-batching fields (defaults = legacy single-request) ---- #
    batch_occupancy: int = 1   # requests sharing this verification pass
    union_experts: float = 0.0  # batch-union unique experts (mean per layer)
    padding_frac: float = 0.0  # padded fraction of the [B, T_max] step
    # -- batch-planner fields (k_granted == k_requested off-planner) ------ #
    k_granted: int = 0         # planner's joint allocation for this request
    plan_held: bool = False    # TEST trial postponed by phase staggering
    # -- SLO fields (docs/slo.md; defaults = unconstrained request) ------- #
    t_pass: float = 0.0        # the WHOLE shared pass's seconds (verify +
                               # slowest draft/sample) — the latency this
                               # request experienced waiting the pass out,
                               # as opposed to t_iter's attributed share
    slo_capped: bool = False   # a grant to this row was denied by an SLO


@dataclass
class RequestTelemetry:
    request_id: str = ""
    task: str = ""
    prompt_len: int = 0
    iterations: List[IterationTelemetry] = field(default_factory=list)
    t_prefill: float = 0.0     # prefill seconds on the engine's clock
                               # (cm.prefill_time under clock="model" — never
                               # wall-clock mixed into the virtual clock)
    t_queue: float = 0.0       # admission wait: submit -> first prefill work
    ttft: float = 0.0          # submit -> first output token, engine clock
    prefill_chunks: int = 0    # chunks the prompt was admitted in (0 =
                               # legacy single-shot blocking prefill)
    # -- SLO identity (docs/slo.md; defaults = unconstrained request) ----- #
    tier: str = "throughput"   # scheduling tier ("latency" | "throughput")
    slo_tpot: Optional[float] = None   # TPOT bound of the request, if any
    slo_ttft: Optional[float] = None   # TTFT bound of the request, if any
    # -- overload outcome (docs/serving_load.md) -------------------------- #
    shed: bool = False         # admission shed the request before it ever
                               # reached a slot; t_queue holds the wait it
                               # accrued, ttft stays 0 (and a TTFT bound on
                               # a shed request counts as violated)

    # ------------------------------------------------------------------ #

    @property
    def output_tokens(self) -> int:
        return sum(it.tokens_emitted for it in self.iterations)

    @property
    def decode_time(self) -> float:
        return sum(it.t_iter for it in self.iterations)

    @property
    def tpot(self) -> float:
        """Time per output token (paper's figure of merit): attributed
        cost share per token — what this request's decoding cost the
        cluster."""
        n = self.output_tokens
        return self.decode_time / n if n else float("inf")

    @property
    def experienced_tpot(self) -> float:
        """Time per output token the *user* experienced: under continuous
        batching a request waits out the whole shared pass between its
        token batches, so its inter-token latency is the pass time — not
        its attributed cost share, which deliberately charges expert bytes
        to whoever dragged them in. This is the quantity `RequestSLO.tpot`
        bounds and the planner's SLO constraint predicts (docs/slo.md).
        Falls back to the attributed `tpot` for records without a pass
        time (the single-request engine, where the two coincide)."""
        n = self.output_tokens
        if not n:
            return float("inf")
        t = sum(it.t_pass for it in self.iterations)
        return t / n if t > 0 else self.tpot

    @property
    def slo_tpot_violated(self) -> bool:
        """True when this request's experienced TPOT exceeded its bound
        (False without a bound — the shared no-bound-passes rule)."""
        from repro_torch.core.slo import tpot_within
        return not tpot_within(self.slo_tpot, self.experienced_tpot)

    @property
    def slo_ttft_violated(self) -> bool:
        """True when this request's TTFT blew its bound — including the
        never-served case (shed, or still queued at a replay horizon):
        a bounded request with no first token IS a violation, not an
        unknown (`slo.ttft_violated`'s rule; mapping ttft == 0 to "no
        violation" silently zeroed the violation counters under
        overload)."""
        from repro_torch.core.slo import ttft_violated
        return ttft_violated(self.slo_ttft, self.ttft)

    @property
    def etr(self) -> float:
        its = self.iterations
        return self.output_tokens / len(its) if its else 0.0

    def breakdown(self):
        its = self.iterations
        if not its:
            return {}
        return {
            "draft": sum(i.t_draft for i in its),
            "verify": sum(i.t_verify for i in its),
            "sample": sum(i.t_sample for i in its),
            "total": self.decode_time,
        }
