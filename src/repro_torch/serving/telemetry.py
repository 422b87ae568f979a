"""Per-iteration serving telemetry: the measurement substrate Cascade's
utility analyzer feeds on (the paper's 'utility analysis telemetry', §6),
and the per-step records of the continuous-batching engine. The step
record's offload fields carry the host tier's prices (prefetch hits,
demand misses, evictions, fetch bytes and seconds, per layer under
layered streaming) and, under an expert-parallel placement, the shard
fields: the per-shard activated experts measured in the pass, the gating
(hottest) shard, the imbalance, the all-to-all seconds priced into the
pass and the replica re-routes."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest element covering a q-fraction
    of the sorted sample (q in (0, 1]; 0 of an empty sample): the one
    percentile rule shared by `ContinuousBatchingScheduler.tier_stats` and
    the load harness's p50/p95/p99 latency figures."""
    if not values:
        return 0.0
    vs = sorted(values)
    rank = math.ceil(q * len(vs))
    return vs[min(max(rank, 1), len(vs)) - 1]


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
class StepTelemetry:
    """One continuous-batching engine step (the batch-level view the
    per-request records can't show: occupancy, expert-union inflation, and
    how much of the padded verification batch was wasted)."""
    step: int
    occupancy: int             # live requests in the pass
    tokens_in_flight: int      # sum of (1 + K_i) plus prefill-chunk tokens
    padded_tokens: int         # occupancy * T_max - tokens_in_flight
    union_experts: float = 0.0  # batch-union unique experts (mean per layer)
    t_step: float = 0.0        # shared verification seconds
    t_overhead: float = 0.0    # serial non-verify cost: max_i(draft+sample)
    joined: int = 0            # requests admitted before this step
    retired: int = 0           # requests finished by this step
    # -- chunked-prefill split (both 0 on a pure legacy decode step) ------ #
    prefill_tokens: int = 0    # prompt tokens co-scheduled into this pass
    decode_tokens: int = 0     # speculative span tokens in this pass
    # -- batch-planner decisions (requested == granted off-planner) ------- #
    k_requested: int = 0       # sum of controller asks across decode rows
    k_granted: int = 0         # sum of planner grants across decode rows
    preempted: int = 0         # decode rows granted 0 while asking > 0
    held_tests: int = 0        # TEST trials postponed by phase staggering
    t_step_predicted: float = 0.0  # planner's predicted pass seconds
    t_base_predicted: float = 0.0  # predicted no-speculation pass seconds
    tokens_predicted: float = 0.0  # planner's predicted decode emissions
    planned: bool = False      # the planner actually priced this pass —
                               # the calibration-sample filter (a predicted
                               # 0.0 is a sample, not an absence of one)
    slo_denied: int = 0        # rows whose grants an SLO constraint capped
    # -- EP-shard fields (defaults = unsharded deployment) ---------------- #
    shard_experts: tuple = ()  # per-shard activated experts (mean layers)
    max_shard_experts: float = 0.0  # the gating shard's activated experts
    hot_shard: int = -1        # id of the gating shard (-1 = unsharded)
    shard_imbalance: float = 1.0   # max-shard / mean-shard occupancy
    t_a2a: float = 0.0         # all-to-all seconds priced into t_step
    replica_moves: int = 0     # replicated experts re-routed to a cooler
                               # replica after this pass (0 = no replicas)
    packed_experts: int = 0    # U_pad of the union-packed verification
                               # path (0 = dense path)
    # -- residency/offload fields (defaults = all-hbm placement) ---------- #
    prefetch_hits: int = 0     # activated host-tier experts found resident
    prefetch_misses: int = 0   # activated host-tier experts demand-fetched
    evictions: int = 0         # host-tier residents evicted this step
    fetch_bytes: float = 0.0   # host->HBM bytes fetched (prefetch + demand)
    t_fetch: float = 0.0       # non-overlapped fetch seconds in t_step
    # -- layered-streaming fields (defaults = whole-expert granularity) --- #
    fetch_hide: float = 0.0    # the effective (staged-bytes-capped,
                               # first-layer) hide window this step's
                               # fetch pricing overlapped against
    t_fetch_by_layer: tuple = ()       # per-MoE-layer link seconds for the
                                       # gating shard's fetched slices
    prefetch_hits_by_layer: tuple = ()    # per-layer resident activations
    prefetch_misses_by_layer: tuple = ()  # per-layer demand-fetched slices
    # -- precision fields (defaults = bf16 everywhere) -------------------- #
    precision: str = ""        # cost-model Precision label ("" = legacy)
    expert_bytes_saved: float = 0.0  # expert-read bytes this pass avoided
                               # moving vs bf16 storage (0.0 unquantized)

    @property
    def t_total(self) -> float:
        """Wall time of the step: shared verify + the slowest request's
        draft/sample work (drafting runs per-request, concurrently)."""
        return self.t_step + self.t_overhead

    @property
    def padding_frac(self) -> float:
        tot = self.tokens_in_flight + self.padded_tokens
        return self.padded_tokens / tot if tot else 0.0


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


@dataclass
class EngineTelemetry:
    """Per-step telemetry of a continuous-batching engine run."""
    steps: List[StepTelemetry] = field(default_factory=list)

    @property
    def mean_occupancy(self) -> float:
        s = self.steps
        return sum(t.occupancy for t in s) / len(s) if s else 0.0

    @property
    def mean_union_experts(self) -> float:
        s = self.steps
        return sum(t.union_experts for t in s) / len(s) if s else 0.0

    @property
    def mean_padding_frac(self) -> float:
        s = self.steps
        return sum(t.padding_frac for t in s) / len(s) if s else 0.0

    @property
    def total_time(self) -> float:
        return sum(t.t_total for t in self.steps)

    @property
    def prefill_token_frac(self) -> float:
        """Fraction of scheduled (unpadded) tokens that were prefill — how
        much of the serving capacity admission pressure consumed."""
        pre = sum(t.prefill_tokens for t in self.steps)
        tot = sum(t.tokens_in_flight for t in self.steps)
        return pre / tot if tot else 0.0

    # -- batch-planner aggregates ---------------------------------------- #

    @property
    def grant_ratio(self) -> float:
        """Granted / requested draft tokens across the run — how much of
        the controllers' asks the joint planner actually admitted (1.0
        under policy="independent" by construction)."""
        return planner_aggregates(self.steps)["grant_ratio"]

    @property
    def preemptions(self) -> int:
        """Decode iterations whose speculation the planner denied outright."""
        return planner_aggregates(self.steps)["preemptions"]

    @property
    def held_tests(self) -> int:
        """Cascade TEST trials postponed by phase staggering."""
        return planner_aggregates(self.steps)["held_tests"]

    @property
    def plan_time_error(self) -> float:
        """Mean relative |predicted - measured| step time — the planner's
        calibration against the measured pass (analytic union + acceptance
        prior vs the model's actual routing)."""
        return planner_aggregates(self.steps)["plan_time_error"]

    @property
    def slo_denied(self) -> int:
        """Row-steps whose grants an SLO constraint capped (victim
        protection engaging; 0 without bounded requests)."""
        return planner_aggregates(self.steps)["slo_denied"]

    @property
    def replica_moves(self) -> int:
        """Replicated-expert route flips across the run (the engine's
        online cheapest-replica routing engaging; 0 without replicas)."""
        return planner_aggregates(self.steps)["replica_moves"]

    @property
    def mean_shard_imbalance(self) -> float:
        """Mean max-shard/mean-shard activated-expert ratio over sharded
        steps (1.0 = perfectly balanced, or no EP placement)."""
        return planner_aggregates(self.steps)["mean_shard_imbalance"]

    @property
    def hot_shard_frac(self) -> float:
        """How persistently one shard gates: the modal hot shard's share
        of sharded steps (0.0 when the deployment is unsharded)."""
        return planner_aggregates(self.steps)["hot_shard_frac"]

    @property
    def prefetch_hit_rate(self) -> float:
        """Activated host-tier experts found HBM-resident at pass time /
        all activated host-tier experts (1.0 = every fetch was hidden by
        the prefetcher, or no host tier; docs/offload.md)."""
        return planner_aggregates(self.steps)["prefetch_hit_rate"]

    @property
    def fetch_bytes(self) -> float:
        """Total host->HBM bytes fetched across the run (0 without a
        host tier)."""
        return planner_aggregates(self.steps)["fetch_bytes"]

    @property
    def evictions(self) -> int:
        """Host-tier cache evictions across the run."""
        return planner_aggregates(self.steps)["evictions"]

    @property
    def expert_bytes_saved(self) -> float:
        """Expert-read bytes the run avoided moving vs bf16 storage
        (docs/quantization.md; 0.0 on unquantized runs)."""
        return planner_aggregates(self.steps)["expert_bytes_saved"]


def planner_aggregates(steps) -> dict:
    """Batch-planner decision aggregates over a step-telemetry list: the
    one implementation behind `EngineTelemetry`'s planner properties and
    `ContinuousBatchingScheduler.planner_stats` (which slices the steps to
    its own run before aggregating)."""
    req = sum(s.k_requested for s in steps)
    gr = sum(s.k_granted for s in steps)
    hits = sum(s.prefetch_hits for s in steps)
    misses = sum(s.prefetch_misses for s in steps)
    # filter on "a plan priced this pass", not on the prediction's
    # truthiness — a predicted 0.0 is a (terrible) calibration sample the
    # error must count, not a missing one
    errs = [abs(s.t_step_predicted - s.t_step) / s.t_step
            for s in steps if s.t_step > 0 and s.planned]
    sharded = [s for s in steps if s.hot_shard >= 0]
    hot_frac = 0.0
    if sharded:
        counts: dict = {}
        for s in sharded:
            counts[s.hot_shard] = counts.get(s.hot_shard, 0) + 1
        hot_frac = max(counts.values()) / len(sharded)
    return {
        "grant_ratio": gr / req if req else 1.0,
        "preemptions": sum(s.preempted for s in steps),
        "held_tests": sum(s.held_tests for s in steps),
        "plan_time_error": sum(errs) / len(errs) if errs else 0.0,
        "mean_shard_imbalance": (sum(s.shard_imbalance for s in sharded)
                                 / len(sharded) if sharded else 1.0),
        "hot_shard_frac": hot_frac,
        "slo_denied": sum(s.slo_denied for s in steps),
        "replica_moves": sum(s.replica_moves for s in steps),
        "prefetch_hit_rate": (hits / (hits + misses)
                              if (hits + misses) else 1.0),
        "fetch_bytes": sum(s.fetch_bytes for s in steps),
        "evictions": sum(s.evictions for s in steps),
        "expert_bytes_saved": sum(s.expert_bytes_saved for s in steps),
    }
