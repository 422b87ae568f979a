"""Batch-level speculation planner (the batching analogue of the paper's
per-request utility rule, §4-§5).

Under continuous batching the verification cost is *shared*: B requests'
draft spans activate a union of experts, so one request's aggressive K
taxes everyone sharing the pass, which the per-request Cascade controllers
cannot see (each one only observes its own attributed share).
`BatchSpecPlanner` closes the loop at the batch level. Each step it takes
every live request's controller *ask* (the Cascade FSM still drives
exploration and per-request disable), then jointly decides the *grants*
{K_i} by greedy marginal-utility water-filling:

  * price candidate allocations through the data-movement cost model
    (`cost_model.BatchCostOracle`: union expert bytes, per-row KV,
    shared-pass FLOPs, the memory/compute roofline crossover);
  * predict each request's marginal token yield from its windowed draft
    acceptance (`UtilityAnalyzer.accept_rate`): granting the (k+1)-th
    draft token to a request with acceptance a is worth a^(k+1) expected
    extra emissions (or the depth-k product of its per-position
    `accept_curve` under `use_accept_curve`);
  * repeatedly grant +1 draft token to the admissible candidate with the
    highest predicted Δtokens/Δt_batch, where *admissible* is decided by a
    pipeline of `GrantConstraint` objects: `BreakEvenConstraint` (the
    paper's break-even rule per grant, latency-tier rows weighted above 1)
    and `SLOTpotConstraint` (victim protection: no grant may push any
    co-scheduled bounded request's predicted TPOT past its bound unless it
    does not worsen it).

Trial hygiene: the planner staggers Cascade TEST phases so at most one
request trials an off-policy K per shared pass (`SpeculationManager.hold`),
and grants that trial its probe K in full unless that would break a
co-scheduled SLO bound.

Admission (the join-side analogue of the grant pipeline): an
`AdmissionConstraint` vets a queued request about to join the batch;
`PredictiveTTFTAdmission` sheds or defers one whose TTFT bound is already
doomed by its queue delay plus the predicted service time.

Degradation: at B=1 (a single span in the pass) the planner is bypassed and
grants equal asks bit for bit; `policy="independent"` bypasses it at every
batch size. `calibration` (a `cost_model.Calibration`) corrects every
oracle's pass time; None is the analytic planner, bit for bit. The
residency constraints (`MemoryCapConstraint`, `FetchDeadlineConstraint`)
and expert-parallel steering belong to offload and expert parallelism,
which the port has not reached (ROADMAP M4, M5)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from . import cost_model as cm
from .cost_model import expected_emitted, expected_emitted_curve
from .manager import TEST
from .slo import LATENCY, RequestSLO, tpot_within


@dataclass(frozen=True)
class PlannerConfig:
    #: "joint" — batch-level water-filling; "independent" — escape hatch,
    #: every grant equals its controller's ask (the pre-planner engine)
    policy: str = "joint"
    #: stop granting when the best marginal utility drops below this
    #: (1.0 = the paper's break-even rule at batch level)
    util_floor: float = 1.0
    #: acceptance prior for requests with no speculative history yet
    default_accept: float = 0.5
    #: analyzer window for the acceptance estimate
    accept_window: int = 16
    #: stagger Cascade TEST phases to one trial per shared pass
    stagger_tests: bool = True
    #: water-level weight of a latency-tier request (throughput tier = 1):
    #: with mixed-tier traffic the no-speculation rate is weighted, so
    #: marginal grants must clear a higher bar when latency requests
    #: share the pass. 1.0 disables the weighting.
    latency_tier_weight: float = 2.0
    #: predict marginal yield from the per-position acceptance curve
    #: (UtilityAnalyzer.accept_curve) instead of the flat windowed mean —
    #: drafts decay with depth, so the flat mean over-grants deep Ks.
    #: Default off: the flat path is the bit-identity baseline.
    use_accept_curve: bool = False


class DraftYieldModel:
    """Predicted draft yield for the water-filling and the SLO constraint:
    `marginal(i, k)` is the expected extra emissions of granting row i its
    (k+1)-th draft token, `emitted(i, k)` its cumulative expected
    emissions at k granted drafts. Flat acceptance a gives the paper's
    truncated geometric series (marginal a^(k+1)); a per-position curve
    (accept-model upgrade, flag-gated) gives the depth-decayed product."""

    def __init__(self, accepts: Dict[int, float],
                 curves: Optional[Dict[int, Sequence[float]]] = None):
        self.accepts = accepts
        self.curves = curves or {}

    def marginal(self, i: int, k: int) -> float:
        curve = self.curves.get(i)
        if curve is None:
            return self.accepts[i] ** (k + 1)
        p = 1.0
        for j in range(k + 1):
            c = curve[j] if j < len(curve) else curve[-1]
            p *= min(max(c, 0.0), 0.999)
        return p

    def emitted(self, i: int, k: int) -> float:
        curve = self.curves.get(i)
        if curve is None:
            return expected_emitted(self.accepts[i], k)
        return expected_emitted_curve(curve, k)


@dataclass
class GrantCandidate:
    """One +1-draft-token proposal the constraint pipeline vets."""
    row: int               # decode row receiving the extra draft
    k_current: int         # drafts already granted to the row
    d_tokens: float        # predicted marginal emissions of the grant
    d_t: float             # marginal batch-pass delta
    rate: float            # d_tokens / d_t (inf when the grant is free)
    t_after: float         # predicted pass seconds AFTER the grant


@dataclass
class AllocationContext:
    """Shared state the constraints read (and `greedy_allocate` owns):
    `ns`/`alloc`/`t_cur` are live views updated as grants land."""
    oracle: cm.BatchCostOracle
    decode: Sequence[int]
    caps: Dict[int, int]
    accepts: Dict[int, float]
    yields: DraftYieldModel
    ns: List[int]
    alloc: Dict[int, int]
    t_base: float
    t_cur: float
    fixed: frozenset


class GrantConstraint:
    """One rule of the allocation pipeline. `prepare` runs once per plan
    (after fixed rows are pinned), `admits` vets each candidate grant, and
    `admits_pinned` vets the pinned-trial base state — a constraint that
    rejects it demotes the pinned probes to ordinary candidates. Subclass
    and pass via `greedy_allocate(constraints=[...])` /
    `BatchSpecPlanner(constraints_factory=...)` to extend the planner
    (this is the extension point future constraints — replication
    steering, memory caps — plug into)."""

    name = "constraint"

    def prepare(self, ctx: AllocationContext) -> None:
        pass

    def admits(self, cand: GrantCandidate, ctx: AllocationContext) -> bool:
        return True

    def admits_pinned(self, ctx: AllocationContext) -> bool:
        return True


@dataclass
class BreakEvenConstraint(GrantConstraint):
    """The paper's break-even rule per grant: a candidate must beat the
    batch's no-speculation token rate — the water level
    `util_floor * sum(w_i) / t_base`, with latency-tier rows weighted
    above 1 (`weights`) so mixed-tier passes demand more from every
    marginal grant. With unit weights this is exactly the pre-pipeline
    `util_floor * B_live / t_base` level, float for float."""
    util_floor: float = 1.0
    weights: Optional[Dict[int, float]] = None

    name = "break_even"
    r_floor: float = 0.0

    def prepare(self, ctx: AllocationContext) -> None:
        if not ctx.decode:
            self.r_floor = 0.0
            return
        eff_b = (len(ctx.decode) if self.weights is None
                 else sum(self.weights.get(i, 1.0) for i in ctx.decode))
        self.r_floor = self.util_floor * eff_b / ctx.t_base

    def admits(self, cand: GrantCandidate, ctx: AllocationContext) -> bool:
        return not (cand.rate < self.r_floor)


@dataclass
class SLOTpotConstraint(GrantConstraint):
    """Victim protection: deny any grant that pushes any co-scheduled
    bounded request's *predicted* TPOT past its bound — not just the
    grantee's. Predicted TPOT is the whole pass (the candidate's
    `t_after`) over the request's expected emissions.

    The escape clause — a candidate violating row j's bound is still
    admitted when it does not worsen j's predicted TPOT — keeps an
    *infeasibly*-bounded row (its bound below even the no-speculation
    pass) from freezing the whole batch, and lets a bounded row's own
    speculation pull it back under its bound (Theorem 4.2: TPOT falls as
    utility rises). The invariant that survives water-filling, property-
    tested: every bounded row's predicted TPOT ends <= max(its bound, its
    no-speculation TPOT)."""
    bounds: Dict[int, float] = field(default_factory=dict)

    name = "slo_tpot"

    def _tpot(self, j: int, t_pass: float, ctx: AllocationContext,
              extra: int = 0) -> float:
        e = ctx.yields.emitted(j, ctx.alloc[j] + extra)
        return t_pass / e if e > 0 else float("inf")

    def admits(self, cand: GrantCandidate, ctx: AllocationContext) -> bool:
        for j, bound in self.bounds.items():
            extra = 1 if j == cand.row else 0
            after = self._tpot(j, cand.t_after, ctx, extra)
            if tpot_within(bound, after):
                continue
            if after > self._tpot(j, ctx.t_cur, ctx):
                return False   # worsens a bounded victim past its SLO
        return True

    def admits_pinned(self, ctx: AllocationContext) -> bool:
        """A staggered trial's pinned probe K must not break a
        co-scheduled bound either — SLO beats trial fidelity. Compared
        against the no-speculation base state (the demotion target)."""
        if not self.bounds or not ctx.fixed:
            return True
        base_ns = list(ctx.ns)
        for i in ctx.fixed:
            base_ns[i] -= ctx.alloc[i]
        t_zero = ctx.oracle.t_batch(base_ns)
        for j, bound in self.bounds.items():
            after = self._tpot(j, ctx.t_cur, ctx)
            if tpot_within(bound, after):
                continue
            e = ctx.yields.emitted(j, 0 if j in ctx.fixed else ctx.alloc[j])
            if after > (t_zero / e if e > 0 else float("inf")):
                return False
        return True


# -- admission-side constraints ----------------------------------------- #
#
# The GrantConstraint pipeline above vets +1-draft grants to rows already
# IN the batch. Under open-loop load the symmetric decision happens one
# level earlier: should a queued request join the batch at all? Same
# shape (a predicted cost, a bound, an escape clause) applied to joins
# instead of grants.

#: admission verdicts: ADMIT joins the request now; DEFER holds it at the
#: queue head until the batch drains (backpressure); SHED drops it and
#: records the drop as first-class telemetry (a bounded shed request IS a
#: TTFT violation, `slo.ttft_violated`).
ADMIT, DEFER, SHED = "admit", "defer", "shed"


@dataclass
class AdmissionDecision:
    """One join verdict, with the prediction that produced it."""
    action: str                # ADMIT | DEFER | SHED
    predicted_ttft: float = 0.0  # queue delay so far + predicted service
    reason: str = ""


class AdmissionConstraint:
    """One rule of the admission pipeline, the join-side analogue of
    `GrantConstraint`. `decide` vets a single queued request about to
    join; it must be a pure read (no engine or scheduler state mutated),
    so an admission pipeline that always returns ADMIT is bit-identical
    to running without one. Subclass and hand to
    `ContinuousBatchingScheduler(admission=...)`."""

    name = "admission"

    def decide(self, slo, *, queue_delay: float, service_time: float,
               deferrals: int = 0) -> AdmissionDecision:
        return AdmissionDecision(ADMIT, queue_delay + service_time)


@dataclass
class PredictiveTTFTAdmission(AdmissionConstraint):
    """Shed (or defer) joins whose TTFT is already doomed: the request's
    accrued queue delay plus the `BatchCostOracle`-predicted service time
    to its first token (`BatchedEngine.predicted_service_time`, prefill
    passes priced at the CURRENT batch state) already exceeds its TTFT
    bound, so admitting it burns prefill capacity on a guaranteed SLO
    violation and lengthens the shared pass for everyone behind it.

    The escape clause mirrors the grant constraints' don't-worsen rule:
    requests without a TTFT bound are never touched, and a bound met
    within `headroom` admits immediately, so under light load the
    constraint never engages and the token streams are bit-identical to
    the unconstrained scheduler. `on_doomed` picks the overload
    behavior: "shed" drops doomed requests (load shedding), "defer"
    holds them at the queue head for up to `max_defers` admission rounds
    (backpressure) before admitting anyway: the defer budget keeps
    deferral from becoming livelock."""
    on_doomed: str = "shed"    # "shed" | "defer"
    max_defers: int = 8
    headroom: float = 1.0     # admit when predicted <= headroom * bound

    name = "predictive_ttft"

    def __post_init__(self):
        if self.on_doomed not in (SHED, DEFER):
            raise ValueError(f"on_doomed={self.on_doomed!r} "
                             f"(expected {SHED!r} or {DEFER!r})")

    def decide(self, slo, *, queue_delay: float, service_time: float,
               deferrals: int = 0) -> AdmissionDecision:
        bound = getattr(slo, "ttft", None)
        predicted = queue_delay + service_time
        if bound is None or predicted <= self.headroom * bound:
            return AdmissionDecision(ADMIT, predicted)
        if self.on_doomed == DEFER and deferrals < self.max_defers:
            return AdmissionDecision(DEFER, predicted,
                                     "predicted TTFT past bound")
        return AdmissionDecision(
            SHED if self.on_doomed == SHED else ADMIT, predicted,
            "predicted TTFT past bound" if self.on_doomed == SHED
            else "defer budget exhausted")


@dataclass
class PlanDecision:
    """One request's slice of the step plan."""
    slot: int
    requested: int          # the controller's ask (next_k / hold)
    granted: int            # the planner's joint allocation
    accept_rate: float      # windowed estimate used for the prediction
    phase: str              # controller phase when planned
    held: bool = False      # TEST trial postponed by staggering
    slo_capped: bool = False  # a grant to this row was denied by an SLO

    @property
    def preempted(self) -> bool:
        """Speculation denied outright despite the controller asking."""
        return self.requested > 0 and self.granted == 0


@dataclass
class BatchPlan:
    """The joint allocation for one engine step, plus the predictions the
    telemetry compares against the measured pass (predicted vs measured Δt
    is the planner's own calibration signal)."""
    decisions: Dict[int, PlanDecision] = field(default_factory=dict)
    t_base: float = 0.0        # predicted no-speculation pass seconds
    t_predicted: float = 0.0   # predicted pass seconds at the grants
    tokens_predicted: float = 0.0  # predicted emissions (decode rows)
    held: int = 0              # TEST trials postponed this step
    preempted: int = 0         # requests granted 0 while asking > 0
    slo_denied: int = 0        # rows whose grants an SLO constraint capped
    priced: bool = False       # the oracle actually priced this pass (any
                               # tokens planned) — telemetry's calibration-
                               # sample filter, robust to a predicted 0.0

    @property
    def requested_total(self) -> int:
        return sum(d.requested for d in self.decisions.values())

    @property
    def granted_total(self) -> int:
        return sum(d.granted for d in self.decisions.values())

    @property
    def utility_predicted(self) -> float:
        """Predicted batch utility of the allocation: predicted throughput
        over the batch's predicted no-speculation throughput."""
        n = len(self.decisions)
        if not n or self.t_predicted <= 0 or self.t_base <= 0:
            return 1.0
        return (self.tokens_predicted / self.t_predicted) / (n / self.t_base)


def greedy_allocate(oracle: cm.BatchCostOracle, base_ns, decode, caps,
                    accepts, *, fixed=frozenset(), util_floor: float = 1.0,
                    constraints: Optional[Sequence[GrantConstraint]] = None,
                    yield_model: Optional[DraftYieldModel] = None):
    """Greedy marginal-utility water-filling through the constraint
    pipeline.

    Starting from `base_ns` (every decode row at its committed token, plus
    any co-scheduled prefill chunks), repeatedly grant +1 draft token to
    the *admissible* decode row with the highest predicted Δtokens/Δt_batch,
    where Δtokens comes from `yield_model` (default: the flat-acceptance
    geometric increment accepts[i]^(k_i+1)) and Δt_batch from the cost
    oracle at the *current* allocation — so union saturation cheapens later
    grants and roofline crossover taxes them, exactly as the shared pass
    will. A candidate is admissible when every constraint admits it;
    `constraints=None` builds the default pipeline [BreakEvenConstraint
    (util_floor)], which reproduces the pre-pipeline stopping rule — stop
    when the best marginal rate falls below `util_floor * len(decode) /
    t_base` — bit for bit. The loop ends when no admissible candidate
    remains. Ties break on the lowest row index, keeping the allocation
    deterministic.

    `fixed` rows are pinned at caps[i] before water-filling begins — the
    staggered TEST trial whose probe K must run unmodified. A constraint
    may veto the pinned state (`admits_pinned` — the SLO constraint does,
    when a probe would break a co-scheduled bound); the pins are then
    demoted to ordinary capped candidates.

    Returns (alloc, info) with alloc = {row: drafts granted} and info
    carrying t_base / t_alloc / r_floor plus `denied` ({constraint name:
    rows it vetoed at least once}) for telemetry."""
    ym = yield_model or DraftYieldModel(accepts)
    cons = (list(constraints) if constraints is not None
            else [BreakEvenConstraint(util_floor=util_floor)])
    ns = list(base_ns)
    alloc = {i: 0 for i in decode}
    t_base = oracle.t_batch(ns)
    for i in fixed:
        alloc[i] = caps[i]
        ns[i] += caps[i]
    t_cur = oracle.t_batch(ns)
    ctx = AllocationContext(oracle=oracle, decode=decode, caps=caps,
                            accepts=accepts, yields=ym, ns=ns, alloc=alloc,
                            t_base=t_base, t_cur=t_cur, fixed=fixed)
    denied: Dict[str, set] = {}
    if fixed and not all(c.admits_pinned(ctx) for c in cons):
        for i in fixed:
            ns[i] -= caps[i]
            alloc[i] = 0
            denied.setdefault("pinned", set()).add(i)
        fixed = ctx.fixed = frozenset()
        ctx.t_cur = t_cur = oracle.t_batch(ns)
    for c in cons:
        c.prepare(ctx)
    while True:
        best = None
        for i in decode:
            if i in fixed or alloc[i] >= caps[i]:
                continue
            d_tok = ym.marginal(i, alloc[i])
            ns[i] += 1
            t_after = oracle.t_batch(ns)
            ns[i] -= 1
            d_t = t_after - t_cur
            rate = (d_tok / d_t) if d_t > 0 else float("inf")
            cand = GrantCandidate(row=i, k_current=alloc[i], d_tokens=d_tok,
                                  d_t=d_t, rate=rate, t_after=t_after)
            veto = next((c for c in cons if not c.admits(cand, ctx)), None)
            if veto is not None:
                denied.setdefault(veto.name, set()).add(i)
                continue
            if best is None or cand.rate > best.rate:
                best = cand
        if best is None:
            break
        alloc[best.row] += 1
        ns[best.row] += 1
        ctx.t_cur = t_cur = oracle.t_batch(ns)
    floor = next((c.r_floor for c in cons
                  if isinstance(c, BreakEvenConstraint)), 0.0)
    return alloc, {"t_base": t_base, "t_alloc": t_cur, "r_floor": floor,
                   "denied": denied}


class BatchSpecPlanner:
    """Joint {K_i} allocator for one `BatchedEngine` (see module docstring).

    Stateless across steps except the staggering round-robin pointer, so a
    planner can be shared by the engine for the whole serving run."""

    def __init__(self, cfg, hw: cm.Hardware = None, *, affinity: float = 0.0,
                 window: int = 0, config: Optional[PlannerConfig] = None,
                 calibration: Optional[cm.Calibration] = None,
                 precision: Optional[cm.Precision] = None,
                 drafter_precision: Optional[cm.Precision] = None):
        self.cfg = cfg
        self.hw = hw or cm.H100_SXM
        self.affinity = affinity
        self.window = window
        self.config = config or PlannerConfig()
        #: per-tensor-class bytes-per-param spec (cost_model.Precision)
        #: every oracle this planner builds prices with: quantized experts
        #: move the break-even water level; None is the bf16 default
        self.precision = precision
        #: bytes-per-param spec for the drafter's weights (priced at the
        #: dense class); None is bf16
        self.drafter_precision = drafter_precision
        #: wall-clock residual correction (cost_model.Calibration) applied
        #: to every oracle this planner prices with; None is bit-identical
        #: to the uncalibrated planner
        self.calibration = calibration
        self._stagger_tick = 0   # round-robin fairness across trialing rows

    # ------------------------------------------------------------------ #

    def _accept_rate(self, controller) -> Optional[float]:
        analyzer = getattr(controller, "analyzer", None)
        if analyzer is None or not hasattr(analyzer, "accept_rate"):
            return None
        return analyzer.accept_rate(self.config.accept_window)

    def _accept_curve(self, controller, max_k: int) -> Optional[list]:
        analyzer = getattr(controller, "analyzer", None)
        if analyzer is None or not hasattr(analyzer, "accept_curve"):
            return None
        return analyzer.accept_curve(max_k, self.config.accept_window)

    def build_constraints(self, decode, requested,
                          slos: Dict[int, RequestSLO]
                          ) -> List[GrantConstraint]:
        """The default pipeline: the (latency-weighted) break-even water
        level plus victim-protecting TPOT bounds. Override or extend in a
        subclass to plug in additional constraints."""
        cfgp = self.config
        weights = None
        if cfgp.latency_tier_weight != 1.0:
            lat = {i: cfgp.latency_tier_weight for i in decode
                   if i in slos and slos[i].tier == LATENCY}
            weights = lat or None
        bounds = {i: slos[i].tpot for i in decode
                  if i in slos and slos[i].tpot is not None}
        cons: List[GrantConstraint] = [
            BreakEvenConstraint(util_floor=cfgp.util_floor,
                                weights=weights),
            SLOTpotConstraint(bounds=bounds)]
        return cons

    def plan(self, controllers: Dict[int, object], context_lens, *,
             prefill_tokens: Optional[Dict[int, int]] = None,
             slos: Optional[Dict[int, RequestSLO]] = None) -> BatchPlan:
        """Plan one step. `controllers` maps decode row -> its controller
        (asks are collected here: `next_k()`, or `hold()` for staggered
        TEST rows); `context_lens` is the full [B] row table's cache
        lengths; `prefill_tokens` maps prefill rows to their co-scheduled
        chunk sizes (they share the pass and its expert union, so the
        water-filling prices them in); `slos` maps decode rows to their
        `RequestSLO`s: TPOT bounds and tiers become constraints on the
        joint allocation."""
        cfgp = self.config
        b = len(context_lens)
        pre = {i: max(int(p), 0)
               for i, p in (prefill_tokens or {}).items() if p > 0}
        decode = sorted(controllers)
        slos = slos or {}
        joint = cfgp.policy == "joint"

        # -- phase staggering: at most one TEST trial per shared pass ----
        held = frozenset()
        if joint and cfgp.stagger_tests and len(decode) > 1:
            testers = [i for i in decode
                       if getattr(controllers[i], "phase", "") == TEST
                       and hasattr(controllers[i], "hold")]
            if len(testers) > 1:
                keep = testers[self._stagger_tick % len(testers)]
                held = frozenset(t for t in testers if t != keep)
                self._stagger_tick += 1

        requested, phases, accepts = {}, {}, {}
        for i in decode:
            ctl = controllers[i]
            phases[i] = getattr(ctl, "phase", "")
            requested[i] = int(ctl.hold() if i in held else ctl.next_k())
            a = self._accept_rate(ctl)
            accepts[i] = cfgp.default_accept if a is None else a
        curves = None
        if cfgp.use_accept_curve:
            curves = {}
            for i in decode:
                c = self._accept_curve(controllers[i],
                                       max(requested[i], 1))
                if c is not None:
                    curves[i] = c
        ym = DraftYieldModel(accepts, curves)

        base_ns = [0] * b
        for i in decode:
            base_ns[i] = 1
        for i, p in pre.items():
            base_ns[i] = p
        oracle = cm.BatchCostOracle(
            self.cfg, self.hw, context_lens, affinity=self.affinity,
            window=self.window,
            prefill_tokens=[pre.get(i, 0) for i in range(b)],
            calibration=self.calibration,
            precision=self.precision)

        # -- allocate ----------------------------------------------------
        # bypass: independent policy, or a single-span pass (B=1 — the
        # paper's regime, where Cascade alone is the policy, the planner
        # must be invisible bit for bit, and the request's own SLO is the
        # per-request CascadeConfig.slo_tpot check)
        singleton = len(decode) == 1 and not pre
        slo_capped: set = set()
        if not joint or singleton:
            alloc = dict(requested)
        else:
            # the (single) surviving trial runs its probe K unmodified
            fixed = frozenset(
                i for i in decode
                if phases[i] == TEST and i not in held and requested[i] > 0)
            alloc, info = greedy_allocate(
                oracle, base_ns, decode, requested, accepts, fixed=fixed,
                util_floor=cfgp.util_floor, yield_model=ym,
                constraints=self.build_constraints(decode, requested, slos))
            slo_capped = (info["denied"].get("slo_tpot", set())
                          | info["denied"].get("pinned", set()))

        # -- predictions + decisions ------------------------------------
        ns = list(base_ns)
        for i in decode:
            ns[i] += alloc[i]
        any_tokens = bool(decode or pre)
        t_base = oracle.t_batch(base_ns) if any_tokens else 0.0
        t_pred = oracle.t_batch(ns) if any_tokens else 0.0
        decisions = {
            i: PlanDecision(slot=i, requested=requested[i],
                            granted=alloc[i], accept_rate=accepts[i],
                            phase=phases[i], held=i in held,
                            slo_capped=i in slo_capped)
            for i in decode}
        return BatchPlan(
            decisions=decisions, t_base=t_base, t_predicted=t_pred,
            tokens_predicted=sum(ym.emitted(i, alloc[i]) for i in decode),
            held=len(held),
            preempted=sum(1 for d in decisions.values() if d.preempted),
            slo_denied=len(slo_capped), priced=any_tokens)
