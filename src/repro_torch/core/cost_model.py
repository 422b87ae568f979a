"""Data-movement cost model for MoE speculative verification (paper §2.4):
the part the serving engines and the batch planner price their passes
with, the wall-clock `Calibration` of its predictions, and the host tier
of expert residency: `ExpertPlacement` marks experts as device-resident
("hbm") or offloaded ("host"), and a pass whose activated host experts
are missing from device memory pays a host-link fetch term, whole-expert
(`_fetch_time`) or layer-pipelined (`fetch_time_layered`), minus what
the draft window and the compute of earlier layers hide. The tier is
priced, not enacted: the engines keep every expert's weights on the
device. A placement over more than one shard prices expert parallelism
(EP): the hottest shard's local activated experts gate the pass, and the
all-to-all dispatch adds interconnect time (`a2a_bytes`, `_a2a_time`);
hot experts may be replicated, and the analytic union then takes the
relief of the coolest replica (`_rebalance_replicas`).

Single-batch decoding is memory-bandwidth-bound: iteration time is governed
by the bytes fetched from device memory — all attention weights, the
*unique* experts activated by the in-flight tokens, the KV cache read, and
the unembedding. Verifying K+1 tokens multiplies the expert term by the
number of unique experts they collectively activate (bucket-and-balls,
damped by expert affinity), which is exactly why speculation can slow MoEs
down. Under `clock="model"` the engine's times come from here, so they are
deterministic functions of token counts and routing counts."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple


@dataclass(frozen=True)
class Hardware:
    name: str
    hbm_bw: float            # bytes/s
    peak_flops: float        # FLOP/s at serving precision
    ici_bw: float = 0.0      # bytes/s per chip-to-chip link
    weight_bytes: int = 2    # serving precision (bf16/fp16 = 2)
    #: host<->HBM link bandwidth (PCIe/DMA class) — the path an offloaded
    #: (host-tier) expert's weights cross to become HBM-resident
    #: (docs/offload.md). 0 = no offload path: fetch pricing raises.
    host_bw: float = 0.0
    #: HBM capacity in bytes (0 = unspecified). Informational for the
    #: large-config sanity checks; residency caps are set per shard on
    #: `ResidencyState`, not read from here.
    hbm_bytes: float = 0.0


#: NVIDIA H100 SXM (NVIDIA data sheet): 3.35 TB/s HBM3, 989 TFLOP/s dense
#: bf16, 80 GB; host link PCIe Gen5 x16 at about 64 GB/s per direction;
#: NVLink 4 at 900 GB/s a GPU, both directions together, so 450 GB/s in
#: one direction, the egress `_a2a_time` divides by. The NVLink figure is
#: the data sheet's, not a measurement. The default `hw` of the port's
#: serving engine.
H100_SXM = Hardware("h100-sxm", hbm_bw=3.35e12, peak_flops=989e12,
                    ici_bw=450e9, host_bw=64e9, hbm_bytes=80e9)


@dataclass(frozen=True)
class Precision:
    """Bytes-per-param by tensor class — the ONE source of truth for
    serving precision (docs/quantization.md).

    The paper's utility calculus is bytes-moved-per-pass, and quantization
    changes the bytes: int8/fp8 expert weights halve `_expert_read_bytes`,
    shifting the roofline crossover and with it every planner decision
    (break-even floor, grant steering, residency capacity, fetch
    deadlines). A single global `Hardware.weight_bytes` cannot express
    mixed precision — the quantized path keeps dense/attention weights at
    bf16 while experts stream at 1 byte/param — so pricing takes a
    per-tensor-class spec instead. Every bytes function threads this spec;
    the scattered `wb=2` defaults all resolve through `DEFAULT` so a
    precision change cannot silently half-apply.

    `precision=None` everywhere means `Precision.DEFAULT` (all classes at
    2 bytes) and is bit-identical to the pre-quantization stack — the same
    degradation contract as `calibration=None` / `placement=None`, pinned
    by a tier-1 property test."""
    dense: int = 2     # attention / dense-FFN / router / unembedding
    expert: int = 2    # routed expert weights (the quantization target)
    kv: int = 2        # KV-cache rows
    label: str = "bf16"   # telemetry tag; never enters arithmetic

    @classmethod
    def int8_experts(cls) -> "Precision":
        """Weight-only int8 routed experts (per-expert absmax scales,
        dequant-in-kernel); dense/attention/KV stay bf16."""
        return cls(expert=1, label="int8-experts")

    @classmethod
    def fp8_experts(cls) -> "Precision":
        """fp8(e4m3) routed experts — same 1 byte/param pricing as int8;
        the numerics differ (kernels/moe_gmm/quant.py fake-quant on CPU)."""
        return cls(expert=1, label="fp8-experts")

    @property
    def quantized_experts(self) -> bool:
        return self.expert < self.dense


#: module default: bf16 everywhere — what `precision=None` resolves to
Precision.DEFAULT = Precision()


def _resolve_precision(precision: Optional["Precision"],
                       wb: Optional[int] = None) -> "Precision":
    """`precision` if given; else a uniform spec from a legacy `wb` int;
    else the bf16 default. Keeps old `wb=` call sites working while the
    spec stays the single source of truth."""
    if precision is not None:
        return precision
    if wb is not None:
        return Precision(dense=wb, expert=wb, kv=wb, label=f"wb{wb}")
    return Precision.DEFAULT


# --------------------------------------------------------------------- #
# Wall-clock calibration
# --------------------------------------------------------------------- #

@dataclass(frozen=True)
class Calibration:
    """Measured-residual correction for the analytic pass-time model.

    The planner predicts each step's pass time analytically (expected
    union + roofline); the engine then measures it (`StepTelemetry.t_step`
    vs `t_step_predicted`, aggregated as `plan_time_error`). The residual
    is dominated by systematic terms (on the card, the host's share of
    every pass, which the roofline does not price), so a least-squares
    scale/offset on (predicted, measured) pairs removes most of it. The
    all-to-all term gets its own scale (`a2a_scale`): it prices the
    interconnect, not device memory, and its residual is independent of
    the roofline's.

    Applied on the *prediction* side only (`BatchCostOracle(calibration=)`
    via `BatchSpecPlanner(calibration=)`); the engine's measured costs are
    never calibrated, so before/after residuals stay comparable.
    `calibration=None` everywhere is bit-identical to the uncalibrated
    stack."""
    time_scale: float = 1.0     # multiplier on the roofline + overhead term
    time_offset: float = 0.0    # additive seconds
    a2a_scale: float = 1.0      # multiplier on the all-to-all term
    resid_before: float = 0.0   # mean |pred-meas|/meas of the fitted pairs
    resid_after: float = 0.0    # same, after applying the fit

    def apply(self, t: float, t_a2a: float = 0.0) -> float:
        """Calibrated pass seconds for an analytic prediction `t` whose
        all-to-all component was `t_a2a` (0 when unsharded)."""
        base = t - t_a2a
        return max(self.time_scale * base + self.a2a_scale * t_a2a
                   + self.time_offset, 0.0)

    def adapted_util_floor(self, base: float = 1.0) -> float:
        """Break-even utility floor with an uncertainty margin: after
        calibration the model still mispredicts by `resid_after` on
        average, so grants must clear break-even by that margin before
        they are trusted (planner.PlannerConfig.util_floor)."""
        return base * (1.0 + max(self.resid_after, 0.0))

    @classmethod
    def fit(cls, predicted, measured, a2a=None) -> "Calibration":
        """Least-squares fit of measured ≈ scale*(pred - a2a) +
        a2a_scale*a2a + offset over per-step pairs. Without any nonzero
        `a2a` the collective column is dropped (a2a_scale stays 1.0). A
        degenerate system falls back to the identity transform."""
        pred = [float(p) for p in predicted]
        meas = [float(m) for m in measured]
        n = len(pred)
        if n == 0 or len(meas) != n:
            raise ValueError(f"{n} predictions vs {len(meas)} measurements")
        aa = [0.0] * n if a2a is None else [float(x) for x in a2a]
        if len(aa) != n:
            raise ValueError(f"{n} predictions vs {len(aa)} a2a terms")
        base = [p - a for p, a in zip(pred, aa)]
        have_a2a = any(a > 0.0 for a in aa)
        cols = [base, aa, [1.0] * n] if have_a2a else [base, [1.0] * n]
        theta = _lstsq(cols, meas)
        if theta is None:
            s, c, off = 1.0, 1.0, 0.0
        elif have_a2a:
            s, c, off = theta
        else:
            (s, off), c = theta, 1.0
        s = max(s, 1e-6)   # a degenerate fit must not run time backwards
        c = max(c, 0.0)
        rb = _mean_rel_err(pred, meas)
        ra = _mean_rel_err([s * b + c * a + off
                            for b, a in zip(base, aa)], meas)
        return cls(time_scale=s, time_offset=off, a2a_scale=c,
                   resid_before=rb, resid_after=ra)


def _mean_rel_err(pred, meas) -> float:
    """Mean |pred - meas| / meas over pairs with meas > 0: the same
    definition `serving.telemetry.planner_aggregates` reports as
    `plan_time_error`."""
    errs = [abs(p - m) / m for p, m in zip(pred, meas) if m > 0]
    return sum(errs) / len(errs) if errs else 0.0


def _lstsq(cols, y):
    """Tiny normal-equations least squares (2-3 unknowns): solve
    (A^T A) theta = A^T y by Gaussian elimination with a whisper of ridge.
    Returns None when the system is singular beyond rescue."""
    k = len(cols)
    ata = [[sum(ci * cj for ci, cj in zip(cols[i], cols[j])) + (1e-12 if
            i == j else 0.0) for j in range(k)] for i in range(k)]
    aty = [sum(ci * yi for ci, yi in zip(cols[i], y)) for i in range(k)]
    for col in range(k):          # forward elimination with partial pivot
        piv = max(range(col, k), key=lambda r: abs(ata[r][col]))
        if abs(ata[piv][col]) < 1e-30:
            return None
        ata[col], ata[piv] = ata[piv], ata[col]
        aty[col], aty[piv] = aty[piv], aty[col]
        for r in range(col + 1, k):
            fac = ata[r][col] / ata[col][col]
            for cc in range(col, k):
                ata[r][cc] -= fac * ata[col][cc]
            aty[r] -= fac * aty[col]
    theta = [0.0] * k
    for r in range(k - 1, -1, -1):
        theta[r] = (aty[r] - sum(ata[r][cc] * theta[cc]
                                 for cc in range(r + 1, k))) / ata[r][r]
    return theta


# --------------------------------------------------------------------- #
# Expert activation statistics (paper §2.4)
# --------------------------------------------------------------------- #

def expected_unique_experts(num_experts: int, top_k: int, n_tokens: int,
                            affinity: float = 0.0) -> float:
    """Expected number of distinct experts activated by `n_tokens` tokens,
    each selecting `top_k` distinct experts.

    affinity=0: uniform-random routing (bucket-and-balls):
        E[unique] = E * (1 - (1 - k/E)^T)
    affinity=1: perfect temporal reuse (all tokens share one expert set).
    The paper observes real tasks fall between the two (§2.4: Mixtral math
    shows 3x instead of the random 3.5x at K=7)."""
    if num_experts == 0:
        return 0.0
    n_tokens = max(int(n_tokens), 1)
    e, k = float(num_experts), float(min(top_k, num_experts))
    rand = e * (1.0 - (1.0 - k / e) ** n_tokens)
    floor = k  # one shared expert set
    return floor + (rand - floor) * (1.0 - affinity)


def expected_unique_experts_batch(num_experts: int, top_k: int,
                                  tokens_per_request, affinity: float = 0.0
                                  ) -> dict:
    """Multi-request extension of `expected_unique_experts`: B requests
    jointly verifying sum(n_i) tokens in one shared pass activate the
    *union* of their expert sets.

    Returns:
        union     — E[unique experts] over all sum(n_i) tokens
        marginal  — per-request marginal contribution,
                    m_i = union(all) - union(all minus request i),
                    the bytes request i adds to the shared verification
                    (it shrinks as the rest of the batch grows, because the
                    batch has already paid for most of i's experts)."""
    ns = [max(int(n), 0) for n in tokens_per_request]
    total = sum(ns)
    if total <= 0:
        return {"union": 0.0, "marginal": [0.0] * len(ns)}
    union = expected_unique_experts(num_experts, top_k, total, affinity)
    marginal = []
    for n in ns:
        if n <= 0:
            marginal.append(0.0)
        elif total - n <= 0:
            marginal.append(union)
        else:
            marginal.append(union - expected_unique_experts(
                num_experts, top_k, total - n, affinity))
    return {"union": union, "marginal": marginal}


# --------------------------------------------------------------------- #
# Expert-parallel placement + per-shard activation statistics. Under
# expert parallelism (EP) the activated-expert union is *per shard*: the
# pass completes only when the hottest shard has streamed its local
# experts, so global-union accounting under-prices skewed routing
# (docs/expert_parallel.md).
# --------------------------------------------------------------------- #

@dataclass(frozen=True)
class ExpertPlacement:
    """Experts -> EP-shard map: the pricing contract every shard-aware
    consumer (cost model, planner, engine telemetry) shares.

    `shard_of[e]` is the shard holding expert e's weights — an int for the
    common single-home case, or a tuple of distinct shard ids when the
    expert is *replicated* (hot-expert replication: the first id is the
    primary home, the rest hold read-only replicas). Every shard id in
    0..n_shards-1 holds at least one resident expert (primary or replica).
    `contiguous` matches `distributed.expert_parallel`'s layout (expert e
    on shard e // (E / n_shards)); `from_sizes` builds contiguous blocks
    of arbitrary sizes, `zipf` the skew-study placement that co-locates
    zipf-proportional expert populations on shard 0 downward, and
    `replicate` adds replica shards to chosen experts of an existing
    placement.

    Replication is a *pricing* feature: a replicated expert's activated
    load can be served from whichever replica shard is coolest, so the
    analytic per-shard union takes min-over-replicas (see
    `_rebalance_replicas` — it can only lower the gating shard, never
    raise it). `BatchedEngine` routes each replicated expert to its
    currently coolest replica; without replicas it routes on the primary
    homes (`primary_shard_of`).

    Residency tiers (`tier_of`): each expert additionally
    carries a memory tier — `"hbm"` (weights always device-resident, the
    default) or `"host"` (weights live in host memory and must cross the
    `Hardware.host_bw` link before the shard can stream them). `tier_of is
    None` means all-`hbm` and degrades bit-exactly to the flat placement.
    A replicated expert cannot be `host`-tier: replication exists to
    relieve the gating shard, and a replica that might not be resident
    would make the min-over-replicas relief unsound. Tiers do not change
    homes — `shard_of`, `counts`, and the routed activation curve are
    tier-blind; what changes is which activated experts cost a host fetch,
    tracked dynamically by `ResidencyState` (core/residency.py)."""
    shard_of: Tuple
    tier_of: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        if not self.shard_of:
            raise ValueError("empty placement (no experts)")
        norm = []
        for e, s in enumerate(self.shard_of):
            if isinstance(s, (tuple, list)):
                reps = tuple(int(x) for x in s)
                if not reps or len(set(reps)) != len(reps) or min(reps) < 0:
                    raise ValueError(f"expert {e}: replica shards must be "
                                     f"a non-empty set of distinct "
                                     f"non-negative ids, got {s!r}")
                norm.append(reps if len(reps) > 1 else reps[0])
            else:
                if int(s) < 0:
                    raise ValueError(f"expert {e}: negative shard id {s!r}")
                norm.append(int(s))
        object.__setattr__(self, "shard_of", tuple(norm))
        resident = set()
        for s in self.shard_of:
            resident.update(s if isinstance(s, tuple) else (s,))
        n = max(resident) + 1
        if resident != set(range(n)):
            raise ValueError("shard ids must cover 0..n_shards-1 with every "
                             f"shard non-empty, got {self.shard_of}")
        if self.tier_of is not None:
            tiers = tuple(str(t) for t in self.tier_of)
            if len(tiers) != len(self.shard_of):
                raise ValueError(f"{len(tiers)} tiers vs "
                                 f"{len(self.shard_of)} experts")
            bad = sorted({t for t in tiers if t not in ("hbm", "host")})
            if bad:
                raise ValueError(f"unknown tier(s) {bad}; expected "
                                 f"'hbm' or 'host'")
            for e, (s, t) in enumerate(zip(self.shard_of, tiers)):
                if t == "host" and isinstance(s, tuple):
                    raise ValueError(f"expert {e} is replicated and cannot "
                                     "be host-tier (replica relief assumes "
                                     "residency)")
            object.__setattr__(self, "tier_of", tiers)

    @property
    def num_experts(self) -> int:
        return len(self.shard_of)

    @property
    def n_shards(self) -> int:
        return max(max(s) if isinstance(s, tuple) else s
                   for s in self.shard_of) + 1

    @property
    def primary_shard_of(self) -> Tuple[int, ...]:
        """Each expert's primary home — the layout the measured engine
        path routes on (ints, usable as `ep_shard_ids`)."""
        return tuple(s[0] if isinstance(s, tuple) else s
                     for s in self.shard_of)

    @property
    def has_replication(self) -> bool:
        return any(isinstance(s, tuple) for s in self.shard_of)

    @property
    def counts(self) -> Tuple[int, ...]:
        """Experts homed per shard (primary residence — the population the
        analytic activation curve spreads routed mass over; replicas do
        not add activated population, they add serving *options*, priced
        by `_rebalance_replicas`)."""
        c = [0] * self.n_shards
        for s in self.primary_shard_of:
            c[s] += 1
        return tuple(c)

    @property
    def resident_counts(self) -> Tuple[int, ...]:
        """Expert weights *statically* device-resident per shard,
        replicas included: the pinned footprint view. Host-tier experts are
        not counted: their residency is dynamic, tracked by
        `ResidencyState.resident_counts` under a byte cap. Equals `counts`
        for an all-hbm placement without replication."""
        c = [0] * self.n_shards
        tiers = self.tiers
        for e, s in enumerate(self.shard_of):
            if tiers[e] == "host":
                continue
            for x in (s if isinstance(s, tuple) else (s,)):
                c[x] += 1
        return tuple(c)

    @property
    def tiers(self) -> Tuple[str, ...]:
        """Per-expert tier, `tier_of` defaulted to all-`hbm`."""
        return self.tier_of if self.tier_of is not None \
            else ("hbm",) * len(self.shard_of)

    @property
    def has_host_tier(self) -> bool:
        return self.tier_of is not None and "host" in self.tier_of

    @property
    def host_tier_counts(self) -> Tuple[int, ...]:
        """Homed host-tier experts per shard (primary residence)."""
        c = [0] * self.n_shards
        for s, t in zip(self.primary_shard_of, self.tiers):
            if t == "host":
                c[s] += 1
        return tuple(c)

    @property
    def replication_groups(self) -> Tuple[Tuple[int, Tuple[int, ...], int],
                                          ...]:
        """Replicated experts grouped by identical replica set:
        (primary_shard, alternate_shards, n_experts) per group — the
        movable-mass units `_rebalance_replicas` shifts off the gating
        shard. Empty without replication."""
        groups: dict = {}
        for s in self.shard_of:
            if isinstance(s, tuple):
                groups[s] = groups.get(s, 0) + 1
        return tuple((reps[0], reps[1:], n)
                     for reps, n in sorted(groups.items()))

    def validate_experts(self, num_experts: int) -> None:
        """The one consistency check every consumer of the pricing
        contract applies (cost model, planner, engine): this placement
        must map exactly the model's experts."""
        if self.num_experts != num_experts:
            raise ValueError(f"placement maps {self.num_experts} experts, "
                             f"model has {num_experts}")

    @classmethod
    def contiguous(cls, num_experts: int, n_shards: int) -> "ExpertPlacement":
        if n_shards <= 0 or num_experts % n_shards:
            raise ValueError(f"{num_experts} experts do not divide evenly "
                             f"over {n_shards} shards")
        e_loc = num_experts // n_shards
        return cls(tuple(e // e_loc for e in range(num_experts)))

    @classmethod
    def from_sizes(cls, sizes: Sequence[int]) -> "ExpertPlacement":
        ids = []
        for s, n in enumerate(sizes):
            if n <= 0:
                raise ValueError(f"shard {s} holds {n} experts")
            ids.extend([s] * int(n))
        return cls(tuple(ids))

    @classmethod
    def zipf(cls, num_experts: int, n_shards: int,
             alpha: float = 2.0) -> "ExpertPlacement":
        """Contiguous blocks with zipf(alpha)-proportional sizes (shard 0
        largest), every shard holding >= 1 expert — a deliberately skewed
        placement that concentrates the routed load on shard 0 even under
        uniform routing (the --ep-sweep skew axis)."""
        if n_shards <= 0 or n_shards > num_experts:
            raise ValueError(f"{n_shards} shards for {num_experts} experts")
        w = [1.0 / (s + 1) ** alpha for s in range(n_shards)]
        tot = sum(w)
        rem = num_experts - n_shards
        quota = [rem * x / tot for x in w]
        base = [int(q) for q in quota]
        left = rem - sum(base)
        order = sorted(range(n_shards), key=lambda s: (quota[s] - base[s], -s),
                       reverse=True)
        for s in order[:left]:
            base[s] += 1
        return cls.from_sizes([1 + b for b in base])

    def replicate(self, replicas: dict) -> "ExpertPlacement":
        """Hot-expert replication: a new placement where each expert in
        `replicas` (expert id -> extra shard id(s)) additionally holds
        read-only replicas on those shards. Primary homes are unchanged,
        so the measured layout (`primary_shard_of`) and activation
        populations (`counts`) stay identical — only the min-over-replicas
        pricing relief changes."""
        new = list(self.shard_of)
        for e, extra in replicas.items():
            if not 0 <= e < self.num_experts:
                raise ValueError(f"expert {e} outside 0..{self.num_experts - 1}")
            extra = tuple(extra) if isinstance(extra, (tuple, list)) \
                else (int(extra),)
            cur = new[e] if isinstance(new[e], tuple) else (new[e],)
            merged = cur + tuple(x for x in extra if x not in cur)
            if max(merged) >= self.n_shards:
                raise ValueError(f"expert {e}: replica shard beyond the "
                                 f"placement's {self.n_shards} shards")
            new[e] = merged
        return ExpertPlacement(tuple(new), self.tier_of)

    def offload(self, expert_ids) -> "ExpertPlacement":
        """A new placement with `expert_ids` demoted to the host tier.
        Homes are unchanged; replicated experts cannot be offloaded
        (ValueError via __post_init__)."""
        tiers = list(self.tiers)
        for e in expert_ids:
            if not 0 <= int(e) < self.num_experts:
                raise ValueError(f"expert {e} outside "
                                 f"0..{self.num_experts - 1}")
            tiers[int(e)] = "host"
        return ExpertPlacement(self.shard_of, tuple(tiers))


def _hot_shard(per_shard) -> int:
    """The gating shard: argmax activated experts, ties broken on the
    lowest shard id — the ONE tie-break rule shared by the analytic and
    measured paths (they must never disagree on which shard gates)."""
    return max(range(len(per_shard)), key=lambda s: (per_shard[s], -s))


def _normalized_shard_weights(counts, n_requests: int, shard_weights):
    """Per-request routing profiles normalized to unit mass; None entries
    (and all-zero profiles) fall back to placement-proportional mass
    E_s/E — allocation-independent, so oracles cache the result."""
    e = float(sum(counts))
    base_w = [c / e for c in counts]
    ws = []
    for i in range(n_requests):
        w = None if shard_weights is None else shard_weights[i]
        if w is None:
            ws.append(base_w)
            continue
        w = [max(float(x), 0.0) for x in w]
        if len(w) != len(counts):
            raise ValueError(f"profile of {len(w)} shards vs {len(counts)}")
        tot = sum(w)
        ws.append([x / tot for x in w] if tot > 0 else base_w)
    return ws


def _rebalance_replicas(per_shard, counts, groups, capacity=None):
    """Min-over-replicas pricing relief (hot-expert replication): a
    replicated expert group's activated load can be served from whichever
    of its replica shards is coolest, so activated mass may move off the
    gating shard. Mass on a shard splits uniformly over the shard's homed
    population, so group g on shard s owns `per_shard[s] * n_g / E_s` of
    its activated count; the greedy loop repeatedly halves the gap between
    the current gating shard and a cooler replica target. Every move takes
    mass OFF the argmax shard and lands the target strictly below the old
    max, so the gating count is non-increasing — replication can only
    relieve the gating shard, never create a hotter one (property-tested).
    Shard totals are conserved, so the union is unchanged.

    `capacity` ([S] expert-count headroom, from
    `ResidencyState.capacity_experts` under a residency cap): a shard
    whose activated load already meets its residency capacity cannot
    absorb rebalanced mass — serving a replica from it would force weights
    it has no room to keep resident — so moves are clamped to the target's
    remaining headroom and full shards are skipped. None (no residency
    cap) is bit-identical to the uncapped rebalance."""
    loads = list(per_shard)
    # movable parcels: [mass, shard-it-sits-on, full replica set]
    parcels = []
    for p, alts, n_g in groups:
        if counts[p] > 0 and loads[p] > 0:
            parcels.append([loads[p] * (n_g / counts[p]), p, (p,) + alts])
    for _ in range(16 * max(len(parcels), 1)):
        hot = _hot_shard(loads)
        best = None
        for idx, (m, src, reps) in enumerate(parcels):
            if src != hot or m <= 1e-12:
                continue
            for a in reps:
                if capacity is not None and \
                        loads[a] >= capacity[a] - 1e-12:
                    continue  # no residency headroom on this target
                if loads[a] < loads[hot] - 1e-12 and (
                        best is None or loads[a] < loads[best[1]]):
                    best = (idx, a)
        if best is None:
            break
        idx, tgt = best
        m, src, reps = parcels[idx]
        delta = min(m, (loads[src] - loads[tgt]) / 2.0)
        if capacity is not None:
            delta = min(delta, capacity[tgt] - loads[tgt])
        loads[src] -= delta
        loads[tgt] += delta
        parcels[idx][0] = m - delta
        parcels.append([delta, tgt, reps])
    return loads


def _sharded_union(num_experts: int, top_k: int, ns, counts, norm_ws,
                   affinity: float, replica_groups=None,
                   capacity=None) -> dict:
    """Core per-shard curve over pre-normalized profiles (see
    `expected_unique_experts_sharded` for the derivation and the public
    normalizing entry point). `replica_groups` (from
    `ExpertPlacement.replication_groups`) applies the min-over-replicas
    relief after the primary-home curve; `capacity` bounds what the relief
    may land on each shard (residency headroom, see
    `_rebalance_replicas`)."""
    s_n = len(counts)
    total = sum(ns)
    if num_experts == 0 or total == 0:
        return {"per_shard": [0.0] * s_n, "union": 0.0, "max_shard": 0.0,
                "hot_shard": 0, "n_shards": s_n}
    k = float(min(top_k, num_experts))
    per_shard = []
    for s in range(s_n):
        e_s = float(counts[s])
        if e_s <= 0:           # replica-only shard: no homed population
            per_shard.append(0.0)
            continue
        untouched, mass = 1.0, 0.0
        for i, n in enumerate(ns):
            if n <= 0:
                continue
            q = min(k * norm_ws[i][s] / e_s, 1.0)
            untouched *= (1.0 - q) ** n
            mass += n * norm_ws[i][s]
        rand = e_s * (1.0 - untouched)
        floor = min(k * (mass / total), e_s)
        val = floor + (rand - floor) * (1.0 - affinity)
        per_shard.append(min(max(val, 0.0), e_s))
    if replica_groups:
        per_shard = _rebalance_replicas(per_shard, counts, replica_groups,
                                        capacity)
    hot = _hot_shard(per_shard)
    return {"per_shard": per_shard, "union": sum(per_shard),
            "max_shard": per_shard[hot], "hot_shard": hot, "n_shards": s_n}


def expected_unique_experts_sharded(num_experts: int, top_k: int,
                                    tokens_per_request,
                                    placement: Optional[ExpertPlacement],
                                    affinity: float = 0.0,
                                    shard_weights=None,
                                    capacity=None) -> dict:
    """Per-EP-shard expected distinct-expert activations for B requests
    jointly verifying sum(n_i) tokens in one shared pass.

    Per-expert occupancy with per-request shard profiles: request i routes a
    fraction `shard_weights[i][s]` of its expert picks to shard s (default:
    proportional to the shard's resident population E_s/E — uniform
    routing), spread uniformly over the shard's E_s local experts, so one of
    its tokens leaves a given expert on s untouched with probability
    (1 - k*w_is/E_s). Shard s's random-routing union is then
        rand_s = E_s * (1 - prod_i (1 - k*w_is/E_s)^{n_i}),
    damped toward the affinity floor k * (s's share of the routed mass)
    exactly as `expected_unique_experts` damps the global curve. Under
    uniform profiles the shards partition the global curve
    (sum_s rand_s == E*(1-(1-k/E)^T)); skewed profiles concentrate it — the
    hottest shard's count grows while the total shrinks, which is the whole
    point: the *max* over shards gates a sharded verification pass.

    Returns per_shard [S], union (= sum over shards, the placement-
    consistent global union), max_shard, hot_shard, n_shards. Degrades
    float-exactly to `expected_unique_experts_batch` at n_shards=1 /
    placement=None (delegation, not re-derivation)."""
    ns = [max(int(n), 0) for n in tokens_per_request]
    if placement is not None:
        placement.validate_experts(num_experts)
    if placement is None or placement.n_shards == 1:
        u = expected_unique_experts_batch(num_experts, top_k, ns,
                                          affinity)["union"]
        return {"per_shard": [u], "union": u, "max_shard": u,
                "hot_shard": 0, "n_shards": 1}
    counts = placement.counts
    norm_ws = _normalized_shard_weights(counts, len(ns), shard_weights)
    return _sharded_union(num_experts, top_k, ns, counts, norm_ws, affinity,
                          replica_groups=placement.replication_groups
                          if placement.has_replication else None,
                          capacity=capacity)


def a2a_bytes(cfg, n_tokens: int, n_shards: int, wb: int = None) -> float:
    """All-to-all dispatch volume of one EP-sharded pass: each in-flight
    token's k expert inputs cross shards with probability (S-1)/S, once out
    and once back, per MoE layer (the Switch/GShard pattern
    `distributed.expert_parallel` implements). The wire carries
    *activations* (d_model vectors), which stay at dense precision even
    under quantized experts — `wb=None` resolves to `Precision.DEFAULT
    .dense`, not to the expert class."""
    if not cfg.is_moe or n_shards <= 1 or n_tokens <= 0:
        return 0.0
    if wb is None:
        wb = Precision.DEFAULT.dense
    n_moe = sum(1 for kk in cfg.layer_kinds() if kk in ("A", "X"))
    return (2.0 * n_tokens * cfg.experts_per_token * cfg.d_model * wb
            * (n_shards - 1) / n_shards * n_moe)


def _a2a_time(cfg, hw: "Hardware", n_tokens: int, n_shards: int,
              wb: int = None) -> float:
    """Seconds the collective adds to the pass: per-shard egress (the total
    volume spreads across S links) over the interconnect bandwidth.
    Hardware without an interconnect figure (ici_bw 0) cannot host a
    multi-shard placement, and pricing one raises."""
    if n_shards <= 1:
        return 0.0
    if hw.ici_bw <= 0:
        raise ValueError(
            f"hardware {hw.name!r} has no interconnect (ici_bw=0) but the "
            f"placement spans {n_shards} shards; give the Hardware an "
            "ici_bw figure to price multi-shard all-to-all")
    return a2a_bytes(cfg, n_tokens, n_shards, wb) / (hw.ici_bw * n_shards)


# --------------------------------------------------------------------- #
# Per-iteration bytes / flops
# --------------------------------------------------------------------- #

def _per_layer_weight_bytes(cfg, precision: Precision):
    """(attention_bytes, dense_ffn_bytes, one_expert_bytes, shared_bytes).

    Per tensor class: attention/router/dense-FFN price at `precision
    .dense`; routed experts at `precision.expert` (the quantization
    target); shared experts are read every pass like dense FFN and stay at
    dense precision (the quantized path quantizes ROUTED experts only)."""
    attn = cfg._attn_params() * precision.dense
    mult = 3 if cfg.activation == "swiglu" else 2
    if cfg.is_moe:
        expert = mult * cfg.d_model * cfg.moe_d_ff * precision.expert
        shared = (mult * cfg.d_model * cfg.moe_d_ff * cfg.num_shared_experts
                  * precision.dense)
        router = cfg.d_model * cfg.num_experts * precision.dense
        return attn + router, 0, expert, shared
    return attn, mult * cfg.d_model * cfg.d_ff * precision.dense, 0, 0


def kv_bytes_per_token(cfg, wb: int) -> float:
    """KV-cache bytes appended per token per layer (`wb` = the precision
    spec's `kv` class)."""
    if cfg.use_mla:
        return (cfg.kv_lora_rank + cfg.qk_rope_dim) * wb
    if cfg.attention_free:
        return 0.0
    return 2 * cfg.num_kv_heads * cfg.head_dim * wb


def _weight_read_bytes(cfg, precision: Precision) -> float:
    """Dense weight bytes read once per iteration regardless of batch:
    attention + dense/shared FFN + router + unembedding (expert bytes are
    accounted separately — they scale with the activated-expert union)."""
    kinds = cfg.layer_kinds()
    wb = precision.dense
    attn_b, ffn_b, expert_b, shared_b = _per_layer_weight_bytes(cfg,
                                                                precision)
    del expert_b
    weights = 0.0
    for k in kinds:
        if k in ("A", "X"):
            weights += attn_b + ffn_b
            if k == "X":
                weights += attn_b  # cross-attention weights
            if cfg.is_moe:
                weights += shared_b
        elif k == "R":
            weights += cfg._rglru_layer_params() * wb + ffn_b
            if not ffn_b:  # hybrid is dense-ffn
                weights += 3 * cfg.d_model * cfg.d_ff * wb
        elif k == "W":
            weights += cfg._rwkv_layer_params() * wb
    # unembedding is read every iteration; embedding read is per-token rows
    weights += cfg.vocab_size * cfg.d_model * wb
    return weights


def _expert_read_bytes(cfg, unique_experts: float,
                       precision: Precision) -> float:
    """Expert weight bytes for `unique_experts` activated per MoE layer —
    priced at the spec's `expert` class, the term quantization shrinks."""
    if not cfg.is_moe:
        return 0.0
    _, _, expert_b, _ = _per_layer_weight_bytes(cfg, precision)
    n_moe = sum(1 for k in cfg.layer_kinds() if k in ("A", "X"))
    return n_moe * min(unique_experts, cfg.num_experts) * expert_b


def _kv_read_bytes(cfg, context_len: int, window: int,
                   precision: Precision) -> float:
    """Per-request state read: KV cache rows (windowed layers read only the
    window) plus recurrent-state reads."""
    kv_read = 0.0
    for k in cfg.layer_kinds():
        if k in ("A", "X"):
            lw = window
            if cfg.layer_pattern and k == "A":
                lw = cfg.local_window
            ctx = context_len if not lw else min(context_len, lw)
            kv_read += ctx * kv_bytes_per_token(cfg, precision.kv)
        elif k == "W":
            kv_read += cfg.rwkv_num_heads * cfg.rwkv_head_size ** 2 * 4
        elif k == "R":
            kv_read += cfg.d_rnn * 4
    return kv_read


def iteration_bytes(cfg, n_tokens: int, context_len: int,
                    unique_experts: float = None, affinity: float = 0.0,
                    window: int = 0, wb: int = None,
                    precision: Optional[Precision] = None) -> dict:
    """HBM bytes moved by one target-model iteration processing `n_tokens`
    in-flight tokens against a `context_len`-token KV cache. `precision`
    prices each tensor class (`wb` kept as a legacy uniform override)."""
    p = _resolve_precision(precision, wb)
    if cfg.is_moe and unique_experts is None:
        unique_experts = expected_unique_experts(
            cfg.num_experts, cfg.experts_per_token, n_tokens, affinity)

    weights = _weight_read_bytes(cfg, p)
    experts = _expert_read_bytes(cfg, unique_experts or 0.0, p)
    kv_read = _kv_read_bytes(cfg, context_len, window, p)

    return {"weights": weights, "experts": experts, "kv": kv_read,
            "total": weights + experts + kv_read,
            "unique_experts": unique_experts or 0.0}


def iteration_flops(cfg, n_tokens: int, context_len: int,
                    window: int = 0) -> float:
    """Approximate FLOPs of one iteration over n_tokens in-flight tokens."""
    active = cfg.active_param_count()
    flops = 2.0 * active * n_tokens
    # attention over the cache
    kinds = cfg.layer_kinds()
    for k in kinds:
        if k in ("A", "X"):
            lw = cfg.local_window if (cfg.layer_pattern and k == "A") else window
            ctx = context_len if not lw else min(context_len, lw)
            hd = cfg.head_dim if not cfg.use_mla else cfg.kv_lora_rank + cfg.qk_rope_dim
            flops += 4.0 * n_tokens * ctx * cfg.num_heads * hd
    return flops


# --------------------------------------------------------------------- #
# Iteration time
# --------------------------------------------------------------------- #

def iteration_time(cfg, hw: Hardware, n_tokens: int, context_len: int,
                   unique_experts: float = None, affinity: float = 0.0,
                   window: int = 0, fixed_overhead: float = 2e-4,
                   precision: Optional[Precision] = None) -> dict:
    """Seconds for one target iteration. max(memory, compute) + overhead —
    single-batch decode is deep in the memory-bound regime, so the memory
    term dominates everywhere the paper (and we) evaluate."""
    b = iteration_bytes(cfg, n_tokens, context_len, unique_experts,
                        affinity, window, precision=precision)
    f = iteration_flops(cfg, n_tokens, context_len, window)
    t_mem = b["total"] / hw.hbm_bw
    t_compute = f / hw.peak_flops
    t = max(t_mem, t_compute) + fixed_overhead
    return {"t_iter": t, "t_mem": t_mem, "t_compute": t_compute,
            "bytes": b["total"], "expert_bytes": b["experts"],
            "flops": f, "unique_experts": b["unique_experts"]}


# --------------------------------------------------------------------- #
# Host-tier fetch pricing
# --------------------------------------------------------------------- #

def _fetch_time(residency, hw: Hardware, per_shard_active, per_shard_miss,
                fetch_hide: float):
    """Host->HBM fetch pricing of one pass under a residency tier
    (docs/offload.md): `miss_s` host-tier experts missing from shard s's
    HBM must cross the host link before the shard can stream them. Shards
    fetch over independent links, so the pass-level fetch time is the max
    over shards; `fetch_hide` seconds of it overlap work the pass performs
    anyway (the draft+sample window the prefetcher uses), leaving
    `t_unhidden` on the critical path. Misses come measured
    (`per_shard_miss`, [S]) or from the residency's analytic miss curve
    over the per-shard activated counts. The ONE implementation shared by
    `batch_iteration_time` and `BatchCostOracle.t_batch` so the two stay
    float-exact. Returns (miss [S], t_fetch, t_unhidden)."""
    if hw.host_bw <= 0:
        raise ValueError(
            f"hardware {hw.name!r} has no host link (host_bw=0) but the "
            "placement has host-tier experts; give the Hardware a host_bw "
            "figure to price offload fetches")
    if per_shard_miss is not None:
        miss = [max(float(m), 0.0) for m in per_shard_miss]
        if len(miss) != len(per_shard_active):
            raise ValueError(f"{len(miss)} miss counts vs "
                             f"{len(per_shard_active)} shards")
    else:
        miss = residency.expected_misses(per_shard_active)
    t_fetch = max(miss) * residency.expert_bytes / hw.host_bw
    t_unhidden = t_fetch - fetch_hide
    if t_unhidden < 0.0:
        t_unhidden = 0.0
    return miss, t_fetch, t_unhidden


def moe_hide_fracs(cfg) -> list:
    """Per-MoE-layer fraction of a pass that runs before that layer's FFN
    first reads expert weights: (layer_index + 0.5) / n_layers for each
    MoE layer, in stack order (the +0.5: expert weights are consumed by
    the FFN sub-layer, roughly half a layer after its attention block
    starts). `fracs[0]` is the whole-expert `pre_moe_frac`; the full list
    is the layered fetch pipeline's compute-overlap ladder — layer l's slices
    have until frac_l of the pass to arrive, not just the pass start
    (docs/offload.md, layered streaming). Monotone in l by construction."""
    kinds = cfg.layer_kinds()
    moe_idx = [i for i, k in enumerate(kinds) if k in ("A", "X")]
    if not moe_idx or not cfg.is_moe:
        return []
    return [(i + 0.5) / len(kinds) for i in moe_idx]


def fetch_hide_schedule(cfg, base: float, t_basis: float) -> list:
    """Per-MoE-layer fetch-hide windows [L]: layer l's staged fetches
    overlap the shared `base` window (draft+sample, plus any double-buffer
    credit from the previous pass's tail) AND the cumulative compute of
    the layers ahead of l in the current pass — `frac_l * t_basis`, with
    `t_basis` the pass's fetch-free priced floor. This is the schedule
    `batch_iteration_time`/`BatchCostOracle` price layered fetches
    against and the engine's prefetch stage measures with; it is
    nondecreasing in l (deeper layers hide more), which a tier-1 test
    pins."""
    return [base + f * t_basis for f in moe_hide_fracs(cfg)]


def fetch_time_layered(residency, hw: Hardware, per_shard_active,
                       per_shard_miss, fetch_hide, staged_per_shard=None):
    """Host->HBM fetch pricing generalized to the residency's granularity
    (docs/offload.md, layered streaming).

    Under granularity="expert" this delegates verbatim to `_fetch_time` —
    same expressions, same float-op order, so whole-expert pricing is
    bit-identical to it (`fetch_hide` must be the scalar window).

    Under granularity="layer" the fetch is a layer pipeline: shard s must
    have layer l's missing slices across the link before layer l's FFN
    runs, but everything fetched for layer l overlaps the compute of
    layers < l. With R_{s,l} = cumulative fetch seconds of layers <= l on
    shard s's independent link and hide_l the per-layer window
    (`fetch_hide` a scalar — replicated — or a length-L schedule from
    `fetch_hide_schedule`):

        R_{s,l}    = (sum_{j<=l} miss_{s,j}) * unit_bytes / host_bw
        t_unhidden = max(0, max_{s,l} (R_{s,l} - hide_eff_l))
        t_fetch    = max_s R_{s,L-1}

    Misses come measured (`per_shard_miss`, [S] rows of [L] per-layer
    counts) or from the residency's analytic
    `expected_layer_misses(per_shard_active)`. `staged_per_shard` ([S]
    rows of [L] staged unit counts, engine-measured) caps the credit
    honestly, like the whole-expert scalar cap: layer l's window cannot
    exceed the link time of the bytes actually staged for layers <= l —
    hide_eff_l = min(hide_l, max_s(cum_staged_{s,l}) * unit_bytes /
    host_bw) — because demand misses are discovered at routing time
    inside the pass and can never borrow the overlap. The analytic
    callers (oracle, planner) pass None and price the uncapped schedule.

    The ONE implementation shared by `batch_iteration_time` and
    `BatchCostOracle.t_batch` in layer mode, keeping the two float-exact.
    Returns (miss_totals [S], t_fetch, t_unhidden, info) with
    info = {"t_fetch_by_layer": [L], "miss_by_layer": [S][L]} (info is
    None under granularity="expert")."""
    granularity = getattr(residency, "granularity", "expert")
    if granularity != "layer":
        if not isinstance(fetch_hide, (int, float)):
            raise ValueError(
                "a fetch_hide schedule needs granularity='layer' "
                "residency units; whole-expert residency prices one "
                "scalar window")
        miss, t_fetch, t_unhid = _fetch_time(residency, hw,
                                             per_shard_active,
                                             per_shard_miss, fetch_hide)
        return miss, t_fetch, t_unhid, None
    if hw.host_bw <= 0:
        raise ValueError(
            f"hardware {hw.name!r} has no host link (host_bw=0) but the "
            "placement has host-tier experts; give the Hardware a host_bw "
            "figure to price offload fetches")
    n_l = residency.n_unit_layers
    if isinstance(fetch_hide, (int, float)):
        hide = [float(fetch_hide)] * n_l
    else:
        hide = [float(h) for h in fetch_hide]
        if len(hide) != n_l:
            raise ValueError(f"{len(hide)} fetch-hide windows vs "
                             f"{n_l} MoE layers")
    if per_shard_miss is not None:
        if len(per_shard_miss) != len(per_shard_active):
            raise ValueError(f"{len(per_shard_miss)} miss rows vs "
                             f"{len(per_shard_active)} shards")
        miss = []
        for row in per_shard_miss:
            row = [max(float(m), 0.0) for m in row]
            if len(row) != n_l:
                raise ValueError(f"{len(row)} per-layer miss counts vs "
                                 f"{n_l} MoE layers")
            miss.append(row)
    else:
        miss = residency.expected_layer_misses(per_shard_active)
    ub, bw = residency.expert_bytes, hw.host_bw
    # honest staged-bytes cap on the window, cumulative through layer l
    # (a layer's credit can ride on earlier layers' staged bytes — the
    # link drains in nomination order — but never on bytes nobody staged)
    cap = None
    if staged_per_shard is not None:
        cum = []
        for row in staged_per_shard:
            c, tot = [], 0.0
            for v in row:
                tot += float(v)
                c.append(tot)
            cum.append(c)
        cap = [max(cum[s][lyr] for s in range(len(cum))) * ub / bw
               for lyr in range(n_l)]
    hide_eff = (hide if cap is None else
                [min(h, c) for h, c in zip(hide, cap)])
    t_fetch = 0.0
    t_unhid = 0.0
    t_by_layer = [0.0] * n_l
    miss_tot = []
    for s, row in enumerate(miss):
        c = 0.0
        r_last = 0.0
        for lyr, m in enumerate(row):
            c += m
            r = c * ub / bw
            slack = r - hide_eff[lyr]
            if slack > t_unhid:
                t_unhid = slack
            lt = m * ub / bw
            if lt > t_by_layer[lyr]:
                t_by_layer[lyr] = lt
            r_last = r
        if r_last > t_fetch:
            t_fetch = r_last
        miss_tot.append(c)
    return miss_tot, t_fetch, t_unhid, {"t_fetch_by_layer": t_by_layer,
                                        "miss_by_layer": miss}



# --------------------------------------------------------------------- #
# Shared (batched) verification passes
# --------------------------------------------------------------------- #

def batch_iteration_time(cfg, hw: Hardware, tokens_per_request,
                         context_lens, *, unique_experts: float = None,
                         per_request_unique=None, affinity: float = 0.0,
                         window: int = 0, fixed_overhead: float = 2e-4,
                         prefill_tokens=None,
                         placement: Optional[ExpertPlacement] = None,
                         shard_weights=None, per_shard_unique=None,
                         assume_balanced: bool = False,
                         calibration: Optional[Calibration] = None,
                         residency=None, per_shard_miss=None,
                         fetch_hide=0.0, staged_per_shard=None,
                         precision: Optional[Precision] = None) -> dict:
    """Seconds for one *shared* verification pass over B requests, request i
    contributing n_i = tokens_per_request[i] in-flight tokens against its own
    context_lens[i]-token KV cache.

    The batch moves: dense weights ONCE (the whole point of batching), the
    *union* of activated expert weights (what the paper's data movement
    scales with, now across requests), and each request's own KV rows. `unique_experts`
    overrides the analytic union with a measured per-layer mean; at B=1 with
    identical inputs this reduces exactly to `iteration_time`.

    Per-request attribution ("marginal-bytes split", consumed by each
    request's Cascade controller so per-request utility stays meaningful
    under shared verification):
      * KV bytes       -> owned outright by the request;
      * expert bytes   -> split in proportion to each request's marginal
                          expert contribution m_i = union(all) -
                          union(all \\ i) (or to measured per-request unique
                          counts when `per_request_unique` is given);
      * dense weights + fixed overhead -> split evenly.
    sum_i(t_attr_i) == t_iter by construction.

    `prefill_tokens` ([B] ints, default all-zero) marks how many of each
    request's in-flight tokens are co-scheduled prompt-chunk tokens: they
    add the chunk's KV writes, its embedding-row reads and causal attention
    over itself, the terms `prefill_time` prices for blocking admission.

    Expert parallelism (`placement` with n_shards > 1): the expert term is
    no longer the global union. Each shard streams only its resident
    experts, the pass completes when the *hottest* shard has streamed its
    local activated set, and the all-to-all dispatch adds interconnect
    time (split evenly, like the fixed overhead). Per-shard activated
    counts come from `per_shard_unique` (measured, [S]) or the analytic
    `expected_unique_experts_sharded` under `shard_weights` per-request
    routing profiles; `assume_balanced=True` is the naive comparator that
    spreads the union evenly over the shards (it under-prices skewed
    routing). `placement=None` or one shard is the unsharded model, bit
    for bit.

    `precision` prices each tensor class separately (quantized experts
    shrink the expert term); None is `Precision.DEFAULT`, bit for bit.
    `calibration` corrects the pass time (and with it the attribution) on
    the prediction side, the all-to-all term by its own scale; None is the
    analytic model, bit for bit.

    Residency (`residency`, a `ResidencyState` over a host-tiered
    `ExpertPlacement`): activated host-tier experts missing from device
    memory add a non-overlapped host-fetch term, `t_fetch_unhidden`, the
    maximum over shards of miss-count * expert_bytes / host_bw minus the
    `fetch_hide` overlap window, applied after calibration (the
    calibration was fit on fetch-free passes) and split evenly like the
    fixed overhead.
    `per_shard_miss` ([S]) overrides the analytic miss curve with measured
    counts. A `granularity="layer"` residency prices the layer-pipelined
    schedule (`fetch_time_layered`): `fetch_hide` may then be a per-MoE-
    layer sequence, `per_shard_miss` is [S] rows of [L] counts, and
    `staged_per_shard` ([S][L] staged unit counts) caps each layer's
    window at the bytes actually prefetched. `residency=None` (or an
    all-hbm placement) is the fetch-free model, bit for bit.

    Returns iteration_time's keys plus `per_request` (list of dicts with
    t_attr / bytes_attr / marginal_experts), `n_requests`, `n_tokens`,
    `precision` (the spec's label) and `expert_bytes_saved` (expert bytes
    this pass did not move against bf16 storage); residency-priced passes
    add `fetch_miss` [S], `t_fetch`, `t_fetch_unhidden`, `fetch_bytes`
    and, layered, `t_fetch_by_layer` [L]; sharded passes add
    `shard_unique` [S], `max_shard_experts`, `hot_shard`, `imbalance`
    (max/mean over shards), `t_a2a` and `n_shards`."""
    p = _resolve_precision(precision)
    ns = [max(int(n), 0) for n in tokens_per_request]
    cls = list(context_lens)
    if len(ns) != len(cls):
        raise ValueError(f"{len(ns)} token counts vs {len(cls)} contexts")
    b_req = len(ns)
    total_tokens = sum(ns)
    ps = ([0] * b_req if prefill_tokens is None else
          [max(int(p), 0) for p in prefill_tokens])
    if len(ps) != b_req:
        raise ValueError(f"{len(ps)} prefill counts vs {b_req} requests")

    est = expected_unique_experts_batch(
        cfg.num_experts, cfg.experts_per_token, ns, affinity) \
        if cfg.is_moe else {"union": 0.0, "marginal": [0.0] * b_req}
    union = est["union"] if unique_experts is None else float(unique_experts)

    weights = _weight_read_bytes(cfg, p)
    sharded = (placement is not None and placement.n_shards > 1
               and cfg.is_moe)
    fetch_active = (residency is not None and cfg.is_moe
                    and residency.has_host_tier)
    capacity = residency.capacity_experts if fetch_active else None
    shard_info = {}
    if sharded:
        # the hottest shard gates the pass: its local activated experts are
        # the expert stream on the critical path, not the global union
        shard_unique, hot = _resolve_shard_unique(
            cfg, ns, placement, affinity, shard_weights, per_shard_unique,
            capacity=capacity)
        gate = (sum(shard_unique) / placement.n_shards if assume_balanced
                else shard_unique[hot])
        experts = _expert_read_bytes(cfg, gate, p)
        t_a2a = _a2a_time(cfg, hw, total_tokens, placement.n_shards,
                          p.dense)
        mean_shard = sum(shard_unique) / placement.n_shards
        shard_info = {
            "shard_unique": shard_unique,
            "max_shard_experts": shard_unique[hot],
            "hot_shard": hot,
            "imbalance": (shard_unique[hot] / mean_shard
                          if mean_shard > 0 else 1.0),
            "t_a2a": t_a2a, "n_shards": placement.n_shards,
        }
    else:
        experts = _expert_read_bytes(cfg, union, p)
        t_a2a = 0.0
    n_attn = sum(1 for k in cfg.layer_kinds() if k in ("A", "X"))
    prefill_bytes_per_tok = (kv_bytes_per_token(cfg, p.kv) * n_attn
                             + cfg.d_model * p.dense)  # KV write + embed row
    kv_each = [_kv_read_bytes(cfg, c, window, p)
               + pt * prefill_bytes_per_tok if n > 0 else 0.0
               for n, c, pt in zip(ns, cls, ps)]
    total_bytes = weights + experts + sum(kv_each)

    flops = sum(iteration_flops(cfg, n, c + pt, window)
                for n, c, pt in zip(ns, cls, ps) if n > 0)
    t_mem = total_bytes / hw.hbm_bw
    t_compute = flops / hw.peak_flops
    t = max(t_mem, t_compute) + fixed_overhead
    if sharded:
        t = t + t_a2a
    if calibration is not None:
        # prediction-side wall-clock correction; None is bit-identical
        t = calibration.apply(t, t_a2a)
    fetch_info = {}
    if fetch_active:
        # non-overlapped host fetch rides on top of the calibrated pass:
        # the calibration was fit on fetch-free passes, so the fetch term
        # must not be scaled by it
        act = shard_info["shard_unique"] if sharded else [union]
        if getattr(residency, "granularity", "expert") == "layer":
            f_miss, t_fetch, t_unhid, lay = fetch_time_layered(
                residency, hw, act, per_shard_miss, fetch_hide,
                staged_per_shard)
        else:
            f_miss, t_fetch, t_unhid = _fetch_time(residency, hw, act,
                                                   per_shard_miss,
                                                   fetch_hide)
            lay = None
        t = t + t_unhid
        fetch_info = {"fetch_miss": f_miss, "t_fetch": t_fetch,
                      "t_fetch_unhidden": t_unhid,
                      "fetch_bytes": sum(f_miss) * residency.expert_bytes}
        if lay is not None:
            fetch_info["t_fetch_by_layer"] = list(lay["t_fetch_by_layer"])

    # ---- marginal-bytes attribution -------------------------------------
    # non-bytes terms (fixed overhead + the sharded pass's collective) are
    # split evenly — every live request needs them, none owns them
    non_bytes = fixed_overhead + t_a2a if sharded else fixed_overhead
    if fetch_active:
        non_bytes = non_bytes + fetch_info["t_fetch_unhidden"]
    live = [i for i, n in enumerate(ns) if n > 0]
    n_live = max(len(live), 1)
    if per_request_unique is not None:
        mweights = [max(float(u), 0.0) for u in per_request_unique]
    else:
        mweights = est["marginal"]
    msum = sum(mweights[i] for i in live)
    per_request = []
    for i, n in enumerate(ns):
        if n <= 0:
            per_request.append({"t_attr": 0.0, "bytes_attr": 0.0,
                                "marginal_experts": 0.0})
            continue
        if len(live) == 1:
            # sole live request owns the pass outright (bit-exact reduction
            # to iteration_time — no float round-trip through the split)
            per_request.append({"t_attr": t, "bytes_attr": total_bytes,
                                "marginal_experts": est["marginal"][i]})
            continue
        frac_e = (mweights[i] / msum) if msum > 0 else 1.0 / n_live
        bytes_i = weights / n_live + experts * frac_e + kv_each[i]
        t_attr = ((t - non_bytes) * bytes_i / total_bytes
                  if total_bytes > 0 else 0.0) + non_bytes / n_live
        per_request.append({"t_attr": t_attr, "bytes_attr": bytes_i,
                            "marginal_experts": est["marginal"][i]})

    out = {"t_iter": t, "t_mem": t_mem, "t_compute": t_compute,
           "bytes": total_bytes, "expert_bytes": experts, "flops": flops,
           "unique_experts": union, "n_requests": b_req,
           "n_tokens": total_tokens, "per_request": per_request,
           "precision": p.label,
           # bytes the expert stream saved vs pricing it at the bf16
           # default (exact: expert bytes are linear in bytes-per-param)
           "expert_bytes_saved": (experts
                                  * (Precision.DEFAULT.expert - p.expert)
                                  / p.expert)}
    out.update(shard_info)
    out.update(fetch_info)
    return out


def _resolve_shard_unique(cfg, ns, placement: ExpertPlacement,
                          affinity: float, shard_weights,
                          per_shard_unique, capacity=None):
    """Per-shard activated-expert counts for a sharded pass: measured
    counts when the caller has them, the analytic sharded union otherwise.
    Returns (shard_unique [S], hot_shard). Ties break on the lowest shard
    id, keeping the gating shard deterministic. `capacity` bounds the
    analytic replica relief to shards with residency headroom."""
    if per_shard_unique is not None:
        shard_unique = [max(float(u), 0.0) for u in per_shard_unique]
        if len(shard_unique) != placement.n_shards:
            raise ValueError(f"{len(shard_unique)} shard counts vs "
                             f"{placement.n_shards} shards")
        return shard_unique, _hot_shard(shard_unique)
    est = expected_unique_experts_sharded(
        cfg.num_experts, cfg.experts_per_token, ns, placement,
        affinity, shard_weights, capacity=capacity)
    return est["per_shard"], est["hot_shard"]


class BatchCostOracle:
    """Repeated `batch_iteration_time` total-time queries over candidate
    token allocations, with everything except `tokens_per_request` held
    fixed (contexts, prefill chunks, hardware, affinity, precision).

    The batch planner's water-filling evaluates O(B * k_max) candidate
    allocations per engine step, so this caches the allocation-independent
    terms (dense weight read, per-row KV/prefill bytes) at construction.
    `t_batch(ns)` returns exactly `batch_iteration_time(...)["t_iter"]` for
    the same inputs (`calibration` included): same expressions, same
    float-op order.

    `residency` (a `ResidencyState` over a host-tiered placement) adds the
    analytic non-overlapped fetch term under a `fetch_hide` overlap window:
    one scalar under granularity="expert", a per-MoE-layer schedule (from
    `fetch_hide_schedule`) under "layer", through the same `_fetch_time` /
    `fetch_time_layered` as `batch_iteration_time`, so the two stay
    float-exact. The planner's residency constraints query
    `shard_unique(ns)` and `fetch_unhidden(ns)`.

    `placement` (n_shards > 1) switches the pricing to the EP-sharded
    roofline: max over shards of local activated-expert bytes plus the
    all-to-all collective, under per-row `shard_weights` routing profiles
    (None entries: uniform). `assume_balanced=True` keeps the placement's
    shard count but spreads the union evenly, the global-union comparator.
    Both agree float-exactly with `batch_iteration_time` under the same
    arguments."""

    def __init__(self, cfg, hw: Hardware, context_lens, *,
                 affinity: float = 0.0, window: int = 0,
                 fixed_overhead: float = 2e-4, prefill_tokens=None,
                 placement: Optional[ExpertPlacement] = None,
                 shard_weights=None, assume_balanced: bool = False,
                 calibration: Optional[Calibration] = None,
                 residency=None, fetch_hide=0.0,
                 precision: Optional[Precision] = None):
        p = _resolve_precision(precision)
        self.precision = p
        self.calibration = calibration
        self.cfg = cfg
        self.hw = hw
        self.affinity = affinity
        self.window = window
        self.fixed_overhead = fixed_overhead
        self.cls = list(context_lens)
        b = len(self.cls)
        self.ps = ([0] * b if prefill_tokens is None else
                   [max(int(p), 0) for p in prefill_tokens])
        if len(self.ps) != b:
            raise ValueError(f"{len(self.ps)} prefill counts vs {b} contexts")
        self.placement = placement
        self.assume_balanced = assume_balanced
        self._sharded = (placement is not None and placement.n_shards > 1
                         and cfg.is_moe)
        if placement is not None and cfg.is_moe:
            placement.validate_experts(cfg.num_experts)
        self.residency = residency
        #: overlap window the fetch term hides behind: one scalar under
        #: granularity="expert", a per-MoE-layer schedule (list, from
        #: `fetch_hide_schedule`) under granularity="layer"
        self.fetch_hide = fetch_hide
        self._fetch = (residency is not None and cfg.is_moe
                       and residency.has_host_tier)
        self._layered = (self._fetch and
                         getattr(residency, "granularity", "expert")
                         == "layer")
        if self._fetch and hw.host_bw <= 0:
            raise ValueError(
                f"hardware {hw.name!r} has no host link (host_bw=0) but "
                "the placement has host-tier experts")
        self._capacity = residency.capacity_experts if self._fetch else None
        if shard_weights is not None and len(shard_weights) != b:
            raise ValueError(f"{len(shard_weights)} shard profiles vs "
                             f"{b} contexts")
        self.shard_weights = shard_weights
        if self._sharded:
            # allocation-independent shard constants, cached like the
            # dense-weight and per-row KV terms: the water-filling queries
            # t_batch O(B*K) times per step and must not re-derive the
            # placement's counts or re-normalize B profiles each time
            self._counts = placement.counts
            self._norm_sw = _normalized_shard_weights(self._counts, b,
                                                      shard_weights)
            self._replica_groups = (placement.replication_groups
                                    if placement.has_replication else None)
        self._weights = _weight_read_bytes(cfg, p)
        n_attn = sum(1 for k in cfg.layer_kinds() if k in ("A", "X"))
        prefill_bytes_per_tok = (kv_bytes_per_token(cfg, p.kv) * n_attn
                                 + cfg.d_model * p.dense)
        # per-row bytes IF the row is live (n_i > 0); dead rows cost nothing
        self._kv_live = [_kv_read_bytes(cfg, c, window, p)
                         + pt * prefill_bytes_per_tok
                         for c, pt in zip(self.cls, self.ps)]

    def t_batch(self, tokens_per_request) -> float:
        """Seconds for one shared pass at this token allocation (scalar —
        no attribution; use `batch_iteration_time` for the full split)."""
        ns = [max(int(n), 0) for n in tokens_per_request]
        if len(ns) != len(self.cls):
            raise ValueError(f"{len(ns)} token counts vs "
                             f"{len(self.cls)} contexts")
        cfg, hw = self.cfg, self.hw
        total = sum(ns)
        if self._sharded:
            est = _sharded_union(cfg.num_experts, cfg.experts_per_token,
                                 ns, self._counts, self._norm_sw,
                                 self.affinity,
                                 replica_groups=self._replica_groups,
                                 capacity=self._capacity)
            gate = (sum(est["per_shard"]) / self.placement.n_shards
                    if self.assume_balanced else est["max_shard"])
            experts = _expert_read_bytes(cfg, gate, self.precision)
        else:
            union = (expected_unique_experts(cfg.num_experts,
                                             cfg.experts_per_token, total,
                                             self.affinity)
                     if cfg.is_moe and total > 0 else 0.0)
            experts = _expert_read_bytes(cfg, union, self.precision)
        total_bytes = self._weights + experts + sum(
            kv if n > 0 else 0.0 for n, kv in zip(ns, self._kv_live))
        flops = sum(iteration_flops(cfg, n, c + p, self.window)
                    for n, c, p in zip(ns, self.cls, self.ps) if n > 0)
        t_mem = total_bytes / hw.hbm_bw
        t_compute = flops / hw.peak_flops
        t = max(t_mem, t_compute) + self.fixed_overhead
        if self._sharded:
            t_a2a = _a2a_time(cfg, hw, total, self.placement.n_shards,
                              self.precision.dense)
            t = t + t_a2a
        else:
            t_a2a = 0.0
        if self.calibration is not None:
            t = self.calibration.apply(t, t_a2a)
        if self._fetch:
            act = est["per_shard"] if self._sharded else [union]
            if self._layered:
                _, _, t_unhid, _ = fetch_time_layered(
                    self.residency, hw, act, None, self.fetch_hide)
            else:
                _, _, t_unhid = _fetch_time(self.residency, hw, act, None,
                                            self.fetch_hide)
            t = t + t_unhid
        return t

    def shard_unique(self, tokens_per_request) -> list:
        """Predicted per-shard activated-expert counts at this allocation
        ([S]; the global union as a 1-list for unsharded placements):
        what `MemoryCapConstraint` checks against the residency capacity."""
        ns = [max(int(n), 0) for n in tokens_per_request]
        cfg = self.cfg
        if self._sharded:
            est = _sharded_union(cfg.num_experts, cfg.experts_per_token,
                                 ns, self._counts, self._norm_sw,
                                 self.affinity,
                                 replica_groups=self._replica_groups,
                                 capacity=self._capacity)
            return list(est["per_shard"])
        total = sum(ns)
        union = (expected_unique_experts(cfg.num_experts,
                                         cfg.experts_per_token, total,
                                         self.affinity)
                 if cfg.is_moe and total > 0 else 0.0)
        return [union]

    def fetch_unhidden(self, tokens_per_request) -> float:
        """Predicted non-overlapped host-fetch seconds at this allocation
        (0.0 without a host tier): what `FetchDeadlineConstraint` bounds."""
        if not self._fetch:
            return 0.0
        act = self.shard_unique(tokens_per_request)
        if self._layered:
            _, _, t_unhid, _ = fetch_time_layered(self.residency, self.hw,
                                                  act, None,
                                                  self.fetch_hide)
        else:
            _, _, t_unhid = _fetch_time(self.residency, self.hw, act, None,
                                        self.fetch_hide)
        return t_unhid


# --------------------------------------------------------------------- #
# Prefill pricing (chunked admission — the compute-bound regime)
# --------------------------------------------------------------------- #

def prefill_chunk_bytes(cfg, n_tokens: int, context_len: int = 0,
                        unique_experts: float = None, affinity: float = 0.0,
                        window: int = 0, wb: int = None,
                        precision: Optional[Precision] = None) -> dict:
    """HBM bytes moved by one prefill chunk of `n_tokens` prompt tokens
    entering a cache that already holds `context_len` tokens.

    Differs from decode `iteration_bytes` in two ways that matter for TTFT:
    the chunk *writes* its own KV rows (decode's single-token append is
    negligible; a 128-token chunk's is not), and the expert union is driven
    by the chunk's full token count, which saturates toward `num_experts`
    far faster than a [1+K] decode span."""
    p = _resolve_precision(precision, wb)
    n_tokens = max(int(n_tokens), 0)
    if cfg.is_moe and unique_experts is None:
        unique_experts = expected_unique_experts(
            cfg.num_experts, cfg.experts_per_token, n_tokens, affinity)
    weights = _weight_read_bytes(cfg, p)
    experts = _expert_read_bytes(cfg, unique_experts or 0.0, p)
    kv_read = _kv_read_bytes(cfg, context_len, window, p)
    n_attn = sum(1 for k in cfg.layer_kinds() if k in ("A", "X"))
    kv_write = n_tokens * kv_bytes_per_token(cfg, p.kv) * n_attn
    embed = n_tokens * cfg.d_model * p.dense  # embedding-row reads per token
    total = weights + experts + kv_read + kv_write + embed
    return {"weights": weights, "experts": experts, "kv": kv_read,
            "kv_write": kv_write, "embed": embed, "total": total,
            "unique_experts": unique_experts or 0.0}


def prefill_time(cfg, hw: Hardware, n_tokens: int, context_len: int = 0,
                 unique_experts: float = None, affinity: float = 0.0,
                 window: int = 0, fixed_overhead: float = 2e-4,
                 precision: Optional[Precision] = None) -> dict:
    """Seconds for one prefill pass/chunk under the model clock. Unlike
    decode, prefill crosses the roofline: FLOPs grow linearly (and the
    attention term quadratically) with the chunk while the dominant weight
    read stays constant, so large chunks are compute-bound — max(memory,
    compute) switches sides, which is exactly why the model clock must price
    prefill separately for TTFT to mean anything."""
    n_tokens = max(int(n_tokens), 1)
    b = prefill_chunk_bytes(cfg, n_tokens, context_len, unique_experts,
                            affinity, window, precision=precision)
    # the chunk attends causally to the cached context plus itself
    f = iteration_flops(cfg, n_tokens, context_len + n_tokens, window)
    t_mem = b["total"] / hw.hbm_bw
    t_compute = f / hw.peak_flops
    t = max(t_mem, t_compute) + fixed_overhead
    return {"t_iter": t, "t_mem": t_mem, "t_compute": t_compute,
            "bytes": b["total"], "expert_bytes": b["experts"],
            "flops": f, "unique_experts": b["unique_experts"],
            "compute_bound": t_compute >= t_mem}


def prefill_crossover_tokens(cfg, hw: Hardware, context_len: int = 0,
                             affinity: float = 0.0, window: int = 0,
                             max_chunk: int = 65536,
                             precision: Optional[Precision] = None) -> int:
    """Smallest chunk size at which prefill becomes compute-bound (crosses
    the roofline): the natural upper bound for a chunked-admission `chunk`.
    Beyond it, bigger chunks stop amortizing the weight read and only add
    head-of-line latency for the decodes sharing the pass. Quantized
    expert precision moves this crossover left (fewer bytes, same FLOPs).
    Searched over powers of two."""
    n = 1
    while n <= max_chunk:
        if prefill_time(cfg, hw, n, context_len, affinity=affinity,
                        window=window,
                        precision=precision)["compute_bound"]:
            return n
        n *= 2
    return max_chunk


def draft_time(hw: Hardware, k: int, drafter_active_params: int = 0,
               per_token_overhead: float = 2e-5,
               wb: int = None,
               precision: Optional[Precision] = None) -> float:
    """Drafting cost: ~free for n-gram (CPU table lookup), weight-bound for
    model drafters (EAGLE-style). Drafter weights price at the dense class
    of `precision` (docs/quantization.md) — a quantized drafter (e.g.
    `Precision(dense=1, ...)` for int8 drafter storage) halves the model
    term's bytes, shrinking the speculation overhead every utility ratio
    and fetch-hide window is built on. `precision=None` prices at
    `Precision.DEFAULT.dense` (bf16), bit-identical to before; an explicit
    `wb` byte width overrides the precision class, matching the byte
    helpers' precedence."""
    if k <= 0:
        return 0.0
    if wb is None:
        wb = (precision.dense if precision is not None
              else Precision.DEFAULT.dense)
    model = (k * drafter_active_params * wb / hw.hbm_bw
             if drafter_active_params else 0.0)
    return model + k * per_token_overhead


def sample_time(k: int, per_token: float = 1.5e-5) -> float:
    """Rejection-sampling cost, linear in verified tokens (paper: 1-2%)."""
    return (k + 1) * per_token


def expected_emitted(accept_rate: float, k: int) -> float:
    """Expected tokens emitted by a [1+k] speculative span when each draft
    is accepted i.i.d. with probability `accept_rate`: the truncated
    geometric series of the paper's ETR (Def. 4.1; k=0 -> exactly 1)."""
    a = min(max(accept_rate, 0.0), 0.999)
    return (1.0 - a ** (k + 1)) / (1.0 - a)


def expected_emitted_curve(curve, k: int) -> float:
    """`expected_emitted` over a per-position acceptance curve
    (`UtilityAnalyzer.accept_curve`): E[emitted] = 1 + sum over depths j of
    prod_{p<j} curve[p]. Positions past the curve reuse its last value;
    k=0 -> exactly 1."""
    if k <= 0:
        return 1.0
    tot, p = 1.0, 1.0
    for j in range(k):
        c = curve[j] if j < len(curve) else (curve[-1] if curve else 0.0)
        p *= min(max(c, 0.0), 0.999)
        tot += p
    return tot


# --------------------------------------------------------------------- #
# Analytic K prior: warm-start Cascade's hill-climb
# --------------------------------------------------------------------- #

def expected_utility(cfg, hw: Hardware, k: int, accept_rate: float,
                     context_len: int = 1024, affinity: float = 0.3,
                     drafter_params: int = 0) -> float:
    """Analytic Definition-4.1 utility of speculating K tokens when draft
    acceptance is ~accept_rate: ETR from the truncated geometric series,
    cost from the data-movement model."""
    if k <= 0:
        return 1.0
    etr = expected_emitted(accept_rate, k)
    base = iteration_time(cfg, hw, 1, context_len, affinity=affinity)
    spec = iteration_time(cfg, hw, k + 1, context_len, affinity=affinity)
    t_spec = spec["t_iter"] + draft_time(hw, k, drafter_params) + \
        sample_time(k)
    return etr / (t_spec / base["t_iter"])


def suggest_k_start(cfg, hw: Hardware = H100_SXM, *,
                    accept_rate: float = 0.5, k_max: int = 8,
                    context_len: int = 1024, affinity: float = 0.3,
                    drafter_params: int = 0) -> int:
    """Bucket-and-balls prior for Cascade's first trial K: the analytic
    utility-maximizing K for this architecture, so MoEs with steep
    expert-activation curves start conservatively and dense models
    aggressively. The test-and-set loop still measures and adapts."""
    best_k, best_u = 1, -1.0
    for k in range(1, k_max + 1):
        u = expected_utility(cfg, hw, k, accept_rate, context_len, affinity,
                             drafter_params)
        if u > best_u:
            best_k, best_u = k, u
    return best_k
