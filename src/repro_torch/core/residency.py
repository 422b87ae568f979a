"""Tiered expert residency: what is actually device-resident, under a cap.

`ExpertPlacement.tier_of` says where each expert's weights *live* (hbm =
always device-resident, host = offloaded behind `Hardware.host_bw`);
`ResidencyState` tracks which host-tier experts are *currently* resident
under a per-shard byte cap, the analytic miss curve the cost model prices
fetches with, and the eviction policy (by EMA load, then last use) the
engine's prefetch stage uses.

The motivating regime: MoEs whose expert weights alone exceed one
device's memory. With a host tier, speculation's drafted lookahead
becomes a *prefetch oracle* (SP-MoE, arXiv 2510.10302): the router
applied to drafted tokens predicts the verification union one pass
ahead, hiding fetch latency behind the draft+sample window. The state is
pure bookkeeping: the serving engine prices the tier with it and keeps
every expert's weights on the device.
"""

from __future__ import annotations

from typing import Optional

from .cost_model import Precision

__all__ = ["ResidencyState", "expert_hbm_bytes", "moe_layer_count"]

#: per-pass decay of each unit's EMA load, the coldness signal eviction
#: ranks by
EMA_DECAY = 0.8


def expert_hbm_bytes(cfg, precision: Optional[Precision] = None,
                     per_layer: bool = False) -> float:
    """Device bytes of ONE expert across all MoE layers — the unit of
    whole-expert residency accounting (an expert is fetched/evicted whole:
    its slice in every MoE layer moves together, matching the per-expert
    granularity of `_expert_read_bytes`). `per_layer=True` drops the
    layer-count factor and returns the bytes of one expert's slice in ONE
    MoE layer — the unit of `granularity="layer"` residency, where each
    (layer, expert) slice moves independently. The two are exact
    multiples: whole == n_moe_layers * per_layer bitwise (both are
    integer-valued floats), which is what lets the layered pricing
    degrade bit-exactly to the whole-expert path. `precision` prices the
    expert class (None is `Precision.DEFAULT`) — quantized experts shrink
    both the fetch bytes a host-tier miss costs AND the footprint a cache
    slot holds, so the same cap fits more of them."""
    if not cfg.is_moe:
        return 0.0
    weight_bytes = (precision or Precision.DEFAULT).expert
    mult = 3 if cfg.activation == "swiglu" else 2
    per = float(mult * cfg.d_model * cfg.moe_d_ff * weight_bytes)
    return per if per_layer else float(moe_layer_count(cfg)) * per


def moe_layer_count(cfg) -> int:
    """Number of MoE layers in the stack — the layer axis of
    `granularity="layer"` residency units and of the layered fetch
    schedule (`cost_model.fetch_time_layered`)."""
    if not cfg.is_moe:
        return 0
    return sum(1 for k in cfg.layer_kinds() if k in ("A", "X"))


class ResidencyState:
    """Per-shard HBM residency of a host-tiered `ExpertPlacement`.

    Each shard pins its hbm-tier experts (primaries and replicas: those
    are always resident) and holds `slots` cache slots for its homed
    host-tier experts, where ``slots = (cap_bytes - pinned_bytes) //
    expert_bytes``. `cap_bytes` may be a scalar (same cap every shard) or
    a per-shard sequence; None means uncapped (every host expert fits, no
    evictions, zero analytic misses — the bit-exact degradation tier).

    Three consumers share this object:

    * the cost model (`batch_iteration_time` / `BatchCostOracle`) prices
      passes with `expected_misses` — the steady-state random-cache miss
      curve;
    * the planner's `MemoryCapConstraint` / `FetchDeadlineConstraint`
      read `capacity_experts` and the oracle's fetch predictions, and
      `capacity_experts` bounds the cost model's replica rebalancing;
    * the engine's prefetch stage mutates the cache: `fetch(stage=True)`
      streams predicted experts into a per-shard staging buffer before
      the pass, `access` classifies the pass's activated host experts
      into hits (cached or staged) and demand misses, `fetch` installs
      the misses (evicting the coldest by (EMA load, last use) when
      full), and `note_step` decays the EMA and drains the staging
      buffer (used experts installed, unused discarded).

    Counters (`hits`, `misses`, `evictions`, `bytes_fetched`) feed
    `StepTelemetry`. Every unit's EMA load decays by `EMA_DECAY` a
    pass.

    `granularity` picks the residency *unit* (layered streaming):
    `"expert"` (the default) moves an expert's slices across all MoE
    layers as one unit keyed by the expert id. `"layer"` moves each
    (layer, expert) slice independently: unit keys become `(moe_layer, expert)` tuples, the unit
    footprint is `expert_hbm_bytes(cfg, per_layer=True)`, staging/LRU/EMA
    state is per unit, and the same byte cap holds `n_moe_layers` times as
    many (smaller) units — the granularity the layer-pipelined fetch
    schedule needs, since layer l's slices have until layer l's own FFN
    (not the pass start) to arrive."""

    GRANULARITIES = ("expert", "layer")

    def __init__(self, placement, cfg, *, cap_bytes=None,
                 precision: Optional[Precision] = None,
                 granularity: str = "expert"):
        if granularity not in self.GRANULARITIES:
            raise ValueError(f"unknown granularity {granularity!r} "
                             f"(expected one of {self.GRANULARITIES})")
        self.granularity = granularity
        layered = granularity == "layer"
        self._unit_layers = max(moe_layer_count(cfg), 1) if layered else 1
        expert_bytes = expert_hbm_bytes(cfg, per_layer=layered,
                                        precision=precision)
        if expert_bytes <= 0:
            raise ValueError(f"non-positive expert_bytes {expert_bytes}")
        self.placement = placement
        self.expert_bytes = float(expert_bytes)
        s_n = placement.n_shards
        tiers = placement.tiers
        # pinned hbm-tier residents per shard (replicas included)
        self._pinned = list(placement.resident_counts)
        # host-tier experts homed per shard (host experts are never
        # replicated, so the home is the primary one). Residency *units* are
        # expert ids under granularity="expert" and (moe_layer, expert)
        # tuples under granularity="layer" — every cache/staging/EMA
        # structure below is keyed by unit, and `_home` maps units to
        # their shard. `_expert_home` keeps the expert-level view both
        # modes share (H_s for the miss curve, is_resident).
        self._host_of_shard = [[] for _ in range(s_n)]
        self._expert_home = {}
        self._home = {}
        for e, (s, t) in enumerate(zip(placement.primary_shard_of, tiers)):
            if t == "host":
                self._host_of_shard[s].append(e)
                self._expert_home[e] = s
                if self.granularity == "layer":
                    for lyr in range(self._unit_layers):
                        self._home[(lyr, e)] = s
                else:
                    self._home[e] = s
        caps = self._normalize_caps(cap_bytes, s_n)
        self._slots = []
        for s in range(s_n):
            n_units = self._unit_layers * len(self._host_of_shard[s])
            if caps[s] is None:
                self._slots.append(n_units)
                continue
            # the pinned footprint is whole experts regardless of the
            # residency granularity: hbm-tier experts never move per layer
            pinned_b = self._pinned[s] * self._unit_layers \
                * self.expert_bytes
            if caps[s] < pinned_b:
                raise ValueError(
                    f"shard {s}: cap {caps[s]:.3e} B below the pinned "
                    f"hbm-tier footprint {pinned_b:.3e} B")
            self._slots.append(
                min(int((caps[s] - pinned_b) // self.expert_bytes),
                    n_units))
        self.cap_bytes = caps
        # cache: per shard, resident host experts -> last-use step
        self._cache = [dict() for _ in range(s_n)]
        # staging buffer: prefetched-not-yet-installed experts per shard
        # (drained every pass by note_step)
        self._staged = [set() for _ in range(s_n)]
        self._staged_used = [set() for _ in range(s_n)]
        self._ema = {e: 0.0 for e in self._home}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bytes_fetched = 0.0

    @staticmethod
    def _normalize_caps(cap_bytes, s_n):
        if cap_bytes is None:
            return [None] * s_n
        if isinstance(cap_bytes, (int, float)):
            return [float(cap_bytes)] * s_n
        caps = [None if c is None else float(c) for c in cap_bytes]
        if len(caps) != s_n:
            raise ValueError(f"{len(caps)} caps vs {s_n} shards")
        return caps

    # ---- static views ------------------------------------------------- #

    @property
    def has_host_tier(self) -> bool:
        return self.placement.has_host_tier

    @property
    def n_shards(self) -> int:
        return self.placement.n_shards

    @property
    def n_unit_layers(self) -> int:
        """MoE layers per residency unit axis: 1 under
        granularity="expert" (an expert's layers move together), the MoE
        layer count under granularity="layer"."""
        return self._unit_layers

    @property
    def slots(self):
        """Cache slots for host-tier units per shard (capped at the
        shard's host unit population). Units are whole experts under
        granularity="expert", (layer, expert) slices under "layer"."""
        return tuple(self._slots)

    @property
    def capacity_experts(self):
        """Max simultaneously HBM-resident experts per shard — pinned
        hbm-tier residents plus host-tier cache slots, in *expert
        equivalents* (layer-granularity slots count 1/n_moe_layers of an
        expert each; at exact multiples this is bitwise the whole-expert
        figure). The ceiling `MemoryCapConstraint` holds the predicted
        activated union to, and the activated load replica rebalancing
        may land on a shard (`_rebalance_replicas`)."""
        if self.granularity == "layer":
            return [float(p) + sl / self._unit_layers
                    for p, sl in zip(self._pinned, self._slots)]
        return [float(p + sl) for p, sl in zip(self._pinned, self._slots)]

    @property
    def resident_counts(self):
        """Experts *currently* HBM-resident per shard: pinned + cached —
        the live counterpart of `ExpertPlacement.resident_counts`. Under
        granularity="layer" the cached term counts expert equivalents
        (cached units / n_moe_layers), so partial experts show as
        fractions."""
        if self.granularity == "layer":
            return tuple(p + len(c) / self._unit_layers
                         for p, c in zip(self._pinned, self._cache))
        return tuple(p + len(c) for p, c in zip(self._pinned, self._cache))

    def is_resident(self, expert) -> bool:
        """True when `expert`'s weights are in HBM right now (hbm-tier
        experts always are). Accepts an expert id (under
        granularity="layer": resident iff ALL its layer slices are) or a
        (layer, expert) unit key."""
        if isinstance(expert, tuple):
            s = self._home.get(expert)
            if s is None:
                return True
            return expert in self._cache[s]
        s = self._expert_home.get(expert)
        if s is None:
            return True
        if self.granularity == "layer":
            return all((lyr, expert) in self._cache[s]
                       for lyr in range(self._unit_layers))
        return expert in self._cache[s]

    # ---- analytic miss curve (cost-model side) ------------------------ #

    def expected_misses(self, per_shard_active):
        """Steady-state expected host-fetch count per shard when the pass
        activates `per_shard_active[s]` experts on shard s (mean per
        layer): a fraction H_s/E_s of the activated set is host-tier
        (routing is tier-blind), and a random host expert is resident with
        probability slots_s/H_s, so
        miss_s = acts_s * (H_s/E_s) * (1 - slots_s/H_s).
        Uncapped shards (slots_s == H_s) miss nothing — the degradation
        tier the drift gates pin.

        Under granularity="layer" the same curve generalizes to units:
        each of the n_l MoE layers activates acts_s experts, a random host
        *unit* is resident with probability slots_s/(n_l*H_s), and the
        returned figure is the expected missing UNIT count (the sum over
        `expected_layer_misses` rows) — the count that, times the per-unit
        `expert_bytes`, prices the shard's total fetch bytes."""
        if self.granularity == "layer":
            return [sum(row) for row in
                    self.expected_layer_misses(per_shard_active)]
        if len(per_shard_active) != self.n_shards:
            raise ValueError(f"{len(per_shard_active)} activation counts "
                             f"vs {self.n_shards} shards")
        counts = self.placement.counts
        miss = []
        for s, acts in enumerate(per_shard_active):
            h_s = len(self._host_of_shard[s])
            e_s = counts[s]
            if h_s == 0 or e_s == 0 or acts <= 0:
                miss.append(0.0)
                continue
            resident_frac = min(self._slots[s] / h_s, 1.0)
            m = float(acts) * (h_s / e_s) * (1.0 - resident_frac)
            miss.append(max(m, 0.0))
        return miss

    def expected_layer_misses(self, per_shard_active):
        """Per-(shard, MoE layer) expected missing unit counts [S][L] —
        the analytic input of the layered fetch pipeline
        (`cost_model.fetch_time_layered`). Routing is layer-blind in the
        analytic view, so every layer sees the same activated-expert count
        and the per-layer miss is uniform:
        m_{s,l} = acts_s * (H_s/E_s) * (1 - slots_s/(n_l*H_s)).
        Uncapped shards (slots == n_l*H) miss nothing. Only meaningful
        under granularity="layer" (raises otherwise — whole-expert units
        have no layer axis)."""
        if self.granularity != "layer":
            raise ValueError("expected_layer_misses needs "
                             "granularity='layer' residency units")
        if len(per_shard_active) != self.n_shards:
            raise ValueError(f"{len(per_shard_active)} activation counts "
                             f"vs {self.n_shards} shards")
        counts = self.placement.counts
        n_l = self._unit_layers
        out = []
        for s, acts in enumerate(per_shard_active):
            h_s = len(self._host_of_shard[s])
            e_s = counts[s]
            if h_s == 0 or e_s == 0 or acts <= 0:
                out.append([0.0] * n_l)
                continue
            resident_frac = min(self._slots[s] / (n_l * h_s), 1.0)
            m = float(acts) * (h_s / e_s) * (1.0 - resident_frac)
            out.append([max(m, 0.0)] * n_l)
        return out

    # ---- cache mutation (engine side) --------------------------------- #

    def _key(self, u):
        """Normalize a residency unit key: an expert id under
        granularity="expert", a (moe_layer, expert) tuple under "layer".
        Mixing the two is a caller bug, not a miss — it raises."""
        if self.granularity == "layer":
            if not isinstance(u, tuple) or len(u) != 2:
                raise ValueError(
                    f"granularity='layer' residency units are (layer, "
                    f"expert) tuples, got {u!r}")
            return (int(u[0]), int(u[1]))
        if isinstance(u, tuple):
            raise ValueError(
                f"granularity='expert' residency units are expert ids, "
                f"got the tuple {u!r}")
        return int(u)

    def access(self, experts, step: int):
        """Classify activated units at pass time: host-tier residents
        are hits (LRU-touched), staged units are hits too (the pass
        reads them straight from the staging buffer — the conversion a
        prefetch exists for) and are marked for installation, host-tier
        absentees are demand misses the caller should `fetch`. Returns
        (hit_ids, missing_ids). Units follow the granularity: expert ids,
        or (layer, expert) tuples."""
        hit, missing = [], []
        for e in experts:
            e = self._key(e)
            s = self._home.get(e)
            if s is None:
                continue
            if e in self._cache[s]:
                self._cache[s][e] = step
                hit.append(e)
            elif e in self._staged[s]:
                self._staged_used[s].add(e)
                hit.append(e)
            else:
                missing.append(e)
        self.hits += len(hit)
        self.misses += len(missing)
        return hit, missing

    def fetch(self, experts, step: int, *, stage=False):
        """Bring host-tier units over the host link (demand or
        prefetch). Returns {"fetched": n, "per_shard": [S], "bytes": f}.

        Demand mode (stage=False): the expert is installed in its
        shard's cache immediately, evicting the coldest resident — min
        (EMA load, last use, id) — when the slots are full. A shard with
        zero slots streams the weights through without retaining them
        (the fetch still crosses the link and is still billed).

        Staging mode (stage=True, the engine's prefetch path): the
        expert lands in the shard's *staging buffer* — the same bounce
        buffer every streamed fetch flows through — so nothing is
        evicted at prediction time. The pass reads staged weights as
        hits (`access`), and `note_step` then installs the ones the pass
        actually used with post-pass recency while discarding the rest.
        Evicting at prediction time is what this avoids: the predictor
        sees pre-pass recency, so its victims are systematically worse
        than the demand path's post-pass choices, and a mispredicted
        fetch would perturb the cache trajectory instead of costing only
        its (hidden) bytes."""
        per_shard = [0] * self.n_shards
        fetched = 0
        for e in experts:
            e = self._key(e)
            s = self._home.get(e)
            if s is None or e in self._cache[s] or e in self._staged[s]:
                continue
            per_shard[s] += 1
            fetched += 1
            if stage:
                self._staged[s].add(e)
                continue
            if self._slots[s] > 0 and len(self._cache[s]) >= self._slots[s]:
                victim = min(self._cache[s],
                             key=lambda v: (self._ema[v],
                                            self._cache[s][v], v))
                del self._cache[s][victim]
                self.evictions += 1
            if self._slots[s] <= 0:
                continue  # streamed, not retained
            self._cache[s][e] = step
        self.bytes_fetched += fetched * self.expert_bytes
        return {"fetched": fetched, "per_shard": per_shard,
                "bytes": fetched * self.expert_bytes}

    def note_step(self, active_experts, step: int) -> None:
        """End-of-pass bookkeeping: decay every host expert's EMA load
        toward 0 and bump the ones this pass activated — the coldness
        signal `fetch`'s eviction policy ranks by — then drain the
        staging buffer: staged experts the pass actually read are
        installed in the cache with post-pass recency (evicting the
        coldest resident, exactly as a demand fetch would have), unused
        ones are discarded (their only cost was the billed prefetch
        bytes — the cache trajectory stays untouched)."""
        active = {self._key(e) for e in active_experts}
        d = EMA_DECAY
        for e in self._ema:
            self._ema[e] = d * self._ema[e] + \
                (0.0 if e not in active else (1.0 - d))
        for s in range(self.n_shards):
            if self._slots[s] > 0:
                for e in sorted(self._staged_used[s]):
                    if e in self._cache[s]:
                        continue
                    if len(self._cache[s]) >= self._slots[s]:
                        victim = min(self._cache[s],
                                     key=lambda v: (self._ema[v],
                                                    self._cache[s][v], v))
                        del self._cache[s][victim]
                        self.evictions += 1
                    self._cache[s][e] = step
            self._staged[s].clear()
            self._staged_used[s].clear()

    def snapshot(self) -> dict:
        """Counters + live residency for telemetry/artifacts."""
        denom = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "bytes_fetched": self.bytes_fetched,
                "hit_rate": (self.hits / denom) if denom else 1.0,
                "resident_counts": list(self.resident_counts),
                "slots": list(self.slots),
                "granularity": self.granularity}
