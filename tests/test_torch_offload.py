"""The port's tiered expert residency on the CPU against the JAX package:
`ExpertPlacement`'s tiers, `ResidencyState` at both granularities, the
host-fetch terms of `batch_iteration_time` and `BatchCostOracle`, the
planner's `MemoryCapConstraint` and `FetchDeadlineConstraint`,
`decode_step(want_moe_h=True)`, and `BatchedEngine` with a host tier
(whole-expert and per-layer residency, prefetch on and off, double
buffering on and off) on `tiny_moe` and `trained_tiny_moe`.

Residency is pure Python bookkeeping and the prices are the same float
arithmetic on the same inputs, so integers, snapshots and prices are
equal to the bit (`==`). `moe_h` and logits are held at atol = rtol =
1e-4 of max(1, max|ref|), as the other decode tests hold logits. The
engines' token streams, every `IterationTelemetry` and `StepTelemetry`
field and the final `ResidencyState.snapshot()` are exactly equal under
`clock="model"`; an all-hbm residency is the residency-free engine, bit
for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import cost_model as jcm
from repro.core import planner as jplanner
from repro.core import residency as jres
from repro.core.controller import CascadeController as JCascade
from repro.models import transformer as jT
from repro.serving.engine import BatchedEngine as JBatched
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import cost_model as tcm
from repro_torch.core import planner as tplanner
from repro_torch.core import residency as tres
from repro_torch.core.controller import CascadeController
from repro_torch.models import transformer as tT
from repro_torch.serving import BatchedEngine
from test_torch_batching import _share_jits
from test_torch_guards import torch_one_thread  # noqa: F401,E402 (autouse)

TOL = 1e-4
ARCH = "mixtral-8x7b"


def _hw_pair():
    fields = dataclasses.asdict(tcm.H100_SXM)
    return jcm.Hardware(**fields), tcm.Hardware(**fields)


def _cfg_pair():
    return jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()


def _placements(place):
    """The same placement on both sides, from ("contiguous", E, S,
    offloaded ids)."""
    _, e, s, host = place
    return [m.ExpertPlacement.contiguous(e, s).offload(host)
            for m in (jcm, tcm)]


# --------------------------------------------------------------------- #
# ExpertPlacement tiers
# --------------------------------------------------------------------- #

_VIEWS = ("shard_of", "tier_of", "tiers", "num_experts", "n_shards",
          "counts", "resident_counts", "has_host_tier", "host_tier_counts")


@pytest.mark.parametrize("place", [
    ("contiguous", 8, 1, [4, 5, 6, 7]),
    ("contiguous", 4, 1, []),
    ("contiguous", 8, 2, [1, 6]),
    ("contiguous", 8, 4, [0, 7]),
])
def test_expert_placement_views_match_reference(place):
    jpl, tpl = _placements(place)
    for v in _VIEWS:
        assert getattr(tpl, v) == getattr(jpl, v), v
    for m, pl in ((jcm, jpl), (tcm, tpl)):
        pl.validate_experts(place[1])
        with pytest.raises(ValueError, match="placement maps"):
            pl.validate_experts(place[1] + 1)


@pytest.mark.parametrize("bad", [
    lambda m: m.ExpertPlacement((0, 1, 0), ("hbm", "host")),
    lambda m: m.ExpertPlacement((0, 1), ("hbm", "disk")),
    lambda m: m.ExpertPlacement((0, -1)),
    lambda m: m.ExpertPlacement.contiguous(4, 1).offload([4]),
    lambda m: m.ExpertPlacement.contiguous(4, 1).offload([-1]),
    lambda m: m.ExpertPlacement((0, 2)),
    lambda m: m.ExpertPlacement(()),
    lambda m: m.ExpertPlacement.contiguous(6, 4),
])
def test_expert_placement_validation_raises_as_reference(bad):
    msgs = []
    for m in (jcm, tcm):
        with pytest.raises(ValueError) as err:
            bad(m)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# --------------------------------------------------------------------- #
# ResidencyState: one seeded sequence of calls, snapshot after each
# --------------------------------------------------------------------- #

def _units(rng, granularity, n_l, e, n):
    if granularity == "layer":
        return [(int(rng.integers(n_l)), int(rng.integers(e)))
                for _ in range(n)]
    return [int(x) for x in rng.integers(0, e, n)]


def _same_state(ts, js, rng):
    assert ts.snapshot() == js.snapshot()
    assert ts.capacity_experts == js.capacity_experts
    assert ts.resident_counts == js.resident_counts
    assert ts._ema == js._ema
    assert ts._cache == js._cache
    acts = [float(x) for x in rng.uniform(0, 4, ts.n_shards)]
    assert ts.expected_misses(acts) == js.expected_misses(acts)
    if ts.granularity == "layer":
        assert ts.expected_layer_misses(acts) == \
            js.expected_layer_misses(acts)
    for e in range(ts.placement.num_experts):
        assert ts.is_resident(e) == js.is_resident(e)
        if ts.granularity == "layer":
            assert ts.is_resident((0, e)) == js.is_resident((0, e))


@pytest.mark.parametrize("granularity", ["expert", "layer"])
@pytest.mark.parametrize("case", [
    # placement, cap in expert units beyond the pinned ones (None: uncapped)
    dict(place=("contiguous", 4, 1, [1, 2, 3]), slots=1.0),
    dict(place=("contiguous", 4, 1, [2, 3]), slots=0.0),     # zero slots
    dict(place=("contiguous", 4, 1, [3]), slots=None),       # uncapped
    dict(place=("contiguous", 8, 2, [2, 3, 5, 6, 7]), slots=1.5,
         precision="int8"),
])
def test_residency_sequence_matches_reference(granularity, case):
    jcfg, tcfg = _cfg_pair()
    jcfg = dataclasses.replace(jcfg, num_experts=case["place"][1])
    tcfg = dataclasses.replace(tcfg, num_experts=case["place"][1])
    jpl, tpl = _placements(case["place"])
    prec = case.get("precision")
    jprec = jcm.Precision.int8_experts() if prec else None
    tprec = tcm.Precision.int8_experts() if prec else None
    assert tres.expert_hbm_bytes(tcfg, precision=tprec) == \
        jres.expert_hbm_bytes(jcfg, precision=jprec)
    assert tres.expert_hbm_bytes(tcfg, per_layer=True, precision=tprec) == \
        jres.expert_hbm_bytes(jcfg, per_layer=True, precision=jprec)
    assert tres.moe_layer_count(tcfg) == jres.moe_layer_count(jcfg)
    eb = tres.expert_hbm_bytes(tcfg, precision=tprec)
    assert eb == tres.moe_layer_count(tcfg) * tres.expert_hbm_bytes(
        tcfg, per_layer=True, precision=tprec)
    cap = None
    if case["slots"] is not None:
        pinned = [c for c in tpl.resident_counts]
        cap = [(p + case["slots"]) * eb for p in pinned]
    kw = dict(cap_bytes=cap, granularity=granularity)
    js = jres.ResidencyState(jpl, jcfg, precision=jprec, **kw)
    ts = tres.ResidencyState(tpl, tcfg, precision=tprec, **kw)
    n_l = ts.n_unit_layers
    e = tpl.num_experts
    rng = np.random.default_rng(5)
    check = np.random.default_rng(6)
    _same_state(ts, js, check)
    step = 0
    for _ in range(80):
        op = rng.choice(["stage", "fetch", "access", "note"])
        units = _units(rng, granularity, n_l, e, int(rng.integers(0, 5)))
        if op == "stage":
            out = (ts.fetch(units, step, stage=True),
                   js.fetch(units, step, stage=True))
        elif op == "fetch":
            out = ts.fetch(units, step), js.fetch(units, step)
        elif op == "access":
            out = ts.access(units, step), js.access(units, step)
        else:
            out = ts.note_step(units, step), js.note_step(units, step)
            step += 1
        assert out[0] == out[1]
        _same_state(ts, js, check)
    snap = ts.snapshot()
    if case["slots"] == 1.0:
        assert snap["evictions"] > 0 and snap["hits"] > 0
    if case["slots"] is None:
        assert snap["evictions"] == 0
    if case["slots"] == 0.0:
        assert snap["resident_counts"] == list(tpl.resident_counts)


def test_replicas_are_expert_parallelism():
    """A replicated expert (a tuple of shards) is expert parallelism: the
    port builds it as the reference does, and a replica cannot be
    host-tier in either."""
    jpl = jcm.ExpertPlacement(((0, 1), 1))
    tpl = tcm.ExpertPlacement(((0, 1), 1))
    assert tpl.n_shards == jpl.n_shards == 2
    for v in _VIEWS + ("primary_shard_of", "replication_groups"):
        assert getattr(tpl, v) == getattr(jpl, v), v
    for m in (jcm, tcm):
        with pytest.raises(ValueError, match="replicated"):
            m.ExpertPlacement(((0, 1), 1), ("host", "hbm"))


def test_residency_validation_matches_reference():
    jcfg, tcfg = _cfg_pair()
    dense = dataclasses.replace(tcfg, num_experts=0)
    for m, cfg in ((jres, jcfg), (tres, tcfg)):
        cm_ = jcm if m is jres else tcm
        pl = cm_.ExpertPlacement.contiguous(4, 1).offload([3])
        with pytest.raises(ValueError, match="granularity"):
            m.ResidencyState(pl, cfg, granularity="slice")
        with pytest.raises(ValueError, match="pinned"):
            m.ResidencyState(pl, cfg, cap_bytes=1.0)
        rs = m.ResidencyState(pl, cfg, granularity="layer")
        with pytest.raises(ValueError, match="tuples"):
            rs.access([3], 0)
        with pytest.raises(ValueError, match="granularity='layer'"):
            m.ResidencyState(pl, cfg).expected_layer_misses([1.0])
    assert not dense.is_moe
    with pytest.raises(ValueError, match="expert_bytes"):
        tres.ResidencyState(tcm.ExpertPlacement.contiguous(4, 1), dense)


# --------------------------------------------------------------------- #
# Fetch pricing: batch_iteration_time and BatchCostOracle
# --------------------------------------------------------------------- #

def _residency_pair(granularity, host=(2, 3), slots=1.0, precision=None):
    jcfg, tcfg = _cfg_pair()
    jpl, tpl = _placements(("contiguous", 4, 1, list(host)))
    jprec = jcm.Precision.int8_experts() if precision else None
    tprec = tcm.Precision.int8_experts() if precision else None
    eb = tres.expert_hbm_bytes(tcfg, precision=tprec)
    cap = (tpl.resident_counts[0] + slots) * eb
    return (jres.ResidencyState(jpl, jcfg, cap_bytes=cap,
                                granularity=granularity, precision=jprec),
            tres.ResidencyState(tpl, tcfg, cap_bytes=cap,
                                granularity=granularity, precision=tprec),
            jprec, tprec)


@pytest.mark.parametrize("granularity,hide", [
    ("expert", "zero"), ("expert", "scalar"), ("layer", "zero"),
    ("layer", "scalar"), ("layer", "schedule")])   # schedules: layer only
@pytest.mark.parametrize("measured", [False, True])
@pytest.mark.parametrize("precision", [None, "int8"])
def test_fetch_pricing_matches_reference(granularity, hide, measured,
                                         precision):
    jcfg, tcfg = _cfg_pair()
    jhw, thw = _hw_pair()
    js, ts, jprec, tprec = _residency_pair(granularity, precision=precision)
    n_l = ts.n_unit_layers
    assert tcm.moe_hide_fracs(tcfg) == jcm.moe_hide_fracs(jcfg)
    if hide == "schedule":
        fh = (tcm.fetch_hide_schedule(tcfg, 3e-6, 2e-4),
              jcm.fetch_hide_schedule(jcfg, 3e-6, 2e-4))
        assert fh[0] == fh[1]
        fh = fh[0]
    else:
        fh = 0.0 if hide == "zero" else 4e-6
    miss = staged = None
    if measured:
        if granularity == "layer":
            miss = [[1, 3][:n_l] + [0] * (n_l - 2)]
            staged = [[2, 0][:n_l] + [0] * (n_l - 2)]
        else:
            miss = [2]
    ctxs = [([5, 1, 3, 0], [300, 17, 1024, 0], None),
            ([5, 64, 2], [300, 0, 2000], [0, 64, 0]),
            ([1], [512], None)]
    for toks, ctx, pre in ctxs:
        kw = dict(prefill_tokens=pre, per_shard_miss=miss, fetch_hide=fh,
                  staged_per_shard=staged)
        tout = tcm.batch_iteration_time(
            tcfg, thw, toks, ctx, residency=ts, precision=tprec, **kw)
        jout = jcm.batch_iteration_time(
            jcfg, jhw, toks, ctx, residency=js, placement=js.placement,
            precision=jprec, **kw)
        assert tout == jout
        assert tout["t_fetch"] > 0 and tout["fetch_bytes"] > 0
        assert ("t_fetch_by_layer" in tout) == (granularity == "layer")
        okw = dict(prefill_tokens=pre, residency=ts, fetch_hide=fh,
                   precision=tprec)
        to = tcm.BatchCostOracle(tcfg, thw, ctx, **okw)
        jo = jcm.BatchCostOracle(
            jcfg, jhw, ctx, **dict(okw, residency=js, precision=jprec,
                                   placement=js.placement))
        for ns in (toks, [n + 2 for n in toks]):
            assert to.t_batch(ns) == jo.t_batch(ns)
            assert to.shard_unique(ns) == jo.shard_unique(ns)
            assert to.fetch_unhidden(ns) == jo.fetch_unhidden(ns)
        if not measured:   # the oracle prices the analytic curve exactly
            assert to.t_batch(toks) == tout["t_iter"]
    # the fetch terms themselves, measured counts with a staged cap
    act = [2.5]
    if granularity == "layer":
        rows = [[1.0] * n_l]
        assert tcm.fetch_time_layered(ts, thw, act, rows, fh, rows) == \
            jcm.fetch_time_layered(js, jhw, act, rows, fh, rows)
    else:
        assert tcm._fetch_time(ts, thw, act, None, fh) == \
            jcm._fetch_time(js, jhw, act, None, fh)


def test_flat_and_sharded_pricing_as_reference():
    """An all-hbm residency prices as no residency, bit for bit; a host
    tier needs a host link; a residency over two shards prices as the
    reference's, its fetch term the maximum over the shards."""
    jcfg, tcfg = _cfg_pair()
    _, thw = _hw_pair()
    flat = tcm.ExpertPlacement.contiguous(4, 1)
    rs = tres.ResidencyState(flat, tcfg, granularity="layer")
    base = tcm.batch_iteration_time(tcfg, thw, [3, 2], [100, 40])
    assert tcm.batch_iteration_time(tcfg, thw, [3, 2], [100, 40],
                                    residency=rs, fetch_hide=1.0) == base
    no_link = dataclasses.replace(thw, host_bw=0.0)
    _, ts, _, _ = _residency_pair("expert")
    for fn in (lambda: tcm.batch_iteration_time(
                   tcfg, no_link, [1], [10], residency=ts),
               lambda: tcm.BatchCostOracle(tcfg, no_link, [10],
                                           residency=ts)):
        with pytest.raises(ValueError, match="host_bw"):
            fn()
    jhw = _hw_pair()[0]
    for host in ([], [3], [1, 3]):
        pls = [m.ExpertPlacement.contiguous(4, 2).offload(host)
               for m in (jcm, tcm)]
        js, ts = (r.ResidencyState(pl, cfg) for r, pl, cfg in
                  ((jres, pls[0], jcfg), (tres, pls[1], tcfg)))
        tout = tcm.batch_iteration_time(tcfg, thw, [3, 1], [10, 40],
                                        residency=ts, placement=pls[1],
                                        fetch_hide=1e-6)
        assert tout == jcm.batch_iteration_time(
            jcfg, jhw, [3, 1], [10, 40], residency=js, placement=pls[0],
            fetch_hide=1e-6)
        assert tout["n_shards"] == 2
        to = tcm.BatchCostOracle(tcfg, thw, [10, 40], residency=ts,
                                 placement=pls[1], fetch_hide=1e-6)
        jo = jcm.BatchCostOracle(jcfg, jhw, [10, 40], residency=js,
                                 placement=pls[0], fetch_hide=1e-6)
        assert to.t_batch([3, 1]) == jo.t_batch([3, 1]) == tout["t_iter"]
        assert to.fetch_unhidden([3, 1]) == jo.fetch_unhidden([3, 1])


# --------------------------------------------------------------------- #
# The planner's residency constraints
# --------------------------------------------------------------------- #

def _oracles(js, ts, b=2, fetch_hide=0.0):
    jcfg, tcfg = _cfg_pair()
    jhw, thw = _hw_pair()
    return (jcm.BatchCostOracle(jcfg, jhw, [64] * b, residency=js,
                                placement=js.placement,
                                fetch_hide=fetch_hide),
            tcm.BatchCostOracle(tcfg, thw, [64] * b, residency=ts,
                                fetch_hide=fetch_hide))


@pytest.mark.parametrize("case", [
    # (constraint, batch, base tokens, asks, accept, hide): the memory cap
    # with a base union over capacity (the don't-worsen clause governs),
    # saturated (grants that keep the union admitted: the escape clause),
    # and the fetch deadline with no window, a small and a wide one
    ("memory_cap", 2, [1, 1], 6, 0.95, 0.0),
    ("memory_cap", 4, [8, 8, 8, 8], 4, 0.99, 0.0),
    ("fetch_deadline", 2, [1, 1], 6, 0.95, 0.0),
    ("fetch_deadline", 2, [1, 1], 6, 0.95, 2e-5),
    ("fetch_deadline", 2, [1, 1], 6, 0.95, 1.0),
])
@pytest.mark.parametrize("granularity", ["expert", "layer"])
def test_residency_constraints_decide_as_reference(case, granularity):
    name, b, base, ask, acc, hide = case
    js, ts, _, _ = _residency_pair(granularity, slots=0.0)
    jo, to = _oracles(js, ts, b, hide)
    decode = list(range(b))
    caps, accepts = {i: ask for i in decode}, {i: acc for i in decode}
    jcls = {"memory_cap": jplanner.MemoryCapConstraint,
            "fetch_deadline": jplanner.FetchDeadlineConstraint}[name]
    tcls = {"memory_cap": tplanner.MemoryCapConstraint,
            "fetch_deadline": tplanner.FetchDeadlineConstraint}[name]
    ja, jinfo = jplanner.greedy_allocate(jo, base, decode, caps, accepts,
                                         constraints=[jcls(residency=js)])
    ta, tinfo = tplanner.greedy_allocate(to, base, decode, caps, accepts,
                                         constraints=[tcls(residency=ts)])
    assert ta == ja and tinfo == jinfo
    free, _ = tplanner.greedy_allocate(to, base, decode, caps, accepts)
    if case == ("memory_cap", 2, [1, 1], 6, 0.95, 0.0) or \
            (name == "fetch_deadline" and hide == 0.0):
        assert sum(ta.values()) < sum(free.values())
        assert tinfo["denied"].get(name)
    if b == 4:   # a saturated union: grants still admitted
        assert sum(ta.values()) > 0
    if hide == 1.0:
        assert ta == free
    # a pinned probe vetted the same way on both sides
    fixed = frozenset({0})
    ja, jinfo = jplanner.greedy_allocate(jo, base, decode, caps, accepts,
                                         fixed=fixed,
                                         constraints=[jcls(residency=js)])
    ta, tinfo = tplanner.greedy_allocate(to, base, decode, caps, accepts,
                                         fixed=fixed,
                                         constraints=[tcls(residency=ts)])
    assert ta == ja and tinfo == jinfo


class _Ctl:
    """A stateless controller stand-in: phase, ask, held ask, acceptance."""

    def __init__(self, phase, k, hold_k=0, accept=None):
        self.phase, self.k, self.hold_k = phase, k, hold_k
        self.accept = accept
        self.analyzer = self

    def accept_rate(self, n=None):
        return self.accept

    def next_k(self):
        return self.k

    def hold(self):
        return self.hold_k


@pytest.mark.parametrize("granularity", ["expert", "layer"])
@pytest.mark.parametrize("slots", [0.0, 1.0, None])
def test_planner_with_residency_plans_as_reference(granularity, slots):
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    jhw, thw = _hw_pair()
    int8j, int8t = jcm.Precision.int8_experts(), tcm.Precision.int8_experts()
    jpl, tpl = _placements(("contiguous", 8, 1, [4, 5, 6, 7]))
    eb = tres.expert_hbm_bytes(tcfg, precision=int8t)
    cap = None if slots is None else (4 + slots) * eb
    kw = dict(cap_bytes=cap, granularity=granularity)
    js = jres.ResidencyState(jpl, jcfg, precision=int8j, **kw)
    ts = tres.ResidencyState(tpl, tcfg, precision=int8t, **kw)
    jp = jplanner.BatchSpecPlanner(jcfg, jhw, residency=js, precision=int8j)
    tp = tplanner.BatchSpecPlanner(tcfg, thw, residency=ts, precision=int8t)
    assert tp.residency is ts
    names = [c.name for c in tp.build_constraints([0, 1], {0: 3, 1: 3}, {})]
    assert names[-2:] == ["memory_cap", "fetch_deadline"]
    scenarios = [
        ({0: ("set", 4, 0, 0.9), 1: ("test", 6, 2, 0.6),
          2: ("test", 3, 1, 0.3), 3: ("set", 5, 0, None)},
         [300, 512, 40, 1000], {}),
        ({0: ("set", 4, 0, 0.95), 2: ("set", 7, 0, 0.8)}, [100, 0, 700],
         {1: 64}),
        ({1: ("set", 5, 0, 0.5)}, [0, 64], {}),
    ]
    for ctls, lens, pre in scenarios:
        ctl = {i: _Ctl(*v) for i, v in ctls.items()}
        for _ in range(2):
            jplan = jp.plan(ctl, lens, prefill_tokens=pre)
            tplan = tp.plan(ctl, lens, prefill_tokens=pre)
            assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan)
    with pytest.raises(ValueError, match="placement maps"):
        tplanner.BatchSpecPlanner(tcfg, thw, residency=tres.ResidencyState(
            tcm.ExpertPlacement.contiguous(4, 1).offload([3]), tcfg))
    flat = tres.ResidencyState(tcm.ExpertPlacement.contiguous(8, 1), tcfg)
    names = [c.name for c in tplanner.BatchSpecPlanner(
        tcfg, thw, residency=flat).build_constraints([0], {0: 3}, {})]
    assert "memory_cap" not in names and "fetch_deadline" not in names


# --------------------------------------------------------------------- #
# decode_step(want_moe_h=True)
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def tiny(tiny_moe):
    cfg, jparams = tiny_moe
    return cfg, jparams, params_from_numpy(jax.device_get(jparams),
                                           device="cpu")


@pytest.fixture(scope="module")
def trained(trained_tiny_moe):
    cfg, jparams, _ = trained_tiny_moe
    return cfg, jparams, params_from_numpy(jax.device_get(jparams),
                                           device="cpu")


def _close(actual, ref):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(actual.detach().numpy(), ref, rtol=TOL,
                               atol=TOL * scale)


@pytest.mark.parametrize("packed", [False, True])
def test_decode_step_moe_h_matches_reference(tiny, packed):
    cfg, jp, tp = tiny
    rng = np.random.default_rng(11)
    b, max_len = 3, 64
    jc = jT.init_cache(cfg, b, max_len, per_row=True)
    tc = tT.init_cache(cfg, b, max_len, per_row=True, device="cpu")
    for slot, n in ((0, 7), (1, 12), (2, 3)):
        prompt = rng.integers(3, cfg.vocab_size, (1, n)).astype(np.int32)
        jrow = jT.init_cache(cfg, 1, max_len)
        _, jrow, _ = jT.prefill(cfg, jp, jnp.asarray(prompt), jrow)
        trow = tT.init_cache(cfg, 1, max_len, device="cpu")
        _, trow, _ = tT.prefill(cfg, tp, torch.from_numpy(prompt), trow)
        jc = jT.write_cache_row(jc, slot, jrow)
        tc = tT.write_cache_row(tc, slot, trow)
    toks = rng.integers(3, cfg.vocab_size, (b, 5)).astype(np.int32)
    mask = np.array([[1, 1, 1, 0, 0], [1] * 5, [1, 0, 0, 0, 0]], bool)
    jlo, _, jaux, _ = jT.decode_step(cfg, jp, jc, jnp.asarray(toks),
                                     token_mask=jnp.asarray(mask),
                                     moe_packed=packed, want_moe_h=True)
    tc_flat = {k: v.clone() for k, v in tc.items()}
    tlo, _, taux, _ = tT.decode_step(cfg, tp, tc, torch.from_numpy(toks),
                                     token_mask=torch.from_numpy(mask),
                                     moe_packed=packed, want_moe_h=True)
    _close(tlo, jlo)
    assert tuple(taux["moe_h"].shape) == (cfg.num_layers, b, 5, cfg.d_model)
    assert taux["moe_h"].dtype == tp["embed"]["embedding"].dtype
    _close(taux["moe_h"], jaux["moe_h"])
    for key in ("unique_experts", "unique_experts_row", "experts_active"):
        np.testing.assert_array_equal(taux[key].numpy(),
                                      np.asarray(jaux[key]))
    # without the flag nothing is gathered, and the pass is unchanged
    flo, _, faux, _ = tT.decode_step(cfg, tp, tc_flat,
                                     torch.from_numpy(toks),
                                     token_mask=torch.from_numpy(mask),
                                     moe_packed=packed)
    assert "moe_h" not in faux
    assert torch.equal(flo, tlo)


# --------------------------------------------------------------------- #
# BatchedEngine with a host tier
# --------------------------------------------------------------------- #

_RESIDENCY = {
    # name: (granularity, prefetch, double_buffer); None: no residency
    "none": None,
    "all-hbm": ("expert", True, True),
    "whole-prefetch": ("expert", True, True),
    "whole-no-prefetch": ("expert", False, True),
    "layer-double-buffer": ("layer", True, True),
    "layer-single-buffer": ("layer", True, False),
}


def _prompts(model, n, cfg):
    rng = np.random.default_rng(7)
    if model == "trained":   # the periodic-copy task it was trained on
        out = []
        for i in range(n):
            p = rng.integers(3, cfg.vocab_size, 32).tolist()
            out.append([1] + p + p[:7 + 2 * i])
        return out
    return [[int(t) for t in rng.integers(3, 40, 4)] * 5
            for _ in range(n)]


def _serve(eng, prompts, max_new):
    pending, live, done = list(enumerate(prompts)), {}, {}
    while pending or live:
        while pending and eng.free_slots:
            i, p = pending.pop(0)
            live[eng.join(p, max_new, request_id=str(i))] = i
        eng.step()
        for slot, i in list(live.items()):
            if eng.slots[slot].done:
                done[i] = eng.retire(slot)
                del live[slot]
    return done


def _engine_run(model, side, name, max_batch, models, runs):
    """Serve the model's prompts on one side ("jax" or "torch") with the
    named residency; `runs` keeps each run for the other test cases."""
    key = (model, side, name, max_batch)
    if key in runs:
        return runs[key]
    cfg, jp, tp = models[model]
    jhw, thw = _hw_pair()
    jax_side = side == "jax"
    m = jcm if jax_side else tcm
    rmod = jres if jax_side else tres
    kw = {}
    rs = None
    spec = _RESIDENCY[name]
    if spec is not None:
        granularity, prefetch, double_buffer = spec
        pl = m.ExpertPlacement.contiguous(cfg.num_experts, 1)
        cap = None
        if name != "all-hbm":
            e = cfg.num_experts
            pl = pl.offload([e - 2, e - 1])
            cap = (e - 2) * rmod.expert_hbm_bytes(cfg) + \
                rmod.expert_hbm_bytes(cfg)       # one slot for two experts
        rs = rmod.ResidencyState(pl, cfg, cap_bytes=cap,
                                 granularity=granularity)
        kw = dict(residency=rs, prefetch=prefetch,
                  double_buffer=double_buffer)
    common = dict(max_batch=max_batch, max_len=256, temperature=0.0,
                  clock="model", seed=0, **kw)
    if jax_side:
        eng = _share_jits(JBatched(cfg, jp, hw=jhw,
                                   controller_factory=JCascade, **common))
    else:
        eng = BatchedEngine(cfg, tp, hw=thw,
                            controller_factory=CascadeController,
                            device="cpu", **common)
    n = 2 if max_batch == 1 else 5
    res = _serve(eng, _prompts(model, n, cfg), 12)
    runs[key] = (res, eng, rs)
    return runs[key]


def _tel(res, eng):
    return ({i: (r.tokens, [dataclasses.asdict(it)
                            for it in r.telemetry.iterations],
                 r.telemetry.ttft, r.telemetry.t_prefill)
             for i, r in res.items()},
            [dataclasses.asdict(s) for s in eng.telemetry.steps], eng.now)


@pytest.fixture(scope="module")
def models(tiny, trained):
    return {"tiny": tiny, "trained": trained}


@pytest.fixture(scope="module")
def runs():
    return {}


@pytest.mark.parametrize("name", [n for n in _RESIDENCY if n != "none"])
@pytest.mark.parametrize("model,max_batch", [("tiny", 1), ("tiny", 4),
                                             ("trained", 4)])
def test_engine_with_residency_equals_jax(models, runs, model, max_batch,
                                         name):
    jres_, jeng, js = _engine_run(model, "jax", name, max_batch, models,
                                  runs)
    tres_, teng, ts = _engine_run(model, "torch", name, max_batch, models,
                                  runs)
    assert _tel(tres_, teng) == _tel(jres_, jeng)
    assert ts.snapshot() == js.snapshot()
    nres, neng, _ = _engine_run(model, "torch", "none", max_batch, models,
                                runs)
    # the tier changes prices and grants, not weights: in float32 these
    # greedy streams stay those of the residency-free engine
    assert {i: r.tokens for i, r in tres_.items()} == \
        {i: r.tokens for i, r in nres.items()}
    steps = teng.telemetry.steps
    if name == "all-hbm":
        assert _tel(tres_, teng) == _tel(nres, neng)
        return
    assert teng.telemetry.fetch_bytes > 0
    assert ts.snapshot()["bytes_fetched"] == teng.telemetry.fetch_bytes
    assert any(s.t_fetch > 0 for s in steps)
    if name.startswith("layer"):
        layered = [s for s in steps if s.prefetch_hits_by_layer]
        assert layered
        for s in layered:
            assert sum(s.prefetch_hits_by_layer) == s.prefetch_hits
            assert sum(s.prefetch_misses_by_layer) == s.prefetch_misses
    else:
        assert teng.telemetry.evictions > 0
    if max_batch > 1:
        assert max(s.occupancy for s in steps) == max_batch
    if model == "trained":   # the trained model really speculates
        its = [it for r in tres_.values() for it in r.telemetry.iterations]
        assert sum(it.tokens_emitted for it in its) > len(its)


def test_engine_mismatch_checks_raise_as_reference(tiny):
    cfg, jp, tp = tiny
    jhw, thw = _hw_pair()
    e = cfg.num_experts
    for m, rmod, pm, eng_cls, params, extra in (
            (jcm, jres, jplanner, JBatched, jp, {}),
            (tcm, tres, tplanner, BatchedEngine, tp, {"device": "cpu"})):
        one = m.ExpertPlacement.contiguous(e, 1)
        rs = rmod.ResidencyState(one.offload([e - 1]), cfg)

        def make(**kw):
            return eng_cls(cfg, params, max_batch=1, max_len=64, **extra,
                           **kw)
        with pytest.raises(ValueError, match="homes and tiers"):
            make(placement=m.ExpertPlacement.contiguous(e, 2), residency=rs)
        with pytest.raises(ValueError, match="homes and tiers"):
            make(placement=one, residency=rs)
        with pytest.raises(ValueError, match="placement"):
            make(residency=rs, planner=pm.BatchSpecPlanner(cfg))
        other = rmod.ResidencyState(one.offload([e - 1]), cfg)
        with pytest.raises(ValueError, match="different residency"):
            make(residency=rs, planner=pm.BatchSpecPlanner(
                cfg, residency=other))
        eng = make(residency=rs, planner=pm.BatchSpecPlanner(
            cfg, residency=rs))
        assert eng.placement.tiers == one.offload([e - 1]).tiers
    for m, rmod, eng_cls, params, extra in (
            (jcm, jres, JBatched, jp, {}),
            (tcm, tres, BatchedEngine, tp, {"device": "cpu"})):
        two = m.ExpertPlacement.contiguous(e, 2).offload([e - 1])
        eng = eng_cls(cfg, params, max_batch=1, max_len=64, **extra,
                      residency=rmod.ResidencyState(two, cfg))
        assert eng.placement is two and eng.planner.placement is two
