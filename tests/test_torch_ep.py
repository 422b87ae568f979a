"""The port's expert parallelism on the CPU against the JAX package: the
sharded `ExpertPlacement` (replicas included), the per-shard activation
curve and the replica relief, sharded `batch_iteration_time` and
`BatchCostOracle` (the all-to-all term, calibration, precision), the
planner's grants under a placement and its naive comparator, the
residency over 2- and 4-shard tiered placements, `shard_expert_stats`
and `decode_step`'s per-shard counts, and `BatchedEngine` over three
placements of `tiny_moe`'s experts.

Pricing and residency are the same float arithmetic on the same inputs,
so every price, count and grant is equal to the bit (`==`). Routing
counts are integers, equal exactly. The engines' token streams and every
`IterationTelemetry` and `StepTelemetry` field (the shard fields and
`replica_moves` included) are exactly equal under `clock="model"`. The
dispatch over torch.distributed ranks is `test_torch_ep_dispatch.py`."""

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
from repro.core.controller import StaticKController as JStatic
from repro.models import moe as jmoe
from repro.models import transformer as jT
from repro.serving.engine import BatchedEngine as JBatched
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import cost_model as tcm
from repro_torch.core import planner as tplanner
from repro_torch.core import residency as tres
from repro_torch.core.controller import CascadeController, StaticKController
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tT
from repro_torch.serving import BatchedEngine
from test_torch_batching import _JITS, _serve
from test_torch_offload import _same_state, _units
from test_torch_guards import torch_one_thread  # noqa: F401,E402 (autouse)

ARCH = "mixtral-8x7b"                     # reduced: 4 experts top-2


def _cfg_pair(num_experts=None):
    jcfg, tcfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    if num_experts is not None:
        jcfg = dataclasses.replace(jcfg, num_experts=num_experts)
        tcfg = dataclasses.replace(tcfg, num_experts=num_experts)
    return jcfg, tcfg


def _hw_pairs():
    """The H100 figure and three regimes of test_ep_cost (memory-bound,
    compute-bound, a crossover), each on both sides."""
    out = []
    for fields in (dataclasses.asdict(tcm.H100_SXM),
                   dict(name="slowmem", hbm_bw=1e9, peak_flops=197e12,
                        ici_bw=1e9),
                   dict(name="slowflops", hbm_bw=819e9, peak_flops=2e9,
                        ici_bw=50e9),
                   dict(name="crossover", hbm_bw=1e9, peak_flops=6e9,
                        ici_bw=5e8)):
        out.append((jcm.Hardware(**fields), tcm.Hardware(**fields)))
    return out


#: placements by (kind, E, S): each built the same way on both sides
def _placement(m, kind, e, s):
    if kind == "contiguous":
        return m.ExpertPlacement.contiguous(e, s)
    if kind == "zipf":
        return m.ExpertPlacement.zipf(e, s, alpha=2.0)
    if kind == "sizes":
        return m.ExpertPlacement.from_sizes([e - s + 1] + [1] * (s - 1))
    # "replicated": shard 0's experts replicated onto the last shard, and
    # expert e-1 onto shard 0
    pl = m.ExpertPlacement.zipf(e, s, alpha=2.0)
    reps = {x: s - 1 for x, h in enumerate(pl.shard_of) if h == 0}
    reps[e - 1] = 0
    return pl.replicate(reps) if s > 1 else pl


KINDS = ("contiguous", "zipf", "sizes", "replicated")

# --------------------------------------------------------------------- #
# ExpertPlacement over shards
# --------------------------------------------------------------------- #

_VIEWS = ("shard_of", "primary_shard_of", "has_replication",
          "replication_groups", "num_experts", "n_shards", "counts",
          "resident_counts", "tiers", "has_host_tier", "host_tier_counts")


def test_sharded_placements_match_reference():
    for kind in KINDS:
        for e, s in ((8, 4), (8, 2), (64, 4), (4, 1)):
            jpl, tpl = (_placement(m, kind, e, s) for m in (jcm, tcm))
            for v in _VIEWS:
                assert getattr(tpl, v) == getattr(jpl, v), (kind, e, s, v)
    for m in (jcm, tcm):
        pl = m.ExpertPlacement.contiguous(8, 4).replicate({0: 1, 1: (2, 3)})
        mixed = m.ExpertPlacement(((0, 1), 1, 2, 3, 3), ("hbm",) * 4
                                  + ("host",))
        assert pl.replication_groups == ((0, (1,), 1), (0, (2, 3), 1))
        assert mixed.host_tier_counts == (0, 0, 0, 1)
    for e, s, a in ((4, 1, 0.5), (16, 4, 1.0), (64, 4, 2.0), (64, 2, 4.0)):
        assert (tcm.ExpertPlacement.zipf(e, s, alpha=a).shard_of
                == jcm.ExpertPlacement.zipf(e, s, alpha=a).shard_of)


@pytest.mark.parametrize("bad", [
    lambda m: m.ExpertPlacement(((0, 0), 1)),           # duplicate replica
    lambda m: m.ExpertPlacement(((0, 2), 0)),           # shard 1 unresident
    lambda m: m.ExpertPlacement(((), 0)),
    lambda m: m.ExpertPlacement.contiguous(8, 4).replicate({0: 7}),
    lambda m: m.ExpertPlacement.contiguous(8, 4).replicate({99: 1}),
    lambda m: m.ExpertPlacement(((0, 1), 1), ("host", "hbm")),
    lambda m: m.ExpertPlacement.contiguous(8, 4).replicate(
        {0: 1}).offload([0]),
    lambda m: m.ExpertPlacement.zipf(4, 8),
    lambda m: m.ExpertPlacement.from_sizes([2, 0]),
])
def test_sharded_placement_validation_raises_as_reference(bad):
    msgs = []
    for m in (jcm, tcm):
        with pytest.raises(ValueError) as err:
            bad(m)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# --------------------------------------------------------------------- #
# The per-shard activation curve and the pass price
# --------------------------------------------------------------------- #

def _profiles(rng, b, s):
    """Per-request shard profiles: Dirichlet rows, one row None and one
    all-zero when there are enough rows (both fall back to the
    placement's proportions)."""
    w = rng.dirichlet(np.ones(s) * 0.5, size=b).tolist()
    if b > 2:
        w[1] = None
        w[2] = [0.0] * s
    return w


@pytest.mark.parametrize("s", [1, 2, 4])
def test_sharded_union_matches_reference(s):
    """`expected_unique_experts_sharded` (and with it `_sharded_union`,
    `_rebalance_replicas` and `_hot_shard`) over a grid of placements,
    token counts, affinities and profiles, with and without a residency
    capacity bounding the replica relief."""
    rng = np.random.default_rng(10 + s)
    for kind in KINDS:
        for e in (4 * s, 16):
            jpl, tpl = (_placement(m, kind, e, s) for m in (jcm, tcm))
            for aff in (0.0, 0.3, 1.0):
                for _ in range(3):
                    b = int(rng.integers(1, 6))
                    ns = [int(x) for x in rng.integers(0, 9, b)]
                    k = int(rng.integers(1, min(e, 8) + 1))
                    sw = _profiles(rng, b, s) if rng.integers(2) else None
                    cap = (rng.uniform(0.5, 4.0, s).tolist()
                           if rng.integers(2) else None)
                    args = (e, k, ns)
                    kw = dict(affinity=aff, shard_weights=sw, capacity=cap)
                    assert tcm.expected_unique_experts_sharded(
                        *args, tpl, **kw) == \
                        jcm.expected_unique_experts_sharded(
                            *args, jpl, **kw)
    assert tcm.expected_unique_experts_sharded(8, 2, [3, 1], None) == \
        jcm.expected_unique_experts_sharded(8, 2, [3, 1], None)
    with pytest.raises(ValueError, match="placement maps"):
        tcm.expected_unique_experts_sharded(
            8, 2, [3], tcm.ExpertPlacement.contiguous(4, 1))


@pytest.mark.parametrize("s", [1, 2, 4])
def test_sharded_pass_pricing_matches_reference(s):
    """`batch_iteration_time` and the oracle under a placement: analytic
    and measured per-shard counts, the balanced comparator, profiles,
    prefill rows, int8 expert pricing and a calibration with its own
    all-to-all scale; `a2a_bytes` and `_a2a_time` alone."""
    rng = np.random.default_rng(20 + s)
    for kind in KINDS:
        jcfg, tcfg = _cfg_pair(4 * s)
        jpl, tpl = (_placement(m, kind, 4 * s, s) for m in (jcm, tcm))
        for (jhw, thw) in _hw_pairs():
            b = int(rng.integers(1, 5))
            ns = [int(x) for x in rng.integers(0, 9, b)]
            cls = [int(x) for x in rng.integers(1, 400, b)]
            ps = [int(x) for x in rng.integers(0, 16, b)]
            sw = _profiles(rng, b, s) if rng.integers(2) else None
            bal = bool(rng.integers(2))
            measured = ([float(x) for x in rng.uniform(0, 4, s)]
                        if rng.integers(2) else None)
            int8 = bool(rng.integers(2))
            jprec = jcm.Precision.int8_experts() if int8 else None
            tprec = tcm.Precision.int8_experts() if int8 else None
            cal = (dict(time_scale=1.3, time_offset=1e-4, a2a_scale=2.5)
                   if rng.integers(2) else None)
            jcal = jcm.Calibration(**cal) if cal else None
            tcal = tcm.Calibration(**cal) if cal else None
            kw = dict(affinity=0.2, prefill_tokens=ps, shard_weights=sw,
                      assume_balanced=bal)
            jout = jcm.batch_iteration_time(
                jcfg, jhw, ns, cls, placement=jpl, precision=jprec,
                calibration=jcal, per_shard_unique=measured, **kw)
            tout = tcm.batch_iteration_time(
                tcfg, thw, ns, cls, placement=tpl, precision=tprec,
                calibration=tcal, per_shard_unique=measured, **kw)
            assert tout == jout
            if s > 1:
                assert tout["n_shards"] == s and tout["t_a2a"] >= 0.0
            jo = jcm.BatchCostOracle(jcfg, jhw, cls, placement=jpl,
                                     precision=jprec, calibration=jcal,
                                     **kw)
            to = tcm.BatchCostOracle(tcfg, thw, cls, placement=tpl,
                                     precision=tprec, calibration=tcal,
                                     **kw)
            for n2 in (ns, [n + 2 for n in ns], [0] * b):
                assert to.t_batch(n2) == jo.t_batch(n2)
                assert to.shard_unique(n2) == jo.shard_unique(n2)
            for n_tok in (0, 1, 37):
                assert tcm.a2a_bytes(tcfg, n_tok, s) == \
                    jcm.a2a_bytes(jcfg, n_tok, s)
                assert tcm._a2a_time(tcfg, thw, n_tok, s, 1) == \
                    jcm._a2a_time(jcfg, jhw, n_tok, s, 1)
    # an interconnect-less card cannot price a multi-shard pass
    jcfg, tcfg = _cfg_pair(8)
    msgs = []
    for m, cfg in ((jcm, jcfg), (tcm, tcfg)):
        hw = m.Hardware("no-link", hbm_bw=1e12, peak_flops=1e14)
        pl = m.ExpertPlacement.contiguous(8, 2)
        with pytest.raises(ValueError) as err:
            m.batch_iteration_time(cfg, hw, [3], [10], placement=pl)
        msgs.append(str(err.value))
        with pytest.raises(ValueError, match="ici_bw"):
            m.BatchCostOracle(cfg, hw, [10], placement=pl).t_batch([3])
    assert msgs[0] == msgs[1]
    assert tcm.H100_SXM.ici_bw == 450e9


def test_planner_grants_under_a_placement_match_reference():
    """`BatchSpecPlanner(placement=)` water-fills at the max-over-shards
    price (steered by the rows' shard profiles) and its
    `shard_aware=False` comparator at the balanced one; the grants and
    predictions equal the reference's. A placement on a dense config, or
    one that maps other experts than the model's, raises alike."""
    jcfg, tcfg = _cfg_pair(16)
    jhw, thw = _hw_pairs()[3]
    rng = np.random.default_rng(3)
    hot, cold = [1.0, 0.0, 0.0, 0.0], [0.0, 1 / 3, 1 / 3, 1 / 3]
    seen = set()
    for kind in ("contiguous", "zipf", "replicated"):
        jpl, tpl = (_placement(m, kind, 16, 4) for m in (jcm, tcm))
        for aware in (True, False):
            jp = jplanner.BatchSpecPlanner(
                jcfg, jhw, placement=jpl,
                config=jplanner.PlannerConfig(shard_aware=aware))
            tp = tplanner.BatchSpecPlanner(
                tcfg, thw, placement=tpl,
                config=tplanner.PlannerConfig(shard_aware=aware))
            for profiles in ({0: hot, 1: cold}, {0: cold, 2: hot}, None):
                lens = [int(x) for x in rng.integers(64, 2048, 4)]
                jplan = jp.plan({i: JStatic(6) for i in range(3)}, lens,
                                shard_weights=profiles,
                                prefill_tokens={3: 4})
                tplan = tp.plan({i: StaticKController(6) for i in range(3)},
                                lens, shard_weights=profiles,
                                prefill_tokens={3: 4})
                assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan)
                seen.add(tuple(d.granted for d in tplan.decisions.values()))
    assert len(seen) > 1          # the profiles and the comparator matter
    dense_j = jax_get_config("stablelm-1.6b").reduced()
    dense_t = get_config("stablelm-1-6b").reduced()
    for m, pm, cfg, dense in ((jcm, jplanner, jcfg, dense_j),
                              (tcm, tplanner, tcfg, dense_t)):
        with pytest.raises(ValueError, match="placement maps"):
            pm.BatchSpecPlanner(cfg, placement=m.ExpertPlacement.contiguous(
                8, 4))
        with pytest.raises(ValueError, match="dense"):
            pm.BatchSpecPlanner(dense, placement=m.ExpertPlacement
                                .contiguous(8, 4))


# --------------------------------------------------------------------- #
# Residency over more than one shard
# --------------------------------------------------------------------- #

def _tiered(m, s):
    """Eight experts over `s` shards, the last expert of each shard on the
    host tier, expert 0 replicated onto the last shard."""
    pl = m.ExpertPlacement.contiguous(8, s)
    pl = pl.offload([e for e in range(8) if (e + 1) % (8 // s) == 0])
    return pl.replicate({0: s - 1})


@pytest.mark.parametrize("granularity", ["expert", "layer"])
@pytest.mark.parametrize("s", [2, 4])
def test_sharded_residency_matches_reference(s, granularity):
    """Per-shard caps (a different cap on each shard), replicas pinned on
    every shard that holds them, per-shard misses: one seeded sequence of
    stage/fetch/access/note calls leaves both states equal after each,
    and the sharded fetch term (the maximum over shards) prices alike,
    analytic and measured, through `batch_iteration_time` and the
    oracle."""
    jcfg, tcfg = _cfg_pair(8)
    jpl, tpl = _tiered(jcm, s), _tiered(tcm, s)
    assert tpl.resident_counts == jpl.resident_counts
    eb = tres.expert_hbm_bytes(tcfg)
    cap = [(p + 0.5 * (i % 2) + 1.0) * eb
           for i, p in enumerate(tpl.resident_counts)]
    kw = dict(cap_bytes=cap, granularity=granularity)
    js = jres.ResidencyState(jpl, jcfg, **kw)
    ts = tres.ResidencyState(tpl, tcfg, **kw)
    rng, check = np.random.default_rng(7 + s), np.random.default_rng(8)
    _same_state(ts, js, check)
    step = 0
    for _ in range(60):
        op = rng.choice(["stage", "fetch", "access", "note"])
        units = _units(rng, granularity, ts.n_unit_layers, 8,
                       int(rng.integers(0, 5)))
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
    assert js.misses > 0
    (jhw, thw) = _hw_pairs()[0]
    n_l = ts.n_unit_layers
    for miss in (None, [[i % 3] * n_l if granularity == "layer" else i % 3
                        for i in range(s)]):
        for ns, cls in (([5, 1, 3], [300, 17, 1024]), ([2], [64])):
            fkw = dict(per_shard_miss=miss, fetch_hide=2e-6,
                       shard_weights=_profiles(rng, len(ns), s))
            tout = tcm.batch_iteration_time(tcfg, thw, ns, cls,
                                            residency=ts, placement=tpl,
                                            **fkw)
            jout = jcm.batch_iteration_time(jcfg, jhw, ns, cls,
                                            residency=js, placement=jpl,
                                            **fkw)
            assert tout == jout and len(tout["fetch_miss"]) == s
            okw = dict(residency=ts, fetch_hide=2e-6,
                       shard_weights=fkw["shard_weights"])
            to = tcm.BatchCostOracle(tcfg, thw, cls, placement=tpl, **okw)
            jo = jcm.BatchCostOracle(jcfg, jhw, cls, placement=jpl,
                                     **dict(okw, residency=js))
            for n2 in (ns, [n + 3 for n in ns]):
                assert to.t_batch(n2) == jo.t_batch(n2)
                assert to.shard_unique(n2) == jo.shard_unique(n2)
                assert to.fetch_unhidden(n2) == jo.fetch_unhidden(n2)


# --------------------------------------------------------------------- #
# Per-shard routing counts
# --------------------------------------------------------------------- #

def test_shard_expert_stats_match_reference():
    """Static and tensor shard maps (the engine's replica routes), with
    and without a padding mask: per-shard and per-row-per-shard counts
    equal exactly, and they partition the union and the per-row
    counts."""
    rng = np.random.default_rng(4)
    cfg_j, cfg_t = _cfg_pair(8)
    for b, t, s in ((3, 5, 2), (4, 1, 4), (2, 7, 3)):
        idx = rng.integers(0, 8, (b, t, 2)).astype(np.int32)
        mask = rng.random((b, t)) < 0.7
        shard_of = tuple(int(x) for x in rng.permutation(np.arange(8) % s))
        n = s
        for m in (None, mask):
            jm = None if m is None else jnp.asarray(m)
            tm = None if m is None else torch.from_numpy(m)
            ref = jmoe.shard_expert_stats(cfg_j, jnp.asarray(idx), shard_of,
                                          jm)
            for sid, kw in ((shard_of, {}),
                            (torch.tensor(shard_of), {"n_shards": n})):
                got = tmoe.shard_expert_stats(cfg_t, torch.from_numpy(idx),
                                              sid, tm, **kw)
                for g, r in zip(got, ref):
                    np.testing.assert_array_equal(g.numpy(), np.asarray(r))
            union, per_row = tmoe.unique_expert_stats(
                cfg_t, torch.from_numpy(idx), tm)
            assert int(got[0].sum()) == int(union)
            assert torch.equal(got[1].sum(1), per_row)


def test_decode_step_shard_counts_match_reference(tiny_moe):
    """A ragged per-row pass with a padding mask under a static shard map
    and under a tensor map with the shard count: `unique_experts_shard`
    [L,S] and `unique_experts_row_shard` [L,B,S] equal the reference's;
    without a map neither key is returned."""
    cfg, jp = tiny_moe
    tp = params_from_numpy(jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(31)
    b, max_len = 3, 32
    jc = jT.init_cache(cfg, b, max_len, per_row=True)
    tc = tT.init_cache(cfg, b, max_len, per_row=True, device="cpu")
    toks = rng.integers(3, cfg.vocab_size, (b, 5)).astype(np.int32)
    mask = np.array([[1, 1, 1, 0, 0], [1] * 5, [1, 0, 0, 0, 0]], bool)
    shard_of = (0, 0, 1, 1)
    _, _, jaux, _ = jT.decode_step(cfg, jp, jc, jnp.asarray(toks),
                                   token_mask=jnp.asarray(mask),
                                   ep_shard_ids=shard_of)
    for sid, n in ((shard_of, None), (torch.tensor(shard_of), 2)):
        c = {k: v.clone() if torch.is_tensor(v) else v for k, v in tc.items()}
        _, _, taux, _ = tT.decode_step(cfg, tp, c, torch.from_numpy(toks),
                                       token_mask=torch.from_numpy(mask),
                                       ep_shard_ids=sid, ep_n_shards=n)
        for key in ("unique_experts", "unique_experts_row",
                    "unique_experts_shard", "unique_experts_row_shard"):
            np.testing.assert_array_equal(taux[key].numpy(),
                                          np.asarray(jaux[key]))
    assert tuple(taux["unique_experts_row_shard"].shape) == (
        cfg.num_layers, b, 2)
    _, _, plain, _ = tT.decode_step(cfg, tp, tc, torch.from_numpy(toks),
                                    token_mask=torch.from_numpy(mask))
    assert "unique_experts_shard" not in plain


def test_dense_stack_shard_counts_are_zeros():
    """On a dense stack every layer reports zero per-shard counts of the
    map's shape, as the reference's dense layers do."""
    cfg = get_config("stablelm-1-6b").reduced()
    params = tT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    cache = tT.init_cache(cfg, 2, 16, per_row=True, device="cpu")
    _, _, aux, _ = tT.decode_step(cfg, params, cache,
                                  torch.ones((2, 3), dtype=torch.int32),
                                  ep_shard_ids=(0, 1, 2), ep_n_shards=3)
    assert torch.equal(aux["unique_experts_shard"],
                       torch.zeros((cfg.num_layers, 3), dtype=torch.int32))
    assert torch.equal(aux["unique_experts_row_shard"],
                       torch.zeros((cfg.num_layers, 2, 3), dtype=torch.int32))


# --------------------------------------------------------------------- #
# BatchedEngine under a placement (level 3)
# --------------------------------------------------------------------- #

def _shared_ep_decode(jeng):
    """Give the JAX engine `jeng` one jitted decode shared by every EP
    engine of these tests: the shard map enters as an argument (as the
    reference's own replica-routing decode takes it) instead of a closure
    constant, so the three placements compile the pass once per span
    shape. The counts are integers of the same map either way."""
    n_sh = jeng.placement.n_shards
    key = (jeng.cfg, jeng.window, "ep-decode", n_sh, jeng.packed)
    cfg, window, packed = jeng.cfg, jeng.window, jeng.packed
    fn = _JITS.setdefault(key, jax.jit(
        lambda p, c, t, m, sid: jT.decode_step(
            cfg, p, c, t, window=window, token_mask=m, ep_shard_ids=sid,
            ep_n_shards=n_sh, moe_packed=packed)))
    jeng._prefill = _JITS.setdefault((cfg, window), jeng._prefill)
    if jeng._replica_routes is not None:
        jeng._decode = fn
    else:
        sid = jnp.asarray(jeng.placement.primary_shard_of, jnp.int32)
        jeng._decode = lambda p, c, t, m: fn(p, c, t, m, sid)
    return jeng


@pytest.fixture(scope="module")
def tiny(tiny_moe):
    cfg, jparams = tiny_moe
    return cfg, jparams, params_from_numpy(jax.device_get(jparams),
                                           device="cpu")


def _tiny_prompts(n):
    """Repeated 4-token patterns: the n-gram drafter proposes on every
    pass (the offload engine tests' prompts for `tiny_moe`)."""
    rng = np.random.default_rng(7)
    return [[int(t) for t in rng.integers(3, 40, 4)] * 5 for _ in range(n)]


def _ep_placement(m, kind, e):
    if kind == "contiguous":
        return m.ExpertPlacement.contiguous(e, 2)
    if kind == "sizes":
        return m.ExpertPlacement.from_sizes((3, 1))
    # an expert of each shard also held on the other: whichever shard is
    # cooler, one route flips
    return m.ExpertPlacement.contiguous(e, 2).replicate({0: 1, e - 1: 0})


@pytest.mark.parametrize("kind", ["contiguous", "sizes", "replicated"])
def test_ep_engine_streams_and_telemetry_equal_jax(tiny, kind):
    """Four rows asking K=4 under the joint planner (its steering reads
    each row's measured shard profile), packed verification, five
    requests so that a row is recycled: streams, every telemetry field
    and `replica_moves` equal the reference's; the per-shard counts
    partition the union and the pass is priced at its hottest shard plus
    the all-to-all. On `tiny_moe`, as the offload engine tests: its
    float32 argmax margins hold these streams equal, and it costs no
    training."""
    cfg, jp, tp = tiny
    fields = dataclasses.asdict(tcm.H100_SXM)
    jhw, thw = jcm.Hardware(**fields), tcm.Hardware(**fields)
    common = dict(max_batch=4, max_len=256, temperature=0.0, clock="model",
                  packed=True, seed=0)
    jeng = _shared_ep_decode(JBatched(
        cfg, jp, hw=jhw, controller_factory=lambda: JStatic(4),
        placement=_ep_placement(jcm, kind, cfg.num_experts), **common))
    teng = BatchedEngine(cfg, tp, hw=thw,
                         controller_factory=lambda: StaticKController(4),
                         placement=_ep_placement(tcm, kind, cfg.num_experts),
                         device="cpu", **common)
    prompts = _tiny_prompts(5)
    max_new = [12] * 5
    jres_, jpred = _serve(jeng, prompts, max_new, {})
    tres_, tpred = _serve(teng, prompts, max_new, {})
    assert tpred == jpred
    assert sorted(tres_) == sorted(jres_)
    for i in jres_:
        assert tres_[i].tokens == jres_[i].tokens
        assert ([dataclasses.asdict(it) for it in tres_[i].telemetry.iterations]
                == [dataclasses.asdict(it)
                    for it in jres_[i].telemetry.iterations])
    assert ([dataclasses.asdict(s) for s in teng.telemetry.steps]
            == [dataclasses.asdict(s) for s in jeng.telemetry.steps])
    assert teng.now == jeng.now
    assert teng.replica_moves == jeng.replica_moves
    its = [it for r in tres_.values() for it in r.telemetry.iterations]
    assert sum(it.k_drafted for it in its) > 0
    steps = teng.telemetry.steps
    for st in steps:
        assert len(st.shard_experts) == 2 and st.hot_shard >= 0
        assert sum(st.shard_experts) == pytest.approx(st.union_experts)
        assert st.max_shard_experts == max(st.shard_experts)
        assert st.t_a2a > 0.0
    assert teng.telemetry.mean_shard_imbalance >= 1.0
    if kind == "replicated":
        assert teng.replica_moves > 0      # the route really flips
