"""The port's continuous-batching path on the CPU against the JAX package:
per-row caches (`init_cache(per_row=True)`, `write_cache_row`,
`clear_cache_row`, ragged `decode_step` with a token mask, `prefill_chunk`,
per-row `rollback_cache`), the batch cost model and the joint planner, and
`BatchedEngine` itself on `trained_tiny_moe` (float32; its greedy argmax
margins are wide), with bf16-stored and int8 experts.

Logits at atol = rtol = 1e-4 of max(1, max|ref|) (a few float32 layers
summed in another order); cache positions, lengths and every routing count
exactly equal. The cost model and planner are the same float arithmetic on
the same inputs, so their numbers are equal to the bit. The engines'
token streams and every `IterationTelemetry` and `StepTelemetry` field are
exactly equal under `clock="model"`: once tokens and routing agree, every
time they report is that arithmetic."""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import cost_model as jcm
from repro.core import planner as jplanner
from repro.core.controller import CascadeController as JCascade
from repro.core.controller import StaticKController as JStatic
from repro.core.controller import cascade_for_model as j_cascade_for_model
from repro.core.slo import RequestSLO as JSLO
from repro.models import transformer as jT
from repro.models.moe import quantize_transformer_experts as jquantize
from repro.serving.engine import BatchedEngine as JBatched
from repro.serving.telemetry import percentile as jpercentile
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import cost_model as tcm
from repro_torch.core import planner as tplanner
from repro_torch.core.controller import CascadeController, StaticKController
from repro_torch.core.controller import cascade_for_model
from repro_torch.core.slo import RequestSLO
from repro_torch.models import transformer as tT
from repro_torch.serving import BatchedEngine, percentile

PASS_TOL = 1e-4
PERIOD = 32


def _allclose(actual, ref, tol=PASS_TOL):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(actual.detach().numpy(), ref, rtol=tol,
                               atol=tol * scale)


def _eq(actual, ref):
    np.testing.assert_array_equal(actual.detach().numpy(), np.asarray(ref))


def _hw_pair():
    fields = dataclasses.asdict(tcm.H100_SXM)
    return jcm.Hardware(**fields), tcm.Hardware(**fields)


@pytest.fixture(scope="module")
def trained(trained_tiny_moe):
    cfg, jparams, _ = trained_tiny_moe
    return cfg, jparams, params_from_numpy(jax.device_get(jparams),
                                           device="cpu")


# --------------------------------------------------------------------- #
# Per-row caches (level 2)
# --------------------------------------------------------------------- #

def _check_cache(tc, jc):
    _eq(tc["pos"], jc["pos"])
    _eq(tc["lengths"], jc["lengths"])
    assert int(tc["length"]) == int(jc["length"])


@pytest.mark.parametrize("packed", [False, True])
def test_per_row_cache_ragged_pass_chunk_and_rollback_match(trained, packed):
    cfg, jp, tp = trained
    rng = np.random.default_rng(21)
    b, max_len = 3, 64
    jc = jT.init_cache(cfg, b, max_len, per_row=True)
    tc = tT.init_cache(cfg, b, max_len, per_row=True, device="cpu")
    _check_cache(tc, jc)
    # join rows 0 and 2 with prompts of different lengths (blocking prefill
    # into a batch-1 cache, then copied into the row); row 1 stays empty
    for slot, n in ((0, 9), (2, 14)):
        prompt = rng.integers(3, cfg.vocab_size, (1, n)).astype(np.int32)
        jrow = jT.init_cache(cfg, 1, max_len)
        jlo, jrow, _ = jT.prefill(cfg, jp, jnp.asarray(prompt), jrow)
        trow = tT.init_cache(cfg, 1, max_len, device="cpu")
        tlo, trow, _ = tT.prefill(cfg, tp, torch.from_numpy(prompt), trow)
        _allclose(tlo, jlo)
        jc = jT.write_cache_row(jc, slot, jrow)
        tc = tT.write_cache_row(tc, slot, trow)
        _check_cache(tc, jc)

    # one padded pass: row 0 a [1+2] span, row 1 a 5-token prompt chunk
    # (its first), row 2 a [1+4] span; padding is masked out of the union
    toks = rng.integers(3, cfg.vocab_size, (b, 5)).astype(np.int32)
    mask = np.array([[1, 1, 1, 0, 0], [1] * 5, [1] * 5], bool)
    keys = ("unique_experts", "unique_experts_row", "experts_active")
    jlo, jc2, jaux, _ = jT.decode_step(cfg, jp, jc, jnp.asarray(toks),
                                       token_mask=jnp.asarray(mask),
                                       moe_packed=packed)
    lengths_before = np.array(jc["lengths"])
    tlo, tc2, taux, staged = tT.decode_step(
        cfg, tp, tc, torch.from_numpy(toks),
        token_mask=torch.from_numpy(mask), moe_packed=packed)
    assert staged is None
    _allclose(tlo, jlo)
    for key in keys:
        _eq(taux[key], jaux[key])
    _check_cache(tc2, jc2)

    # per-row rollback: each row keeps its own accepted prefix
    n_keep = np.array([2, 5, 1], np.int32)
    jc3 = jT.rollback_cache(cfg, jc2, None, jnp.asarray(n_keep),
                            jnp.asarray(lengths_before))
    tc3 = tT.rollback_cache(cfg, tc2, None, torch.from_numpy(n_keep),
                            torch.from_numpy(lengths_before))
    _check_cache(tc3, jc3)

    # the second chunk of row 1 through prefill_chunk, the others idle
    chunk = rng.integers(3, cfg.vocab_size, (b, 4)).astype(np.int32)
    cmask = np.array([[0] * 4, [1, 1, 1, 0], [0] * 4], bool)
    jlo, jc4, jaux, _ = jT.prefill_chunk(cfg, jp, jc3, jnp.asarray(chunk),
                                         token_mask=jnp.asarray(cmask))
    tlo, tc4, taux, _ = tT.prefill_chunk(cfg, tp, tc3,
                                         torch.from_numpy(chunk),
                                         token_mask=torch.from_numpy(cmask))
    _allclose(tlo[1, :3], jlo[1, :3])
    for key in keys:
        _eq(taux[key], jaux[key])
    _check_cache(tc4, jc4)

    # retire row 0; a scalar rollback rewinds every row alike
    jc5 = jT.clear_cache_row(jc4, 0)
    tc5 = tT.clear_cache_row(tc4, 0)
    _check_cache(tc5, jc5)
    jc6 = jT.rollback_cache(cfg, jc5, None, 2, 10)
    tc6 = tT.rollback_cache(cfg, tc5, None, 2, 10)
    _check_cache(tc6, jc6)


# --------------------------------------------------------------------- #
# Batch cost model, K prior and planner (same arithmetic, equal to the bit)
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("precision", [None, "int8"])
def test_batch_cost_model_matches_reference(precision):
    jp_ = jcm.Precision.int8_experts() if precision else None
    tp_ = tcm.Precision.int8_experts() if precision else None
    jhw, thw = _hw_pair()
    for name in ("mixtral-8x7b", "olmoe-1b-7b"):
        jcfg, tcfg = jax_get_config(name), get_config(name)
        cases = [
            dict(tokens=[5, 1, 3, 0], ctx=[300, 17, 1024, 0]),
            dict(tokens=[5, 64, 2], ctx=[300, 0, 2000], pre=[0, 64, 0],
                 uniq=5.5, per_row=[2.0, 7.5, 3.0]),
            dict(tokens=[1], ctx=[512]),
            dict(tokens=[17, 4], ctx=[40, 90], affinity=0.3, window=64),
        ]
        for c in cases:
            kw = dict(unique_experts=c.get("uniq"),
                      per_request_unique=c.get("per_row"),
                      affinity=c.get("affinity", 0.0),
                      window=c.get("window", 0),
                      prefill_tokens=c.get("pre"))
            assert tcm.batch_iteration_time(
                tcfg, thw, c["tokens"], c["ctx"], precision=tp_, **kw) == \
                jcm.batch_iteration_time(jcfg, jhw, c["tokens"], c["ctx"],
                                         precision=jp_, **kw)
            okw = dict(affinity=kw["affinity"], window=kw["window"],
                       prefill_tokens=c.get("pre"))
            to = tcm.BatchCostOracle(tcfg, thw, c["ctx"], precision=tp_,
                                     **okw)
            jo = jcm.BatchCostOracle(jcfg, jhw, c["ctx"], precision=jp_,
                                     **okw)
            for ns in (c["tokens"], [n + 2 for n in c["tokens"]]):
                assert to.t_batch(ns) == jo.t_batch(ns)
        assert tcm.expected_unique_experts_batch(8, 2, [5, 1, 0, 9], 0.2) == \
            jcm.expected_unique_experts_batch(8, 2, [5, 1, 0, 9], 0.2)


def test_k_prior_matches_reference():
    jhw, thw = _hw_pair()
    for name in ("mixtral-8x7b", "olmoe-1b-7b"):
        jcfg, tcfg = jax_get_config(name), get_config(name)
        for k in range(6):
            for a in (0.0, 0.3, 0.9, 1.0):
                assert tcm.expected_emitted(a, k) == jcm.expected_emitted(a, k)
                assert tcm.expected_utility(tcfg, thw, k, a) == \
                    jcm.expected_utility(jcfg, jhw, k, a)
            curve = [0.9, 0.7, 0.4]
            assert tcm.expected_emitted_curve(curve, k) == \
                jcm.expected_emitted_curve(curve, k)
        assert tcm.suggest_k_start(tcfg, thw) == \
            jcm.suggest_k_start(jcfg, jhw)
        assert tcm.suggest_k_start(tcfg) == jcm.suggest_k_start(jcfg, jhw)
        assert cascade_for_model(tcfg).config.k_start == \
            j_cascade_for_model(jcfg, jhw).config.k_start
    assert percentile([3.0, 1.0, 2.0, 9.0], 0.95) == \
        jpercentile([3.0, 1.0, 2.0, 9.0], 0.95)


class _Analyzer:
    def __init__(self, a):
        self.a = a

    def accept_rate(self, n=None):
        return self.a

    def accept_curve(self, max_k, n=None):
        return None if self.a is None else [self.a * 0.9 ** j
                                            for j in range(max_k)]


class _Ctl:
    """A controller stand-in the planner reads: phase, ask, held ask and
    the analyzer's acceptance. Stateless, so both planners see the same."""

    def __init__(self, phase, k, hold_k=0, accept=None):
        self.phase, self.k, self.hold_k = phase, k, hold_k
        self.analyzer = _Analyzer(accept)

    def next_k(self):
        return self.k

    def hold(self):
        return self.hold_k


@pytest.mark.parametrize("config", [
    dict(), dict(policy="independent"), dict(use_accept_curve=True),
    dict(util_floor=0.5, latency_tier_weight=1.0),
    dict(stagger_tests=False),
])
@pytest.mark.parametrize("precision", [None, "int8"])
def test_planner_plans_match_reference(config, precision):
    jhw, thw = _hw_pair()
    jcfg, tcfg = (jax_get_config("mixtral-8x7b"),
                  get_config("mixtral-8x7b"))
    jp_ = jcm.Precision.int8_experts() if precision else None
    tp_ = tcm.Precision.int8_experts() if precision else None
    jpl = jplanner.BatchSpecPlanner(
        jcfg, jhw, config=jplanner.PlannerConfig(**config), precision=jp_)
    tpl = tplanner.BatchSpecPlanner(
        tcfg, thw, config=tplanner.PlannerConfig(**config), precision=tp_)
    scenarios = [
        # four decode rows, two in TEST (staggered), one with no history
        (dict(c0=("set", 4, 0, 0.9), c1=("test", 6, 2, 0.6),
              c2=("test", 3, 1, 0.3), c3=("set", 5, 0, None)),
         [300, 512, 40, 1000], {}, {}),
        # a prefill chunk shares the pass; an SLO-bounded latency row
        (dict(c0=("set", 4, 0, 0.95), c2=("set", 7, 0, 0.8)),
         [100, 0, 700], {1: 64},
         {0: ("latency", 2e-3), 2: ("throughput", None)}),
        # one span: the planner is bypassed
        (dict(c1=("set", 5, 0, 0.5)), [0, 64], {}, {}),
        # an infeasible bound cannot freeze the batch
        (dict(c0=("test", 4, 0, 0.99), c1=("set", 4, 0, 0.99)),
         [2000, 2000], {}, {1: ("latency", 1e-6)}),
    ]
    for ctls, lens, pre, slos in scenarios:
        ctl = {int(k[1:]): _Ctl(*v) for k, v in ctls.items()}
        for _ in range(2):   # the stagger pointer advances between plans
            jplan = jpl.plan(ctl, lens, prefill_tokens=pre,
                             slos={i: JSLO(tier=t, tpot=b)
                                   for i, (t, b) in slos.items()})
            tplan = tpl.plan(ctl, lens, prefill_tokens=pre,
                             slos={i: RequestSLO(tier=t, tpot=b)
                                   for i, (t, b) in slos.items()})
            assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan)


# --------------------------------------------------------------------- #
# BatchedEngine (level 3)
# --------------------------------------------------------------------- #

def _prompts(n, vocab=128, seed=7):
    """Periodic-copy prompts of different lengths, the trained task."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = rng.integers(3, vocab, PERIOD).tolist()
        out.append([1] + p + p + p[:5 + 3 * i])
    return out


def _serve(eng, prompts, max_new, slos, stop_token=None):
    """Continuous batching: join while a row is free, step, retire what
    finished. Returns the results by prompt index, and the engine's
    predicted service time of each prompt just before it joined."""
    pending, live, done, predicted = list(enumerate(prompts)), {}, {}, []
    while pending or live:
        while pending and eng.free_slots:
            i, p = pending.pop(0)
            predicted.append(eng.predicted_service_time(len(p)))
            live[eng.join(p, max_new[i], request_id=str(i),
                          slo=slos.get(i), stop_token=stop_token)] = i
        eng.step()
        for slot, i in list(live.items()):
            if eng.slots[slot].done:
                done[i] = eng.retire(slot)
                del live[slot]
    return done, predicted


def _run_pair(trained, *, precision=None, drafter_precision=None,
              controller="cascade", n=6, slo_tpot=None, stop_token=None,
              **kw):
    """The reference engine and the port's on the same prompts. An "int8"
    precision quantizes the experts (and prices them at 1 byte); an "int8"
    drafter precision prices the drafter's weights at 1 byte; `slo_tpot`
    bounds the TPOT of the even-numbered requests (latency tier);
    `stop_token` ends every request at that token; other keywords go to
    both engines (they may override the greedy temperature)."""
    cfg, jp, tp = trained
    jhw, thw = _hw_pair()
    if drafter_precision == "int8":
        kw_j = dict(drafter_precision=jcm.Precision(dense=1))
        kw_t = dict(drafter_precision=tcm.Precision(dense=1))
    else:
        kw_j, kw_t = {}, {}
    jparams, tparams, jprec, tprec = jp, tp, None, None
    if precision == "int8":
        jparams = jquantize(jp, "int8")
        tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
        jprec, tprec = jcm.Precision.int8_experts(), \
            tcm.Precision.int8_experts()
    if controller == "cascade":
        jfac, tfac = JCascade, CascadeController
    else:
        jfac, tfac = (lambda: JStatic(4)), (lambda: StaticKController(4))
    common = {"max_len": 256, "temperature": 0.0, "clock": "model", **kw}
    jeng = JBatched(cfg, jparams, hw=jhw, precision=jprec,
                    controller_factory=jfac, **kw_j, **common)
    teng = BatchedEngine(cfg, tparams, hw=thw, precision=tprec,
                         controller_factory=tfac, device="cpu", **kw_t,
                         **common)
    prompts = _prompts(n)
    max_new = [20 + 4 * (i % 3) for i in range(n)]
    bounded = range(0, n, 2) if slo_tpot else ()
    jres, jpred = _serve(jeng, prompts, max_new,
                         {i: JSLO(tier="latency", tpot=slo_tpot)
                          for i in bounded}, stop_token)
    tres, tpred = _serve(teng, prompts, max_new,
                         {i: RequestSLO(tier="latency", tpot=slo_tpot)
                          for i in bounded}, stop_token)
    assert tpred == jpred
    return jeng, jres, teng, tres


def _assert_same(jeng, jres, teng, tres):
    assert sorted(tres) == sorted(jres)
    for i in jres:
        assert tres[i].tokens == jres[i].tokens
        jt, tt = jres[i].telemetry, tres[i].telemetry
        assert ([dataclasses.asdict(it) for it in tt.iterations]
                == [dataclasses.asdict(it) for it in jt.iterations])
        for f in ("t_prefill", "t_queue", "ttft", "prefill_chunks", "tier",
                  "slo_tpot"):
            assert getattr(tt, f) == getattr(jt, f)
    assert ([dataclasses.asdict(s) for s in teng.telemetry.steps]
            == [dataclasses.asdict(s) for s in jeng.telemetry.steps])
    assert teng.now == jeng.now
    # the trained model really speculates: drafts were accepted
    its = [it for r in tres.values() for it in r.telemetry.iterations]
    assert sum(it.tokens_emitted for it in its) > len(its)


@pytest.mark.parametrize("precision", [None, "int8"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("max_batch", [1, 4])
def test_batched_engine_streams_and_telemetry_equal_jax(trained, max_batch,
                                                        packed, precision):
    jeng, jres, teng, tres = _run_pair(
        trained, precision=precision, max_batch=max_batch, packed=packed,
        n=3 if max_batch == 1 else 6)
    _assert_same(jeng, jres, teng, tres)
    if max_batch > 1:
        assert max(s.occupancy for s in teng.telemetry.steps) == max_batch
    if precision == "int8":
        assert all(s.precision == "int8-experts" and s.expert_bytes_saved > 0
                   for s in teng.telemetry.steps)


@pytest.mark.parametrize("case", [
    dict(chunk=16, packed=True, precision="int8"),
    dict(chunk=8, max_prefill_tokens_per_step=12),
    dict(policy="independent", controller="static"),
    dict(drafter_precision="int8", packed=True),
    dict(slo_tpot=1e-4),
    dict(slo_tpot=1e-4, chunk=16),
])
def test_batched_engine_chunked_policies_and_drafter_precision_equal_jax(
        trained, case):
    jeng, jres, teng, tres = _run_pair(trained, max_batch=4, **case)
    _assert_same(jeng, jres, teng, tres)
    if case.get("chunk"):
        assert all(r.telemetry.prefill_chunks > 1 for r in tres.values())
    if case.get("slo_tpot"):   # the bound really constrains the grants
        assert sum(s.slo_denied for s in teng.telemetry.steps) > 0


@pytest.mark.parametrize("case", [
    dict(temperature=0.8),                 # rejection sampling, seeded
    dict(window=16),                       # the rings wrap
    dict(window=16, chunk=8),
    dict(stop_token="p10"),
    dict(affinity=0.3),
])
def test_batched_engine_sampling_windows_stop_and_affinity_equal_jax(
        trained, case):
    """Paths beside the greedy full-attention stream: at temperature 0.8
    both engines draw from the same seeded generator; a 16-token window is
    shorter than every prompt, so the rings wrap; "p10" stops each request
    at the 11th token of the first prompt's pattern."""
    case = dict(case)
    if case.get("stop_token") == "p10":
        case["stop_token"] = _prompts(1)[0][1 + 10]
    jeng, jres, teng, tres = _run_pair(trained, max_batch=4, **case)
    _assert_same(jeng, jres, teng, tres)
    if "stop_token" in case:
        assert any(r.tokens[-1] == case["stop_token"] for r in tres.values())
    if case.get("chunk"):
        assert all(r.telemetry.prefill_chunks > 1 for r in tres.values())


def test_quantized_reference_tree_crosses_over(trained):
    """A tree from the reference's quantize_transformer_experts (int8
    [L,E,...] codes, float32 [L,E] scales) converts unchanged and runs."""
    cfg, jp, _ = trained
    jq = jax.device_get(jquantize(jp, "int8"))
    tq = params_from_numpy(jq, device="cpu")
    moe = tq["blocks"]["moe"]
    assert moe["w_up_q8"].dtype == torch.int8
    assert moe["w_up_s"].dtype == torch.float32
    assert tuple(moe["w_up_s"].shape) == (cfg.num_layers, cfg.num_experts)
    for k, v in jq["blocks"]["moe"].items():
        _eq(moe[k], v)
    toks = np.array([[1, 5, 9, 12, 7, 3]], np.int32)
    jc = jT.init_cache(cfg, 1, 32)
    tc = tT.init_cache(cfg, 1, 32, device="cpu")
    jlo, _, _ = jT.prefill(cfg, jq, jnp.asarray(toks), jc)
    tlo, _, _ = tT.prefill(cfg, tq, torch.from_numpy(toks), tc)
    _allclose(tlo, jlo)


def test_batched_engine_refuses_what_is_not_ported(trained):
    cfg, _, tp = trained
    with pytest.raises(NotImplementedError, match="M5"):
        BatchedEngine(cfg, tp, device="cpu",
                      placement=SimpleNamespace(n_shards=2))
    with pytest.raises(NotImplementedError, match="M4"):
        BatchedEngine(cfg, tp, device="cpu",
                      residency=SimpleNamespace(has_host_tier=True))
    with pytest.raises(ValueError, match="policy"):
        BatchedEngine(cfg, tp, device="cpu", policy="greedy")
    eng = BatchedEngine(cfg, tp, device="cpu", max_batch=1, max_len=64,
                        placement=SimpleNamespace(n_shards=1))
    eng.join([1, 2, 3], 4)
    with pytest.raises(RuntimeError, match="free slot"):
        eng.join([1, 2, 3], 4)
    with pytest.raises(KeyError):
        eng.retire(3)
