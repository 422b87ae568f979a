"""The port's open-loop serving slice against the JAX package on the CPU:
the wall-clock `Calibration` and its threading through the cost model, the
planner and `BatchedEngine(planner=)`; `prefill_crossover_tokens` and
`moe_pass_counters`; the admission constraints; `Scheduler`,
`ContinuousBatchingScheduler` (closed batches, open-loop replays that shed
and defer, a replay cut by `max_steps`) and the load harness
(`poisson_arrivals`, `diurnal_arrivals`, `build_trace`, `summarize`).

The engines run `trained_tiny_moe` (float32; wide argmax margins) under
`clock="model"`, both sides pricing the same `Hardware` field values. The
calibration, the cost model and the load harness are the same float
arithmetic on the same inputs, and the engines give the same token streams
and routing counts, so every number compared here is equal to the bit:
token streams, every `RequestTelemetry` and `StepTelemetry` field, every
`summarize(...)` field, the shed and deferred requests and the timeline."""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import cost_model as jcm
from repro.core import planner as jplanner
from repro.core.controller import CascadeController as JCascade
from repro.core.controller import StaticKController as JStatic
from repro.core.slo import RequestSLO as JSLO
from repro.models import moe as jmoe
from repro.models.moe import quantize_transformer_experts as jquantize
from repro.serving import BatchedEngine as JBatched
from repro.serving import ContinuousBatchingScheduler as JCBS
from repro.serving import NGramDrafter as JNGram
from repro.serving import Request as JRequest
from repro.serving import Scheduler as JScheduler
from repro.serving import ServingEngine as JEngine
from repro.serving import load as jload
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import cost_model as tcm
from repro_torch.core import planner as tplanner
from repro_torch.core.controller import CascadeController, StaticKController
from repro_torch.core.slo import RequestSLO
from repro_torch.models import moe as tmoe
from repro_torch.serving import (BatchedEngine, ContinuousBatchingScheduler,
                                 NGramDrafter, Request, Scheduler,
                                 ServingEngine)
from repro_torch.serving import load as tload

PERIOD = 32


def _hw_pair():
    fields = dataclasses.asdict(tcm.H100_SXM)
    return jcm.Hardware(**fields), tcm.Hardware(**fields)


def _cal_pair(cal):
    """The same calibration on both sides."""
    return jcm.Calibration(**dataclasses.asdict(cal)), cal


@pytest.fixture(scope="module")
def trained(trained_tiny_moe):
    cfg, jparams, _ = trained_tiny_moe
    return cfg, jparams, params_from_numpy(jax.device_get(jparams),
                                           device="cpu")


def _prompts(n, vocab=128, seed=7):
    """Periodic-copy prompts of different lengths, the trained task."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = rng.integers(3, vocab, PERIOD).tolist()
        out.append([1] + p + p + p[:5 + 3 * i])
    return out


def _results_equal(tres, jres):
    assert [r.tokens for r in tres] == [r.tokens for r in jres]
    assert ([dataclasses.asdict(r.telemetry) for r in tres]
            == [dataclasses.asdict(r.telemetry) for r in jres])


def _steps_equal(teng, jeng):
    assert ([dataclasses.asdict(s) for s in teng.telemetry.steps]
            == [dataclasses.asdict(s) for s in jeng.telemetry.steps])
    assert teng.now == jeng.now


def _aggregates(sched) -> dict:
    """Every aggregate figure of a continuous-batching scheduler."""
    return {"tokens_per_second": sched.tokens_per_second(),
            "throughput_stats": sched.throughput_stats(),
            "mean_tpot": sched.mean_tpot(),
            "mean_request_utility": sched.mean_request_utility(),
            "mean_ttft": sched.mean_ttft(),
            "mean_queue_delay": sched.mean_queue_delay(),
            "planner_stats": sched.planner_stats(),
            "tier_stats": sched.tier_stats(),
            "slo_violations": sched.slo_violations(),
            "deferred": sched.deferred,
            "timeline": sched.timeline}


def _schedulers_equal(tsched, jsched):
    _results_equal(tsched.results, jsched.results)
    _results_equal(tsched.shed_results, jsched.shed_results)
    _steps_equal(tsched.engine, jsched.engine)
    assert _aggregates(tsched) == _aggregates(jsched)


# --------------------------------------------------------------------- #
# Calibration and the cost model
# --------------------------------------------------------------------- #

def _pairs(case):
    rng = np.random.default_rng(5)
    if case == "plain":
        pred = (1e-3 * (1 + rng.random(40))).tolist()
        meas = [2.3 * p + 4e-4 + 1e-5 * rng.standard_normal()
                for p in pred]
        return pred, meas, None
    if case == "a2a":
        base = 1e-3 * (1 + rng.random(30))
        a2a = 2e-4 * rng.integers(0, 4, 30)
        meas = 0.8 * base + 1.5 * a2a + 1e-4 + 1e-6 * rng.random(30)
        return (base + a2a).tolist(), meas.tolist(), a2a.tolist()
    if case == "constant":          # rank-deficient, solved by the ridge
        return [1e-3] * 8, [1.3e-3] * 8, None
    # so many equal pairs that the ridge is lost in the rounding: the
    # elimination meets an exact zero pivot, and the fit falls back to the
    # identity transform
    return [1.0] * 65536, [2.0] * 65536, None


@pytest.mark.parametrize("case", ["plain", "a2a", "constant", "identity"])
def test_calibration_fit_apply_and_floor_match_reference(case):
    pred, meas, a2a = _pairs(case)
    jcal = jcm.Calibration.fit(pred, meas, a2a)
    tcal = tcm.Calibration.fit(pred, meas, a2a)
    assert dataclasses.asdict(tcal) == dataclasses.asdict(jcal)
    for t, aa in ((1e-3, 0.0), (5e-3, 1e-3), (0.0, 0.0), (1e-6, 0.0)):
        assert tcal.apply(t, aa) == jcal.apply(t, aa)
    for base in (1.0, 1.2):
        assert tcal.adapted_util_floor(base) == jcal.adapted_util_floor(base)
    if case == "plain":
        assert tcal.resid_after < tcal.resid_before
    if case == "identity":
        assert (tcal.time_scale, tcal.time_offset) == (1.0, 0.0)
        assert tcal.resid_after == tcal.resid_before == 0.5
    with pytest.raises(ValueError):
        tcm.Calibration.fit(pred, meas[:-1])
    with pytest.raises(ValueError):
        tcm.Calibration.fit([], [])


@pytest.mark.parametrize("precision", [None, "int8"])
def test_calibrated_batch_cost_and_oracle_match_reference(precision):
    jhw, thw = _hw_pair()
    jcal, tcal = _cal_pair(tcm.Calibration(time_scale=1.7,
                                           time_offset=3e-4,
                                           resid_after=0.05))
    jprec = jcm.Precision.int8_experts() if precision else None
    tprec = tcm.Precision.int8_experts() if precision else None
    for arch in ("mixtral-8x7b", "olmoe-1b-7b"):
        jcfg, tcfg = jax_get_config(arch), get_config(arch)
        ctx = [300, 0, 1024, 77]
        pre = [0, 64, 0, 0]
        for ns in ([1, 64, 5, 3], [0, 64, 1, 0], [8, 64, 8, 8]):
            for cal_j, cal_t in ((None, None), (jcal, tcal)):
                jr = jcm.batch_iteration_time(
                    jcfg, jhw, ns, ctx, prefill_tokens=pre,
                    calibration=cal_j, precision=jprec)
                tr = tcm.batch_iteration_time(
                    tcfg, thw, ns, ctx, prefill_tokens=pre,
                    calibration=cal_t, precision=tprec)
                assert tr == jr
                jo = jcm.BatchCostOracle(jcfg, jhw, ctx, prefill_tokens=pre,
                                         calibration=cal_j, precision=jprec)
                to = tcm.BatchCostOracle(tcfg, thw, ctx, prefill_tokens=pre,
                                         calibration=cal_t, precision=tprec)
                assert to.t_batch(ns) == jo.t_batch(ns) == tr["t_iter"]
        plain = tcm.batch_iteration_time(tcfg, thw, [1, 1, 1, 1], ctx,
                                         precision=tprec)
        cal = tcm.batch_iteration_time(tcfg, thw, [1, 1, 1, 1], ctx,
                                       calibration=tcal, precision=tprec)
        assert cal["t_iter"] == tcal.apply(plain["t_iter"])


@pytest.mark.parametrize("precision", [None, "int8"])
def test_prefill_crossover_tokens_match_reference(precision):
    jhw, thw = _hw_pair()
    jprec = jcm.Precision.int8_experts() if precision else None
    tprec = tcm.Precision.int8_experts() if precision else None
    found = set()
    for arch in ("mixtral-8x7b", "olmoe-1b-7b", "qwen15-moe-a2.7b"):
        jcfg, tcfg = jax_get_config(arch), get_config(arch)
        for kw in (dict(), dict(context_len=2048), dict(affinity=0.3),
                   dict(window=512, context_len=4096), dict(max_chunk=8)):
            n = tcm.prefill_crossover_tokens(tcfg, thw, precision=tprec,
                                             **kw)
            assert n == jcm.prefill_crossover_tokens(jcfg, jhw,
                                                     precision=jprec, **kw)
            found.add(n)
    assert len(found) > 1


@pytest.mark.parametrize("packed", [False, True])
def test_moe_pass_counters_match_reference(packed):
    jcfg = jax_get_config("mixtral-8x7b").reduced()
    tcfg = get_config("mixtral-8x7b").reduced()
    wide_j = dataclasses.replace(jax_get_config("olmoe-1b-7b"))
    wide_t = get_config("olmoe-1b-7b")
    for (jc, tc) in ((jcfg, tcfg), (wide_j, wide_t)):
        for t in (1, 2, 5, 20, 64, 512):
            for policy in ("exact", "train", "serve"):
                for kw_j, kw_t in (({}, {}),
                                   ({"precision":
                                     jcm.Precision.int8_experts()},
                                    {"precision":
                                     tcm.Precision.int8_experts()})):
                    tr = tmoe.moe_pass_counters(tc, t, packed=packed,
                                                capacity_policy=policy,
                                                **kw_t)
                    assert tr == jmoe.moe_pass_counters(
                        jc, t, packed=packed, capacity_policy=policy,
                        **kw_j)
                    if packed:
                        assert tr["experts_streamed"] == \
                            tmoe.packed_expert_cap(tc, t)


def test_admission_decisions_match_reference():
    slos = [None, (None, None), (1e-2, None), (None, 1e-3),
            (None, 5e-3), (2e-4, 2e-3)]
    for on_doomed in ("shed", "defer"):
        for headroom, max_defers in ((1.0, 8), (1.5, 2)):
            ja = jplanner.PredictiveTTFTAdmission(
                on_doomed=on_doomed, headroom=headroom,
                max_defers=max_defers)
            ta = tplanner.PredictiveTTFTAdmission(
                on_doomed=on_doomed, headroom=headroom,
                max_defers=max_defers)
            for slo in slos:
                js = ts = None
                if slo is not None:
                    js = JSLO(tier="latency", tpot=slo[0], ttft=slo[1])
                    ts = RequestSLO(tier="latency", tpot=slo[0],
                                    ttft=slo[1])
                for delay in (0.0, 1e-3, 4e-3):
                    for svc in (5e-4, 2e-3):
                        for n in (0, 1, 2, 9):
                            kw = dict(queue_delay=delay, service_time=svc,
                                      deferrals=n)
                            assert (dataclasses.asdict(ta.decide(ts, **kw))
                                    == dataclasses.asdict(
                                        ja.decide(js, **kw)))
    base = tplanner.AdmissionConstraint().decide(
        None, queue_delay=1.0, service_time=2.0)
    assert (base.action, base.predicted_ttft) == (tplanner.ADMIT, 3.0)
    assert (tplanner.ADMIT, tplanner.DEFER, tplanner.SHED) == \
        (jplanner.ADMIT, jplanner.DEFER, jplanner.SHED)
    with pytest.raises(ValueError, match="on_doomed"):
        tplanner.PredictiveTTFTAdmission(on_doomed="drop")


# --------------------------------------------------------------------- #
# The load harness
# --------------------------------------------------------------------- #

def _request_dict(req):
    d = dataclasses.asdict(req)
    d["slo"] = None if req.slo is None else dataclasses.asdict(req.slo)
    return d


_SPECS = [
    dict(n_requests=40, rate=25.0, seed=3),
    dict(n_requests=30, arrival="diurnal", rate=4.0, amplitude=0.6,
         period=5.0, mix="code+math", seed=1),
    dict(n_requests=20, prompt_dist="pareto", out_dist="pareto",
         latency_frac=0.3, latency_ttft=0.5, latency_tpot=0.01,
         vocab=64, seed=9),
]


@pytest.mark.parametrize("spec", _SPECS, ids=["poisson", "diurnal",
                                              "pareto"])
def test_arrivals_and_traces_equal_reference(spec):
    for seed in (0, 4):
        for rate, n in ((3.0, 50), (0.5, 7)):
            ta = tload.poisson_arrivals(np.random.default_rng(seed), rate, n)
            assert ta == jload.poisson_arrivals(np.random.default_rng(seed),
                                                rate, n)
            kw = dict(amplitude=0.9, period=7.0)
            assert (tload.diurnal_arrivals(np.random.default_rng(seed),
                                           rate, n, **kw)
                    == jload.diurnal_arrivals(np.random.default_rng(seed),
                                              rate, n, **kw))
    ttrace = tload.build_trace(tload.LoadSpec(**spec))
    jtrace = jload.build_trace(jload.LoadSpec(**spec))
    assert [at for at, _ in ttrace] == [at for at, _ in jtrace]
    assert ([_request_dict(r) for _, r in ttrace]
            == [_request_dict(r) for _, r in jtrace])
    assert tload.LoadSpec(**spec).scaled(2.0).rate == 2.0
    with pytest.raises(ValueError):
        tload.poisson_arrivals(np.random.default_rng(0), 0.0, 3)
    with pytest.raises(ValueError):
        tload.diurnal_arrivals(np.random.default_rng(0), 1.0, 3,
                               amplitude=1.5)
    with pytest.raises(ValueError, match="arrival"):
        tload.build_trace(tload.LoadSpec(arrival="burst"))


# --------------------------------------------------------------------- #
# Engines and schedulers on trained_tiny_moe, clock="model"
# --------------------------------------------------------------------- #

def _engines(trained, *, precision=None, planner_kw=None, **kw):
    """The reference BatchedEngine and the port's on the same params and
    hardware; `planner_kw` builds each side's BatchSpecPlanner (its
    `calibration`, a port `Calibration`, is copied for the reference)."""
    cfg, jp, tp = trained
    jhw, thw = _hw_pair()
    jparams, tparams, jprec, tprec = jp, tp, None, None
    if precision == "int8":
        jparams = jquantize(jp, "int8")
        tparams = params_from_numpy(jax.device_get(jparams), device="cpu")
        jprec, tprec = jcm.Precision.int8_experts(), \
            tcm.Precision.int8_experts()
    common = {"max_len": 256, "temperature": 0.0, "clock": "model", **kw}
    jkw, tkw = {}, {}
    if planner_kw is not None:
        pk = dict(planner_kw)
        tcal = pk.pop("calibration", None)
        jcal = None if tcal is None else _cal_pair(tcal)[0]
        cfgp = pk.pop("config", {})
        jcfgp = jplanner.PlannerConfig(**cfgp)
        tcfgp = tplanner.PlannerConfig(**cfgp)
        jkw["planner"] = jplanner.BatchSpecPlanner(
            cfg, jhw, config=jcfgp, calibration=jcal, precision=jprec)
        tkw["planner"] = tplanner.BatchSpecPlanner(
            cfg, thw, config=tcfgp, calibration=tcal, precision=tprec)
    jeng = JBatched(cfg, jparams, hw=jhw, precision=jprec, **jkw, **common)
    teng = BatchedEngine(cfg, tparams, hw=thw, precision=tprec,
                         device="cpu", **tkw, **common)
    return jeng, teng


def _recording(base):
    """An admission constraint that admits everything and records the
    predicted service time of every join it vets."""
    class Recording(base):
        def __init__(self):
            self.seen = []

        def decide(self, slo, *, queue_delay, service_time, deferrals=0):
            self.seen.append((queue_delay, service_time))
            return super().decide(slo, queue_delay=queue_delay,
                                  service_time=service_time,
                                  deferrals=deferrals)
    return Recording()


def _copy_requests(n, req_cls, slo_cls, *, slo_every=2, max_new=None,
                   **slo_kw):
    """Periodic-copy requests, every `slo_every`-th on the latency tier."""
    reqs = []
    for i, p in enumerate(_prompts(n)):
        slo = (slo_cls(tier="latency", **slo_kw)
               if slo_every and i % slo_every == 1 else None)
        reqs.append(req_cls(request_id=f"r{i}", prompt=p,
                            max_new=(max_new or 12 + 4 * (i % 3)),
                            task=("code", "math", "extract")[i % 3],
                            slo=slo))
    return reqs


@pytest.mark.parametrize("precision", [None, "int8"])
def test_calibrated_engine_streams_and_telemetry_equal_jax(trained,
                                                           precision):
    """BatchedEngine(planner=BatchSpecPlanner(calibration=, util_floor=
    cal.adapted_util_floor(1.0))) under chunked admission: streams, every
    telemetry field and the calibrated predicted service time of every
    join equal the reference's."""
    pred, meas, _ = _pairs("plain")
    cal = tcm.Calibration.fit(pred, meas)
    jeng, teng = _engines(
        trained, precision=precision, max_batch=3, chunk=16,
        planner_kw=dict(calibration=cal, config=dict(
            policy="joint", util_floor=cal.adapted_util_floor(1.0))))
    assert teng.planner.calibration is cal
    jadm, tadm = _recording(jplanner.AdmissionConstraint), \
        _recording(tplanner.AdmissionConstraint)
    jsched = JCBS(jeng, controller_factory=JCascade, admission=jadm)
    tsched = ContinuousBatchingScheduler(
        teng, controller_factory=CascadeController, admission=tadm)
    jsched.run(_copy_requests(6, JRequest, JSLO, slo_every=0))
    tsched.run(_copy_requests(6, Request, RequestSLO, slo_every=0))
    _schedulers_equal(tsched, jsched)
    assert tadm.seen == jadm.seen and len(tadm.seen) == 6
    # the calibrated oracle priced the joins: the service times are the
    # calibration's transform, which adds its offset to every pass
    assert all(svc > cal.time_offset for _, svc in tadm.seen)
    its = [it for r in tsched.results for it in r.telemetry.iterations]
    assert sum(it.tokens_emitted for it in its) > len(its)


def test_engine_refuses_a_planner_that_disagrees_as_the_reference(trained):
    cfg, jp, tp = trained
    jhw, thw = _hw_pair()
    cases = [  # (engine kwargs, planner kwargs, message)
        (dict(policy="independent"), dict(), "policy"),
        (dict(precision="int8"), dict(), "precision"),
        (dict(), dict(precision="int8"), "precision"),
        (dict(drafter_precision="dense1"), dict(), "drafter_precision"),
    ]
    for ekw, pkw, msg in cases:
        sides = []
        for mod, cm_, eng_cls, params, hw, extra in (
                (jplanner, jcm, JBatched, jp, jhw, {}),
                (tplanner, tcm, BatchedEngine, tp, thw, {"device": "cpu"})):
            def conv(kw):
                out = dict(kw)
                if out.get("precision") == "int8":
                    out["precision"] = cm_.Precision.int8_experts()
                if out.get("drafter_precision") == "dense1":
                    out["drafter_precision"] = cm_.Precision(dense=1)
                return out
            planner = mod.BatchSpecPlanner(cfg, hw, **conv(pkw))
            sides.append(lambda e=eng_cls, p=params, pl=planner,
                         kw={**conv(ekw), **extra}:
                         e(cfg, p, planner=pl, max_len=64, **kw))
        for make in sides:
            with pytest.raises(ValueError, match=msg):
                make()
    # agreeing arguments are accepted, and the planner's policy wins
    planner = tplanner.BatchSpecPlanner(
        cfg, thw, config=tplanner.PlannerConfig(policy="independent"))
    eng = BatchedEngine(cfg, tp, planner=planner, device="cpu", max_len=64)
    assert eng.planner is planner and eng.policy == "independent"


def test_closed_mixed_tier_batch_equal_jax(trained):
    """ContinuousBatchingScheduler.run on a closed batch under blocking
    admission, every other request on the latency tier with TPOT and TTFT
    bounds: latency-tier requests jump the queue, the planner honours the
    TPOT bounds, and every result and aggregate equals the reference's."""
    jeng, teng = _engines(trained, max_batch=2)
    bounds = dict(tpot=1.5e-4, ttft=2e-3)
    jsched = JCBS(jeng, controller_factory=JCascade)
    tsched = ContinuousBatchingScheduler(teng,
                                         controller_factory=CascadeController)
    jsched.run(_copy_requests(6, JRequest, JSLO, **bounds))
    tsched.run(_copy_requests(6, Request, RequestSLO, **bounds))
    _schedulers_equal(tsched, jsched)
    # latency-tier r3 jumped the FIFO-earlier r2
    q = {r.telemetry.request_id: r.telemetry.t_queue
         for r in tsched.results}
    assert q["r3"] < q["r2"]
    assert set(tsched.tier_stats()) == {"latency", "throughput"}


_TRACE = dict(n_requests=12, arrival="poisson", rate=3000.0,
              prompt_median=24, prompt_lo=8, prompt_hi=48, out_median=10,
              out_lo=4, out_hi=16, latency_frac=0.5, latency_ttft=1e-3,
              vocab=128, seed=0)


@pytest.mark.parametrize("case", ["shed", "defer", "censored"])
def test_open_loop_replay_equal_jax(trained, case):
    """run_trace on one trace above saturation (arrivals at 3000 requests
    per model-clock second; a single request's TTFT is about 1.6 ms, its
    bound 1 ms) under PredictiveTTFTAdmission that sheds, that defers, and
    cut by max_steps with requests in flight (the censored case)."""
    jeng, teng = _engines(trained, max_batch=3, chunk=16)
    on_doomed = "defer" if case == "defer" else "shed"
    max_steps = 12 if case == "censored" else None
    jsched = JCBS(jeng, controller_factory=JCascade,
                  admission=jplanner.PredictiveTTFTAdmission(
                      on_doomed=on_doomed))
    tsched = ContinuousBatchingScheduler(
        teng, controller_factory=CascadeController,
        admission=tplanner.PredictiveTTFTAdmission(on_doomed=on_doomed))
    jrep = jload.run_load(jsched, jload.LoadSpec(**_TRACE),
                          max_steps=max_steps)
    trep = tload.run_load(tsched, tload.LoadSpec(**_TRACE),
                          max_steps=max_steps)
    assert trep == jrep
    _schedulers_equal(tsched, jsched)
    assert [r.request_id for r in tsched.queue] == \
        [r.request_id for r in jsched.queue]
    if case == "shed":
        assert trep["n_shed"] > 0 and trep["n_served"] + \
            trep["n_shed"] == _TRACE["n_requests"]
    if case == "defer":
        assert trep["n_deferred"] > 0 and trep["n_shed"] == 0
    if case == "censored":
        assert trep["throughput"]["censored"]
        assert trep["n_served"] + trep["n_shed"] < _TRACE["n_requests"]
        assert trep["throughput"]["inflight_tokens"] > 0


@pytest.mark.parametrize("policy", ["cascade", "static"])
def test_single_request_scheduler_equal_jax(trained, policy):
    """Scheduler over ServingEngine (the launcher's path): results,
    tokens_per_second and mean_tpot equal the reference's."""
    cfg, jp, tp = trained
    jhw, thw = _hw_pair()
    if policy == "cascade":
        jfac, tfac = JCascade, CascadeController
    else:
        jfac, tfac = (lambda: JStatic(4)), (lambda: StaticKController(4))
    kw = dict(max_len=256, temperature=0.0, clock="model")
    jsched = JScheduler(JEngine(cfg, jp, JNGram(), hw=jhw, **kw),
                        controller_factory=jfac,
                        share_controller_across_requests=True)
    tsched = Scheduler(ServingEngine(cfg, tp, NGramDrafter(), hw=thw,
                                     device="cpu", **kw),
                       controller_factory=tfac,
                       share_controller_across_requests=True)
    jsched.run(_copy_requests(3, JRequest, JSLO, slo_every=0, max_new=24))
    tsched.run(_copy_requests(3, Request, RequestSLO, slo_every=0,
                              max_new=24))
    _results_equal(tsched.results, jsched.results)
    assert tsched.tokens_per_second() == jsched.tokens_per_second() > 0
    assert tsched.mean_tpot() == jsched.mean_tpot()
    its = [it for r in tsched.results for it in r.telemetry.iterations]
    assert sum(it.tokens_emitted for it in its) > len(its)
