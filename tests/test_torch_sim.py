"""The port's speculation simulator against the JAX package's: the same
seed, config and `Hardware` field values give the same acceptance draws,
the same routing draws, the same controller decisions and the same cost
model times, so every `SimIteration` of `run_request`, `run_workload` and
`run_point` is equal to the bit, for the paper's five MoE configs. The
port prices for `H100_SXM` by default, never for a TPU."""

import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import cost_model as jcm
from repro.core.controller import CascadeController as JCascade
from repro.core.controller import StaticKController as JStatic
from repro.core.manager import CascadeConfig as JCascadeConfig
from repro.sim import simulator as jsim
from repro.sim import tasks as jtasks
from repro_torch.configs import get_config
from repro_torch.core import cost_model as tcm
from repro_torch.core.controller import CascadeController, StaticKController
from repro_torch.core.manager import CascadeConfig
from repro_torch.sim import simulator as tsim
from repro_torch.sim import tasks as ttasks
from test_torch_guards import torch_one_thread  # noqa: F401,E402 (autouse)

PAPER_MOES = ["mixtral-8x7b", "phi-3.5-moe", "olmoe-1b-7b",
              "deepseek-moe-16b", "qwen15-moe-a2.7b"]


def _hw_pair():
    fields = dataclasses.asdict(tcm.H100_SXM)
    return jcm.Hardware(**fields), tcm.Hardware(**fields)


def _reqs(reqs):
    return [dataclasses.asdict(r) for r in reqs]


def test_simulator_defaults_to_h100():
    sim = tsim.SpeculationSimulator(get_config("mixtral-8x7b"))
    assert sim.hw is tcm.H100_SXM and sim.hw.name == "h100-sxm"
    assert not hasattr(tcm, "TPU_V5E")


def test_acceptance_and_routing_processes_match_reference():
    for task in ("code", "math", "extract"):
        assert (dataclasses.asdict(ttasks.TASK_PROCESSES[task])
                == dataclasses.asdict(jtasks.TASK_PROCESSES[task]))
        for boost in (0.0, 0.2):
            ja = jtasks.AcceptanceProcess(jtasks.TASK_PROCESSES[task],
                                          np.random.default_rng(2), boost)
            ta = ttasks.AcceptanceProcess(ttasks.TASK_PROCESSES[task],
                                          np.random.default_rng(2), boost)
            assert [ta.step() for _ in range(300)] == \
                [ja.step() for _ in range(300)]
        for model in PAPER_MOES + ["unknown"]:
            assert ttasks.effective_affinity(model, task) == \
                jtasks.effective_affinity(model, task)
    for e, k, aff in ((8, 2, 0.12), (64, 8, 0.8), (60, 4, 0.0)):
        jr = jtasks.RoutingSimulator(e, k, aff, np.random.default_rng(7))
        tr = ttasks.RoutingSimulator(e, k, aff, np.random.default_rng(7))
        for n in (1, 2, 5, 8, 3, 1):
            assert tr.unique_for(n) == jr.unique_for(n)


@pytest.mark.parametrize("arch", PAPER_MOES)
def test_run_request_and_workload_match_reference(arch):
    jhw, thw = _hw_pair()
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    for drafter in ("ngram", "eagle"):
        jsm = jsim.SpeculationSimulator(jcfg, hw=jhw, drafter=drafter,
                                        seed=4, context_len=512)
        tsm = tsim.SpeculationSimulator(tcfg, hw=thw, drafter=drafter,
                                        seed=4, context_len=512)
        assert tsm.drafter_params == jsm.drafter_params
        for task in ("code", "math", "extract"):
            jr = jsm.run_request(task, 48, JCascade())
            tr = tsm.run_request(task, 48, CascadeController())
            assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
            assert (tr.output_tokens, tr.decode_time) == \
                (jr.output_tokens, jr.decode_time)
        jw = jsm.run_workload(["code", "math"], n_requests=3,
                              iters_per_request=32,
                              controller_factory=lambda: JStatic(3))
        tw = tsm.run_workload(["code", "math"], n_requests=3,
                              iters_per_request=32,
                              controller_factory=lambda: StaticKController(3))
        assert _reqs(tw) == _reqs(jw)
        assert tsim.tpot_speedup(tw, tw[:1]) == jsim.tpot_speedup(jw, jw[:1])


@pytest.mark.parametrize("arch", PAPER_MOES)
def test_run_point_matches_reference(arch, monkeypatch):
    """run_point builds its simulators with the default `hw`; the
    reference's default (a TPU) is set to the port's H100 fields for the
    comparison."""
    jhw, _ = _hw_pair()
    monkeypatch.setitem(jsim.SpeculationSimulator.__init__.__kwdefaults__,
                        "hw", jhw)
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    mix = ["code", "math", "extract"]
    for k, jkw, tkw in ((None, {}, {}), (2, {}, {}),
                        (None, {"cascade_cfg": JCascadeConfig(k_max=4)},
                         {"cascade_cfg": CascadeConfig(k_max=4)})):
        jp = jsim.run_point(jcfg, mix, k, n_requests=3, iters=40, seed=1,
                            **jkw)
        tp = tsim.run_point(tcfg, mix, k, n_requests=3, iters=40, seed=1,
                            **tkw)
        for key in ("speedup", "tpot", "etr"):
            assert tp[key] == jp[key]
        assert _reqs(tp["requests"]) == _reqs(jp["requests"])
        assert _reqs(tp["baseline"]) == _reqs(jp["baseline"])
