"""Both serving engines of the port on the recurrent families against the
JAX engines, beyond the greedy runs of test_torch_rwkv.py and
test_torch_rglru.py: sampling with rejection sampling, a stop token, an
engine-wide attention window and expert affinity. The reduced RWKV-6 and
RecurrentGemma at vocab 16, with those files' params (seeds 1 and 2) and
the first two of their prompts (seed 0), in float32 on the CPU.

Under `clock="model"` the token streams, every `RequestTelemetry` field
(each `IterationTelemetry` included), the batched engine's every
`StepTelemetry` and its clock `now` are exactly equal to the JAX
engines'."""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import cost_model as jcm
from repro.core.controller import CascadeController as JCascade
from repro.models import transformer as jT
from repro.serving import NGramDrafter as JNGram
from repro.serving import ServingEngine as JEngine
from repro.serving.engine import BatchedEngine as JBatched
from repro_torch.convert import params_from_numpy
from repro_torch.core import cost_model as tcm
from repro_torch.core.controller import CascadeController
from repro_torch.serving import BatchedEngine, NGramDrafter, ServingEngine

# family -> (config, params seed): the seeds of the greedy engine tests
FAMILIES = {"rwkv": ("rwkv6-3b", 1), "rgemma": ("recurrentgemma-9b", 2)}
MAX_NEW = 16

# case -> (engine, its keywords, generate/join keywords)
CASES = {
    "sampled": ("serving", dict(temperature=0.8, seed=3), {}),
    "sampled-batched": ("batched", dict(temperature=0.8, seed=3,
                                        max_batch=3), {}),
    "stop": ("serving", dict(temperature=0.0), dict(stop_token=7)),
    "stop-batched-chunked": ("batched", dict(temperature=0.0, max_batch=3,
                                             chunk=8), dict(stop_token=7)),
    "window": ("serving", dict(temperature=0.0, window=16), {}),
    "window-batched": ("batched", dict(temperature=0.0, window=16,
                                       max_batch=3), {}),
    "affinity": ("serving", dict(temperature=0.0, affinity=0.3), {}),
}

_MODELS: dict = {}


def _model(family):
    """(cfg, JAX params, their torch copy, prompts), built once a family."""
    if family not in _MODELS:
        arch, seed = FAMILIES[family]
        cfg = dataclasses.replace(jax_get_config(arch).reduced(),
                                  vocab_size=16)
        jp = jT.init_params(cfg, jax.random.PRNGKey(seed))
        rng = np.random.default_rng(0)
        prompts = [[1] + rng.integers(3, 16, 20 + 3 * i).tolist()
                   for i in range(3)][:2]   # the first two keep it quick
        _MODELS[family] = (cfg, jp, params_from_numpy(jax.device_get(jp),
                                                      device="cpu"), prompts)
    return _MODELS[family]


def _hw_pair():
    fields = dataclasses.asdict(tcm.H100_SXM)
    return jcm.Hardware(**fields), tcm.Hardware(**fields)


def _serve(eng, prompts, **join_kw):
    """Continuous batching: join while a row is free, step, retire what
    finished. Returns the results by prompt index."""
    pending, live, done = list(enumerate(prompts)), {}, {}
    while pending or live:
        while pending and eng.free_slots:
            i, p = pending.pop(0)
            live[eng.join(p, MAX_NEW, request_id=str(i), **join_kw)] = i
        eng.step()
        for slot, i in list(live.items()):
            if eng.slots[slot].done:
                done[i] = eng.retire(slot)
                del live[slot]
    return [done[i] for i in range(len(prompts))]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_engines_equal_jax(family, case):
    cfg, jp, tp, prompts = _model(family)
    kind, eng_kw, req_kw = CASES[case]
    jhw, thw = _hw_pair()
    kw = dict(max_len=128, clock="model", **eng_kw)
    if kind == "serving":
        jeng = JEngine(cfg, jp, JNGram(), controller_factory=JCascade,
                       hw=jhw, **kw)
        teng = ServingEngine(cfg, tp, NGramDrafter(),
                             controller_factory=CascadeController, hw=thw,
                             device="cpu", **kw)
        jres = [jeng.generate(p, max_new=MAX_NEW, request_id=str(i),
                              **req_kw) for i, p in enumerate(prompts)]
        tres = [teng.generate(p, max_new=MAX_NEW, request_id=str(i),
                              **req_kw) for i, p in enumerate(prompts)]
    else:
        jeng = JBatched(cfg, jp, controller_factory=JCascade, hw=jhw, **kw)
        teng = BatchedEngine(cfg, tp, controller_factory=CascadeController,
                             hw=thw, device="cpu", **kw)
        jres = _serve(jeng, prompts, **req_kw)
        tres = _serve(teng, prompts, **req_kw)
        assert ([dataclasses.asdict(s) for s in teng.telemetry.steps]
                == [dataclasses.asdict(s) for s in jeng.telemetry.steps])
        assert teng.now == jeng.now
    for t, j in zip(tres, jres):
        assert t.tokens == j.tokens
        assert dataclasses.asdict(t.telemetry) == dataclasses.asdict(
            j.telemetry)
    drafted = sum(it.k_drafted for r in tres for it in r.telemetry.iterations)
    assert drafted > 0
    if "stop" in req_kw:
        assert any(r.tokens[-1] == req_kw["stop_token"]
                   and len(r.tokens) < MAX_NEW for r in tres)
