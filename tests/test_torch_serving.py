"""The port's serving stack against the JAX package on the CPU.

The engine on `trained_tiny_moe` at temperature 0 (level 3): the same
prompts give the same token streams and the same model-clock telemetry,
bit for bit, since under `clock="model"` every time is the same cost-model
arithmetic over the same integer routing counts. Both engines price the
same `Hardware` field values."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_model as jcm
from repro.core.controller import CascadeController as JCascade
from repro.core.controller import StaticKController as JStatic
from repro.serving import NGramDrafter as JNGram
from repro.serving import ServingEngine as JEngine
from repro.serving import sampler as jsampler
from repro_torch.convert import params_from_numpy
from repro_torch.core import cost_model as tcm
from repro_torch.core.controller import CascadeController, StaticKController
from repro_torch.serving import NGramDrafter, ServingEngine
from repro_torch.serving import sampler as tsampler
from test_torch_batching import _share_jits
from test_torch_guards import torch_one_thread  # noqa: F401,E402 (autouse)

PERIOD = 32


def _prompts(n=3, vocab=128, seed=7):
    """Periodic-copy prompts: [BOS, p, p, p[:5]], the trained task."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p = rng.integers(3, vocab, PERIOD).tolist()
        out.append([1] + p + p + p[:5])
    return out


def _hw_pair():
    fields = dataclasses.asdict(tcm.H100_SXM)
    return jcm.Hardware(**fields), tcm.Hardware(**fields)


@pytest.mark.parametrize("policy", ["cascade", "static"])
def test_engine_streams_and_model_clock_telemetry_equal_jax(
        trained_tiny_moe, policy):
    cfg, jparams, _ = trained_tiny_moe
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    jhw, thw = _hw_pair()
    if policy == "cascade":
        jfac, tfac = JCascade, CascadeController
    else:
        jfac, tfac = (lambda: JStatic(4)), (lambda: StaticKController(4))
    kw = dict(max_len=256, temperature=0.0, clock="model")
    jeng = _share_jits(JEngine(cfg, jparams, JNGram(), controller_factory=jfac,
                               hw=jhw, **kw))
    teng = ServingEngine(cfg, params, NGramDrafter(), controller_factory=tfac,
                         hw=thw, device="cpu", **kw)
    for i, prompt in enumerate(_prompts()):
        jr = jeng.generate(prompt, max_new=48, request_id=str(i))
        tr = teng.generate(prompt, max_new=48, request_id=str(i))
        assert tr.tokens == jr.tokens
        assert len(tr.telemetry.iterations) == len(jr.telemetry.iterations)
        assert ([dataclasses.asdict(it) for it in tr.telemetry.iterations]
                == [dataclasses.asdict(it) for it in jr.telemetry.iterations])
        assert tr.telemetry.t_prefill == jr.telemetry.t_prefill
    # the trained model really speculates: drafts were accepted
    assert sum(it.tokens_emitted for it in tr.telemetry.iterations) > \
        len(tr.telemetry.iterations)


@pytest.mark.parametrize("case", [
    dict(engine=dict(temperature=0.8), policy="static"),  # rejection sampling
    dict(engine=dict(window=16), policy="cascade"),       # the ring wraps
    dict(engine=dict(affinity=0.3), policy="cascade"),
    dict(stop="p10", policy="static"),
])
def test_engine_sampling_window_stop_and_affinity_equal_jax(
        trained_tiny_moe, case):
    """Paths beside the greedy full-attention stream, against the JAX
    engine: at temperature 0.8 both draw from the same seeded generator; a
    16-token window is shorter than every prompt; "p10" stops each request
    at the 11th token of its prompt's pattern."""
    cfg, jparams, _ = trained_tiny_moe
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    jhw, thw = _hw_pair()
    if case["policy"] == "cascade":
        jfac, tfac = JCascade, CascadeController
    else:
        jfac, tfac = (lambda: JStatic(4)), (lambda: StaticKController(4))
    kw = {"max_len": 256, "temperature": 0.0, "clock": "model",
          **case.get("engine", {})}
    jeng = _share_jits(JEngine(cfg, jparams, JNGram(), controller_factory=jfac,
                               hw=jhw, **kw))
    teng = ServingEngine(cfg, params, NGramDrafter(), controller_factory=tfac,
                         hw=thw, device="cpu", **kw)
    for i, prompt in enumerate(_prompts()):
        stop = prompt[1 + 10] if case.get("stop") else None
        jr = jeng.generate(prompt, max_new=48, request_id=str(i),
                           stop_token=stop)
        tr = teng.generate(prompt, max_new=48, request_id=str(i),
                           stop_token=stop)
        assert tr.tokens == jr.tokens
        assert ([dataclasses.asdict(it) for it in tr.telemetry.iterations]
                == [dataclasses.asdict(it) for it in jr.telemetry.iterations])
        assert tr.telemetry.t_prefill == jr.telemetry.t_prefill
        if stop is not None:
            assert tr.tokens[-1] == stop and len(tr.tokens) < 48


def test_logits_to_probs_matches():
    logits = np.random.default_rng(0).normal(0, 3, (4, 50)).astype(np.float32)
    for temp in (1.0, 0.7, 0.0):
        np.testing.assert_allclose(
            tsampler.logits_to_probs(torch.from_numpy(logits), temp).numpy(),
            np.asarray(jsampler.logits_to_probs(jnp.asarray(logits), temp)),
            atol=1e-6, rtol=1e-5)


def test_samplers_fed_the_same_probs_draw_the_same_tokens():
    rng = np.random.default_rng(1)
    probs = rng.dirichlet(np.ones(40), size=6).astype(np.float32)
    draft_probs = rng.dirichlet(np.ones(40), size=5).astype(np.float32)
    drafts = [int(np.argmax(p)) for p in probs[:5]]
    for dp in (None, draft_probs):
        for seed in range(20):
            a = tsampler.rejection_sample(np.random.default_rng(seed), probs,
                                          drafts, dp)
            b = jsampler.rejection_sample(np.random.default_rng(seed), probs,
                                          drafts, dp)
            assert (a.accepted, a.next_token) == (b.accepted, b.next_token)
        assert tsampler.sample_token(np.random.default_rng(3), probs[0]) == \
            jsampler.sample_token(np.random.default_rng(3), probs[0])


def test_ngram_drafter_matches():
    hist = [1, 5, 6, 7, 9, 5, 6, 7, 2, 5, 6]
    for k in (0, 1, 3, 8):
        assert NGramDrafter().propose(hist, k) == JNGram().propose(hist, k)


def test_cost_model_matches_reference(tiny_moe):
    cfg, _ = tiny_moe
    jhw, thw = _hw_pair()
    for n, ctx, uniq in ((1, 10, None), (5, 200, 3.0), (17, 1000, 4.0)):
        assert tcm.iteration_time(cfg, thw, n, ctx, uniq) == \
            jcm.iteration_time(cfg, jhw, n, ctx, uniq)
        assert tcm.prefill_time(cfg, thw, n * 30) == \
            jcm.prefill_time(cfg, jhw, n * 30)
        assert tcm.draft_time(thw, n, 1000) == jcm.draft_time(jhw, n, 1000)
        assert tcm.sample_time(n) == jcm.sample_time(n)
