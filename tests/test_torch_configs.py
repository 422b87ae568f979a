"""The dense configurations (StableLM-2 1.6B and 3B, Minitron-4B) and
Kimi-K2 in the port against the JAX package on the CPU.

Each port config equals the reference's field for field, `reduced()`
and the parameter counts included; so do ChatGLM3-6B, Qwen2-VL-7B and
Whisper-large-v3 (their passes and engines: test_torch_families.py). On the reduced configs (float32, JAX params converted), a
12-token prefill and a `[1+4]` `decode_step` give logits within atol 1e-5
(max|logit| is 3-4 there), the routing integers and the cache's `pos` and
`length` exactly, and a rollback the same cache metadata. Both engines'
greedy streams and model-clock telemetry equal the JAX engines' on the
reduced StableLM-2 1.6B and Kimi-K2 (n-gram drafting over a periodic
prompt)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import cost_model as jcm
from repro.core.controller import CascadeController as JCascade
from repro.models import transformer as jT
from repro.serving import NGramDrafter as JNGram
from repro.serving import ServingEngine as JEngine
from repro.serving.engine import BatchedEngine as JBatched
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import cost_model as tcm
from repro_torch.core.controller import CascadeController
from repro_torch.models import transformer as tT
from repro_torch.serving import BatchedEngine, NGramDrafter, ServingEngine
from test_torch_batching import _share_jits
from test_torch_guards import torch_one_thread  # noqa: F401,E402 (autouse)

ARCHS = ["stablelm-1.6b", "stablelm-3b", "minitron-4b", "kimi-k2-1t-a32b"]
#: configs held here only field for field
FAMILY_ARCHS = ["chatglm3-6b", "qwen2-vl-7b", "whisper-large-v3"]
LOGIT_ATOL = 1e-5
MAX_NEW = 16

_MODELS: dict = {}


def _model(arch):
    """(reduced cfg, JAX params, their torch copy), built once an arch."""
    if arch not in _MODELS:
        cfg = jax_get_config(arch).reduced()
        jp = jT.init_params(cfg, jax.random.PRNGKey(ARCHS.index(arch)))
        _MODELS[arch] = (cfg, jp, params_from_numpy(jax.device_get(jp),
                                                    device="cpu"))
    return _MODELS[arch]


@pytest.mark.parametrize("arch", ARCHS + FAMILY_ARCHS)
def test_config_equals_reference_field_for_field(arch):
    ref, port = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert arch.replace(".", "-") in ALL_ARCHS


def test_full_width_head_dims():
    """The head dims (and GQA groups) the card's attention kernels serve
    for these models."""
    assert [get_config(a).head_dim for a in ARCHS] == [64, 80, 128, 128]
    assert get_config("minitron-4b").num_heads // \
        get_config("minitron-4b").num_kv_heads == 3
    assert [(get_config(a).head_dim,
             get_config(a).num_heads // get_config(a).num_kv_heads)
            for a in FAMILY_ARCHS] == [(128, 16), (128, 7), (64, 1)]


def _np(x):
    return x.detach().numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_span_and_rollback_match(arch):
    cfg, jp, tp = _model(arch)
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab_size, (1, 12)).astype(np.int32)
    span = rng.integers(0, cfg.vocab_size, (1, 5)).astype(np.int32)
    jcache = jT.init_cache(cfg, 1, 64)
    cache = tT.init_cache(cfg, 1, 64, device="cpu")
    jlo, jcache, jaux = jT.prefill(cfg, jp, jnp.asarray(prompt), jcache)
    lo, cache, aux = tT.prefill(cfg, tp, torch.from_numpy(prompt), cache)
    np.testing.assert_allclose(_np(lo), np.asarray(jlo), rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_array_equal(_np(aux["unique_experts"]),
                                  np.asarray(jaux["unique_experts"]))

    jlo, jnew, jaux, jst = jT.decode_step(cfg, jp, jcache, jnp.asarray(span))
    lo, new, aux, st = tT.decode_step(cfg, tp, cache, torch.from_numpy(span))
    np.testing.assert_allclose(_np(lo), np.asarray(jlo), rtol=0,
                               atol=LOGIT_ATOL)
    for key in ("unique_experts", "unique_experts_row", "experts_active"):
        np.testing.assert_array_equal(_np(aux[key]), np.asarray(jaux[key]))
    np.testing.assert_array_equal(_np(new["pos"]), np.asarray(jnew["pos"]))
    assert int(new["length"]) == int(jnew["length"]) == 17
    if cfg.is_moe:
        assert int(aux["unique_experts"].max()) > 0

    jback = jT.rollback_cache(cfg, jnew, jst, 2, 12)
    back = tT.rollback_cache(cfg, new, st, 2, 12)
    np.testing.assert_array_equal(_np(back["pos"]), np.asarray(jback["pos"]))
    assert int(back["length"]) == int(jback["length"]) == 14


def _hw_pair():
    fields = dataclasses.asdict(tcm.H100_SXM)
    return jcm.Hardware(**fields), tcm.Hardware(**fields)


def _prompts(cfg, n=3):
    """Periodic prompts over 8 tokens, so the n-gram drafter proposes; one
    length, so the JAX engines compile one prefill."""
    rng = np.random.default_rng(0)
    return [[1] + rng.integers(3, cfg.vocab_size, 8).tolist() * 4
            for _ in range(n)]


def _serve(eng, prompts):
    pending, live, done = list(enumerate(prompts)), {}, {}
    while pending or live:
        while pending and eng.free_slots:
            i, p = pending.pop(0)
            live[eng.join(p, MAX_NEW, request_id=str(i))] = i
        eng.step()
        for slot, i in list(live.items()):
            if eng.slots[slot].done:
                done[i] = eng.retire(slot)
                del live[slot]
    return [done[i] for i in range(len(prompts))]


@pytest.mark.parametrize("engine", ["serving", "batched"])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "kimi-k2-1t-a32b"])
def test_engines_equal_jax(arch, engine):
    cfg, jp, tp = _model(arch)
    jhw, thw = _hw_pair()
    kw = dict(max_len=128, temperature=0.0, clock="model")
    prompts = _prompts(cfg)
    if engine == "serving":
        jeng = _share_jits(JEngine(cfg, jp, JNGram(),
                                   controller_factory=JCascade, hw=jhw, **kw))
        teng = ServingEngine(cfg, tp, NGramDrafter(),
                             controller_factory=CascadeController, hw=thw,
                             device="cpu", **kw)
        jres = [jeng.generate(p, max_new=MAX_NEW, request_id=str(i))
                for i, p in enumerate(prompts)]
        tres = [teng.generate(p, max_new=MAX_NEW, request_id=str(i))
                for i, p in enumerate(prompts)]
    else:
        jeng = _share_jits(JBatched(cfg, jp, controller_factory=JCascade,
                                    max_batch=3, hw=jhw, **kw))
        teng = BatchedEngine(cfg, tp, controller_factory=CascadeController,
                             max_batch=3, hw=thw, device="cpu", **kw)
        jres, tres = _serve(jeng, prompts), _serve(teng, prompts)
        assert ([dataclasses.asdict(s) for s in teng.telemetry.steps]
                == [dataclasses.asdict(s) for s in jeng.telemetry.steps])
        assert teng.now == jeng.now
    for t, j in zip(tres, jres):
        assert t.tokens == j.tokens
        assert dataclasses.asdict(t.telemetry) == dataclasses.asdict(
            j.telemetry)
    assert sum(it.k_drafted for r in tres
               for it in r.telemetry.iterations) > 0
