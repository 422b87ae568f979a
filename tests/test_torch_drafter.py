"""The port's `DraftModelDrafter` against the JAX package's on the CPU, and
both serving engines driven by it against the JAX engines.

Proposals: the same history gives exactly the same drafts and the same
`synced` count, greedy and sampled from the same numpy generator, and
`draft_probs` within 1e-6 (float32 logits of two frameworks, a float64
softmax of each). The drafters are `trained_tiny_moe` and its first layer
alone, whose argmax margins are wide; one case drafts past the end of the
drafter's ring, which wraps onto committed slots in both packages (the
port writes K/V in place, the JAX package rolls back the cache its
drafting returned).

Engines, under `clock="model"`: token streams and every
`IterationTelemetry` / `StepTelemetry` field exactly equal, greedy (the
JAX package's perfect-drafter case included) and at temperature 0.8 with
rejection sampling. The JAX drafter compiles its pass per feed length and
per instance, so its instances here share one compiled pass per config
(`_JDraft`: the same function, compiled once), the prompts share one
length, and the runs stay at 3 requests and 16 new tokens."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import cost_model as jcm
from repro.core.controller import CascadeController as JCascade
from repro.core.controller import StaticKController as JStatic
from repro.serving import DraftModelDrafter as JDrafter
from repro.serving import ServingEngine as JEngine
from repro.serving.engine import BatchedEngine as JBatched
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import cost_model as tcm
from repro_torch.core.controller import CascadeController, StaticKController
from repro_torch.serving import (BatchedEngine, DraftModelDrafter,
                                 ServingEngine)
from test_torch_batching import _share_jits
from test_torch_guards import torch_one_thread  # noqa: F401,E402 (autouse)

PERIOD = 32
MAX_NEW = 16
PASS_TOL = 1e-4


_JITTED: dict = {}


class JDraft(JDrafter):
    """The JAX package's drafter, its jitted pass shared by every instance
    of one config (each instance would compile the same function anew)."""

    def __init__(self, cfg, params, **kw):
        super().__init__(cfg, params, **kw)
        self._decode = _JITTED.setdefault(cfg, self._decode)


def _torch_tree(tree):
    return params_from_numpy(jax.device_get(tree), device="cpu")


@pytest.fixture(scope="module")
def trained(trained_tiny_moe):
    cfg, jp, _ = trained_tiny_moe
    return cfg, jp, _torch_tree(jp)


@pytest.fixture(scope="module")
def first_layer(trained):
    """The trained target cut to its first layer: a one-layer drafter."""
    cfg, jp, _ = trained
    jp1 = dict(jp, blocks=jax.tree_util.tree_map(lambda a: a[:1],
                                                 jp["blocks"]))
    return dataclasses.replace(cfg, num_layers=1), jp1, _torch_tree(jp1)


def _prompts(n, vocab=128, seed=7):
    """Periodic-copy prompts of 70 tokens, the trained task."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p = rng.integers(3, vocab, PERIOD).tolist()
        out.append([1] + p + p + p[:5])
    return out


def _hw_pair():
    fields = dataclasses.asdict(tcm.H100_SXM)
    return jcm.Hardware(**fields), tcm.Hardware(**fields)


# --------------------------------------------------------------------- #
# Proposals
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("drafter,max_len", [
    ("trained", 256),
    ("first_layer", 72),    # the 70-token history + 4 drafts wrap the ring
])
def test_propose_equals_jax(request, drafter, max_len, temperature):
    cfg, jp, tp = request.getfixturevalue(drafter)
    jd = JDraft(cfg, jp, max_len=max_len, temperature=temperature)
    td = DraftModelDrafter(cfg, tp, max_len=max_len,
                           temperature=temperature, device="cpu")
    assert td.active_params == jd.active_params == cfg.active_param_count()
    jrng, trng = np.random.default_rng(5), np.random.default_rng(5)
    history = _prompts(1)[0]
    assert len(history) == 70
    for _ in range(3):
        jdrafts, jprobs = jd.propose(history, 4, rng=jrng)
        tdrafts, tprobs = td.propose(history, 4, rng=trng)
        assert tdrafts == jdrafts and len(tdrafts) == 4
        assert td.synced == jd.synced == len(history)
        if temperature > 0:
            assert tprobs.dtype == np.float32
            assert tprobs.shape == (4, cfg.vocab_size)
            np.testing.assert_allclose(tprobs, np.asarray(jprobs), rtol=0,
                                       atol=1e-6)
        else:
            assert tprobs is None and jprobs is None
        # the drafter's own cache after the rollback: positions exactly,
        # K/V at the whole-pass tolerance of test_torch_model.py (float32
        # sums of two frameworks, a few layers deep)
        np.testing.assert_array_equal(td.cache["pos"].numpy(),
                                      np.asarray(jd.cache["pos"]))
        assert int(td.cache["length"]) == int(jd.cache["length"])
        for name in ("k", "v"):
            ref = np.asarray(jd.cache[name])
            np.testing.assert_allclose(
                td.cache[name].numpy(), ref, rtol=PASS_TOL,
                atol=PASS_TOL * max(1.0, float(np.abs(ref).max())))
        # commit two drafts and a correction, as a verifier would
        history = history + jdrafts[:2] + [(jdrafts[2] + 1) % cfg.vocab_size]
    assert jrng.random() == trng.random()   # the same draws were taken
    if max_len == 72:
        assert int(td.cache["pos"].max()) >= max_len   # the ring wrapped


def test_propose_without_a_history_or_k():
    cfg = get_config("mixtral-8x7b").reduced()
    from repro_torch.models import transformer as T
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    d = DraftModelDrafter(cfg, params, max_len=32, device="cpu")
    assert d.propose([], 4) == ([], None)
    assert d.propose([1, 2, 3], 0) == ([], None)
    assert d.synced == 3
    d.reset()
    assert d.cache is None and d.synced == 0


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b"])
def test_recurrent_drafters_are_refused(arch):
    """The JAX package's drafter rolls a recurrent stack back without staged
    states, so the drafted tokens stay in its state (RWKV-6: the next
    proposal differs from a fresh drafter's fed the same history); the
    port refuses such a drafter instead."""
    cfg = get_config(arch).reduced()
    with pytest.raises(ValueError, match="recurrent stack"):
        DraftModelDrafter(cfg, {}, device="cpu")


# --------------------------------------------------------------------- #
# Engines
# --------------------------------------------------------------------- #

def _assert_results_equal(tres, jres):
    assert len(tres) == len(jres)
    for t, j in zip(tres, jres):
        assert t.tokens == j.tokens
        assert dataclasses.asdict(t.telemetry) == dataclasses.asdict(
            j.telemetry)


def _serve(eng, prompts):
    """Continuous batching: join while a row is free, step, retire what
    finished. Returns the results by prompt index."""
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


def test_perfect_drafter_end_to_end_equals_jax(trained):
    """The JAX package's own case (there on `tiny_moe`): the target itself
    as the drafter, so every draft is accepted."""
    cfg, jp, tp = trained
    jhw, thw = _hw_pair()
    kw = dict(max_len=256, temperature=0.0, clock="model", seed=0)
    jeng = _share_jits(JEngine(cfg, jp, JDraft(cfg, jp, max_len=256,
                                               temperature=0.0),
                               hw=jhw, **kw))
    teng = ServingEngine(cfg, tp, DraftModelDrafter(
        cfg, tp, max_len=256, temperature=0.0, device="cpu"), hw=thw,
        device="cpu", **kw)
    prompt = list(range(3, 23))
    for k in (0, 4):
        jr = jeng.generate(prompt, max_new=MAX_NEW,
                           controller=JStatic(k))
        tr = teng.generate(prompt, max_new=MAX_NEW,
                           controller=StaticKController(k))
        _assert_results_equal([tr], [jr])
    assert tr.telemetry.etr > 3.0


@pytest.mark.parametrize("engine,temperature", [
    ("serving", 0.8), ("batched", 0.0), ("batched", 0.8)])
def test_engines_with_a_draft_model_equal_jax(trained, first_layer, engine,
                                              temperature):
    """The trained target served with its first layer as the drafter, under
    Cascade; sampled runs draw drafts and verification from the engines'
    numpy generators (seed 3) in both packages. ServingEngine's greedy
    case is the perfect drafter's above."""
    cfg, jp, tp = trained
    dcfg, djp, dtp = first_layer
    jhw, thw = _hw_pair()
    kw = dict(max_len=256, temperature=temperature, clock="model", seed=3)

    def jdraft():
        return JDraft(dcfg, djp, max_len=256, temperature=temperature)

    def tdraft():
        return DraftModelDrafter(dcfg, dtp, max_len=256,
                                 temperature=temperature, device="cpu")

    prompts = _prompts(3)
    if engine == "serving":
        jeng = _share_jits(JEngine(cfg, jp, jdraft(),
                                   controller_factory=JCascade, hw=jhw, **kw))
        teng = ServingEngine(cfg, tp, tdraft(),
                             controller_factory=CascadeController, hw=thw,
                             device="cpu", **kw)
        jres = [jeng.generate(p, max_new=MAX_NEW, request_id=str(i))
                for i, p in enumerate(prompts)]
        tres = [teng.generate(p, max_new=MAX_NEW, request_id=str(i))
                for i, p in enumerate(prompts)]
    else:
        jeng = _share_jits(JBatched(cfg, jp, drafter_factory=jdraft,
                                    max_batch=3, controller_factory=JCascade,
                                    hw=jhw, **kw))
        teng = BatchedEngine(cfg, tp, drafter_factory=tdraft, max_batch=3,
                             controller_factory=CascadeController, hw=thw,
                             device="cpu", **kw)
        jres, tres = _serve(jeng, prompts), _serve(teng, prompts)
        assert ([dataclasses.asdict(s) for s in teng.telemetry.steps]
                == [dataclasses.asdict(s) for s in jeng.telemetry.steps])
        assert teng.now == jeng.now
    _assert_results_equal(tres, jres)
    its = [it for r in tres for it in r.telemetry.iterations]
    assert sum(it.k_drafted for it in its) > 0
    if temperature == 0.0:
        # the one-layer drafter of the copy task is accepted
        assert sum(it.tokens_emitted for it in its) > len(its)
