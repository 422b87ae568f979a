"""Multi-head Latent Attention and DeepSeek-V2 in the port against the JAX
package on the CPU.

The port's `deepseek-v2-236b` equals the reference's field for field,
`reduced()` included. On the reduced config in float32 (JAX params
converted), `latent_kv`, `mla_full` and `mla_absorbed` agree within
rtol = atol = 1e-5 with and without a query LoRA, the absorbed form with
a window and with a row that has no valid key (zeros, not NaN); the
prefill's padded-V route (v zero-padded to the key width, through
`flash_attention`'s plain version here) agrees with `attend` over the
unpadded v. The model's MoE layer routes as the reference's
(`expert_idx` exactly). A prefill, a `[1+4]` span, a rollback and a
second span give logits within atol 1e-5 (max|logit| is a few units),
the cached latents within 1e-5, and the routing integers, positions and
lengths exactly.
Both engines on a reduced DeepSeek-V2 trained by the JAX trainer emit the
JAX engines' token streams and model-clock telemetry exactly, with drafts
accepted. Training the reduced DeepSeek-V2 (query LoRA on; the expanded
attention through `FlashAttention` with v zero-padded) gives the
reference's loss within 1e-5 and every parameter's gradient within
1e-5 * max|g_ref| + 1e-7."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.controller import CascadeController as JCascade
from repro.models import attention as jattn
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models import transformer as jT
from repro.serving import NGramDrafter as JNGram
from repro.serving import ServingEngine as JEngine
from repro.serving.engine import BatchedEngine as JBatched
from repro.training import make_train_step
from repro.training.optimizer import adamw
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.controller import CascadeController
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tT
from repro_torch.serving import BatchedEngine, NGramDrafter, ServingEngine
from tests.conftest import copy_batch
from test_torch_batching import _assert_same, _hw_pair, _serve, _share_jits
from test_torch_families import assert_loss_and_grads
from test_torch_guards import torch_one_thread  # noqa: F401,E402 (autouse)

ARCH = "deepseek-v2-236b"
TOL = 1e-5
LOGIT_ATOL = 1e-5


def _np(x):
    return x.detach().numpy()


def _close(actual, ref, tol=TOL):
    np.testing.assert_allclose(_np(actual), np.asarray(ref), rtol=tol,
                               atol=tol)


_LAYERS: dict = {}


def _layer(q_lora: bool):
    """(cfg, one layer's JAX MLA params, their torch copy) on the reduced
    config, with or without the query LoRA."""
    if q_lora not in _LAYERS:
        cfg = jax_get_config(ARCH).reduced()
        if not q_lora:
            cfg = dataclasses.replace(cfg, q_lora_rank=0)
        jp = jmla.init_mla(cfg, jax.random.PRNGKey(5), jnp.float32)
        _LAYERS[q_lora] = (cfg, jp, params_from_numpy(jax.device_get(jp),
                                                      device="cpu"))
    return _LAYERS[q_lora]


def test_config_equals_reference_field_for_field():
    ref, port = jax_get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert ARCH in ALL_ARCHS
    # the prefill's expanded heads: 128 latent-expanded + 64 RoPE columns
    assert port.qk_nope_dim + port.qk_rope_dim == port.head_dim == 192


@pytest.mark.parametrize("q_lora", [True, False])
def test_init_leaves_match_reference(q_lora):
    cfg, jp, _ = _layer(q_lora)
    tp = tmla.init_mla(cfg, torch.Generator().manual_seed(0), torch.float32,
                       "cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}


def _xpos(cfg, b=2, t=7, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
    return x, pos


@pytest.mark.parametrize("q_lora", [True, False])
def test_latent_kv_and_mla_full_match(q_lora):
    cfg, jp, tp = _layer(q_lora)
    x, pos = _xpos(cfg)
    jc, jk = jmla.latent_kv(cfg, jp, jnp.asarray(x), jnp.asarray(pos))
    tc, tk = tmla.latent_kv(cfg, tp, torch.from_numpy(x),
                            torch.from_numpy(pos))
    _close(tc, jc)
    _close(tk, jk)
    jout, (jc, jk) = jmla.mla_full(cfg, jp, jnp.asarray(x), jnp.asarray(pos))
    tout, (tc, tk) = tmla.mla_full(cfg, tp, torch.from_numpy(x),
                                   torch.from_numpy(pos))
    _close(tout, jout)
    _close(tc, jc)
    _close(tk, jk)


@pytest.mark.parametrize("q_lora,window", [(True, 0), (False, 0), (True, 5)])
def test_mla_absorbed_matches(q_lora, window):
    """Three queries per row over a ring of 12 latents: row 0 at positions
    9..11 with its ring holding 0..11, row 1's ring empty (its output is
    zeros)."""
    cfg, jp, tp = _layer(q_lora)
    rng = np.random.default_rng(1)
    b, t, r = 2, 3, 12
    x = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)
    pos = np.array([[9, 10, 11], [0, 1, 2]], np.int32)
    ckv = rng.standard_normal((b, r, cfg.kv_lora_rank)).astype(np.float32)
    krope = rng.standard_normal((b, r, cfg.qk_rope_dim)).astype(np.float32)
    cache_pos = np.stack([np.arange(r, dtype=np.int32),
                          np.full(r, -1, np.int32)])
    jout = jmla.mla_absorbed(cfg, jp, jnp.asarray(x), jnp.asarray(pos),
                             jnp.asarray(ckv), jnp.asarray(krope),
                             jnp.asarray(cache_pos), window=window)
    tout = tmla.mla_absorbed(cfg, tp, torch.from_numpy(x),
                             torch.from_numpy(pos), torch.from_numpy(ckv),
                             torch.from_numpy(krope),
                             torch.from_numpy(cache_pos), window=window)
    _close(tout, jout)
    assert bool(torch.isfinite(tout).all())
    assert float(tout[1].abs().max()) == 0.0


def test_padded_value_prefill_matches_attend():
    """The prefill route: q, k at 48 columns, v at 32 padded to 48, against
    the reference's `attend` with the unpadded v (scaled by 1/sqrt(48))."""
    rng = np.random.default_rng(2)
    b, s, h, d, dv = 2, 9, 4, 48, 32
    q, k = (rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    ref = jattn.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(pos), jnp.asarray(pos), window=0,
                       causal=True)
    out = tmla.attend_padded(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v))
    assert tuple(out.shape) == (b, s, h, dv)
    _close(out, ref)


_MODEL: dict = {}


def _model():
    if not _MODEL:
        cfg = jax_get_config(ARCH).reduced()
        jp = jT.init_params(cfg, jax.random.PRNGKey(9))
        _MODEL["m"] = (cfg, jp, params_from_numpy(jax.device_get(jp),
                                                  device="cpu"))
    return _MODEL["m"]


def _check_pass(lo, jlo, aux, jaux, cache, jcache, keys):
    np.testing.assert_allclose(_np(lo), np.asarray(jlo), rtol=0,
                               atol=LOGIT_ATOL)
    for key in keys:
        np.testing.assert_array_equal(_np(aux[key]), np.asarray(jaux[key]))
    for key in ("pos",) + (("lengths",) if "lengths" in cache else ()):
        np.testing.assert_array_equal(_np(cache[key]),
                                      np.asarray(jcache[key]))
    assert int(cache["length"]) == int(jcache["length"])
    for key in ("ckv", "krope"):
        _close(cache[key], jcache[key])


@pytest.mark.parametrize("packed", [False, True])
def test_moe_layer_routing_matches(packed):
    """The model's MoE layer (4 experts top-2 and a shared expert) on a
    `[1+4]` span's worth of tokens: `expert_idx` and the union exactly,
    the output within 1e-5 of its largest value (float32 sums of up to
    600 in another order)."""
    cfg, jp, tp = _model()
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["moe"])
    tl = {k: (v[0] if torch.is_tensor(v) else {n: w[0] for n, w in v.items()})
          for k, v in tp["blocks"]["moe"].items()}
    x = np.random.default_rng(4).standard_normal((5, cfg.d_model))
    x = x.astype(np.float32)
    jy, jaux = jmoe.apply_moe(cfg, jl, jnp.asarray(x),
                              capacity_policy="exact", packed=packed)
    ty, taux = tmoe.apply_moe(cfg, tl, torch.from_numpy(x),
                              capacity_policy="exact", packed=packed)
    scale = float(np.abs(np.asarray(jy)).max())
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=TOL,
                               atol=TOL * scale)
    for key in ("expert_idx", "unique_experts"):
        np.testing.assert_array_equal(_np(taux[key]), np.asarray(jaux[key]))


@pytest.mark.parametrize("packed", [False, True])
def test_prefill_spans_and_rollback_match(packed):
    cfg, jp, tp = _model()
    assert "k" not in tT.init_cache(cfg, 1, 8, device="cpu")
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab_size, (1, 12)).astype(np.int32)
    spans = rng.integers(0, cfg.vocab_size, (2, 1, 5)).astype(np.int32)
    jcache = jT.init_cache(cfg, 1, 64)
    cache = tT.init_cache(cfg, 1, 64, device="cpu")
    assert tuple(cache["ckv"].shape) == tuple(jcache["ckv"].shape)
    assert tuple(cache["krope"].shape) == tuple(jcache["krope"].shape)
    jlo, jcache, jaux = jT.prefill(cfg, jp, jnp.asarray(prompt), jcache)
    lo, cache, aux = tT.prefill(cfg, tp, torch.from_numpy(prompt), cache)
    _check_pass(lo, jlo, aux, jaux, cache, jcache, ("unique_experts",))

    keys = ("unique_experts", "unique_experts_row", "experts_active")
    length = 12
    for i, keep in enumerate((2, 4)):
        jlo, jnew, jaux, jst = jT.decode_step(cfg, jp, jcache,
                                              jnp.asarray(spans[i]),
                                              moe_packed=packed)
        lo, new, aux, st = tT.decode_step(cfg, tp, cache,
                                          torch.from_numpy(spans[i]),
                                          moe_packed=packed)
        assert st is None
        _check_pass(lo, jlo, aux, jaux, new, jnew, keys)
        assert int(aux["unique_experts"].max()) > 0
        jcache = jT.rollback_cache(cfg, jnew, jst, keep, length)
        cache = tT.rollback_cache(cfg, new, st, keep, length)
        length += keep
        np.testing.assert_array_equal(_np(cache["pos"]),
                                      np.asarray(jcache["pos"]))
        assert int(cache["length"]) == int(jcache["length"]) == length


def test_per_row_cache_ragged_pass_matches():
    """Rows joined by `write_cache_row` at different lengths, one ragged
    padded pass under a token mask, a per-row rollback and a chunk
    through `prefill_chunk`, as the batched engine drives them: the latent
    leaves travel with the rows."""
    cfg, jp, tp = _model()
    rng = np.random.default_rng(21)
    b, max_len = 3, 48
    jc = jT.init_cache(cfg, b, max_len, per_row=True)
    tc = tT.init_cache(cfg, b, max_len, per_row=True, device="cpu")
    for slot, n in ((0, 9), (2, 14)):
        prompt = rng.integers(3, cfg.vocab_size, (1, n)).astype(np.int32)
        jrow = jT.init_cache(cfg, 1, max_len)
        _, jrow, _ = jT.prefill(cfg, jp, jnp.asarray(prompt), jrow)
        trow = tT.init_cache(cfg, 1, max_len, device="cpu")
        _, trow, _ = tT.prefill(cfg, tp, torch.from_numpy(prompt), trow)
        jc = jT.write_cache_row(jc, slot, jrow)
        tc = tT.write_cache_row(tc, slot, trow)
    toks = rng.integers(3, cfg.vocab_size, (b, 5)).astype(np.int32)
    mask = np.array([[1, 1, 1, 0, 0], [1] * 5, [1] * 5], bool)
    keys = ("unique_experts", "unique_experts_row", "experts_active")
    before = np.array(jc["lengths"])
    jlo, jc2, jaux, _ = jT.decode_step(cfg, jp, jc, jnp.asarray(toks),
                                       token_mask=jnp.asarray(mask),
                                       moe_packed=True)
    tlo, tc2, taux, _ = tT.decode_step(cfg, tp, tc, torch.from_numpy(toks),
                                       token_mask=torch.from_numpy(mask),
                                       moe_packed=True)
    _check_pass(tlo, jlo, taux, jaux, tc2, jc2, keys)
    keep = np.array([2, 5, 1], np.int32)
    jc3 = jT.rollback_cache(cfg, jc2, None, jnp.asarray(keep),
                            jnp.asarray(before))
    tc3 = tT.rollback_cache(cfg, tc2, None, torch.from_numpy(keep),
                            torch.from_numpy(before))
    jc3, tc3 = jT.clear_cache_row(jc3, 2), tT.clear_cache_row(tc3, 2)
    chunk = rng.integers(3, cfg.vocab_size, (b, 4)).astype(np.int32)
    cmask = np.array([[0] * 4, [1, 1, 1, 0], [1] * 4], bool)
    jlo, jc4, jaux, _ = jT.prefill_chunk(cfg, jp, jc3, jnp.asarray(chunk),
                                         token_mask=jnp.asarray(cmask))
    tlo, tc4, taux, _ = tT.prefill_chunk(cfg, tp, tc3,
                                         torch.from_numpy(chunk),
                                         token_mask=torch.from_numpy(cmask))
    np.testing.assert_allclose(_np(tlo[1:, :3]), np.asarray(jlo[1:, :3]),
                               rtol=0, atol=LOGIT_ATOL)
    for key in keys:
        np.testing.assert_array_equal(_np(taux[key]), np.asarray(jaux[key]))
    for key in ("pos", "lengths"):
        np.testing.assert_array_equal(_np(tc4[key]), np.asarray(jc4[key]))


# --------------------------------------------------------------------- #
# Engines on a trained MLA model
# --------------------------------------------------------------------- #

MAX_NEW = 24
PERIOD = 32


def test_train_loss_and_gradients_match_jax():
    """`loss_fn` of the 2-layer reduced DeepSeek-V2 (MLA with a query LoRA,
    the MoE under the "train" capacity policy) and every parameter's
    gradient, the padded value columns' included, against the
    reference's. The params are the port's init (seeded), handed to JAX
    as arrays: the reference's init runs op by op for seconds."""
    cfg = jax_get_config(ARCH).reduced()
    assert cfg.q_lora_rank and cfg.num_layers == 2
    tp = tT.init_params(get_config(ARCH).reduced(),
                        torch.Generator().manual_seed(7), device="cpu")
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    rng = np.random.default_rng(13)
    toks, labels = (rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
                    for _ in range(2))
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    assert assert_loss_and_grads(cfg, jp, tp, jb, tb) > 20


@pytest.fixture(scope="module")
def trained_mla():
    """A 2-layer reduced DeepSeek-V2 (MLA, 4 experts top-2, a shared
    expert) trained 200 steps by the JAX trainer on the periodic-copy task,
    as `trained_tiny_moe` is: its greedy streams copy the prompt's period,
    so the n-gram drafter's drafts are accepted."""
    cfg = dataclasses.replace(jax_get_config(ARCH).reduced(),
                              vocab_size=128, num_layers=2)
    init_state, step = make_train_step(cfg, optimizer=adamw(3e-3))
    state = init_state(jax.random.PRNGKey(1))
    step = jax.jit(step)
    rng = np.random.default_rng(3)
    for _ in range(200):
        state, _ = step(state, copy_batch(rng))
    jp = state[0]
    return cfg, jp, params_from_numpy(jax.device_get(jp), device="cpu")


def _prompts(n):
    """Periodic-copy prompts of one length (one prefill shape to compile)."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        p = rng.integers(3, 128, PERIOD).tolist()
        out.append([1] + p + p[:20])
    return out


def test_serving_engine_equals_jax(trained_mla):
    cfg, jp, tp = trained_mla
    jhw, thw = _hw_pair()
    kw = dict(max_len=128, temperature=0.0, clock="model")
    jeng = _share_jits(JEngine(cfg, jp, JNGram(), controller_factory=JCascade,
                               hw=jhw, **kw))
    teng = ServingEngine(cfg, tp, NGramDrafter(),
                         controller_factory=CascadeController, hw=thw,
                         device="cpu", **kw)
    prompts = _prompts(2)
    jres = [jeng.generate(p, max_new=MAX_NEW, request_id=str(i))
            for i, p in enumerate(prompts)]
    tres = [teng.generate(p, max_new=MAX_NEW, request_id=str(i))
            for i, p in enumerate(prompts)]
    for t, j in zip(tres, jres):
        assert t.tokens == j.tokens
        assert dataclasses.asdict(t.telemetry) == dataclasses.asdict(
            j.telemetry)
    its = [it for r in tres for it in r.telemetry.iterations]
    assert sum(it.tokens_emitted for it in its) > len(its)


@pytest.mark.parametrize("case", [
    dict(packed=False),
    dict(packed=True),
    dict(packed=True, chunk=16),
])
def test_batched_engine_equals_jax(trained_mla, case):
    cfg, jp, tp = trained_mla
    jhw, thw = _hw_pair()
    common = dict(max_batch=4, max_len=128, temperature=0.0, clock="model",
                  **case)
    jeng = _share_jits(JBatched(cfg, jp, hw=jhw, controller_factory=JCascade,
                                **common))
    teng = BatchedEngine(cfg, tp, hw=thw,
                         controller_factory=CascadeController,
                         device="cpu", **common)
    prompts = _prompts(5)
    max_new = [MAX_NEW - 4 * (i % 2) for i in range(len(prompts))]
    jres, jpred = _serve(jeng, prompts, max_new, {})
    tres, tpred = _serve(teng, prompts, max_new, {})
    assert tpred == jpred
    _assert_same(jeng, jres, teng, tres)
    assert max(s.occupancy for s in teng.telemetry.steps) == 4
    if case.get("chunk"):
        assert all(r.telemetry.prefill_chunks > 1 for r in tres.values())

