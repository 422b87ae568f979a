"""The port's RecurrentGemma family against the JAX package on the CPU: the
config, the linear recurrence's plain version (against the reference's
oracle and its Pallas kernel in interpret mode), the causal conv, the
RG-LRU and the recurrent block, whole pattern-stack passes with staged
states and rollback (single-request and per-row caches), the cost model's
pricing of a hybrid pass, and both serving engines, on the reduced
RecurrentGemma ("RRA", d=256, local window 32) and on a variant of it
with one KV head at head_dim 256, in float32, with the JAX params carried
across by `params_from_numpy`.

Tolerances: the recurrence, the conv and the blocks at rtol = 1e-5 and
atol = 1e-5 of max(1, max|ref|) (float32 sums in another order); whole
passes at 1e-4 on the same terms (a few float32 layers). A rollback's
selection is held exactly to the staged slot it selects, and cache
lengths and positions are integers and must be exactly equal. The
engines' token streams and every `IterationTelemetry` and `StepTelemetry`
field are exactly equal under `clock="model"`."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import cost_model as jcm
from repro.core.controller import CascadeController as JCascade
from repro.core.controller import StaticKController as JStatic
from repro.kernels.linear_scan import linear_scan as jax_linear_scan
from repro.kernels.linear_scan import linear_scan_ref
from repro.models import rglru as jrglru
from repro.models import transformer as jT
from repro.serving import NGramDrafter as JNGram
from repro.serving import ServingEngine as JEngine
from repro.serving.engine import BatchedEngine as JBatched
from repro_torch import kernels as K
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import cost_model as tcm
from repro_torch.core.controller import CascadeController, StaticKController
from repro_torch.kernels import linear_scan_plain
from repro_torch.models import rglru as trglru
from repro_torch.models import transformer as tT
from repro_torch.serving import BatchedEngine, NGramDrafter, ServingEngine

OP_TOL = 1e-5
PASS_TOL = 1e-4
RGLRU_LEAVES = ("h", "conv")

# the reference's passes, jitted: the pattern stack's Python loop of layers
# runs an order of magnitude faster traced once than op by op
_jit = functools.partial(jax.jit, static_argnums=(0,))
j_prefill = _jit(jT.prefill)
j_decode_step = _jit(jT.decode_step)
j_prefill_chunk = _jit(jT.prefill_chunk)
j_train_forward = jax.jit(jT.train_forward, static_argnums=(0,),
                          static_argnames=("moe_exact",))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _allclose(actual, ref, tol):
    ref = np.asarray(ref, np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(_np(actual).astype(np.float32), ref,
                               rtol=tol, atol=tol * scale)


def _torch_tree(tree):
    return params_from_numpy(jax.device_get(tree), device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _mqa256(cfg):
    """The reduced config with RecurrentGemma-9B's attention heads: one KV
    head at head_dim 256."""
    return dataclasses.replace(cfg, num_kv_heads=1, head_dim=256)


@pytest.fixture(scope="module")
def rg_small():
    """The reduced RecurrentGemma (vocab 512): JAX params and their torch
    copy, and the same for its head_dim-256 MQA variant."""
    out = {}
    for name, cfg in (("reduced", jax_get_config("recurrentgemma-9b")
                       .reduced()),
                      ("mqa256", _mqa256(jax_get_config("recurrentgemma-9b")
                                         .reduced()))):
        jp = jT.init_params(cfg, jax.random.PRNGKey(0))
        out[name] = (cfg, jp, _torch_tree(jp))
    return out


@pytest.fixture(scope="module")
def rg_engine():
    """The reduced RecurrentGemma at vocab 16: random weights whose greedy
    streams repeat often enough for the n-gram drafter to propose, with
    drafts accepted in full, in part and not at all (params seed 2,
    prompts seed 0 were picked for that mix). The prompts and 32 new
    tokens outgrow the local window of 32."""
    cfg = dataclasses.replace(jax_get_config("recurrentgemma-9b").reduced(),
                              vocab_size=16)
    jp = jT.init_params(cfg, jax.random.PRNGKey(2))
    rng = np.random.default_rng(0)
    prompts = [[1] + rng.integers(3, 16, 20 + 3 * i).tolist()
               for i in range(3)]
    return cfg, jp, _torch_tree(jp), prompts


def _rec_layer(tree):
    """The first "R" layer's recurrent-block params."""
    return tree["blocks_list"][0]["rec"]


# --------------------------------------------------------------------- #
# (a) the config
# --------------------------------------------------------------------- #

def test_recurrentgemma_config_equals_reference():
    ref, port = (jax_get_config("recurrentgemma-9b"),
                 get_config("recurrentgemma-9b"))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert port.param_count() == ref.param_count() == 10_444_242_944
    assert port.layer_kinds() == ("R", "R", "A") * 12 + ("R", "R")
    assert (port.num_heads, port.num_kv_heads, port.head_dim) == (16, 1, 256)
    assert (port.d_rnn, port.local_window, port.conv1d_width) == \
        (4096, 2048, 4)
    assert "recurrentgemma-9b" in ALL_ARCHS


# --------------------------------------------------------------------- #
# (b) the recurrence's plain version
# --------------------------------------------------------------------- #

def _scan_inputs(rng, b, t, d):
    a = (1 / (1 + np.exp(-rng.normal(3, 1, (b, t, d))))).astype(np.float32)
    x = rng.normal(0, 1, (b, t, d)).astype(np.float32)
    h0 = rng.normal(0, 1, (b, d)).astype(np.float32)
    return a, x, h0


@pytest.mark.parametrize("b,t,d", [
    (1, 1, 256), (1, 5, 4096), (4, 32, 200), (2, 33, 77), (3, 100, 130),
])
def test_linear_scan_plain_matches_reference(b, t, d):
    """y and h_last against `linear_scan_ref` (the TPU kernel's oracle), at
    any T and at D that is no multiple of 128."""
    a, x, h0 = _scan_inputs(np.random.default_rng(b * 100 + t), b, t, d)
    y, h_last = linear_scan_plain(_t(a), _t(x), _t(h0))
    ry, rh = linear_scan_ref(a, x, h0)
    _allclose(y, ry, OP_TOL)
    _allclose(h_last, rh, OP_TOL)
    assert torch.equal(h_last, y[:, -1])


@pytest.mark.parametrize("b,t,d,bt,bd", [(2, 32, 256, 8, 128),
                                         (1, 48, 128, 16, 128)])
def test_linear_scan_plain_matches_pallas_interpret(b, t, d, bt, bd):
    """Against the Pallas kernel itself, in interpret mode, at T and D
    that its blocks divide (the only shapes it takes)."""
    a, x, h0 = _scan_inputs(np.random.default_rng(t + d), b, t, d)
    y, h_last = linear_scan_plain(_t(a), _t(x), _t(h0))
    py, ph = jax_linear_scan(a, x, h0, force_pallas=True, bt=bt, bd=bd)
    _allclose(y, py, OP_TOL)
    _allclose(h_last, ph, OP_TOL)


# --------------------------------------------------------------------- #
# (c) the conv, the RG-LRU and the block
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("t", [1, 6])
def test_rglru_ops_and_block_match_reference(rg_small, t):
    """`causal_conv1d`, `rg_lru` and `apply_rglru_block` with staged states
    against the JAX functions; the staged windows and the new conv state
    are new tensors, not views of the state they started from."""
    cfg, jp, tp = rg_small["reduced"]
    jl, tl = _rec_layer(jp), _rec_layer(tp)
    rng = np.random.default_rng(t)
    b, d, dr, cw = 2, cfg.d_model, cfg.d_rnn, cfg.conv1d_width
    x = rng.normal(0, 1, (b, t, d)).astype(np.float32)
    u = rng.normal(0, 1, (b, t, dr)).astype(np.float32)
    h0 = rng.normal(0, 1, (b, dr)).astype(np.float32)
    conv0 = rng.normal(0, 1, (b, cw - 1, dr)).astype(np.float32)

    conv_t = _t(conv0)
    ty, tstate, tstaged = trglru.causal_conv1d(tl, _t(u), conv_t,
                                               want_states=True)
    jy, jstate, jstaged = jrglru.causal_conv1d(jl, u, conv0,
                                               want_states=True)
    for got, ref in ((ty, jy), (tstate, jstate), (tstaged, jstaged)):
        _allclose(got, ref, OP_TOL)
    assert tstaged.shape == (t + 1, b, cw - 1, dr)
    conv_t.fill_(7.0)
    _allclose(tstaged, jstaged, OP_TOL)
    _allclose(tstate, jstate, OP_TOL)

    ty, th, tst = trglru.rg_lru(tl, _t(u), _t(h0), want_states=True)
    jy, jh, jst = jrglru.rg_lru(jl, u, h0, want_states=True)
    for got, ref in ((ty, jy), (th, jh), (tst, jst)):
        _allclose(got, ref, OP_TOL)
    np.testing.assert_array_equal(_np(tst[0]), h0)

    state = {"h": _t(h0), "conv": _t(conv0)}
    tout, tnew, tstg = trglru.apply_rglru_block(cfg, tl, _t(x), state,
                                                want_states=True)
    jout, jnew, jstg = jrglru.apply_rglru_block(
        cfg, jl, x, {"h": h0, "conv": conv0}, want_states=True)
    _allclose(tout, jout, OP_TOL)
    for name in RGLRU_LEAVES:
        _allclose(tnew[name], jnew[name], OP_TOL)
        _allclose(tstg[name], jstg[name], OP_TOL)
    tout2, tnew2, tstg2 = trglru.apply_rglru_block(cfg, tl, _t(x), state)
    assert tstg2 is None and torch.equal(tout2, tout)


def test_bf16_block_keeps_lam_and_gate_products_in_float32():
    """In a bf16 model `lam` is float32 (from `init_params` and from
    `params_from_numpy`), and the gate products are float32 products of
    the bf16 values: the RG-LRU's float32 state and last state agree with
    the JAX package's at float32 precision, not bf16's."""
    cfg = dataclasses.replace(jax_get_config("recurrentgemma-9b").reduced(),
                              dtype="bfloat16")
    tp = tT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert tp["blocks_list"][0]["rec"]["lam"].dtype == torch.float32
    assert tp["blocks_list"][0]["rec"]["w_a"].dtype == torch.bfloat16
    jp = jT.init_params(cfg, jax.random.PRNGKey(0))
    cp = _torch_tree(jp)
    jl, tl = _rec_layer(jp), _rec_layer(cp)
    assert tl["lam"].dtype == torch.float32
    assert tl["w_x"].dtype == torch.bfloat16
    rng = np.random.default_rng(3)
    u = rng.normal(0, 1, (2, 7, cfg.d_rnn)).astype(np.float32)
    h0 = rng.normal(0, 1, (2, cfg.d_rnn)).astype(np.float32)
    u_b = jnp.asarray(u, jnp.bfloat16)
    ty, th, tst = trglru.rg_lru(tl, _t(np.asarray(u_b).view(np.int16)).view(
        torch.bfloat16), _t(h0), want_states=True)
    jy, jh, jst = jrglru.rg_lru(jl, u_b, h0, want_states=True)
    assert ty.dtype == torch.bfloat16 and th.dtype == torch.float32
    _allclose(th, jh, OP_TOL)
    _allclose(tst, jst, OP_TOL)


# --------------------------------------------------------------------- #
# (d) whole passes, staged states and rollback
# --------------------------------------------------------------------- #

def _check_cache(tc, jc, tol=PASS_TOL):
    for name in RGLRU_LEAVES + ("k", "v"):
        _allclose(tc[name], jc[name], tol)
    np.testing.assert_array_equal(_np(tc["pos"]), np.asarray(jc["pos"]))
    assert int(tc["length"]) == int(jc["length"])
    if "lengths" in jc:
        np.testing.assert_array_equal(_np(tc["lengths"]),
                                      np.asarray(jc["lengths"]))


@pytest.mark.parametrize("variant", ["reduced", "mqa256"])
def test_decode_matches_reference_and_rollback(rg_small, variant):
    """Prefill 40 tokens (past the local window of 32), decode a [1+4]
    span, roll back to 1 accepted, decode the rest again; held against the
    reference's logits, caches and staged states at every step, and
    against its full forward."""
    cfg, jp, tp = rg_small[variant]
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (1, 45), 0,
                                         cfg.vocab_size), np.int32)
    full, _ = j_train_forward(cfg, jp, jnp.asarray(toks), moe_exact=True)

    jc = jT.init_cache(cfg, 1, 64)
    tc = tT.init_cache(cfg, 1, 64, device="cpu")
    assert set(tc) == set(jc) == {"length", "pos", "k", "v", *RGLRU_LEAVES}
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape
    jlo, jc, _ = j_prefill(cfg, jp, jnp.asarray(toks[:, :40]), jc)
    tlo, tc, aux = tT.prefill(cfg, tp, _t(toks[:, :40]), tc)
    assert aux == {}
    _allclose(tlo, jlo, PASS_TOL)
    _check_cache(tc, jc)

    before = {name: tc[name].clone() for name in RGLRU_LEAVES}
    jlo, jc2, _, jst = j_decode_step(cfg, jp, jc, jnp.asarray(toks[:, 40:]))
    tlo, tc2, aux, tst = tT.decode_step(cfg, tp, tc, _t(toks[:, 40:]))
    assert aux == {}
    # the pass leaves the recurrent leaves it was given as they were
    for name in RGLRU_LEAVES:
        assert torch.equal(tc[name], before[name])
    _allclose(tlo, jlo, PASS_TOL)
    _allclose(tlo, full[:, 40:45], PASS_TOL)
    _check_cache(tc2, jc2)
    assert set(tst) == set(RGLRU_LEAVES)
    for name in RGLRU_LEAVES:
        assert tst[name].shape == jst[name].shape
        _allclose(tst[name], jst[name], PASS_TOL)
        # slot 0 holds the cache the pass started from
        assert torch.equal(tst[name][:, 0], tc[name])

    jc3 = jT.rollback_cache(cfg, jc2, jst, 1, 40)
    tc3 = tT.rollback_cache(cfg, tc2, tst, 1, 40)
    assert int(tc3["length"]) == 41
    _check_cache(tc3, jc3)
    for name in RGLRU_LEAVES:
        assert torch.equal(tc3[name], tst[name][:, 1])
    jlo2, _, _, _ = j_decode_step(cfg, jp, jc3, jnp.asarray(toks[:, 41:]))
    tlo2, _, _, _ = tT.decode_step(cfg, tp, tc3, _t(toks[:, 41:]))
    _allclose(tlo2, jlo2, PASS_TOL)
    _allclose(tlo2, full[:, 41:45], PASS_TOL)


def test_per_row_rollback_matches_reference(rg_small):
    """A B=3 per-row cache on the head_dim-256 variant: rows joined by
    blocking prefill at different lengths (row 1 empty, row 2 past the
    window), one ragged padded pass, a per-row rollback, a prefill chunk,
    a retire and a scalar rollback, every leaf against the reference's
    after each step. The retired row's h and conv read zero in the port
    and keep their state in the reference (its known fault); the other
    rows agree."""
    cfg, jp, tp = rg_small["mqa256"]
    rng = np.random.default_rng(21)
    b, max_len = 3, 64
    jc = jT.init_cache(cfg, b, max_len, per_row=True)
    tc = tT.init_cache(cfg, b, max_len, per_row=True, device="cpu")
    _check_cache(tc, jc)
    for slot, n in ((0, 9), (2, 36)):
        prompt = rng.integers(3, cfg.vocab_size, (1, n)).astype(np.int32)
        jlo, jrow, _ = j_prefill(cfg, jp, jnp.asarray(prompt),
                                  jT.init_cache(cfg, 1, max_len))
        tlo, trow, _ = tT.prefill(cfg, tp, _t(prompt),
                                  tT.init_cache(cfg, 1, max_len,
                                                device="cpu"))
        _allclose(tlo, jlo, PASS_TOL)
        jc = jT.write_cache_row(jc, slot, jrow)
        tc = tT.write_cache_row(tc, slot, trow)
        _check_cache(tc, jc)

    toks = rng.integers(3, cfg.vocab_size, (b, 5)).astype(np.int32)
    mask = np.array([[1, 1, 1, 0, 0], [1] * 5, [1] * 5], bool)
    lengths_before = np.array(jc["lengths"])
    jlo, jc2, _, jst = j_decode_step(cfg, jp, jc, jnp.asarray(toks),
                                      token_mask=jnp.asarray(mask))
    tlo, tc2, _, tst = tT.decode_step(cfg, tp, tc, _t(toks),
                                      token_mask=_t(mask))
    _allclose(tlo, jlo, PASS_TOL)
    _check_cache(tc2, jc2)

    n_keep = np.array([2, 5, 0], np.int32)
    jc3 = jT.rollback_cache(cfg, jc2, jst, jnp.asarray(n_keep),
                            jnp.asarray(lengths_before))
    tc3 = tT.rollback_cache(cfg, tc2, tst, _t(n_keep), _t(lengths_before))
    _check_cache(tc3, jc3)
    for row, j in enumerate(n_keep):
        for name in RGLRU_LEAVES:
            assert torch.equal(tc3[name][:, row], tst[name][:, j, row])

    chunk = rng.integers(3, cfg.vocab_size, (b, 4)).astype(np.int32)
    cmask = np.array([[0] * 4, [1, 1, 1, 0], [0] * 4], bool)
    jlo, jc4, _, jst = j_prefill_chunk(cfg, jp, jc3, jnp.asarray(chunk),
                                        token_mask=jnp.asarray(cmask))
    tlo, tc4, _, tst = tT.prefill_chunk(cfg, tp, tc3, _t(chunk),
                                        token_mask=_t(cmask))
    _allclose(tlo[1, :3], jlo[1, :3], PASS_TOL)
    n_keep = np.array([0, 3, 0], np.int32)
    before = np.array(jc3["lengths"])
    jc4 = jT.rollback_cache(cfg, jc4, jst, jnp.asarray(n_keep),
                            jnp.asarray(before))
    tc4 = tT.rollback_cache(cfg, tc4, tst, _t(n_keep), _t(before))
    _check_cache(tc4, jc4)

    jc5 = jT.clear_cache_row(jc4, 0)
    tc5 = tT.clear_cache_row(tc4, 0)
    for name in RGLRU_LEAVES:
        assert not bool(torch.any(tc5[name][:, 0] != 0))
        assert np.any(np.asarray(jc5[name])[:, 0] != 0)
        _allclose(tc5[name][:, 1:], np.asarray(jc5[name])[:, 1:], PASS_TOL)
    np.testing.assert_array_equal(_np(tc5["pos"]), np.asarray(jc5["pos"]))
    np.testing.assert_array_equal(_np(tc5["lengths"]),
                                  np.asarray(jc5["lengths"]))
    # a scalar rollback selects the same staged slot for every row (row 0,
    # cleared in the port only, is left out)
    jlo, jc6, _, jst = j_decode_step(cfg, jp, jc5, jnp.asarray(toks[:, :2]))
    tlo, tc6, _, tst = tT.decode_step(cfg, tp, tc5, _t(toks[:, :2]))
    _allclose(tlo[1:], jlo[1:], PASS_TOL)
    jc7 = jT.rollback_cache(cfg, jc6, jst, 1, 40)
    tc7 = tT.rollback_cache(cfg, tc6, tst, 1, 40)
    for name in RGLRU_LEAVES:
        _allclose(tc7[name][:, 1:], np.asarray(jc7[name])[:, 1:], PASS_TOL)
        assert torch.equal(tc7[name], tst[name][:, 1])
    np.testing.assert_array_equal(_np(tc7["pos"]), np.asarray(jc7["pos"]))
    np.testing.assert_array_equal(_np(tc7["lengths"]), [41, 41, 41])
    assert int(tc7["length"]) == int(jc7["length"]) == 41


def test_pattern_pass_on_cpu_launches_no_kernel(rg_small):
    cfg, _, tp = rg_small["mqa256"]
    K.reset_launch_counts()
    cache = tT.init_cache(cfg, 2, 32, device="cpu", per_row=True)
    toks = torch.tensor([[4, 5, 6], [7, 8, 9]], dtype=torch.int32)
    _, cache, _, staged = tT.decode_step(cfg, tp, cache, toks)
    assert staged["h"].shape == (2, 4, 2, cfg.d_rnn)
    assert staged["conv"].shape == (2, 4, 2, cfg.conv1d_width - 1, cfg.d_rnn)
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


# --------------------------------------------------------------------- #
# (e) the cost model, (f) the engines
# --------------------------------------------------------------------- #

def _hw_pair():
    fields = dataclasses.asdict(tcm.H100_SXM)
    return jcm.Hardware(**fields), tcm.Hardware(**fields)


@pytest.mark.parametrize("n_tokens,context", [(1, 100), (5, 1500),
                                              (5, 3000), (33, 9000)])
def test_cost_model_prices_a_hybrid_pass_as_reference(n_tokens, context):
    """The model clock of the whole RecurrentGemma-9B: the "R" layers'
    weights and state, the local window capping the "A" layers' context."""
    cfg_j = jax_get_config("recurrentgemma-9b")
    cfg_t = get_config("recurrentgemma-9b")
    jhw, thw = _hw_pair()
    assert (tcm.iteration_time(cfg_t, thw, n_tokens, context)
            == jcm.iteration_time(cfg_j, jhw, n_tokens, context))
    assert (tcm.prefill_time(cfg_t, thw, context)
            == jcm.prefill_time(cfg_j, jhw, context))


def _factories(policy):
    if policy == "cascade":
        return JCascade, CascadeController
    return (lambda: JStatic(4)), (lambda: StaticKController(4))


def _acceptance(iterations):
    """(passes that accepted none of their drafts, passes that accepted
    some but not all)."""
    none = sum(1 for it in iterations
               if it.k_drafted > 0 and it.tokens_emitted == 1)
    part = sum(1 for it in iterations
               if 0 < it.tokens_emitted - 1 < it.k_drafted)
    return none, part


def _same_iterations(tr, jr):
    assert tr.tokens == jr.tokens
    assert ([dataclasses.asdict(it) for it in tr.telemetry.iterations]
            == [dataclasses.asdict(it) for it in jr.telemetry.iterations])
    for f in ("t_prefill", "t_queue", "ttft", "prefill_chunks"):
        assert getattr(tr.telemetry, f) == getattr(jr.telemetry, f)


@pytest.mark.parametrize("policy", ["cascade", "static"])
def test_serving_engine_streams_and_telemetry_equal_jax(rg_engine, policy):
    cfg, jp, tp, prompts = rg_engine
    jhw, thw = _hw_pair()
    jfac, tfac = _factories(policy)
    kw = dict(max_len=128, temperature=0.0, clock="model")
    jeng = JEngine(cfg, jp, JNGram(), controller_factory=jfac, hw=jhw, **kw)
    teng = ServingEngine(cfg, tp, NGramDrafter(), controller_factory=tfac,
                         hw=thw, device="cpu", **kw)
    its = []
    for i, prompt in enumerate(prompts):
        jr = jeng.generate(prompt, max_new=32, request_id=str(i))
        tr = teng.generate(prompt, max_new=32, request_id=str(i))
        _same_iterations(tr, jr)
        its += tr.telemetry.iterations
    none, part = _acceptance(its)
    assert none > 0 and part > 0


def _serve(eng, prompts, max_new, on_retire=None):
    """Continuous batching: join while a row is free, step, retire what
    finished. Returns the results by prompt index."""
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
                if on_retire is not None:
                    on_retire(eng, slot)
    return done


@pytest.mark.parametrize("max_batch,chunk,policy", [
    (1, 0, "static"), (3, 0, "cascade"), (1, 8, "cascade"),
    (3, 8, "static"),
])
def test_batched_engine_streams_and_telemetry_equal_jax(rg_engine,
                                                        max_batch, chunk,
                                                        policy):
    """Each policy at both batch sizes and both admission modes. Under
    chunked admission no more requests than rows, so that no request joins
    a recycled row (the reference's fault,
    test_chunked_admission_into_a_recycled_row_starts_fresh)."""
    cfg, jp, tp, prompts = rg_engine
    if chunk:
        prompts = prompts[:max_batch]
    jhw, thw = _hw_pair()
    jfac, tfac = _factories(policy)
    kw = dict(max_len=128, temperature=0.0, clock="model",
              max_batch=max_batch, chunk=chunk)
    jeng = JBatched(cfg, jp, controller_factory=jfac, hw=jhw, **kw)
    teng = BatchedEngine(cfg, tp, controller_factory=tfac, hw=thw,
                         device="cpu", **kw)
    jres = _serve(jeng, prompts, 32)
    tres = _serve(teng, prompts, 32)
    assert sorted(tres) == sorted(jres) == list(range(len(prompts)))
    for i in jres:
        _same_iterations(tres[i], jres[i])
    assert ([dataclasses.asdict(s) for s in teng.telemetry.steps]
            == [dataclasses.asdict(s) for s in jeng.telemetry.steps])
    assert teng.now == jeng.now
    if max_batch > 1:
        assert max(s.occupancy for s in teng.telemetry.steps) > 1
    none, part = _acceptance(
        [it for r in tres.values() for it in r.telemetry.iterations])
    assert none > 0 and part > 0


def test_chunked_admission_into_a_recycled_row_starts_fresh(rg_engine):
    """max_batch=2, chunk=8, 3 requests: the third joins the row the first
    left, and its stream is the one it has alone in the JAX ServingEngine
    (and in the port's). Each retired row's h and conv read zero. (The
    reference's clear_cache_row leaves them, so in its BatchedEngine the
    third stream starts from the state the first request left.)"""
    cfg, jp, tp, prompts = rg_engine
    jalone = JEngine(cfg, jp, JNGram(), max_len=128, temperature=0.0)
    ref = [jalone.generate(p, max_new=32).tokens for p in prompts]
    kw = dict(max_len=128, temperature=0.0, device="cpu")
    alone = ServingEngine(cfg, tp, NGramDrafter(), **kw)
    assert [alone.generate(p, max_new=32).tokens for p in prompts] == ref
    retired = []

    def check_cleared(eng, slot):
        retired.append(slot)
        for name in RGLRU_LEAVES:
            assert not bool(torch.any(eng.cache[name][:, slot] != 0))

    eng = BatchedEngine(cfg, tp, max_batch=2, chunk=8, **kw)
    res = _serve(eng, prompts, 32, on_retire=check_cleared)
    assert [res[i].tokens for i in range(3)] == ref
    assert len(retired) == 3 and len(set(retired)) == 2   # a row recycled
