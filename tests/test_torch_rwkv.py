"""The port's RWKV-6 family against the JAX package on the CPU: the config,
the WKV recurrence's plain version, the time-mix and channel-mix blocks,
whole passes with staged states and rollback (single-request and per-row
caches), and both serving engines on the reduced RWKV-6 (2 layers, d=256,
8 heads of 32) in float32, with the JAX params carried across by
`params_from_numpy`.

Tolerances: the recurrence and the blocks at rtol = 1e-5 and atol = 1e-5 of
max(1, max|ref|) (float32 sums over N = 32 or 64 products in another
order); whole passes at 1e-4 on the same terms (a few float32 layers).
Cache lengths are integers and must be exactly equal. The engines' token
streams and every `IterationTelemetry` and `StepTelemetry` field are
exactly equal under `clock="model"`.

Training: the recurrence's plain backward against `jax.vjp` of `wkv_scan`
(y's and the last state's cotangents; T = 1, 5 and 40, which crosses a
32-token chunk) within 1e-5 of max|ref| for each of the six gradients,
and `loss_fn` with every parameter's gradient against
`jax.value_and_grad` of the reference's (each layer from zero states),
within 5e-5 * max|g_ref| + 1e-7 a leaf (the decay's gradients reach
1.5e-5: see the test)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import cost_model as jcm
from repro.core.controller import CascadeController as JCascade
from repro.core.controller import StaticKController as JStatic
from repro.kernels.rwkv_scan.ref import rwkv_scan_ref
from repro.models import rwkv as jrwkv
from repro.models import transformer as jT
from repro.serving import NGramDrafter as JNGram
from repro.serving import ServingEngine as JEngine
from repro.serving.engine import BatchedEngine as JBatched
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import cost_model as tcm
from repro_torch.core.controller import CascadeController, StaticKController
from repro_torch.kernels import RwkvScan, rwkv_scan_bwd_plain, rwkv_scan_plain
from repro_torch.models import rwkv as trwkv
from repro_torch.models import transformer as tT
from repro_torch.serving import BatchedEngine, NGramDrafter, ServingEngine
from test_torch_batching import _share_jits
from test_torch_families import assert_loss_and_grads
from test_torch_guards import torch_one_thread  # noqa: F401,E402 (autouse)

OP_TOL = 1e-5
PASS_TOL = 1e-4
RWKV_LEAVES = ("wkv", "sx_att", "sx_ffn")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _allclose(actual, ref, tol):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(_np(actual), ref, rtol=tol, atol=tol * scale)


def _torch_tree(tree):
    return params_from_numpy(jax.device_get(tree), device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def rwkv_small():
    """The reduced RWKV-6 (vocab 512), JAX params and their torch copy."""
    cfg = jax_get_config("rwkv6-3b").reduced()
    jp = jT.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, jp, _torch_tree(jp)


@pytest.fixture(scope="module")
def rwkv_engine():
    """The reduced RWKV-6 at vocab 16: random weights whose greedy streams
    repeat often enough for the n-gram drafter to propose, with drafts
    accepted in full, in part and not at all (params seed 1, prompts seed
    0 were picked for that mix)."""
    cfg = dataclasses.replace(jax_get_config("rwkv6-3b").reduced(),
                              vocab_size=16)
    jp = jT.init_params(cfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(0)
    prompts = [[1] + rng.integers(3, 16, 20 + 3 * i).tolist()
               for i in range(3)]
    return cfg, jp, _torch_tree(jp), prompts


def _layer0(tree):
    """Layer 0 of a stacked [L, ...] tree, JAX arrays or tensors."""
    return {k: (_layer0(v) if isinstance(v, dict) else v[0])
            for k, v in tree.items()}


# --------------------------------------------------------------------- #
# (a) the config
# --------------------------------------------------------------------- #

def test_rwkv_config_equals_reference():
    ref, port = jax_get_config("rwkv6-3b"), get_config("rwkv6-3b")
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert port.param_count() == ref.param_count() == 3_303_014_400
    assert port.layer_kinds() == ("W",) * 32
    assert (port.rwkv_num_heads, port.rwkv_head_size) == (40, 64)
    assert "rwkv6-3b" in ALL_ARCHS


# --------------------------------------------------------------------- #
# (b) the recurrence's plain version
# --------------------------------------------------------------------- #

def _scan_inputs(rng, b, t, h, n):
    r, k, v = (rng.normal(0, 1, (b, t, h, n)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.normal(-1, 1, (b, t, h, n)))).astype(np.float32)
    u = rng.normal(0, 0.5, (h, n)).astype(np.float32)
    s0 = rng.normal(0, 1, (b, h, n, n)).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("b,t,h,n", [
    (1, 5, 2, 64), (3, 8, 2, 32), (3, 7, 3, 8), (1, 16, 1, 8), (1, 1, 4, 32),
])
def test_rwkv_scan_plain_matches_reference(b, t, h, n):
    """y, s_last and every staged state against `rwkv_scan_ref` (the TPU
    kernel's oracle) and `wkv_scan` (the model path's, with states)."""
    args = _scan_inputs(np.random.default_rng(b * 100 + t), b, t, h, n)
    states = torch.full((t + 1, b, h, n, n), float("nan"))
    y, s_last = rwkv_scan_plain(*map(_t, args), states=states)
    ry, rs = rwkv_scan_ref(*args)
    wy, wstates = jrwkv.wkv_scan(*args)
    for ref in (ry, wy):
        _allclose(y, ref, OP_TOL)
    _allclose(s_last, rs, OP_TOL)
    _allclose(states, wstates, OP_TOL)
    # slot 0 is the initial state itself, and the last slot is s_last
    np.testing.assert_array_equal(_np(states[0]), args[5])
    assert torch.equal(states[-1], s_last)
    # without staged states, the same y and s_last
    y2, s2 = rwkv_scan_plain(*map(_t, args))
    assert torch.equal(y2, y) and torch.equal(s2, s_last)


_j_wkv_vjp = jax.jit(lambda args, cot: jax.vjp(
    lambda *a: (lambda y, st: (y, st[-1]))(*jrwkv.wkv_scan(*a)), *args)[1](
        cot))


@pytest.mark.parametrize("t", [1, 5, 40])
def test_rwkv_scan_bwd_plain_matches_jax_vjp(t):
    """dr, dk, dv, dw, du and ds0 of `rwkv_scan_bwd_plain` against
    `jax.vjp` of `wkv_scan` with seeded cotangents for y and the last
    state, each within 1e-5 * max|ref| (float32 sums over N products and
    T steps in another order), and the same through `RwkvScan`."""
    b, h, n = 2, 2, 32
    rng = np.random.default_rng(40 + t)
    args = _scan_inputs(rng, b, t, h, n)
    dy = rng.normal(0, 1, (b, t, h, n)).astype(np.float32)
    ds = rng.normal(0, 1, (b, h, n, n)).astype(np.float32)
    ref = _j_wkv_vjp(tuple(map(jnp.asarray, args)),
                     (jnp.asarray(dy), jnp.asarray(ds)))
    got = rwkv_scan_bwd_plain(*map(_t, args), _t(dy), _t(ds))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape
        err = float(np.abs(_np(g) - r).max())
        assert err <= 1e-5 * float(np.abs(r).max()), err
    leaves = [_t(a).requires_grad_() for a in args]
    y, s_last = RwkvScan.apply(*leaves)
    auto = torch.autograd.grad((y, s_last), leaves, (_t(dy), _t(ds)))
    for a, g in zip(auto, got):
        assert torch.equal(a, g)


def test_train_loss_and_gradients_match_jax(rwkv_small):
    """`loss_fn` of the reduced RWKV-6 (each layer from zero token-shift
    and WKV states; the recurrence through `RwkvScan`) and every
    parameter's gradient against the reference's: the loss within 5e-5,
    each leaf within 5e-5 * max|g_ref| + 1e-7. The decay's LoRA (`wa`,
    `wb`) and `mu_w` come to 1.5e-5 of their max|g|: their gradient
    passes through w = exp(-exp(ww)) and sums dw over the N x N state
    and every token, in another float32 order than XLA's."""
    cfg, jp, tp = rwkv_small
    rng = np.random.default_rng(11)
    toks, labels = (rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
                    for _ in range(2))
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": _t(toks), "labels": _t(labels)}
    assert assert_loss_and_grads(cfg, jp, tp, jb, tb, rel=5e-5) > 20


# --------------------------------------------------------------------- #
# (c) the blocks
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("t", [1, 6])
def test_time_mix_and_channel_mix_match_reference(rwkv_small, t):
    cfg, jp, tp = rwkv_small
    jl, tl = _layer0(jp["blocks"]), _layer0(tp["blocks"])
    rng = np.random.default_rng(t)
    b, d = 2, cfg.d_model
    h, n = cfg.rwkv_num_heads, cfg.rwkv_head_size
    x = rng.normal(0, 1, (b, t, d)).astype(np.float32)
    x_prev = rng.normal(0, 1, (b, d)).astype(np.float32)
    s0 = rng.normal(0, 0.5, (b, h, n, n)).astype(np.float32)

    jout, jlast, js, jstates = jrwkv.time_mix(cfg, jl["tmix"], x, x_prev,
                                              s0, want_states=True)
    states = torch.empty((t + 1, b, h, n, n))
    tout, tlast, ts = trwkv.time_mix(cfg, tl["tmix"], _t(x), _t(x_prev),
                                     _t(s0), states=states)
    _allclose(tout, jout, OP_TOL)
    _allclose(tlast, jlast, OP_TOL)
    _allclose(ts, js, OP_TOL)
    _allclose(states, jstates, OP_TOL)

    jout2, jlast2 = jrwkv.channel_mix(cfg, jl["cmix"], x, x_prev)
    tout2, tlast2 = trwkv.channel_mix(cfg, tl["cmix"], _t(x), _t(x_prev))
    _allclose(tout2, jout2, OP_TOL)
    _allclose(tlast2, jlast2, OP_TOL)


def test_group_norm_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(0, 3, (2, 3, 64)).astype(np.float32)
    scale = rng.normal(1, 0.1, (64,)).astype(np.float32)
    bias = rng.normal(0, 0.1, (64,)).astype(np.float32)
    _allclose(trwkv._group_norm(_t(x), _t(scale), _t(bias), 4),
              jrwkv._group_norm(x, scale, bias, 4), OP_TOL)


# --------------------------------------------------------------------- #
# (d), (e) whole passes, staged states and rollback
# --------------------------------------------------------------------- #

def _check_rwkv_cache(tc, jc, tol=PASS_TOL):
    for name in RWKV_LEAVES:
        _allclose(tc[name], jc[name], tol)
    assert int(tc["length"]) == int(jc["length"])
    if "lengths" in jc:
        np.testing.assert_array_equal(_np(tc["lengths"]),
                                      np.asarray(jc["lengths"]))


def test_decode_matches_reference_and_rollback(rwkv_small):
    """The reference's test_decode_matches_full_forward_and_rollback case on
    the port: prefill 12, decode 3, roll back to 1 accepted, decode 2; held
    against the reference's logits, caches and staged states at every
    step, and against its full forward."""
    cfg, jp, tp = rwkv_small
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (1, 15), 0,
                                         cfg.vocab_size), np.int32)
    full, _ = jT.train_forward(cfg, jp, jnp.asarray(toks), moe_exact=True)

    jc = jT.init_cache(cfg, 1, 64)
    tc = tT.init_cache(cfg, 1, 64, device="cpu")
    assert set(tc) == set(jc) == {"length", *RWKV_LEAVES}
    jlo, jc, _ = jT.prefill(cfg, jp, jnp.asarray(toks[:, :12]), jc)
    tlo, tc, aux = tT.prefill(cfg, tp, _t(toks[:, :12]), tc)
    assert aux == {}
    _allclose(tlo, jlo, PASS_TOL)
    _check_rwkv_cache(tc, jc)

    before = {name: tc[name].clone() for name in RWKV_LEAVES}
    jlo, jc2, _, jst = jT.decode_step(cfg, jp, jc, jnp.asarray(toks[:, 12:]))
    tlo, tc2, _, tst = tT.decode_step(cfg, tp, tc, _t(toks[:, 12:]))
    # the pass leaves the cache it was given as it was
    for name in RWKV_LEAVES:
        assert torch.equal(tc[name], before[name])
    _allclose(tlo, jlo, PASS_TOL)
    _allclose(tlo, full[:, 12:15], PASS_TOL)
    _check_rwkv_cache(tc2, jc2)
    assert set(tst) == set(RWKV_LEAVES)
    for name in RWKV_LEAVES:
        assert tst[name].shape == jst[name].shape
        _allclose(tst[name], jst[name], PASS_TOL)
    # slot 0 holds the cache the pass started from
    for name in RWKV_LEAVES:
        assert torch.equal(tst[name][:, 0], tc[name])

    # reject 2 of 3 -> rollback -> re-verify must still match
    jc3 = jT.rollback_cache(cfg, jc2, jst, 1, 12)
    tc3 = tT.rollback_cache(cfg, tc2, tst, 1, 12)
    assert int(tc3["length"]) == 13
    _check_rwkv_cache(tc3, jc3)
    for name in RWKV_LEAVES:
        assert torch.equal(tc3[name], tst[name][:, 1])
    jlo2, _, _, _ = jT.decode_step(cfg, jp, jc3, jnp.asarray(toks[:, 13:]))
    tlo2, _, _, _ = tT.decode_step(cfg, tp, tc3, _t(toks[:, 13:]))
    _allclose(tlo2, jlo2, PASS_TOL)
    _allclose(tlo2, full[:, 13:15], PASS_TOL)


def test_per_row_rollback_matches_reference(rwkv_small):
    """A B=3 per-row cache: rows joined by blocking prefill at different
    lengths (row 1 empty), one ragged padded pass, a per-row rollback, a
    prefill chunk, a retire and a scalar rollback, every leaf against the
    reference's after each step. The retired row reads zero in the port
    and keeps its state in the reference (its known fault); the other
    rows agree."""
    cfg, jp, tp = rwkv_small
    rng = np.random.default_rng(21)
    b, max_len = 3, 64
    jc = jT.init_cache(cfg, b, max_len, per_row=True)
    tc = tT.init_cache(cfg, b, max_len, per_row=True, device="cpu")
    _check_rwkv_cache(tc, jc)
    for slot, n in ((0, 9), (2, 14)):
        prompt = rng.integers(3, cfg.vocab_size, (1, n)).astype(np.int32)
        jlo, jrow, _ = jT.prefill(cfg, jp, jnp.asarray(prompt),
                                  jT.init_cache(cfg, 1, max_len))
        tlo, trow, _ = tT.prefill(cfg, tp, _t(prompt),
                                  tT.init_cache(cfg, 1, max_len,
                                                device="cpu"))
        _allclose(tlo, jlo, PASS_TOL)
        jc = jT.write_cache_row(jc, slot, jrow)
        tc = tT.write_cache_row(tc, slot, trow)
        _check_rwkv_cache(tc, jc)

    toks = rng.integers(3, cfg.vocab_size, (b, 5)).astype(np.int32)
    mask = np.array([[1, 1, 1, 0, 0], [1] * 5, [1] * 5], bool)
    lengths_before = np.array(jc["lengths"])
    jlo, jc2, _, jst = jT.decode_step(cfg, jp, jc, jnp.asarray(toks),
                                      token_mask=jnp.asarray(mask))
    tlo, tc2, _, tst = tT.decode_step(cfg, tp, tc, _t(toks),
                                      token_mask=_t(mask))
    _allclose(tlo, jlo, PASS_TOL)
    _check_rwkv_cache(tc2, jc2)

    n_keep = np.array([2, 5, 0], np.int32)
    jc3 = jT.rollback_cache(cfg, jc2, jst, jnp.asarray(n_keep),
                            jnp.asarray(lengths_before))
    tc3 = tT.rollback_cache(cfg, tc2, tst, _t(n_keep), _t(lengths_before))
    _check_rwkv_cache(tc3, jc3)
    for row, j in enumerate(n_keep):
        for name in RWKV_LEAVES:
            assert torch.equal(tc3[name][:, row], tst[name][:, j, row])

    chunk = rng.integers(3, cfg.vocab_size, (b, 4)).astype(np.int32)
    cmask = np.array([[0] * 4, [1, 1, 1, 0], [0] * 4], bool)
    jlo, jc4, _, jst = jT.prefill_chunk(cfg, jp, jc3, jnp.asarray(chunk),
                                        token_mask=jnp.asarray(cmask))
    tlo, tc4, _, tst = tT.prefill_chunk(cfg, tp, tc3, _t(chunk),
                                        token_mask=_t(cmask))
    _allclose(tlo[1, :3], jlo[1, :3], PASS_TOL)
    n_keep = np.array([0, 3, 0], np.int32)
    before = np.array(jc3["lengths"])
    jc4 = jT.rollback_cache(cfg, jc4, jst, jnp.asarray(n_keep),
                            jnp.asarray(before))
    tc4 = tT.rollback_cache(cfg, tc4, tst, _t(n_keep), _t(before))
    _check_rwkv_cache(tc4, jc4)

    jc5 = jT.clear_cache_row(jc4, 0)
    tc5 = tT.clear_cache_row(tc4, 0)
    for name in RWKV_LEAVES:
        assert not bool(torch.any(tc5[name][:, 0] != 0))
        assert np.any(np.asarray(jc5[name])[:, 0] != 0)
        _allclose(tc5[name][:, 1:], np.asarray(jc5[name])[:, 1:], PASS_TOL)
    np.testing.assert_array_equal(_np(tc5["lengths"]),
                                  np.asarray(jc5["lengths"]))
    # a scalar rollback selects the same staged slot for every row (row 0,
    # cleared in the port only, is left out)
    jlo, jc6, _, jst = jT.decode_step(cfg, jp, jc5, jnp.asarray(toks[:, :2]))
    tlo, tc6, _, tst = tT.decode_step(cfg, tp, tc5, _t(toks[:, :2]))
    _allclose(tlo[1:], jlo[1:], PASS_TOL)
    jc7 = jT.rollback_cache(cfg, jc6, jst, 1, 10)
    tc7 = tT.rollback_cache(cfg, tc6, tst, 1, 10)
    for name in RWKV_LEAVES:
        _allclose(tc7[name][:, 1:], np.asarray(jc7[name])[:, 1:], PASS_TOL)
        assert torch.equal(tc7[name], tst[name][:, 1])
    np.testing.assert_array_equal(_np(tc7["lengths"]), [11, 11, 11])
    assert int(tc7["length"]) == int(jc7["length"]) == 11


# --------------------------------------------------------------------- #
# (f), (g) the engines
# --------------------------------------------------------------------- #

def _hw_pair():
    fields = dataclasses.asdict(tcm.H100_SXM)
    return jcm.Hardware(**fields), tcm.Hardware(**fields)


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
def test_serving_engine_streams_and_telemetry_equal_jax(rwkv_engine, policy):
    cfg, jp, tp, prompts = rwkv_engine
    jhw, thw = _hw_pair()
    jfac, tfac = _factories(policy)
    kw = dict(max_len=128, temperature=0.0, clock="model")
    jeng = _share_jits(JEngine(cfg, jp, JNGram(), controller_factory=jfac,
                               hw=jhw, **kw))
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
def test_batched_engine_streams_and_telemetry_equal_jax(rwkv_engine,
                                                        max_batch, chunk,
                                                        policy):
    """Each policy at both batch sizes and both admission modes. Under
    chunked admission no more requests than rows, so that no request joins
    a recycled row (the reference's fault,
    test_chunked_admission_into_a_recycled_row_starts_fresh)."""
    cfg, jp, tp, prompts = rwkv_engine
    if chunk:
        prompts = prompts[:max_batch]
    jhw, thw = _hw_pair()
    jfac, tfac = _factories(policy)
    kw = dict(max_len=128, temperature=0.0, clock="model",
              max_batch=max_batch, chunk=chunk)
    jeng = _share_jits(JBatched(cfg, jp, controller_factory=jfac, hw=jhw,
                                **kw))
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


def test_chunked_admission_into_a_recycled_row_starts_fresh(rwkv_engine):
    """max_batch=2, chunk=8, 3 requests: the third joins the row the first
    left, and its stream is the one it has alone in the JAX ServingEngine
    (and in the port's). Each retired row's recurrent state reads zero.
    (The reference's clear_cache_row leaves the state, so in its
    BatchedEngine the third stream differs.)"""
    cfg, jp, tp, prompts = rwkv_engine
    jalone = _share_jits(JEngine(cfg, jp, JNGram(), max_len=128,
                                 temperature=0.0))
    ref = [jalone.generate(p, max_new=32).tokens for p in prompts]
    kw = dict(max_len=128, temperature=0.0, device="cpu")
    alone = ServingEngine(cfg, tp, NGramDrafter(), **kw)
    assert [alone.generate(p, max_new=32).tokens for p in prompts] == ref
    retired = []

    def check_cleared(eng, slot):
        retired.append(slot)
        for name in RWKV_LEAVES:
            assert not bool(torch.any(eng.cache[name][:, slot] != 0))

    eng = BatchedEngine(cfg, tp, max_batch=2, chunk=8, **kw)
    res = _serve(eng, prompts, 32, on_retire=check_cleared)
    assert [res[i].tokens for i in range(3)] == ref
    assert len(retired) == 3 and len(set(retired)) == 2   # a row recycled
