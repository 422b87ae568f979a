"""The port's training path on the CPU against the JAX package: the
grouped expert matmul (K5's plain version) and `MoeGmm`, causal attention
with lse and `FlashAttention`, both optimizers, `loss_fn` gradients on
`tiny_moe`, three `train_step`s, the data pipeline and the launcher.

Tolerances: float32 against the reference at atol = rtol = 1e-5 of the
output's scale, max(1, max|ref|) for values of O(1) and up, or of
max|ref| itself for gradients (sums in another order); bfloat16 outputs at
rtol = 2^-7 (one bf16 rounding of a float32 sum taken in another order);
gradcheck in float64 at its defaults. Routing (`expert_idx`, `dropped`)
and the data pipeline's arrays are integers and must be exactly equal."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import copy_batch
from repro.data import batch_iterator as jbatch_iterator
from repro.data import make_sample as jmake_sample
from repro.data import request_stream as jrequest_stream
from repro.data.workloads import sample_length as jsample_length
from repro.kernels.moe_gmm.ref import moe_gmm_ref
from repro.models import attention as jattn
from repro.models import layers as jL
from repro.models import moe as jmoe
from repro.training import loss_fn as jloss_fn
from repro.training import make_train_step as jmake_train_step
from repro.training import optimizer as jopt
from repro_torch import kernels as K
from repro_torch.convert import params_from_numpy
from repro_torch.data import batch_iterator, make_sample, request_stream
from repro_torch.data.workloads import sample_length
from repro_torch.models import moe as tmoe
from repro_torch.training import loss_fn, make_train_step
from repro_torch.training import optimizer as topt

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(actual, ref, tol=TOL, floor=1.0):
    """|actual - ref| <= tol * (|ref| + max(floor, max|ref|))."""
    ref = np.asarray(ref, np.float32)
    scale = max(floor, float(np.abs(ref).max()))
    np.testing.assert_allclose(_np(actual).astype(np.float32), ref, rtol=tol,
                               atol=tol * scale)


def _grad_close(actual, ref, tol=TOL):
    """Gradients: tolerance relative to the leaf's own largest entry."""
    _close(actual, ref, tol, floor=1e-30)


def _torch(tree):
    return params_from_numpy(jax.device_get(tree), device="cpu")


# --------------------------------------------------------------------- #
# K5: the grouped expert matmul and MoeGmm
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("transpose_w", [False, True])
@pytest.mark.parametrize("e,c,d,f,counts", [
    (4, 37, 24, 40, (37, 0, 20, 64)),     # a count past C clamps to C
    (3, 9, 17, 33, (1, 8, 5)),            # odd C, d and F
])
def test_moe_gmm_plain_matches_ref(dtype, transpose_w, e, c, d, f, counts):
    rng = np.random.default_rng(c + d)
    x = rng.normal(0, 1, (e, c, d)).astype(np.float32)
    w = rng.normal(0, d ** -0.5, (e, d, f)).astype(np.float32)
    cnt = np.array(counts, np.int32)
    x[np.arange(c)[None, :] >= cnt[:, None]] = 0.0   # dead rows hold zeros
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    ref = moe_gmm_ref(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                      jnp.asarray(cnt))
    wt = np.ascontiguousarray(w.transpose(0, 2, 1)) if transpose_w else w
    out = K.moe_gmm(torch.from_numpy(x).to(tdt), torch.from_numpy(wt).to(tdt),
                    torch.from_numpy(cnt), transpose_w=transpose_w)
    assert out.dtype == tdt and tuple(out.shape) == (e, c, f)
    tol = TOL if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), rtol=tol,
                               atol=tol * float(np.abs(ref).max()))
    dead = np.arange(c)[None, :] >= cnt[:, None]
    assert not out.float().numpy()[dead].any()


def test_moe_gmm_gradcheck():
    rng = np.random.default_rng(0)
    cnt = torch.tensor([5, 0, 3], dtype=torch.int32)
    x = torch.tensor(rng.normal(size=(3, 5, 7)), requires_grad=True)
    w = torch.tensor(rng.normal(size=(3, 7, 6)), requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b: K.MoeGmm.apply(a, b, cnt), (x, w), fast_mode=True)


def test_moe_gmm_grads_match_jax_grad():
    rng = np.random.default_rng(1)
    e, c, d, f = 4, 11, 24, 20
    cnt = np.array([11, 0, 4, 7], np.int32)
    x = rng.normal(0, 1, (e, c, d)).astype(np.float32)
    w = rng.normal(0, 0.2, (e, d, f)).astype(np.float32)
    dy = rng.normal(0, 1, (e, c, f)).astype(np.float32)
    jdx, jdw = jax.grad(lambda a, b: jnp.sum(moe_gmm_ref(a, b, cnt) * dy),
                        argnums=(0, 1))(x, w)
    tx, tw = (torch.tensor(a, requires_grad=True) for a in (x, w))
    (K.MoeGmm.apply(tx, tw, torch.from_numpy(cnt))
     * torch.from_numpy(dy)).sum().backward()
    _grad_close(tx.grad, jdx)
    _grad_close(tw.grad, jdw)


# --------------------------------------------------------------------- #
# K3 with lse and FlashAttention
# --------------------------------------------------------------------- #

ATTN_CASES = [(2, 9, 4, 2, 8, 0), (1, 13, 4, 1, 8, 4), (2, 12, 2, 2, 16, 5)]


@pytest.mark.parametrize("b,s,h,hkv,d,window", [
    (1, 6, 4, 2, 4, 0), (1, 7, 2, 1, 4, 3), (2, 5, 2, 2, 4, 2)])
def test_flash_attention_gradcheck(b, s, h, hkv, d, window):
    """Small shapes and gradcheck's fast mode (random projections of the
    Jacobian): a numerical Jacobian costs one pass per input element."""
    rng = np.random.default_rng(s)
    q, k, v = (torch.tensor(rng.normal(size=(b, s, n, d)), requires_grad=True)
               for n in (h, hkv, hkv))
    assert torch.autograd.gradcheck(
        lambda a, bb, cc: K.FlashAttention.apply(a, bb, cc, window),
        (q, k, v), fast_mode=True)


@pytest.mark.parametrize("b,s,h,hkv,d,window", ATTN_CASES)
def test_flash_attention_lse_and_grads_match_jax(b, s, h, hkv, d, window):
    """lse against logsumexp of the reference's masked scaled scores; dq,
    dk, dv against jax.grad of the reference `attend` (every row sees its
    own key, so no row is fully masked here)."""
    rng = np.random.default_rng(s + 1)
    q, k, v = (rng.normal(0, 1, (b, s, n, d)).astype(np.float32)
               for n in (h, hkv, hkv))
    do = rng.normal(0, 1, (b, s, h, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))

    def jout(q, k, v):
        return jnp.sum(jattn.attend(q, k, v, pos, pos, window=window,
                                    causal=True) * do)

    jg = jax.grad(jout, argnums=(0, 1, 2))(q, k, v)
    qg = q.reshape(b, s, hkv, h // hkv, d) / np.sqrt(d)
    scores = np.einsum("bthgd,bshd->bhgts", qg, k)
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    mask = (j <= i) & ((j > i - window) if window else True)
    jlse = jax.nn.logsumexp(jnp.where(mask, scores, -jnp.inf), axis=-1)

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out, lse = K.flash_attention(tq.detach(), tk.detach(), tv.detach(),
                                 window=window, lse=True)
    _close(lse, np.asarray(jlse).reshape(b, h, s))
    (K.FlashAttention.apply(tq, tk, tv, window)
     * torch.from_numpy(do)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), jg):
        _grad_close(got, ref)


# --------------------------------------------------------------------- #
# Optimizers
# --------------------------------------------------------------------- #

def _leaf_tree(rng):
    """A tree like init_params': 1-D to 4-D leaves, one nested dict."""
    shapes = {"a": (7,), "b": (5, 6), "blocks": {"c": (2, 3, 4),
                                                 "d": (2, 3, 4, 5)}}
    return jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.5, s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))


@pytest.mark.parametrize("name,kw", [
    ("adamw", {}), ("adamw", {"weight_decay": 0.0}),
    ("adafactor", {}), ("adafactor", {"weight_decay": 0.01}),
])
@pytest.mark.parametrize("n_updates", [1, 3])
def test_optimizer_updates_match_reference(name, kw, n_updates):
    rng = np.random.default_rng(n_updates)
    params = _leaf_tree(rng)
    grads = [_leaf_tree(rng) for _ in range(n_updates)]
    lr = jopt.warmup_cosine(1e-2, 2, 10)
    tlr = topt.warmup_cosine(1e-2, 2, 10)
    jo = jopt.make_optimizer(name, lr, **kw)
    to = topt.make_optimizer(name, tlr, **kw)
    jp, tp = params, _torch(params)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        ju, js = jo.update(g, js, jp)
        jp = jopt.apply_updates(jp, ju)
        tu, ts = to.update(_torch(g), ts, tp)   # consumes the gradients
        tp = topt.apply_updates(tp, tu)
    assert ts.step == int(js.step) == n_updates
    for a, b in zip(jax.tree_util.tree_leaves(tp),
                    jax.tree_util.tree_leaves(jp)):
        _close(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(ts.inner),
                    jax.tree_util.tree_leaves(js.inner)):
        _grad_close(a, b)


def test_schedule_norm_and_clip_match_reference():
    for step in (0, 1, 5, 9, 50):
        assert topt.warmup_cosine(3e-4, 5, 40)(step) == pytest.approx(
            float(jopt.warmup_cosine(3e-4, 5, 40)(step)), rel=1e-6)
    tree = _leaf_tree(np.random.default_rng(5))
    jg, jn = jopt.clip_by_global_norm(tree, 1.0)
    tg, tn = topt.clip_by_global_norm(_torch(tree), 1.0)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    assert float(topt.global_norm(_torch(tree))) == pytest.approx(
        float(jopt.global_norm(tree)), rel=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(tg),
                    jax.tree_util.tree_leaves(jg)):
        _close(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_clipped_update_matches_reference(name, dtype):
    """The train step's clip then update: the port passes `clip_scale`'s
    float32 scale to `update(grad_scale=)`, where the reference updates
    from `clip_by_global_norm`'s g * scale, float32 for bf16 leaves. The
    optimizer state (float32) is held at TOL, the bf16 parameters at one
    bf16 rounding (rtol 2^-7)."""
    rng = np.random.default_rng(11)
    cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.asarray(a, dtype), t)
    params, grads = cast(_leaf_tree(rng)), cast(_leaf_tree(rng))
    jo = jopt.make_optimizer(name, 1e-2)
    to = topt.make_optimizer(name, 1e-2)
    jg, jn = jopt.clip_by_global_norm(grads, 0.5)     # the clip bites
    ju, js = jo.update(jg, jo.init(params), params)
    jp = jopt.apply_updates(params, ju)
    tg, tn = topt.clip_by_global_norm(_torch(grads), 0.5)
    for a, b in zip(jax.tree_util.tree_leaves(tg),
                    jax.tree_util.tree_leaves(jg)):
        assert str(a.dtype).endswith(str(b.dtype))
        _grad_close(a.float(), b)
    tp = _torch(params)
    scale, tn = topt.clip_scale(_torch(grads), 0.5)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6) and float(tn) > 1
    tu, ts = to.update(_torch(grads), to.init(tp), tp, grad_scale=scale)
    tp = topt.apply_updates(tp, tu)
    for a, b in zip(jax.tree_util.tree_leaves(ts.inner),
                    jax.tree_util.tree_leaves(js.inner)):
        _grad_close(a, b)
    tol = TOL if dtype == "float32" else 2.0 ** -7
    for a, b in zip(jax.tree_util.tree_leaves(tp),
                    jax.tree_util.tree_leaves(jp)):
        _close(a.float(), np.asarray(b, np.float32), tol)


# --------------------------------------------------------------------- #
# loss_fn and train_step on tiny_moe
# --------------------------------------------------------------------- #

def _copy_batch(seed, bs=4, seq=64):
    return {k: np.asarray(v) for k, v in
            copy_batch(np.random.default_rng(seed), bs=bs, seq=seq).items()}


def _jax_routing(cfg, params, tokens):
    """The reference's routed experts and drops per layer, from its own
    layer functions: attention half of `_attn_block`, then `apply_moe`
    under the "train" policy, layer by layer."""
    b, t = tokens.shape
    pos = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32), (b, t))
    x = jL.embed_tokens(params["embed"], jnp.asarray(tokens))
    out = []
    for layer in range(cfg.num_layers):
        p = jax.tree_util.tree_map(lambda a: a[layer], params["blocks"])
        h = jL.apply_norm(cfg, p["ln1"], x)
        q, k, v = jattn.qkv(cfg, p["attn"], h, pos)
        a = jattn.attend(q, k, v, pos, pos, window=cfg.window, causal=True)
        x = x + a.reshape(b, t, -1) @ p["attn"]["wo"]
        h2 = jL.apply_norm(cfg, p["ln2"], x)
        y, aux = jmoe.apply_moe(cfg, p["moe"], h2.reshape(b * t, -1),
                                capacity_policy="train")
        x = x + y.reshape(b, t, -1)
        out.append((np.asarray(aux["expert_idx"]), int(aux["dropped"])))
    return out


def test_loss_fn_value_grads_and_routing_match_jax(tiny_moe, monkeypatch):
    cfg, jparams = tiny_moe
    batch = _copy_batch(5)
    (jl, jparts), jg = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(cfg, p, batch), has_aux=True))(jparams)

    routes = []
    apply_moe = tmoe.apply_moe

    def recording(*a, **kw):
        y, aux = apply_moe(*a, **kw)
        routes.append((aux["expert_idx"].numpy(), int(aux["dropped"])))
        assert kw["capacity_policy"] == "train"
        return y, aux

    monkeypatch.setattr(tmoe, "apply_moe", recording)
    leaves, treedef = jax.tree_util.tree_flatten(_torch(jparams))
    live = [t.requires_grad_() for t in leaves]
    loss, parts = loss_fn(cfg, jax.tree_util.tree_unflatten(treedef, live),
                          {k: torch.tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, live)
    _close(loss, jl)
    _close(parts["ce"], jparts["ce"])
    _close(parts["lb"], jparts["lb"])
    for g, jgl in zip(grads, jax.tree_util.tree_leaves(jg)):
        _grad_close(g, jgl, tol=1e-4)
    jroutes = _jax_routing(cfg, jparams, batch["tokens"])
    assert len(routes) == len(jroutes) == cfg.num_layers
    for (idx, dropped), (jidx, jdropped) in zip(routes, jroutes):
        np.testing.assert_array_equal(idx, jidx)
        assert dropped == jdropped


@pytest.mark.parametrize("eps,n_steps", [(1e-8, 1), (1e-4, 3)])
def test_train_steps_match_jax(tiny_moe, eps, n_steps):
    """AdamW steps: the metrics, and the parameters wherever the
    reference's gradient exceeded 1e-6 in every step. With the default
    eps = 1e-8 the first step moves each weight by about lr * sign(g), so
    a gradient at float noise may move its weight either way in either
    program, and from the second step on that difference reaches every
    gradient; eps = 1e-4 keeps the update continuous in g for |g| << eps,
    so three steps stay comparable."""
    cfg, jparams = tiny_moe
    batches = [_copy_batch(10 + i) for i in range(n_steps)]
    _, jstep = jmake_train_step(cfg, optimizer=jopt.adamw(3e-3, eps=eps))
    jstep = jax.jit(jstep)
    jgrad = jax.jit(jax.grad(lambda p, b: jloss_fn(cfg, p, b)[0]))
    opt = topt.adamw(3e-3, eps=eps)
    _, step = make_train_step(cfg, optimizer=opt)
    jstate = (jparams, jopt.adamw(3e-3, eps=eps).init(jparams))
    tparams = _torch(jparams)
    state = (tparams, opt.init(tparams))
    live = jax.tree_util.tree_map(lambda a: np.ones(a.shape, bool), jparams)
    for batch in batches:
        live = jax.tree_util.tree_map(
            lambda m, g: m & (np.abs(np.asarray(g)) > 1e-6), live,
            jgrad(jstate[0], batch))
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
        for key in ("loss", "ce", "lb", "grad_norm"):
            _close(m[key], jm[key], tol=1e-4)
    left_out = total = 0
    for t, j, keep in zip(jax.tree_util.tree_leaves(state[0]),
                          jax.tree_util.tree_leaves(jstate[0]),
                          jax.tree_util.tree_leaves(live)):
        j = np.asarray(j)
        left_out += int((~keep).sum())
        total += keep.size
        np.testing.assert_allclose(t.numpy()[keep], j[keep], rtol=1e-4,
                                   atol=1e-4 * float(np.abs(j).max()))
    print(f"parameters compared: {total - left_out} of {total} "
          f"({left_out} left out where |g_ref| <= 1e-6)")
    assert left_out < 0.1 * total


def test_train_step_on_cpu_launches_no_kernel(tiny_moe):
    cfg, jparams = tiny_moe
    opt = topt.adafactor(1e-3)
    _, step = make_train_step(cfg, optimizer=opt)
    params = _torch(jparams)
    K.reset_launch_counts()
    _, m = step((params, opt.init(params)), _copy_batch(3, bs=2, seq=40))
    assert np.isfinite(float(m["loss"]))
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


def test_train_forward_refuses_what_is_not_ported(tiny_moe):
    cfg, jparams = tiny_moe
    batch = dict(_copy_batch(4, bs=1, seq=8), enc_out=np.zeros((1, 2, 4)))
    with pytest.raises(NotImplementedError, match="enc_out"):
        loss_fn(cfg, _torch(jparams), batch)


# --------------------------------------------------------------------- #
# Data pipeline and launcher
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("mix,b,s,kw", [
    ("all-3", 4, 96, dict(vocab=128, seed=0, prompt_len=48)),
    ("code+math", 3, 40, dict(vocab=300, seed=7)),
    ("extract", 2, 128, dict(seed=3, prompt_len=16)),
])
def test_batch_iterator_matches_reference(mix, b, s, kw):
    ours, ref = batch_iterator(mix, b, s, **kw), jbatch_iterator(mix, b, s,
                                                                 **kw)
    for _ in range(3):
        got, want = next(ours), next(ref)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_workloads_match_reference():
    for task in ("code", "math", "extract"):
        a = make_sample(task, np.random.default_rng(2), vocab=64)
        b = jmake_sample(task, np.random.default_rng(2), vocab=64)
        assert (a.task, a.prompt, a.continuation) == \
            (b.task, b.prompt, b.continuation)
    ra = request_stream("all-3", 5, seed=4, prompt_len=16, cont_len=8)
    rb = jrequest_stream("all-3", 5, seed=4, prompt_len=16, cont_len=8)
    assert [(s.task, s.prompt, s.continuation) for s in ra] == \
        [(s.task, s.prompt, s.continuation) for s in rb]
    for dist in ("lognormal", "pareto"):
        ga, gb = np.random.default_rng(9), np.random.default_rng(9)
        assert [sample_length(ga, dist) for _ in range(20)] == \
            [jsample_length(gb, dist) for _ in range(20)]


def _launcher(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)


def test_launcher_trains_on_cpu_and_refuses_without_a_card():
    out = _launcher("--device", "cpu", "--steps", "2", "--batch", "2",
                    "--seq", "32")
    assert out.returncode == 0, out.stderr
    losses = [float(line.split()[3]) for line in out.stdout.splitlines()
              if line.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    out = _launcher("--steps", "1")
    assert out.returncode != 0
    assert "cuda" in out.stderr
