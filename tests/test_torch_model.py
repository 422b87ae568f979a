"""The port's model against the JAX package on the CPU, same numpy inputs
and the same weights (converted with `params_from_numpy`).

Ops (route, apply_moe on both branches, apply_norm, apply_rope) in float32
at rtol = 1e-5 and atol = 1e-5 of the output's scale, max(1, max|ref|):
the random experts' outputs reach a few hundred, where float32 sums of 256
products in another order differ by ~1e-4 absolute. Whole passes at 1e-4
on the same terms: the error of a few float32 layers. Routing and cache
metadata are integers and must be exactly equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jL
from repro.models import moe as jmoe
from repro.models import rope as jrope
from repro.models import transformer as jT
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as tL
from repro_torch.models import moe as tmoe
from repro_torch.models import rope as trope
from repro_torch.models import transformer as tT
from test_torch_guards import torch_one_thread  # noqa: F401,E402 (autouse)

OP_TOL = 1e-5
PASS_TOL = 1e-4


def _allclose(actual, ref, tol):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(_np(actual), ref, rtol=tol, atol=tol * scale)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _torch_tree(tree):
    return params_from_numpy(jax.device_get(tree), device="cpu")


@pytest.fixture(scope="module")
def olmoe_small():
    cfg = jax_get_config("olmoe-1b-7b").reduced()
    return cfg, jT.init_params(cfg, jax.random.PRNGKey(2))


def _small(arch, seed):
    cfg = jax_get_config(arch).reduced()
    return cfg, jT.init_params(cfg, jax.random.PRNGKey(seed))


@pytest.fixture(scope="module")
def deepseek_small():
    """Shared experts beside the routed ones."""
    return _small("deepseek-moe-16b", 3)


@pytest.fixture(scope="module")
def qwen_small():
    """Shared experts beside the routed ones."""
    return _small("qwen15-moe-a2.7b", 4)


@pytest.fixture(scope="module")
def phi_small():
    return _small("phi-3.5-moe", 5)


def _moe_layer(params):
    return jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["moe"])


# --------------------------------------------------------------------- #
# Ops
# --------------------------------------------------------------------- #

def test_port_config_equals_reference_config():
    for name in ("olmoe-1b-7b", "mixtral-8x7b", "phi-3.5-moe",
                 "deepseek-moe-16b", "qwen15-moe-a2.7b"):
        ref, port = jax_get_config(name), get_config(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert dataclasses.asdict(port.reduced()) == \
            dataclasses.asdict(ref.reduced())
        assert port.param_count() == ref.param_count()


@pytest.mark.parametrize("scale", [1.0, 1e-4])
def test_apply_norm_matches(tiny_moe, scale):
    """scale=1e-4 makes the mean square ~1e-8, where eps = 1e-6 dominates."""
    cfg, _ = tiny_moe
    x = np.random.default_rng(0).normal(0, scale, (3, 5, cfg.d_model))
    x = x.astype(np.float32)
    p = {"scale": np.linspace(0.5, 1.5, cfg.d_model).astype(np.float32)}
    out = tL.apply_norm(cfg, _torch_tree(p), torch.from_numpy(x))
    _allclose(out, np.asarray(jL.apply_norm(cfg, p, x)), OP_TOL)


def test_apply_rope_matches():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 7, 4, 64)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    out = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos))
    _allclose(out, np.asarray(jrope.apply_rope(x, pos)), OP_TOL)


def test_apply_mlp_gelu_uses_tanh_approximation(tiny_moe):
    cfg, _ = tiny_moe
    cfg = dataclasses.replace(cfg, activation="gelu")
    rng = np.random.default_rng(2)
    p = {"w_up": rng.normal(0, 0.1, (cfg.d_model, 64)).astype(np.float32),
         "w_down": rng.normal(0, 0.1, (64, cfg.d_model)).astype(np.float32)}
    x = rng.normal(0, 1, (4, cfg.d_model)).astype(np.float32)
    out = tL.apply_mlp(cfg, _torch_tree(p), torch.from_numpy(x))
    _allclose(out, np.asarray(jL.apply_mlp(cfg, p, x)), OP_TOL)


def test_route_matches(tiny_moe):
    cfg, params = tiny_moe
    p = _moe_layer(params)
    x = np.random.default_rng(3).normal(0, 1, (9, cfg.d_model))
    x = x.astype(np.float32)
    w, idx, probs = tmoe.route(cfg, _torch_tree(p), torch.from_numpy(x))
    jw, jidx, jprobs = jmoe.route(cfg, p, x)
    np.testing.assert_array_equal(_np(idx), np.asarray(jidx))
    _allclose(w, np.asarray(jw), OP_TOL)
    _allclose(probs, np.asarray(jprobs), OP_TOL)


def test_route_ties_go_to_the_lower_index(tiny_moe):
    """A zero router gives every expert the same probability; jax.lax.top_k
    then picks experts 0..k-1, and so must the port."""
    cfg, params = tiny_moe
    p = dict(_moe_layer(params))
    p["router"] = jnp.zeros_like(p["router"])
    x = np.ones((3, cfg.d_model), np.float32)
    _, idx, _ = tmoe.route(cfg, _torch_tree(p), torch.from_numpy(x))
    _, jidx, _ = jmoe.route(cfg, p, x)
    np.testing.assert_array_equal(_np(idx), np.asarray(jidx))
    assert _np(idx).tolist() == [list(range(cfg.experts_per_token))] * 3


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("policy,n_tokens", [("exact", 5), ("exact", 1),
                                             ("train", 24)])
def test_apply_moe_matches(tiny_moe, packed, policy, n_tokens):
    """"train" capacity on 24 near-identical tokens (all routed to the same
    experts) overflows: the spill slot must take the overflow and be
    dropped exactly as in JAX."""
    cfg, params = tiny_moe
    p = _moe_layer(params)
    rng = np.random.default_rng(n_tokens)
    x = rng.normal(0, 1, (n_tokens, cfg.d_model))
    if policy == "train":
        x = x[:1] + 0.01 * x
    x = x.astype(np.float32)
    y, aux = tmoe.apply_moe(cfg, _torch_tree(p), torch.from_numpy(x),
                            capacity_policy=policy, packed=packed)
    jy, jaux = jmoe.apply_moe(cfg, p, x, capacity_policy=policy,
                              packed=packed)
    _allclose(y, np.asarray(jy), OP_TOL)
    for key in ("expert_idx", "unique_experts", "dropped"):
        np.testing.assert_array_equal(_np(aux[key]), np.asarray(jaux[key]))
    _allclose(aux["lb_loss"], np.asarray(jaux["lb_loss"]), OP_TOL)
    if policy == "train":
        assert int(aux["dropped"]) > 0


def test_apply_moe_gelu_experts_match(tiny_moe):
    cfg, params = tiny_moe
    cfg = dataclasses.replace(cfg, activation="gelu")
    p = _moe_layer(params)
    x = np.random.default_rng(7).normal(0, 1, (5, cfg.d_model))
    x = x.astype(np.float32)
    for packed in (False, True):
        y, _ = tmoe.apply_moe(cfg, _torch_tree(p), torch.from_numpy(x),
                              capacity_policy="exact", packed=packed)
        jy, _ = jmoe.apply_moe(cfg, p, x, capacity_policy="exact",
                               packed=packed)
        _allclose(y, np.asarray(jy), OP_TOL)


def test_packed_expert_cap_and_capacity_match(tiny_moe, olmoe_small):
    for cfg, _ in (tiny_moe, olmoe_small):
        for t in (1, 2, 3, 5, 9, 17, 64):
            assert tmoe.packed_expert_cap(cfg, t) == \
                jmoe.packed_expert_cap(cfg, t)
            for policy in ("exact", "train", "serve"):
                assert tmoe._capacity(cfg, t, policy) == \
                    jmoe._capacity(cfg, t, policy)


# --------------------------------------------------------------------- #
# Whole passes (level 2)
# --------------------------------------------------------------------- #

def _check_pass(lo, jlo, aux, jaux, cache, jcache, keys):
    _allclose(lo, np.asarray(jlo), PASS_TOL)
    for key in keys:
        np.testing.assert_array_equal(_np(aux[key]), np.asarray(jaux[key]))
    np.testing.assert_array_equal(_np(cache["pos"]), np.asarray(jcache["pos"]))
    assert int(cache["length"]) == int(jcache["length"])


@pytest.mark.parametrize("model", ["tiny_moe", "olmoe_small",
                                   "deepseek_small", "qwen_small",
                                   "phi_small"])
@pytest.mark.parametrize("packed", [False, True])
def test_prefill_decode_rollback_match(request, model, packed):
    cfg, jparams = request.getfixturevalue(model)
    params = _torch_tree(jparams)
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, cfg.vocab_size, (1, 13)).astype(np.int32)
    span = rng.integers(0, cfg.vocab_size, (1, 5)).astype(np.int32)
    max_len = 64

    jcache = jT.init_cache(cfg, 1, max_len)
    cache = tT.init_cache(cfg, 1, max_len, device="cpu")
    jlo, jcache, jaux = jT.prefill(cfg, jparams, jnp.asarray(prompt), jcache)
    lo, cache, aux = tT.prefill(cfg, params, torch.from_numpy(prompt), cache)
    _check_pass(lo, jlo, aux, jaux, cache, jcache, ["unique_experts"])

    for step in range(2):
        len_before = int(jcache["length"])
        jlo, jnew, jaux, jst = jT.decode_step(cfg, jparams, jcache,
                                              jnp.asarray(span),
                                              moe_packed=packed)
        lo, new, aux, st = tT.decode_step(cfg, params, cache,
                                          torch.from_numpy(span),
                                          moe_packed=packed)
        _check_pass(lo, jlo, aux, jaux, new, jnew,
                    ["unique_experts", "unique_experts_row",
                     "experts_active"])
        n_keep = 2 + step
        jcache = jT.rollback_cache(cfg, jnew, jst, n_keep, len_before)
        cache = tT.rollback_cache(cfg, new, st, n_keep, len_before)
        np.testing.assert_array_equal(_np(cache["pos"]),
                                      np.asarray(jcache["pos"]))
        assert int(cache["length"]) == int(jcache["length"]) == \
            len_before + n_keep


def test_windowed_ring_cache_matches(tiny_moe):
    """A sliding window small enough that the ring wraps during decode."""
    cfg, jparams = tiny_moe
    params = _torch_tree(jparams)
    window, max_len = 8, 128
    rng = np.random.default_rng(12)
    prompt = rng.integers(0, cfg.vocab_size, (1, 20)).astype(np.int32)
    jcache = jT.init_cache(cfg, 1, max_len, window=window)
    cache = tT.init_cache(cfg, 1, max_len, window=window, device="cpu")
    assert tuple(cache["k"].shape) == tuple(jcache["k"].shape)
    jlo, jcache, _ = jT.prefill(cfg, jparams, jnp.asarray(prompt), jcache,
                                window=window)
    lo, cache, _ = tT.prefill(cfg, params, torch.from_numpy(prompt), cache,
                              window=window)
    _allclose(lo, np.asarray(jlo), PASS_TOL)
    for _ in range(3):
        span = rng.integers(0, cfg.vocab_size, (1, 4)).astype(np.int32)
        jlo, jcache, _, _ = jT.decode_step(cfg, jparams, jcache,
                                           jnp.asarray(span), window=window)
        lo, cache, _, _ = tT.decode_step(cfg, params, cache,
                                         torch.from_numpy(span),
                                         window=window)
        _allclose(lo, np.asarray(jlo), PASS_TOL)
        np.testing.assert_array_equal(_np(cache["pos"]),
                                      np.asarray(jcache["pos"]))


def test_init_params_tree_and_shapes_match(olmoe_small):
    cfg, jparams = olmoe_small
    gen = torch.Generator().manual_seed(0)
    params = tT.init_params(get_config("olmoe-1b-7b").reduced(), gen,
                            device="cpu")
    jshapes = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)),
                                     jparams)
    shapes = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
        params)
    assert shapes == jshapes


def test_params_from_numpy_round_trips_bfloat16(tiny_moe):
    _, jparams = tiny_moe
    jb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jparams)
    tb = _torch_tree(jb)
    leaves = jax.tree_util.tree_leaves(jb)
    tleaves = jax.tree_util.tree_leaves(tb)
    assert len(leaves) == len(tleaves)
    for a, t in zip(leaves, tleaves):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            np.asarray(a).view(np.int16), t.view(torch.int16).numpy())
