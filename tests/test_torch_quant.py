"""The port's int8 expert path on the CPU against the JAX package: the
quantization module (`kernels/moe_gmm/quant.py`), the plain version of
kernel K4 (`moe_gmm_fused_quant_plain`) against the reference oracle
`moe_gmm_fused_quant_ref` and the interpret-mode Pallas kernel, and
`apply_moe` over int8 and fp8 experts on both dispatch branches. Inputs
are numpy draws from fixed seeds, handed to both sides.

Tolerances: absmax scales and int8 codes are exact (the same float32
max, division and round-half-to-even); a quantile < 1 agrees within 1e-6
relative (both interpolate in float32, XLA may fuse the multiply-add);
fp8 fake-quant is bit-equal. FFN outputs in float32 at atol = rtol = 1e-5
of max(1, max|ref|) (float32 sums in another order); routing, counts and
the union are integers and exactly equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.moe_gmm import quant as jq
from repro.kernels.moe_gmm.ops import moe_gmm_fused_quant as jax_kernel
from repro.kernels.moe_gmm.ref import moe_gmm_fused_quant_ref
from repro.models import moe as jmoe
from repro_torch import kernels as K
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.moe_gmm import quant as tq
from repro_torch.models import moe as tmoe
from test_torch_guards import torch_one_thread  # noqa: F401,E402 (autouse)

TOL = 1e-5


def _close(actual, ref, tol=TOL):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    a = actual.detach().numpy() if isinstance(actual, torch.Tensor) \
        else np.asarray(actual)
    np.testing.assert_allclose(a, ref, rtol=tol, atol=tol * scale)


def _w(rng, shape, scale=1.0):
    return rng.normal(0, scale, shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


# --------------------------------------------------------------------- #
# quant.py
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("shape", [(4, 33, 17), (3, 1000), (2, 5), (1, 64)])
def test_fit_expert_scales_absmax_is_exact(shape):
    w = _w(np.random.default_rng(sum(shape)), shape)
    ref = np.asarray(jq.fit_expert_scales(jnp.asarray(w)))
    out = tq.fit_expert_scales(_t(w)).numpy()
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("quantile", [0.01, 0.5, 0.9, 0.999])
@pytest.mark.parametrize("shape", [(4, 33, 17), (3, 1000), (2, 5)])
def test_fit_expert_scales_quantile_matches_jnp_quantile(shape, quantile):
    w = _w(np.random.default_rng(len(shape) + int(quantile * 100)), shape)
    ref = np.asarray(jq.fit_expert_scales(jnp.asarray(w), quantile))
    out = tq.fit_expert_scales(_t(w), quantile).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
    # and the quantile itself against jnp.quantile, before the / 127
    absw = np.abs(w).reshape(shape[0], -1)
    np.testing.assert_allclose(
        tq._row_quantile(_t(absw), quantile).numpy(),
        np.asarray(jnp.quantile(jnp.asarray(absw), quantile, axis=1)),
        rtol=1e-6, atol=0)


def test_quantile_over_2_24_elements():
    """One full Mixtral expert matrix has 58.7 M elements; torch.quantile
    refuses rows over 2^24, the port's selection does not, and it agrees
    with jnp.quantile there (whose index arithmetic is float32 too)."""
    n = (1 << 24) + 5
    w = _w(np.random.default_rng(0), (1, n))
    with pytest.raises(RuntimeError):
        torch.quantile(_t(w).abs(), 0.999, dim=1)
    ref = np.asarray(jq.fit_expert_scales(jnp.asarray(w), 0.999))
    out = tq.fit_expert_scales(_t(w), 0.999).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)


def test_fit_expert_scales_rejects_bad_quantile():
    with pytest.raises(ValueError):
        tq.fit_expert_scales(torch.ones(2, 3), 0.0)
    with pytest.raises(ValueError):
        tq.fit_expert_scales_from_batches([])


@pytest.mark.parametrize("quantile", [1.0, 0.9])
def test_fit_expert_scales_from_batches_matches(quantile):
    rng = np.random.default_rng(4)
    batches = [_w(rng, (3, 8, 6), s) for s in (0.5, 2.0, 1.0)]
    ref = np.asarray(jq.fit_expert_scales_from_batches(
        [jnp.asarray(b) for b in batches], quantile))
    out = tq.fit_expert_scales_from_batches([_t(b) for b in batches],
                                            quantile).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("quantile", [1.0, 0.8])
def test_quantize_and_dequantize_int8_match(quantile):
    w = _w(np.random.default_rng(5), (5, 16, 8), 0.3)
    jq8, js = jq.quantize_int8(jnp.asarray(w), quantile=quantile)
    tq8, ts = tq.quantize_int8(_t(w), quantile=quantile)
    assert tq8.dtype == torch.int8 and ts.dtype == torch.float32
    if quantile == 1.0:
        np.testing.assert_array_equal(tq8.numpy(), np.asarray(jq8))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # with the same given scales the codes are the same exactly
    tq8b, _ = tq.quantize_int8(_t(w), scales=_t(js))
    np.testing.assert_array_equal(tq8b.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(
        tq.dequantize_int8(_t(jq8), _t(js)).numpy(),
        np.asarray(jq.dequantize_int8(jq8, js)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_fp8_is_bit_equal(dtype):
    w = jnp.asarray(_w(np.random.default_rng(6), (3, 40, 24), 2.0),
                    jnp.dtype(dtype))
    ref = np.asarray(jq.fake_quant_fp8(w))
    out = tq.fake_quant_fp8(params_from_numpy(np.asarray(w), device="cpu"))
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(out.float().numpy(),
                                  ref.astype(np.float32))


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_moe_experts_matches(mode):
    rng = np.random.default_rng(7)
    p = {"router": _w(rng, (16, 4)), "w_gate": _w(rng, (4, 16, 8)),
         "w_up": _w(rng, (4, 16, 8)), "w_down": _w(rng, (4, 8, 16))}
    ref = jq.quantize_moe_experts({k: jnp.asarray(v) for k, v in p.items()},
                                  mode)
    out = tq.quantize_moe_experts(params_from_numpy(p, device="cpu"), mode)
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert out[k].dtype == params_from_numpy(
            np.asarray(ref[k]), device="cpu").dtype
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    with pytest.raises(ValueError):
        tq.quantize_moe_experts({"router": torch.ones(2)}, mode)


# --------------------------------------------------------------------- #
# K4's plain version
# --------------------------------------------------------------------- #

def _kernel_inputs(rng, u, c, d, f, e=None):
    """x with zero rows past each count, counts with a dead slot, and int8
    stacks of E (default U) experts quantized by the reference."""
    e = e or u
    counts = rng.integers(1, c + 1, u).astype(np.int32)
    counts[rng.integers(0, u)] = 0
    x = _w(rng, (u, c, d))
    for i, n in enumerate(counts):
        x[i, n:] = 0.0
    q = [jq.quantize_int8(jnp.asarray(_w(rng, s, 0.3)))
         for s in ((e, d, f), (e, d, f), (e, f, d))]
    (qg, sg), (qu, su), (qd, sd) = q
    return x, counts, (qg, qu, qd, sg, su, sd)


def _plain(x, counts, w, activation, ids=None):
    qg, qu, qd, sg, su, sd = (_t(a) for a in w)
    return K.moe_gmm_fused_quant_plain(
        _t(x), qg, qu, qd, sg, su, sd, _t(counts), activation=activation,
        expert_ids=None if ids is None else _t(ids))


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
@pytest.mark.parametrize("u,c,d,f", [(5, 7, 8, 8), (3, 10, 12, 20),
                                     (4, 16, 32, 24)])
def test_quant_plain_matches_ref_and_interpret_kernel(activation, u, c, d,
                                                      f):
    rng = np.random.default_rng(u * c + f)
    x, counts, w = _kernel_inputs(rng, u, c, d, f)
    qg, qu, qd, sg, su, sd = w
    out = _plain(x, counts, w, activation)
    assert out.dtype == torch.float32
    ref = moe_gmm_fused_quant_ref(jnp.asarray(x), qg, qu, qd, sg, su, sd,
                                  jnp.asarray(counts), activation=activation)
    _close(out, ref)
    pallas = jax_kernel(jnp.asarray(x), qg, qu, qd, sg, su, sd,
                        jnp.asarray(counts), activation=activation,
                        backend="interpret", bc=8, bf=8)
    _close(out, pallas)
    dead = counts == 0
    assert not out[torch.from_numpy(dead)].any()
    rows = np.arange(c)[None, :] >= counts[:, None]
    assert not out[torch.from_numpy(rows)].any()


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_quant_plain_with_expert_ids_matches_gathered_ref(activation):
    """Slots name their expert in an [E,...] stack (the packed branch);
    the reference oracle takes the gathered [U,...] weights and scales."""
    rng = np.random.default_rng(11)
    e, u, c, d, f = 8, 4, 6, 16, 24
    x, counts, w = _kernel_inputs(rng, u, c, d, f, e=e)
    ids = np.array([5, 2, 7, 0], np.int32)
    out = _plain(x, counts, w, activation, ids)
    g = [jnp.take(a, jnp.asarray(ids), axis=0) for a in w]
    ref = moe_gmm_fused_quant_ref(jnp.asarray(x), *g, jnp.asarray(counts),
                                  activation=activation)
    _close(out, ref)


def test_quant_wrapper_on_cpu_takes_the_plain_version():
    rng = np.random.default_rng(12)
    x, counts, w = _kernel_inputs(rng, 3, 4, 16, 16)
    qg, qu, qd, sg, su, sd = (_t(a) for a in w)
    n = K.moe_gmm_fused_quant.launches
    out = K.moe_gmm_fused_quant(_t(x), qg, qu, qd, sg, su, sd, _t(counts))
    assert K.moe_gmm_fused_quant.launches == n
    assert torch.equal(out, _plain(x, counts, w, "swiglu"))
    bf = K.moe_gmm_fused_quant_plain(_t(x).bfloat16(), qg, qu, qd, sg, su,
                                     sd, _t(counts))
    assert bf.dtype == torch.bfloat16    # the kernel's contract: x.dtype
    with pytest.raises(ValueError, match="activation"):
        K.moe_gmm_fused_quant(_t(x), qg, qu, qd, sg, su, sd, _t(counts),
                              activation="relu")


# --------------------------------------------------------------------- #
# apply_moe over int8 / fp8 experts
# --------------------------------------------------------------------- #

def _moe_params(cfg, rng):
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    return {"router": _w(rng, (d, e), 0.5),
            "w_gate": _w(rng, (e, d, f), d ** -0.5),
            "w_up": _w(rng, (e, d, f), d ** -0.5),
            "w_down": _w(rng, (e, f, d), f ** -0.5)}


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("activation,n_tokens", [("swiglu", 5),
                                                 ("swiglu", 1),
                                                 ("swiglu", 17),
                                                 ("gelu", 6)])
def test_apply_moe_quantized_matches(mode, packed, activation, n_tokens):
    cfg = dataclasses.replace(jax_get_config("mixtral-8x7b").reduced(),
                              activation=activation)
    rng = np.random.default_rng(n_tokens + 3)
    p = _moe_params(cfg, rng)
    jp = jq.quantize_moe_experts({k: jnp.asarray(v) for k, v in p.items()},
                                 mode)
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                           device="cpu")
    x = _w(rng, (n_tokens, cfg.d_model))
    y, aux = tmoe.apply_moe(cfg, tp, torch.from_numpy(x),
                            capacity_policy="exact", packed=packed)
    jy, jaux = jmoe.apply_moe(cfg, jp, jnp.asarray(x),
                              capacity_policy="exact", packed=packed)
    assert y.dtype == torch.float32
    _close(y, jy)
    for key in ("expert_idx", "unique_experts", "dropped"):
        np.testing.assert_array_equal(aux[key].numpy(), np.asarray(jaux[key]))


def test_apply_moe_int8_runs_the_quant_wrapper_on_both_branches(
        monkeypatch):
    """Both branches hand the int8 [E,...] stacks to moe_gmm_fused_quant
    (never a dequantized copy); the packed branch names its experts."""
    cfg = jax_get_config("mixtral-8x7b").reduced()
    p = tq.quantize_moe_experts(params_from_numpy(
        _moe_params(cfg, np.random.default_rng(0)), device="cpu"))
    seen = []

    def spy(x, wg, wu, wd, *args, **kw):
        seen.append((wu.dtype, tuple(wu.shape), kw.get("expert_ids")))
        return K.moe_gmm_fused_quant_plain(x, wg, wu, wd, *args, **kw)

    monkeypatch.setattr(tmoe, "moe_gmm_fused_quant", spy)
    x = torch.randn(5, cfg.d_model, generator=torch.Generator().manual_seed(0))
    for packed in (False, True):
        tmoe.apply_moe(cfg, p, x, capacity_policy="exact", packed=packed)
    e = cfg.num_experts
    assert [s[:2] for s in seen] == [(torch.int8, (e, cfg.d_model,
                                                   cfg.moe_d_ff))] * 2
    assert seen[0][2] is None and seen[1][2] is not None


def test_quantize_transformer_experts_matches():
    cfg = jax_get_config("mixtral-8x7b").reduced()
    rng = np.random.default_rng(9)
    layer = _moe_params(cfg, rng)
    tree = {"embed": {"embedding": _w(rng, (8, 4))},
            "blocks": {"moe": {k: np.stack([v, 2 * v]) for k, v in
                               layer.items()}}}
    for mode in ("int8", "fp8"):
        ref = jmoe.quantize_transformer_experts(
            {"embed": tree["embed"],
             "blocks": {"moe": {k: jnp.asarray(v) for k, v in
                                tree["blocks"]["moe"].items()}}}, mode)
        out = tmoe.quantize_transformer_experts(
            params_from_numpy(tree, device="cpu"), mode)
        assert sorted(out["blocks"]["moe"]) == sorted(ref["blocks"]["moe"])
        for k, v in ref["blocks"]["moe"].items():
            np.testing.assert_array_equal(out["blocks"]["moe"][k].numpy(),
                                          np.asarray(v))
        if mode == "int8":
            assert out["blocks"]["moe"]["w_up_s"].shape == (
                2, cfg.num_experts)
    with pytest.raises(ValueError):
        tmoe.quantize_transformer_experts({"blocks": {}})
