"""The port's kernel modules on the CPU: each plain PyTorch version against
the JAX package's `ref.py` oracle and `attend`, on the same numpy inputs in
float32 (atol = rtol = 1e-5: both sides sum in float32, in another order),
and each wrapper taking its plain version for CPU tensors without
launching anything."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention_ref
from repro.kernels.flash_attention import flash_attention_ref
from repro.kernels.moe_gmm import moe_gmm_fused_ref
from repro.models.attention import attend as jax_attend
from repro_torch import kernels as K

TOL = dict(atol=1e-5, rtol=1e-5)


def _normal(rng, shape, scale=1.0):
    return rng.normal(0, scale, shape).astype(np.float32)


def _close(torch_out, jax_out):
    np.testing.assert_allclose(torch_out.numpy(), np.asarray(jax_out), **TOL)


# --------------------------------------------------------------------- #
# Kernel A: causal prefill attention
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("b,s,h,hkv,d,window", [
    (1, 37, 4, 4, 64, 0), (2, 64, 4, 2, 32, 0), (1, 50, 4, 1, 16, 8),
])
def test_flash_attention_plain_matches_ref_and_attend(b, s, h, hkv, d, window):
    rng = np.random.default_rng(s + window)
    q, k, v = (_normal(rng, (b, s, n, d)) for n in (h, hkv, hkv))
    out = K.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), window=window)
    _close(out, flash_attention_ref(q, k, v, window=window))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    _close(out, jax_attend(q, k, v, pos, pos, window=window))


# --------------------------------------------------------------------- #
# Kernel B: span decode attention
# --------------------------------------------------------------------- #

def _ring(rng, b, s, length):
    """cache_pos [B,S] with `length` valid slots per row, -1 elsewhere."""
    pos = np.full((b, s), -1, np.int32)
    pos[:, :length] = np.arange(length, dtype=np.int32)
    return pos


@pytest.mark.parametrize("window", [0, 6])
def test_decode_attention_plain_t1_matches_decode_attention_ref(window):
    rng = np.random.default_rng(1)
    b, s, h, hkv, d = 2, 32, 4, 2, 16
    q = _normal(rng, (b, h, d))
    k, v = _normal(rng, (b, s, hkv, d)), _normal(rng, (b, s, hkv, d))
    cache_pos = _ring(rng, b, s, 20)
    q_pos = np.array([19, 11], np.int32)
    out = K.decode_attention_plain(
        torch.from_numpy(q[:, None]), torch.from_numpy(k),
        torch.from_numpy(v), torch.from_numpy(cache_pos),
        torch.from_numpy(q_pos[:, None]), window=window)
    _close(out[:, 0], decode_attention_ref(q, k, v, cache_pos, q_pos,
                                           window=window))


def test_decode_attention_plain_span_matches_attend():
    rng = np.random.default_rng(2)
    b, t, s, h, hkv, d = 1, 5, 48, 4, 4, 32
    q = _normal(rng, (b, t, h, d))
    k, v = _normal(rng, (b, s, hkv, d)), _normal(rng, (b, s, hkv, d))
    cache_pos = _ring(rng, b, s, 30)
    q_pos = (25 + np.arange(t, dtype=np.int32))[None]
    out = K.decode_attention_plain(*map(torch.from_numpy,
                                        (q, k, v, cache_pos, q_pos)))
    _close(out, jax_attend(q, k, v, q_pos, cache_pos))


def test_decode_attention_plain_zero_rows_without_valid_key():
    """A query whose keys are all empty or in its future gets zeros."""
    rng = np.random.default_rng(3)
    b, t, s, h, d = 1, 3, 16, 2, 16
    q = _normal(rng, (b, t, h, d))
    k, v = _normal(rng, (b, s, h, d)), _normal(rng, (b, s, h, d))
    cache_pos = np.full((b, s), -1, np.int32)
    cache_pos[0, :4] = np.arange(5, 9)
    q_pos = np.array([[2, 6, 20]], np.int32)   # row 0 precedes every key
    out = K.decode_attention_plain(*map(torch.from_numpy,
                                        (q, k, v, cache_pos, q_pos)))
    assert torch.equal(out[0, 0], torch.zeros(h, d))
    assert out[0, 1].abs().sum() > 0
    _close(out, jax_attend(q, k, v, q_pos, cache_pos))


# --------------------------------------------------------------------- #
# Kernel C: fused expert FFN
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_moe_gmm_fused_plain_matches_ref_with_dead_slots(activation):
    rng = np.random.default_rng(4)
    u, c, d, f = 5, 6, 32, 24
    counts = np.array([3, 0, 6, 1, 0], np.int32)
    x = _normal(rng, (u, c, d))
    x[np.arange(c)[None, :] >= counts[:, None]] = 0.0
    wg, wu = _normal(rng, (u, d, f), 0.2), _normal(rng, (u, d, f), 0.2)
    wd = _normal(rng, (u, f, d), 0.2)
    out = K.moe_gmm_fused_plain(*map(torch.from_numpy,
                                     (x, wg, wu, wd, counts)),
                                activation=activation)
    _close(out, moe_gmm_fused_ref(x, wg, wu, wd, jnp.asarray(counts),
                                  activation=activation))
    dead = torch.from_numpy(counts == 0)
    assert torch.equal(out[dead], torch.zeros_like(out[dead]))


def test_moe_gmm_fused_plain_expert_ids_match_gathered_ref():
    """Slots naming their expert through expert_ids equal the oracle on
    weights gathered by those ids (the packed branch's layout)."""
    rng = np.random.default_rng(5)
    e, u, c, d, f = 6, 4, 3, 16, 8
    ids = np.array([4, 1, 5, 0], np.int32)
    counts = np.array([2, 3, 1, 0], np.int32)
    x = _normal(rng, (u, c, d))
    # scaled as the model's init, 1/sqrt(fan-in)
    wg, wu = _normal(rng, (e, d, f), 0.25), _normal(rng, (e, d, f), 0.25)
    wd = _normal(rng, (e, f, d), 0.35)
    out = K.moe_gmm_fused_plain(*map(torch.from_numpy,
                                     (x, wg, wu, wd, counts)),
                                expert_ids=torch.from_numpy(ids))
    _close(out, moe_gmm_fused_ref(x, wg[ids], wu[ids], wd[ids],
                                  jnp.asarray(counts)))


# --------------------------------------------------------------------- #
# Wrappers on CPU tensors
# --------------------------------------------------------------------- #

def test_wrappers_take_plain_version_on_cpu_without_launching():
    rng = np.random.default_rng(6)
    K.reset_launch_counts()
    q = torch.from_numpy(_normal(rng, (1, 9, 2, 16)))
    assert torch.equal(K.flash_attention(q, q, q),
                       K.flash_attention_plain(q, q, q))
    pos = torch.arange(9, dtype=torch.int32)[None]
    assert torch.equal(K.decode_attention(q, q, q, pos, pos),
                       K.decode_attention_plain(q, q, q, pos, pos))
    x = torch.from_numpy(_normal(rng, (2, 3, 8)))
    w = torch.from_numpy(_normal(rng, (2, 8, 8)))
    counts = torch.tensor([3, 0], dtype=torch.int32)
    assert torch.equal(K.moe_gmm_fused(x, w, w, w, counts),
                       K.moe_gmm_fused_plain(x, w, w, w, counts))
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}
