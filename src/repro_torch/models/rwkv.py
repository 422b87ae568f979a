"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free token mixing with
data-dependent per-channel decay.

Per head (size n), state S in R^{n_k x n_v}:
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
with w_t = exp(-exp(w0 + lora_w(x-shift-mix))) data-dependent (the Finch
novelty vs RWKV-5's static decay).

The recurrence runs through `kernels.rwkv_scan`: the CUDA kernel on the
card, its plain per-token loop on the CPU. The params keep the JAX
package's tree, names and shapes."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import rwkv_scan

from .layers import _dense_init

LORA_DIM = 32


def init_time_mix(cfg, gen, dtype, device):
    d = cfg.d_model
    h, n = cfg.rwkv_num_heads, cfg.rwkv_head_size

    def zeros():
        return torch.zeros((d,), dtype=dtype, device=device)

    def dense(*shape):
        return _dense_init(gen, shape, dtype, device)

    return {
        # token-shift mixing coefficients (static part) for x,w,k,v,r,g
        "mu_x": zeros(), "mu_w": zeros(), "mu_k": zeros(), "mu_v": zeros(),
        "mu_r": zeros(), "mu_g": zeros(),
        # data-dependent mix loras (rank LORA_DIM), one per of w,k,v,r,g
        "lora_a": dense(5, d, LORA_DIM),
        "lora_b": dense(5, LORA_DIM, d),
        # decay lora (deeper, per RWKV6) + base decay
        "w0": torch.full((d,), -4.0, dtype=torch.float32,
                         device=device).to(dtype),
        "wa": dense(d, 2 * LORA_DIM),
        "wb": dense(2 * LORA_DIM, d),
        # projections
        "wr": dense(d, d), "wk": dense(d, d), "wv": dense(d, d),
        "wg": dense(d, d), "wo": dense(d, d),
        # per-channel bonus
        "u": (torch.randn((h, n), generator=gen, dtype=torch.float32,
                          device=device) * 0.1).to(dtype),
        # group-norm over heads
        "gn_scale": torch.ones((d,), dtype=dtype, device=device),
        "gn_bias": zeros(),
    }


def init_channel_mix(cfg, gen, dtype, device):
    d = cfg.d_model
    return {
        "mu_k": torch.zeros((d,), dtype=dtype, device=device),
        "mu_r": torch.zeros((d,), dtype=dtype, device=device),
        "wk": _dense_init(gen, (d, cfg.d_ff), dtype, device),
        "wv": _dense_init(gen, (cfg.d_ff, d), dtype, device),
        "wr": _dense_init(gen, (d, d), dtype, device),
    }


def _group_norm(x, scale, bias, n_heads, eps=1e-5):
    """x: [..., d] normalized per head group, in float32."""
    shp = x.shape
    xh = x.reshape(shp[:-1] + (n_heads, shp[-1] // n_heads)).float()
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, unbiased=False)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    out = xh.reshape(shp) * scale.float() + bias.float()
    return out.to(x.dtype)


def _mix_inputs(p, x, x_prev):
    """RWKV6 data-dependent token-shift. x,x_prev: [B,T,d].
    Returns xw,xk,xv,xr,xg each [B,T,d]."""
    dx = x_prev - x
    xx = x + dx * p["mu_x"]
    # 5 low-rank data-dependent deltas
    delta = torch.einsum("btd,sdr->sbtr", torch.tanh(xx), p["lora_a"])
    delta = torch.einsum("sbtr,srd->sbtd", delta, p["lora_b"])  # [5,B,T,d]
    mus = torch.stack([p["mu_w"], p["mu_k"], p["mu_v"], p["mu_r"],
                       p["mu_g"]])
    mixed = x[None] + dx[None] * (mus[:, None, None, :] + delta)
    return mixed.unbind(0)


def time_mix(cfg, p, x, x_prev_tok, s0, *, states=None):
    """x: [B,T,d]; x_prev_tok: [B,d] last token of the previous chunk;
    s0: [B,H,N,N] float32. With `states` ([T+1,B,H,N,N] float32) the
    recurrence also stages the state before and after every token there.
    Returns (out [B,T,d], last_x [B,d], s_last [B,H,N,N])."""
    b, t, d = x.shape
    h, n = cfg.rwkv_num_heads, cfg.rwkv_head_size
    x_prev = torch.cat([x_prev_tok[:, None, :], x[:, :-1]], dim=1)
    xw, xk, xv, xr, xg = _mix_inputs(p, x, x_prev)

    r = (xr @ p["wr"]).reshape(b, t, h, n)
    k = (xk @ p["wk"]).reshape(b, t, h, n)
    v = (xv @ p["wv"]).reshape(b, t, h, n)
    g = F.silu(xg @ p["wg"])
    # data-dependent decay, in float32
    ww = p["w0"].float() + (torch.tanh(xw @ p["wa"]) @ p["wb"]).float()
    w = torch.exp(-torch.exp(ww)).reshape(b, t, h, n)

    y, s_last = rwkv_scan(r.float(), k.float(), v.float(), w,
                          p["u"].float(), s0.float(), states=states)
    y = y.reshape(b, t, d).to(x.dtype)
    y = _group_norm(y, p["gn_scale"], p["gn_bias"], h)
    out = (y * g) @ p["wo"]
    return out, x[:, -1], s_last


def channel_mix(cfg, p, x, x_prev_tok):
    """RWKV6 FFN with token shift. Returns (out, last_x)."""
    x_prev = torch.cat([x_prev_tok[:, None, :], x[:, :-1]], dim=1)
    dx = x_prev - x
    xk = x + dx * p["mu_k"]
    xr = x + dx * p["mu_r"]
    kk = torch.square(F.relu(xk @ p["wk"]))
    return torch.sigmoid(xr @ p["wr"]) * (kk @ p["wv"]), x[:, -1]
