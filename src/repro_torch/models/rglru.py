"""RecurrentGemma / Griffin recurrent block (arXiv:2402.19427).

Block: x -> {branch1: linear -> causal conv1d -> RG-LRU} * gelu(branch2)
          -> out projection.

RG-LRU per channel:
    r_t = sigmoid(x_t W_a + b_a)             (recurrence gate)
    i_t = sigmoid(x_t W_x + b_x)             (input gate)
    log a_t = -c * softplus(Lambda) * r_t    (c = 8)
    h_t = exp(log a_t) * h_{t-1} + sqrt(1 - exp(2 log a_t)) * (i_t * x_t)

The recurrence runs through `kernels.linear_scan`: the CUDA kernel on the
card, its plain per-token loop on the CPU; where a gradient is needed,
through `kernels.LinearScan` (the forward, then the backward kernel
`linear_scan_bwd`). The gates are computed in
float32 from the model-dtype input, as in the JAX package: the gate
products upcast the input and W_a, W_x to float32 for each pass (no
bf16 rounding of the products). `lam` is float32 in every model dtype.
The params keep the JAX package's tree, names and shapes."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import LinearScan, linear_scan

from .layers import _dense_init

RG_LRU_C = 8.0


def init_rglru_block(cfg, gen, dtype, device):
    d, dr, cw = cfg.d_model, cfg.d_rnn, cfg.conv1d_width

    def dense(*shape):
        return _dense_init(gen, shape, dtype, device)

    def zeros():
        return torch.zeros((dr,), dtype=dtype, device=device)

    return {
        "w_in": dense(d, dr),
        "w_gate": dense(d, dr),
        "conv_w": dense(cw, dr),
        "conv_b": zeros(),
        "w_a": dense(dr, dr),
        "b_a": zeros(),
        "w_x": dense(dr, dr),
        "b_x": zeros(),
        # Lambda init so that a^c ~ uniform(0.9, 0.999) at r=1 (Griffin A.2)
        "lam": torch.rand((dr,), generator=gen, dtype=torch.float32,
                          device=device) * (0.999 - 0.9) + 0.9,
        "w_out": dense(dr, d),
    }


def causal_conv1d(p, x, conv_state, *, want_states: bool = False):
    """Depthwise causal conv. x: [B,T,dr]; conv_state: [B,cw-1,dr] history.
    Returns (y [B,T,dr], new_state [B,cw-1,dr], staged [T+1,B,cw-1,dr] or
    None): staged slot j is the history after j of the T new tokens. The new
    state and the staged windows are new tensors, never views of
    `conv_state`."""
    cw = p["conv_w"].shape[0]
    full = torch.cat([conv_state, x], dim=1)                 # [B,cw-1+T,dr]
    t = x.shape[1]
    y = 0
    for i in range(cw):
        y = y + full[:, i:i + t] * p["conv_w"][i]
    y = y + p["conv_b"]
    new_state = full[:, -(cw - 1):].clone() if cw > 1 else conv_state
    staged = None
    if want_states and cw > 1:
        staged = torch.stack([full[:, j:j + cw - 1] for j in range(t + 1)])
    return y, new_state, staged


def rg_lru(p, x, h0, *, want_states: bool = False):
    """x: [B,T,dr]; h0: [B,dr] float32 -> (y [B,T,dr] in x's dtype, h_last
    [B,dr] float32, states [T+1,B,dr] float32 or None): slot 0 is h0, slot
    j the state after j tokens."""
    xf = x.float()
    r = torch.sigmoid(xf @ p["w_a"].float() + p["b_a"].float())
    i = torch.sigmoid(xf @ p["w_x"].float() + p["b_x"].float())
    log_a = -RG_LRU_C * F.softplus(-torch.log(p["lam"])) * r   # <0
    a = torch.exp(log_a)
    gated_x = i * xf
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    h0 = h0.float()
    args = (a.contiguous(), (beta * gated_x).contiguous(), h0.contiguous())
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        hs, h_last = LinearScan.apply(*args)
    else:
        hs, h_last = linear_scan(*args)
    states = None
    if want_states:
        states = torch.cat([h0[None], hs.movedim(1, 0)])
    return hs.to(x.dtype), h_last, states


def apply_rglru_block(cfg, p, x, state, *, want_states: bool = False):
    """x: [B,T,d]; state: {"h": [B,dr] float32, "conv": [B,cw-1,dr]}.
    Returns (out [B,T,d], new_state, staged {"h": [T+1,B,dr],
    "conv": [T+1,B,cw-1,dr]} or None)."""
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    u = x @ p["w_in"]
    u, conv_state, conv_staged = causal_conv1d(p, u, state["conv"],
                                               want_states=want_states)
    y, h_last, hs = rg_lru(p, u, state["h"], want_states=want_states)
    out = (y * gate) @ p["w_out"]
    new_state = {"h": h_last, "conv": conv_state}
    staged = {"h": hs, "conv": conv_staged} if want_states else None
    return out, new_state, staged
