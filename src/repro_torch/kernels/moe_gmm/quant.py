"""Expert-weight quantization: absmax scale calibration and packing.

The quantized expert path stores each routed expert's gate/up/down
matrices as int8 with one float32 absmax scale per expert per matrix: the
weights stream from device memory at 1 byte per parameter while the kernel
`moe_gmm_fused_quant` dequantizes inside its tiles and accumulates in
float32. fp8 (e4m3) is simulated: weights round-trip through
`torch.float8_e4m3fn` at calibration time (fake-quant) and run the standard
kernel, priced at the same 1 byte per parameter by the cost model.

Scale fitting is per-expert absmax by default; `quantile < 1` clips the
scale to that quantile of |w| (outlier-robust), and
`fit_expert_scales_from_batches` pools a handful of weight batches the way
an activation-calibration pass would."""

from __future__ import annotations

import torch

__all__ = ["fit_expert_scales", "fit_expert_scales_from_batches",
           "quantize_int8", "dequantize_int8", "fake_quant_fp8",
           "quantize_moe_experts", "QUANT_SUFFIX", "SCALE_SUFFIX"]

#: params-dict key suffixes of the packed storage format `models/moe.py`
#: detects: `w_up` -> `w_up_q8` (int8 [E, ...]) + `w_up_s` (f32 [E])
QUANT_SUFFIX = "_q8"
SCALE_SUFFIX = "_s"

_INT8_MAX = 127.0


def _row_quantile(a, q: float):
    """The q-quantile of each row of `a` [E, N] (float32), with the linear
    interpolation of `numpy.quantile`'s default method, and its index and
    weight arithmetic in float32 as `jax.numpy.quantile` does it.
    `torch.quantile` refuses rows over 2^24 elements; two `kthvalue`
    selections take any length."""
    n = a.shape[1]
    pos = (torch.tensor(q, dtype=torch.float32)
           * (torch.tensor(n, dtype=torch.float32) - 1))
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    w_low = 1 - w_high
    lo = int(low.clamp(0, n - 1))
    hi = int(high.clamp(0, n - 1))
    v_lo = torch.kthvalue(a, lo + 1, dim=1).values
    v_hi = v_lo if hi == lo else torch.kthvalue(a, hi + 1, dim=1).values
    return v_lo * w_low.to(a.device) + v_hi * w_high.to(a.device)


def fit_expert_scales(w, quantile: float = 1.0):
    """Per-expert absmax scales for an [E, ...] weight stack: scale_e =
    quantile_q(|w_e|) / 127, floored away from zero so an all-zero expert
    still round-trips. Returns float32 [E]."""
    if not 0.0 < quantile <= 1.0:
        raise ValueError(f"quantile {quantile} outside (0, 1]")
    absw = w.float().abs().reshape(w.shape[0], -1)
    if quantile >= 1.0:
        amax = absw.amax(dim=1)
    else:
        amax = _row_quantile(absw, quantile)
    return torch.clamp(amax, min=1e-12) / _INT8_MAX


def fit_expert_scales_from_batches(batches, quantile: float = 1.0):
    """Absmax scale fit pooled over a handful of [E, ...] weight batches:
    the per-expert max of each batch's per-expert quantile. One batch is
    `fit_expert_scales`."""
    scales = None
    for w in batches:
        s = fit_expert_scales(w, quantile)
        scales = s if scales is None else torch.maximum(scales, s)
    if scales is None:
        raise ValueError("no calibration batches")
    return scales


def quantize_int8(w, scales=None, quantile: float = 1.0):
    """Symmetric int8 quantization of an [E, ...] stack under per-expert
    scales (fit from `w` when not given). Returns (q8 int8, scales float32
    [E]); `dequantize_int8(q8, scales)` recovers w to within scale/2 per
    element."""
    if scales is None:
        scales = fit_expert_scales(w, quantile)
    s = scales.reshape((-1,) + (1,) * (w.dim() - 1))
    q = torch.round(w.float() / s)   # half to even, as jnp.round
    return q.clamp(-_INT8_MAX, _INT8_MAX).to(torch.int8), scales


def dequantize_int8(q8, scales):
    """float32 dequantization, the inverse the kernel fuses into its
    tiles (the plain version `moe_gmm_fused_quant_plain` uses exactly
    this)."""
    s = scales.reshape((-1,) + (1,) * (q8.dim() - 1))
    return q8.float() * s


def fake_quant_fp8(w):
    """fp8 (e4m3) simulated: round-trip through float8_e4m3fn and return in
    w's dtype. The bytes saving is priced by the cost model
    (`Precision.fp8_experts()`); compute runs the standard kernel."""
    return w.to(torch.float8_e4m3fn).to(w.dtype)


def quantize_moe_experts(params, mode: str = "int8",
                         quantile: float = 1.0) -> dict:
    """Quantize one MoE layer's params dict's routed expert tensors
    (w_gate/w_up/w_down), leaving router and shared weights untouched: the
    mixed-precision storage `apply_moe` detects.

    mode="int8": each `w_x` [E, ...] is replaced by `w_x_q8` (int8) +
    `w_x_s` (float32 [E]) and removed. mode="fp8": weights are
    fake-quantized in place (same keys, same dtype)."""
    out = dict(params)
    names = [k for k in ("w_gate", "w_up", "w_down") if k in params]
    if not names:
        raise ValueError("params hold no routed expert tensors "
                         "(w_gate/w_up/w_down)")
    if mode == "fp8":
        for k in names:
            out[k] = fake_quant_fp8(params[k])
        return out
    if mode != "int8":
        raise ValueError(f"unknown quantization mode {mode!r}")
    for k in names:
        q, s = quantize_int8(params[k], quantile=quantile)
        out[k + QUANT_SUFFIX] = q
        out[k + SCALE_SUFFIX] = s
        del out[k]
    return out
