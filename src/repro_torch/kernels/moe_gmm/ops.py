"""Fused MoE expert FFN over a slot layout: the CUDA kernel
`csrc/moe_gmm.cu` and its plain PyTorch version.

`moe_gmm_fused` takes the plain version for tensors on the CPU and launches
the kernel for tensors on the card; it never falls back."""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _lib

_NAME = "moe_gmm"
ACTIVATIONS = ("swiglu", "gelu")


def moe_gmm_fused_plain(x, wg, wu, wd, counts, *, activation: str = "swiglu",
                        expert_ids=None):
    """x: [U,C,d]; wg, wu: [E,d,F]; wd: [E,F,d]; counts: [U] int32 live rows
    per slot; expert_ids: [U] int32 weight row of each slot, or None for
    E == U and slot u on expert u. Returns [U,C,d] in x.dtype: the swiglu
    (or tanh-gelu) FFN in float32 for rows below counts[u], exact zeros for
    the other rows and for slots with counts[u] == 0."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    u, c, d = x.shape
    y = torch.zeros((u, c, d), dtype=torch.float32, device=x.device)
    live = torch.nonzero(counts > 0).flatten()
    if live.numel():
        rows = live if expert_ids is None else expert_ids[live].long()
        xf = x[live].float()
        up = torch.einsum("ucd,udf->ucf", xf, wu[rows].float())
        if activation == "swiglu":
            gate = torch.einsum("ucd,udf->ucf", xf, wg[rows].float())
            h = F.silu(gate) * up
        else:
            h = F.gelu(up, approximate="tanh")
        yl = torch.einsum("ucf,ufd->ucd", h, wd[rows].float())
        keep = (torch.arange(c, device=x.device)[None, :]
                < counts[live][:, None])
        y[live] = torch.where(keep[..., None], yl, 0.0)
    return y.to(x.dtype)


def _fn():
    fn = _lib.library(_NAME).moe_gmm_fused
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def moe_gmm_fused(x, wg, wu, wd, counts, *, activation: str = "swiglu",
                  expert_ids=None):
    """Fused expert FFN; see `moe_gmm_fused_plain` for the contract."""
    if x.device.type == "cpu":
        return moe_gmm_fused_plain(x, wg, wu, wd, counts,
                                   activation=activation,
                                   expert_ids=expert_ids)
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    swiglu = activation == "swiglu"
    weights = (wg, wu, wd) if swiglu else (wu, wd)
    ints = (counts,) if expert_ids is None else (counts, expert_ids)
    _lib.require_cuda(_NAME, x, *weights, *ints)
    if x.dtype not in _lib.DTYPE_CODES or any(w.dtype != x.dtype
                                              for w in weights):
        raise ValueError(f"{_NAME}: x and weights must share float32 or "
                         f"bfloat16, got {x.dtype} and "
                         f"{[w.dtype for w in weights]}")
    if any(t.dtype != torch.int32 for t in ints):
        raise ValueError(f"{_NAME}: counts and expert_ids must be int32")
    if x.dim() != 3:
        raise ValueError(f"{_NAME}: x [U,C,d] expected, got {tuple(x.shape)}")
    u, c, d = x.shape
    e, f = wu.shape[0], wu.shape[2]
    if (tuple(wu.shape) != (e, d, f) or tuple(wd.shape) != (e, f, d)
            or (swiglu and tuple(wg.shape) != (e, d, f))):
        raise ValueError(f"{_NAME}: weights do not match x {tuple(x.shape)}: "
                         f"wu {tuple(wu.shape)}, wd {tuple(wd.shape)}")
    if tuple(counts.shape) != (u,) or (expert_ids is None and e != u) or (
            expert_ids is not None and tuple(expert_ids.shape) != (u,)):
        raise ValueError(f"{_NAME}: counts/expert_ids must be [U={u}] "
                         f"(and E == U without expert_ids), E={e}")
    if d % 2 or f % 2:
        raise ValueError(f"{_NAME}: d={d} and F={f} must be even")
    h = torch.empty((u, c, f), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    err = _fn()(x.data_ptr(), wg.data_ptr() if swiglu else None,
                wu.data_ptr(), wd.data_ptr(), counts.data_ptr(),
                None if expert_ids is None else expert_ids.data_ptr(),
                h.data_ptr(), y.data_ptr(), u, c, d, f, int(swiglu),
                _lib.DTYPE_CODES[x.dtype], _lib.stream_ptr(x))
    _lib.check(_NAME, err)
    moe_gmm_fused.launches += 1
    return y


moe_gmm_fused.launches = 0
