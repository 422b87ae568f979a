"""Causal GQA prefill attention: the CUDA kernel `csrc/flash_attention.cu`
and its plain PyTorch version, and `FlashAttention`, the training path's
autograd function over the kernel.

`flash_attention` takes the plain version for tensors on the CPU and
launches the kernel for tensors on the card; it never falls back. The
backward (`flash_attention_bwd`) is plain PyTorch on both: the JAX package
differentiates its attention outside any Pallas kernel."""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _lib
from repro_torch.models.attention import attend

_NAME = "flash_attention"
HEAD_DIMS = (64, 128, 256)


def _causal_mask(s: int, window: int, device) -> torch.Tensor:
    """[S,S] bool: key j serves query i where j <= i (and j > i - window
    when windowed)."""
    pos = torch.arange(s, device=device)
    valid = pos[None, :] <= pos[:, None]
    if window and window > 0:
        valid = valid & (pos[None, :] > pos[:, None] - window)
    return valid


def _grouped_scores(q, k):
    """Scaled scores [B,Hkv,G,S,S] in float32 (float64 kept) and q scaled
    by 1/sqrt(D) as [B,S,Hkv,G,D], with the query heads of a KV head
    grouped as `attend` groups them."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    acc = torch.promote_types(q.dtype, torch.float32)
    qs = (q.to(acc) / math.sqrt(d)).reshape(b, s, hkv, h // hkv, d)
    return torch.einsum("bthgd,bshd->bhgts", qs, k.to(acc)), qs


def flash_attention_plain(q, k, v, *, window: int = 0, lse: bool = False):
    """q: [B,S,H,D]; k,v: [B,S,Hkv,D] -> [B,S,H,D]. Causal over positions
    0..S-1, optionally windowed. With lse=True also returns each query
    row's log-sum-exp of its valid scaled scores, [B,H,S] in float32
    (float64 for float64 inputs; -inf for a row with no valid key)."""
    b, s = q.shape[:2]
    pos = torch.arange(s, dtype=torch.int32, device=q.device).expand(b, s)
    out = attend(q, k, v, pos, pos, window=window, causal=True)
    if not lse:
        return out
    scores, _ = _grouped_scores(q, k)
    mask = _causal_mask(s, window, q.device)
    row_lse = torch.where(mask, scores, -math.inf).logsumexp(-1)
    return out, row_lse.reshape(b, q.shape[2], s)


def flash_attention_bwd(q, k, v, out, lse, dout, *, window: int = 0):
    """The attention backward from the forward's saved q, k, v, out and
    lse [B,H,S]: P = exp(S*scale - lse) under the causal (and window)
    mask, dV = P^T dO, dP = dO V^T, D = rowsum(dO * O), dS = P * (dP - D),
    dQ = dS K * scale, dK = dS^T Q * scale, in float32 (float64 kept). The
    query heads of a KV head sum into its dK and dV. A row with no valid
    key has P = 0, so zero gradients. Returns (dq, dk, dv) in the inputs'
    types."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scores, qs = _grouped_scores(q, k)
    acc = scores.dtype
    mask = _causal_mask(s, window, q.device)
    row_lse = lse.to(acc).reshape(b, hkv, g, s)[..., None]
    p = torch.where(mask, torch.exp(scores - row_lse), 0.0)
    do = dout.to(acc).reshape(b, s, hkv, g, d)
    dv = torch.einsum("bhgts,bthgd->bshd", p, do)
    dp = torch.einsum("bthgd,bshd->bhgts", do, v.to(acc))
    delta = (do * out.to(acc).reshape(b, s, hkv, g, d)).sum(-1)  # [B,S,Hkv,G]
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bhgts,bshd->bthgd", ds, k.to(acc)) / math.sqrt(d)
    dk = torch.einsum("bhgts,bthgd->bshd", ds, qs)
    return (dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def route(dtype: torch.dtype) -> str:
    """The kernel's route for a dtype, as the C launcher chooses it: bf16
    on the tensor cores (wgmma fed by TMA), float32 on the CUDA cores."""
    return "wgmma" if dtype == torch.bfloat16 else "simt"


_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])


def flash_attention(q, k, v, *, window: int = 0, lse: bool = False):
    """Causal (optionally sliding-window) prefill attention; see
    `flash_attention_plain` for the contract (lse=True returns
    (out, lse))."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window=window, lse=lse)
    _lib.require_cuda(_NAME, q, k, v)
    if q.dtype not in _lib.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{_NAME}: q, k, v must share float32 or bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{_NAME}: q [B,S,H,D] and k, v [B,S,Hkv,D] expected")
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if k.shape[:2] != (b, s) or k.shape[3] != d or h % hkv:
        raise ValueError(f"{_NAME}: shapes q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not match")
    if d not in HEAD_DIMS:
        raise ValueError(f"{_NAME}: head_dim {d} not in {HEAD_DIMS}")
    out = torch.empty_like(q)
    row_lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
               if lse else None)
    taken = ctypes.c_int(-1)
    err = _lib.function(_NAME, "flash_attention_fwd", _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if row_lse is None else row_lse.data_ptr(),
        b, s, h, hkv, d, int(window or 0), _lib.DTYPE_CODES[q.dtype],
        _lib.stream_ptr(q), ctypes.byref(taken))
    _lib.check(_NAME, err)
    _lib.count_route(flash_attention, _NAME, taken.value, route(q.dtype))
    return (out, row_lse) if lse else out


flash_attention.launches = 0
flash_attention.launches_by_route = {"wgmma": 0, "simt": 0}


class FlashAttention(torch.autograd.Function):
    """Causal attention for the training path: `flash_attention` forward
    (the kernel on the card, writing each row's lse) and
    `flash_attention_bwd` backward from the saved q, k, v, out and lse.
    `FlashAttention.apply(q, k, v, window)`."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        out, row_lse = flash_attention(q, k, v, window=window, lse=True)
        ctx.save_for_backward(q, k, v, out, row_lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, row_lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, row_lse, dout,
                                         window=ctx.window)
        return dq, dk, dv, None
