"""Causal GQA prefill attention: the CUDA kernel `csrc/flash_attention.cu`
and its plain PyTorch version.

`flash_attention` takes the plain version for tensors on the CPU and
launches the kernel for tensors on the card; it never falls back."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _lib
from repro_torch.models.attention import attend

_NAME = "flash_attention"
HEAD_DIMS = (64, 128)


def flash_attention_plain(q, k, v, *, window: int = 0):
    """q: [B,S,H,D]; k,v: [B,S,Hkv,D] -> [B,S,H,D]. Causal over positions
    0..S-1, optionally windowed."""
    b, s = q.shape[:2]
    pos = torch.arange(s, dtype=torch.int32, device=q.device).expand(b, s)
    return attend(q, k, v, pos, pos, window=window, causal=True)


def _fn():
    fn = _lib.library(_NAME).flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, *, window: int = 0):
    """Causal (optionally sliding-window) prefill attention; see
    `flash_attention_plain` for the contract."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window=window)
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
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, s, h, hkv, d, int(window or 0), _lib.DTYPE_CODES[q.dtype],
                _lib.stream_ptr(q))
    _lib.check(_NAME, err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
