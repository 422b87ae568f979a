"""Span decode attention over the ring KV cache: the CUDA kernel
`csrc/decode_attention.cu` and its plain PyTorch version.

`decode_attention` takes the plain version for tensors on the CPU and
launches the kernel for tensors on the card; it never falls back."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _lib
from repro_torch.models.attention import attend

_NAME = "decode_attention"
HEAD_DIMS = (64, 128, 256)


def decode_attention_plain(q, k_cache, v_cache, cache_pos, q_pos, *,
                           window: int = 0):
    """q: [B,T,H,D]; k_cache, v_cache: [B,S,Hkv,D]; cache_pos: [B,S] int32
    (-1 empty); q_pos: [B,T] int32 -> [B,T,H,D]. A key is valid for a
    query where 0 <= pos <= q_pos (and pos > q_pos - window when windowed);
    a query with no valid key gives zeros."""
    return attend(q, k_cache, v_cache, q_pos, cache_pos, window=window,
                  causal=True)


def _fns():
    return (_lib.function(_NAME, "span_decode_attention",
                          [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                          + [ctypes.c_void_p]),
            _lib.function(_NAME, "span_decode_splits", [ctypes.c_int]))


def decode_attention(q, k_cache, v_cache, cache_pos, q_pos, *,
                     window: int = 0):
    """Span decode attention; see `decode_attention_plain` for the
    contract."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_pos, q_pos,
                                      window=window)
    _lib.require_cuda(_NAME, q, k_cache, v_cache, cache_pos, q_pos)
    if (q.dtype not in _lib.DTYPE_CODES or k_cache.dtype != q.dtype
            or v_cache.dtype != q.dtype):
        raise ValueError(f"{_NAME}: q and the cache must share float32 or "
                         f"bfloat16, got {q.dtype}, {k_cache.dtype}")
    if cache_pos.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise ValueError(f"{_NAME}: cache_pos and q_pos must be int32")
    if q.dim() != 4 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"{_NAME}: q [B,T,H,D], cache [B,S,Hkv,D] expected")
    b, t, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape[0] != b or k_cache.shape[3] != d or h % hkv
            or tuple(cache_pos.shape) != (b, s)
            or tuple(q_pos.shape) != (b, t)):
        raise ValueError(f"{_NAME}: shapes do not match: q {tuple(q.shape)}, "
                         f"cache {tuple(k_cache.shape)}, cache_pos "
                         f"{tuple(cache_pos.shape)}, q_pos {tuple(q_pos.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{_NAME}: head_dim {d} not in {HEAD_DIMS}")
    fn, splits = _fns()
    nsplit = splits(s)
    out = torch.empty_like(q)
    part_o = torch.empty((b, t, h, nsplit, d), dtype=torch.float32,
                         device=q.device)
    part_m = torch.empty((b, t, h, nsplit), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                cache_pos.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
                part_o.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
                b, t, s, h, hkv, d, int(window or 0),
                _lib.DTYPE_CODES[q.dtype], _lib.stream_ptr(q))
    _lib.check(_NAME, err)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
