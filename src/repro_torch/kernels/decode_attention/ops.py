"""Span decode attention over the ring KV cache: the CUDA kernel
`csrc/decode_attention.cu` (bf16 on the tensor cores, float32 on the CUDA
cores) and its plain PyTorch version.

`decode_attention` takes the plain version for tensors on the CPU and
launches the kernel for tensors on the card; it never falls back."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _lib
from repro_torch.models.attention import attend

_NAME = "decode_attention"
HEAD_DIMS = (64, 80, 128, 256)


def decode_attention_plain(q, k_cache, v_cache, cache_pos, q_pos, *,
                           window: int = 0):
    """q: [B,T,H,D]; k_cache, v_cache: [B,S,Hkv,D]; cache_pos: [B,S] int32
    (-1 empty); q_pos: [B,T] int32 -> [B,T,H,D]. A key is valid for a
    query where 0 <= pos <= q_pos (and pos > q_pos - window when windowed);
    a query with no valid key gives zeros."""
    return attend(q, k_cache, v_cache, q_pos, cache_pos, window=window,
                  causal=True)


def route(dtype: torch.dtype) -> str:
    """`decode_attention`'s route for a dtype, as the C launcher chooses
    it: bf16 on the tensor cores (mma.sync fed by bulk copies), float32 on
    the CUDA cores."""
    return "mma" if dtype == torch.bfloat16 else "simt"


#: ring slots per CTA of the float32 route (csrc/decode_attention.cu: CHUNK)
SIMT_SPLIT = 128
#: waves of resident CTAs the bf16 route's grid aims at, at most
_WAVES = 2


def _resident_ctas(d: int) -> int:
    """`span_mma` CTAs an SM holds: 4 of 4 warps at head_dim <= 128 (126
    registers a thread), 1 of 8 warps at head_dim 256 (210 registers)."""
    return 4 if d <= 128 else 1


def split_size(dtype: torch.dtype, b: int, hkv: int, s: int, d: int,
               sms: int) -> int:
    """Ring slots per CTA: 128 on the float32 route; on the bf16 route the
    smallest of 32, 64, 128 (64 at most at head_dim 256, whose K/V rows
    fill shared memory sooner) for which the B * Hkv * ceil(S / split) CTAs
    make at most two waves of the CTAs the SMs hold. From host values only:
    a pass needs no synchronisation to size its grid. Smaller splits cost
    more than they save: every CTA pays a load of its slots' positions and
    then of its K/V before it computes, and every split adds a partial of
    G*T*D floats per KV head to write and merge (measured on an H100 at the
    main path's shapes: PERF.md). One KV head at batch 1 (RecurrentGemma,
    S = 3072) takes 32-slot splits: the 2048 slots of a window spread over
    64 CTAs."""
    if route(dtype) != "mma":
        return SIMT_SPLIT
    cap = 128 if d <= 128 else 64
    limit = _WAVES * _resident_ctas(d) * sms
    split = 32
    while split < cap and b * hkv * -(-s // split) > limit:
        split *= 2
    return split


_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
             + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    split = split_size(q.dtype, b, hkv, s, d, _sm_count(q.device.index))
    nsplit = -(-s // split)
    out = torch.empty_like(q)
    # the splits' partials in one buffer: accumulators, maxima, sums
    part = torch.empty(b * t * h * nsplit * (d + 2), dtype=torch.float32,
                       device=q.device)
    taken = ctypes.c_int(-1)
    err = _lib.function(_NAME, "span_decode_attention", _ARGTYPES)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        cache_pos.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
        part.data_ptr(), b, t, s, h, hkv, d, int(window or 0), split,
        _lib.DTYPE_CODES[q.dtype], _lib.stream_ptr(q), ctypes.byref(taken))
    _lib.check(_NAME, err)
    _lib.count_route(decode_attention, _NAME, taken.value, route(q.dtype))
    return out


decode_attention.launches = 0
decode_attention.launches_by_route = {"mma": 0, "simt": 0}
