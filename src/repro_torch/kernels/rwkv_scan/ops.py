"""The RWKV-6 WKV recurrence: the CUDA kernel `csrc/rwkv_scan.cu` and its
plain PyTorch version.

For each batch row b and head h, with the state S in R^{N x N} indexed
[k, v]:

    y_t[v] = sum_k r_t[k] * (S[k,v] + u[k] * k_t[k] * v_t[v])
    S[k,v] <- w_t[k] * S[k,v] + k_t[k] * v_t[v]

`rwkv_scan` takes the plain version for tensors on the CPU and launches the
kernel for tensors on the card; it never falls back. On the card it takes
one of two routes (`route`): "serial" walks the tokens in order (every call
that stages states, and every call of at most CHUNK tokens), "chunked"
cuts T into chunks of CHUNK tokens and passes the state from chunk to
chunk (a longer call that stages nothing: the prefill). Launches are
counted in `rwkv_scan.launches` and by route in
`rwkv_scan.launches_by_route`."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _lib

_NAME = "rwkv_scan"
HEAD_SIZES = (32, 64)
#: tokens per chunk of the chunked route (csrc/rwkv_scan.cu: CL)
CHUNK = 32
ROUTES = ("serial", "chunked")


def scratch_floats(b: int, t: int, h: int, n: int) -> int:
    """The chunked route's scratch: per (b, h, chunk) an N x N state and an
    N-vector of decays (csrc/rwkv_scan.cu, `launch_chunked`)."""
    return -(-t // CHUNK) * b * h * (n * n + n)


def route(t: int, staged: bool) -> str:
    """The route of a T-token call: "chunked" for more than CHUNK tokens
    without staged states, else "serial"."""
    return "chunked" if t > CHUNK and not staged else "serial"


def rwkv_scan_plain(r, k, v, w, u, s0, *, states=None):
    """r, k, v, w: [B,T,H,N] float32 (w the decay in (0, 1)); u: [H,N];
    s0: [B,H,N,N]. Returns (y [B,T,H,N], s_last [B,H,N,N]). With `states`
    (a [T+1,B,H,N,N] float32 tensor), slot 0 receives a copy of s0 and slot
    t+1 the state after token t: the staged states speculative rollback
    selects from. The serial per-token float32 loop."""
    t = r.shape[1]
    s = s0
    if states is not None:
        states[0].copy_(s0)
    ys = []
    for i in range(t):
        r_t, k_t, v_t, w_t = r[:, i], k[:, i], v[:, i], w[:, i]   # [B,H,N]
        kv = k_t[..., :, None] * v_t[..., None, :]  # [B,H,Nk,Nv]
        ys.append(torch.einsum("bhk,bhkv->bhv", r_t,
                               s + u[..., :, None] * kv))
        s = w_t[..., :, None] * s + kv
        if states is not None:
            states[i + 1].copy_(s)
    return torch.stack(ys, dim=1), s


_ARGTYPES = (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


def _fn():
    return _lib.function(_NAME, "rwkv_scan_f32", _ARGTYPES)


def rwkv_scan(r, k, v, w, u, s0, *, states=None):
    """The WKV recurrence; see `rwkv_scan_plain` for the contract."""
    if r.device.type == "cpu":
        return rwkv_scan_plain(r, k, v, w, u, s0, states=states)
    tensors = (r, k, v, w, u, s0) + (() if states is None else (states,))
    _lib.require_cuda(_NAME, *tensors)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{_NAME}: every input must be float32, got "
                         f"{[t.dtype for t in tensors]}")
    shape = r.shape
    if len(shape) != 4:
        raise ValueError(f"{_NAME}: r [B,T,H,N] expected, got "
                         f"{tuple(shape)}")
    b, t, h, n = shape
    if (k.shape != shape or v.shape != shape or w.shape != shape
            or u.shape != (h, n) or s0.shape != (b, h, n, n)
            or (states is not None and states.shape != (t + 1, b, h, n, n))):
        raise ValueError(
            f"{_NAME}: shapes do not match: r {tuple(r.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, w {tuple(w.shape)}, u "
            f"{tuple(u.shape)}, s0 {tuple(s0.shape)}, states "
            f"{None if states is None else tuple(states.shape)}")
    if n not in HEAD_SIZES:
        raise ValueError(f"{_NAME}: head size {n} not in {HEAD_SIZES}")
    if t < 1:
        raise ValueError(f"{_NAME}: T must be at least 1")
    which = route(t, states is not None)
    y = torch.empty_like(r)
    s_last = torch.empty_like(s0)
    scratch = chunk = None
    if which == "chunked":
        chunk = CHUNK
        scratch = torch.empty(scratch_floats(b, t, h, n),
                              dtype=torch.float32, device=r.device)
    err = _fn()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_last.data_ptr(),
                None if states is None else states.data_ptr(),
                None if scratch is None else scratch.data_ptr(), b, t, h, n,
                chunk or 0, _lib.stream_ptr(r))
    _lib.check(_NAME, err)
    rwkv_scan.launches += 1
    rwkv_scan.launches_by_route[which] += 1
    return y, s_last


rwkv_scan.launches = 0
rwkv_scan.launches_by_route = dict.fromkeys(ROUTES, 0)
