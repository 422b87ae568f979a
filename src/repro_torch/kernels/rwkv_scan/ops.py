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
`rwkv_scan.launches_by_route`.

`rwkv_scan_bwd` is the recurrence's backward (a kernel in the same source;
its plain version `rwkv_scan_bwd_plain` on the CPU), and `RwkvScan` the
autograd function of the training path over the two."""

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


def rwkv_scan(r, k, v, w, u, s0, *, states=None, checkpoints=False):
    """The WKV recurrence; see `rwkv_scan_plain` for the contract. With
    `checkpoints=True` (the card only) it also returns the state entering
    each chunk of CHUNK tokens, [B,H,ceil(T/CHUNK),N,N]: the chunked
    route's scratch (its decays trail the states in the same buffer), or
    a view of s0 for a call of at most CHUNK tokens. `rwkv_scan_bwd`
    recomputes each chunk's states from them."""
    if r.device.type == "cpu":
        if checkpoints:
            raise ValueError(f"{_NAME}: checkpoints are the kernel's; the "
                             "plain backward recomputes from s0")
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
    if not checkpoints:
        return y, s_last
    if scratch is None:
        return y, s_last, s0[:, :, None]
    nc = -(-t // CHUNK)
    return y, s_last, scratch[:b * h * nc * n * n].view(b, h, nc, n, n)


rwkv_scan.launches = 0
rwkv_scan.launches_by_route = dict.fromkeys(ROUTES, 0)


def rwkv_scan_bwd_plain(r, k, v, w, u, s0, dy, ds_last=None):
    """The backward of `rwkv_scan_plain(r, k, v, w, u, s0)` for output
    gradients dy [B,T,H,N] and ds_last [B,H,N,N] (None: zero). Returns
    (dr, dk, dv, dw [B,T,H,N], du [H,N] summed over rows and tokens, ds0
    [B,H,N,N]). The serial float32 loop: the states before each token
    first, then the adjoint G of the state from the last token back,
        dr_t = (S_{t-1} + u k_t v_t^T) dy_t,  dw_t = rowsum(G_t * S_{t-1}),
        dk_t = G_t v_t + r_t u (dy_t . v_t),  dv_t = G_t^T k_t + dy_t
        (r_t u . k_t),  G_{t-1} = w_t G_t + r_t dy_t^T."""
    t = r.shape[1]
    befores = []
    s = s0
    for i in range(t):
        befores.append(s)
        s = (w[:, i, ..., :, None] * s
             + k[:, i, ..., :, None] * v[:, i, ..., None, :])
    g = torch.zeros_like(s0) if ds_last is None else ds_last
    grads = {n: [None] * t for n in ("dr", "dk", "dv", "dw")}
    du = torch.zeros_like(u)
    for i in reversed(range(t)):
        r_t, k_t, v_t, w_t, dy_t = (x[:, i] for x in (r, k, v, w, dy))
        kv = k_t[..., :, None] * v_t[..., None, :]
        c1 = (dy_t * v_t).sum(-1, keepdim=True)          # [B,H,1]
        c2 = (r_t * u * k_t).sum(-1, keepdim=True)
        grads["dr"][i] = torch.einsum("bhv,bhkv->bhk", dy_t,
                                      befores[i] + u[..., :, None] * kv)
        grads["dk"][i] = torch.einsum("bhkv,bhv->bhk", g, v_t) + r_t * u * c1
        grads["dv"][i] = torch.einsum("bhkv,bhk->bhv", g, k_t) + dy_t * c2
        grads["dw"][i] = (g * befores[i]).sum(-1)
        du = du + (r_t * k_t * c1).sum(0)
        g = w_t[..., :, None] * g + r_t[..., :, None] * dy_t[..., None, :]
    dr, dk, dv, dw = (torch.stack(grads[n], dim=1)
                      for n in ("dr", "dk", "dv", "dw"))
    return dr, dk, dv, dw, du, g


_BWD_ARGTYPES = ((ctypes.c_void_p,) * 15 + (ctypes.c_int,) * 4
                 + (ctypes.c_void_p,))


def rwkv_scan_bwd(r, k, v, w, u, s0, dy, ds_last=None, *, ckpt=None):
    """The backward of the WKV recurrence; see `rwkv_scan_bwd_plain` for
    the contract. On the card it recomputes each chunk's states from
    `ckpt`, the state entering each chunk of CHUNK tokens that
    `rwkv_scan(..., checkpoints=True)` returns; the plain version, on the
    CPU, recomputes them from s0. Launches are counted in
    `rwkv_scan_bwd.launches`."""
    if r.device.type == "cpu":
        return rwkv_scan_bwd_plain(r, k, v, w, u, s0, dy, ds_last)
    name = "rwkv_scan_bwd"
    if r.dim() != 4:
        raise ValueError(f"{name}: r [B,T,H,N] expected, got "
                         f"{tuple(r.shape)}")
    b, t, h, n = r.shape
    nc = -(-t // CHUNK)
    if ckpt is None:
        raise ValueError(f"{name}: on the card it needs the forward's chunk "
                         "checkpoints (ckpt=)")
    tensors = (r, k, v, w, u, ckpt, dy) + (() if ds_last is None
                                            else (ds_last,))
    _lib.require_cuda(name, *tensors)
    if any(x.dtype != torch.float32 for x in tensors):
        raise ValueError(f"{name}: every input must be float32, got "
                         f"{[x.dtype for x in tensors]}")
    shape = r.shape
    if (k.shape != shape or v.shape != shape or w.shape != shape
            or dy.shape != shape or u.shape != (h, n)
            or s0.shape != (b, h, n, n) or ckpt.shape != (b, h, nc, n, n)
            or (ds_last is not None and ds_last.shape != (b, h, n, n))):
        raise ValueError(
            f"{name}: shapes do not match: r {tuple(r.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, w {tuple(w.shape)}, dy "
            f"{tuple(dy.shape)}, u {tuple(u.shape)}, s0 {tuple(s0.shape)}, "
            f"ckpt {tuple(ckpt.shape)}, ds_last "
            f"{None if ds_last is None else tuple(ds_last.shape)}")
    if n not in HEAD_SIZES:
        raise ValueError(f"{name}: head size {n} not in {HEAD_SIZES}")
    if t < 1:
        raise ValueError(f"{name}: T must be at least 1")
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du_part = torch.empty((b, h, n), dtype=torch.float32, device=r.device)
    ds0 = torch.empty_like(s0)
    ws = torch.empty(b * h * 2 * min(t, CHUNK) * n * n, dtype=torch.float32,
                     device=r.device)
    err = _lib.function(_NAME, "rwkv_scan_bwd_f32", _BWD_ARGTYPES)(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        ckpt.data_ptr(), dy.data_ptr(),
        None if ds_last is None else ds_last.data_ptr(), dr.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du_part.data_ptr(),
        ds0.data_ptr(), ws.data_ptr(), b, t, h, n, _lib.stream_ptr(r))
    _lib.check(_NAME, err)
    rwkv_scan_bwd.launches += 1
    return dr, dk, dv, dw, du_part.sum(0), ds0


rwkv_scan_bwd.launches = 0


class RwkvScan(torch.autograd.Function):
    """The WKV recurrence for the training path: `rwkv_scan` forward and
    `rwkv_scan_bwd` backward. On the card the forward keeps r, k, v, w, u
    and the state entering each chunk of CHUNK tokens (N*N floats per
    (b, h) a chunk: 20 KB a token at RWKV-6-3B's 40 heads of 64, beside
    r, k, v, w's 40 KB); on the CPU it keeps s0, and the plain backward
    recomputes every state. `RwkvScan.apply(r, k, v, w, u, s0)` -> (y,
    s_last)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        if r.device.type == "cpu":
            y, s_last = rwkv_scan(r, k, v, w, u, s0)
            ckpt = s0
        else:
            y, s_last, ckpt = rwkv_scan(r, k, v, w, u, s0, checkpoints=True)
        ctx.save_for_backward(r, k, v, w, u, s0, ckpt)
        ctx.set_materialize_grads(False)    # an unused s_last: no zeros
        return y, s_last

    @staticmethod
    def backward(ctx, dy, ds_last):
        r, k, v, w, u, s0, ckpt = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        grads = rwkv_scan_bwd(
            r, k, v, w, u, s0, dy.contiguous(),
            None if ds_last is None else ds_last.contiguous(),
            ckpt=None if r.device.type == "cpu" else ckpt)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))
