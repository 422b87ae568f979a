"""The RG-LRU's linear recurrence `h_t = a_t * h_{t-1} + x_t`: the CUDA
kernel `csrc/linear_scan.cu` and its plain PyTorch version.

`linear_scan` takes the plain version for tensors on the CPU and launches
the kernel for tensors on the card; it never falls back. `linear_scan_bwd`
is the recurrence's backward (a kernel in the same source; its plain
version `linear_scan_bwd_plain` on the CPU), and `LinearScan` the autograd
function of the training path over the two."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _lib

_NAME = "linear_scan"


def linear_scan_plain(a, x, h0):
    """a, x: [B,T,D] float32; h0: [B,D] float32. Returns (y [B,T,D],
    h_last [B,D]) with y[:, t] the state after token t. The serial
    per-token float32 loop, each step a product then a sum."""
    h = h0
    ys = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + x[:, t]
        ys.append(h)
    return torch.stack(ys, dim=1), h


_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)


def _fn():
    return _lib.function(_NAME, "linear_scan_f32", _ARGTYPES)


def linear_scan(a, x, h0):
    """The linear recurrence; see `linear_scan_plain` for the contract.
    Any T >= 1 and any D; on the card equal to the plain version bit for
    bit."""
    if a.device.type == "cpu":
        return linear_scan_plain(a, x, h0)
    _lib.require_cuda(_NAME, a, x, h0)
    if (a.dtype != torch.float32 or x.dtype != torch.float32
            or h0.dtype != torch.float32):
        raise ValueError(f"{_NAME}: a, x and h0 must be float32, got "
                         f"{a.dtype}, {x.dtype}, {h0.dtype}")
    shape = a.shape
    if len(shape) != 3 or x.shape != shape or h0.shape != (shape[0],
                                                           shape[2]):
        raise ValueError(f"{_NAME}: shapes do not match: a {tuple(a.shape)}, "
                         f"x {tuple(x.shape)}, h0 {tuple(h0.shape)}")
    b, t, d = shape
    if t < 1:
        raise ValueError(f"{_NAME}: T must be at least 1")
    y = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    err = _fn()(a.data_ptr(), x.data_ptr(), h0.data_ptr(), y.data_ptr(),
                h_last.data_ptr(), b, t, d, _lib.stream_ptr(a))
    _lib.check(_NAME, err)
    linear_scan.launches += 1
    return y, h_last


linear_scan.launches = 0


def linear_scan_bwd_plain(a, y, h0, dy, dh_last=None):
    """The backward of `linear_scan_plain(a, x, h0)` from its output y (y_t
    = h_t) and the output gradients dy [B,T,D] and dh_last [B,D] (None:
    zero). Returns (da, dx [B,T,D], dh0 [B,D]): from the last token back,
    g_t = dy_t + a_{t+1} g_{t+1} (g_T = dy_T + dh_last), dx_t = g_t, da_t
    = g_t h_{t-1} (h_0 = h0) and dh0 = a_1 g_1. The serial float32 loop,
    each step a product then a sum."""
    t = a.shape[1]
    c = torch.zeros_like(h0) if dh_last is None else dh_last
    dxs, das = [None] * t, [None] * t
    for i in reversed(range(t)):
        g = dy[:, i] + c
        dxs[i] = g
        das[i] = g * (y[:, i - 1] if i > 0 else h0)
        c = a[:, i] * g
    return torch.stack(das, dim=1), torch.stack(dxs, dim=1), c


_BWD_ARGTYPES = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 3
                 + (ctypes.c_void_p,))


def linear_scan_bwd(a, y, h0, dy, dh_last=None):
    """The backward of the linear recurrence; see `linear_scan_bwd_plain`
    for the contract. Any T >= 1 and any D; on the card equal to the plain
    version bit for bit. Launches are counted in
    `linear_scan_bwd.launches`."""
    if a.device.type == "cpu":
        return linear_scan_bwd_plain(a, y, h0, dy, dh_last)
    name = "linear_scan_bwd"
    tensors = (a, y, h0, dy) + (() if dh_last is None else (dh_last,))
    _lib.require_cuda(name, *tensors)
    if any(x.dtype != torch.float32 for x in tensors):
        raise ValueError(f"{name}: every input must be float32, got "
                         f"{[x.dtype for x in tensors]}")
    shape = a.shape
    if (len(shape) != 3 or y.shape != shape or dy.shape != shape
            or h0.shape != (shape[0], shape[2])
            or (dh_last is not None and dh_last.shape != h0.shape)):
        raise ValueError(
            f"{name}: shapes do not match: a {tuple(a.shape)}, y "
            f"{tuple(y.shape)}, dy {tuple(dy.shape)}, h0 {tuple(h0.shape)}, "
            f"dh_last {None if dh_last is None else tuple(dh_last.shape)}")
    b, t, d = shape
    if t < 1:
        raise ValueError(f"{name}: T must be at least 1")
    da, dx = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty_like(h0)
    err = _lib.function(_NAME, "linear_scan_bwd_f32", _BWD_ARGTYPES)(
        a.data_ptr(), y.data_ptr(), h0.data_ptr(), dy.data_ptr(),
        None if dh_last is None else dh_last.data_ptr(), da.data_ptr(),
        dx.data_ptr(), dh0.data_ptr(), b, t, d, _lib.stream_ptr(a))
    _lib.check(_NAME, err)
    linear_scan_bwd.launches += 1
    return da, dx, dh0


linear_scan_bwd.launches = 0


class LinearScan(torch.autograd.Function):
    """The linear recurrence for the training path: `linear_scan` forward,
    keeping a, h0 and its output y, and `linear_scan_bwd` backward.
    `LinearScan.apply(a, x, h0)` -> (y, h_last)."""

    @staticmethod
    def forward(ctx, a, x, h0):
        y, h_last = linear_scan(a, x, h0)
        ctx.save_for_backward(a, y, h0)
        ctx.set_materialize_grads(False)    # an unused h_last: no zeros
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        a, y, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(a)
        grads = linear_scan_bwd(
            a, y, h0, dy.contiguous(),
            None if dh_last is None else dh_last.contiguous())
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))
