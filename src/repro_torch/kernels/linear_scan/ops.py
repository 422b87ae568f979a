"""The RG-LRU's linear recurrence `h_t = a_t * h_{t-1} + x_t`: the CUDA
kernel `csrc/linear_scan.cu` and its plain PyTorch version.

`linear_scan` takes the plain version for tensors on the CPU and launches
the kernel for tensors on the card; it never falls back."""

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
