"""MoE expert products: the fused expert FFN over a slot layout, CUDA
kernels `csrc/moe_gmm.cu` (bf16/float32 weights) and `csrc/moe_gmm_quant.cu`
(int8 weights with per-expert scales), and the grouped matmul of the dense
capacity dispatch, `csrc/moe_gmm_grouped.cu`, with `MoeGmm`, its autograd
function for the training path; each kernel with its plain PyTorch
version.

The wrappers (`moe_gmm_fused`, `moe_gmm_fused_quant`, `moe_gmm`) take the
plain version for tensors on the CPU and launch their kernel for tensors
on the card; they never fall back."""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _lib

from .quant import dequantize_int8

_NAME = "moe_gmm"
_QNAME = "moe_gmm_quant"
_GNAME = "moe_gmm_grouped"
ACTIVATIONS = ("swiglu", "gelu")


def _ffn_plain(x, counts, expert_ids, activation, weight):
    """The plain expert FFN of both kernels. `weight(name, rows)` gives the
    float32 weight `name` ("gate", "up" or "down") of the experts `rows`."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    u, c, d = x.shape
    y = torch.zeros((u, c, d), dtype=torch.float32, device=x.device)
    live = torch.nonzero(counts > 0).flatten()
    if live.numel():
        rows = live if expert_ids is None else expert_ids[live].long()
        xf = x[live].float()
        up = torch.einsum("ucd,udf->ucf", xf, weight("up", rows))
        if activation == "swiglu":
            gate = torch.einsum("ucd,udf->ucf", xf, weight("gate", rows))
            h = F.silu(gate) * up
        else:
            h = F.gelu(up, approximate="tanh")
        yl = torch.einsum("ucf,ufd->ucd", h, weight("down", rows))
        keep = (torch.arange(c, device=x.device)[None, :]
                < counts[live][:, None])
        y[live] = torch.where(keep[..., None], yl, 0.0)
    return y.to(x.dtype)


def _check_args(name, x, wg, wu, wd, counts, expert_ids, swiglu, multiple):
    """Refuse what both kernels cannot take: tensors off the card, x not
    float32/bfloat16 [U,C,d], weights not [E,d,F]/[E,F,d], counts and
    expert_ids not int32 [U], d or F not a multiple of `multiple`. Returns
    (U, C, d, E, F)."""
    weights = (wg, wu, wd) if swiglu else (wu, wd)
    ints = (counts,) if expert_ids is None else (counts, expert_ids)
    _lib.require_cuda(name, x, *weights, *ints)
    if x.dtype not in _lib.DTYPE_CODES:
        raise ValueError(f"{name}: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    if any(t.dtype != torch.int32 for t in ints):
        raise ValueError(f"{name}: counts and expert_ids must be int32")
    if x.dim() != 3:
        raise ValueError(f"{name}: x [U,C,d] expected, got {tuple(x.shape)}")
    u, c, d = x.shape
    e, f = wu.shape[0], wu.shape[2]
    if (tuple(wu.shape) != (e, d, f) or tuple(wd.shape) != (e, f, d)
            or (swiglu and tuple(wg.shape) != (e, d, f))):
        raise ValueError(f"{name}: weights do not match x {tuple(x.shape)}: "
                         f"wu {tuple(wu.shape)}, wd {tuple(wd.shape)}")
    if tuple(counts.shape) != (u,) or (expert_ids is None and e != u) or (
            expert_ids is not None and tuple(expert_ids.shape) != (u,)):
        raise ValueError(f"{name}: counts/expert_ids must be [U={u}] "
                         f"(and E == U without expert_ids), E={e}")
    if d % multiple or f % multiple:
        raise ValueError(f"{name}: d={d} and F={f} must be multiples of "
                         f"{multiple}")
    return u, c, d, e, f


def moe_gmm_fused_plain(x, wg, wu, wd, counts, *, activation: str = "swiglu",
                        expert_ids=None):
    """x: [U,C,d]; wg, wu: [E,d,F]; wd: [E,F,d]; counts: [U] int32 live rows
    per slot; expert_ids: [U] int32 weight row of each slot, or None for
    E == U and slot u on expert u. Returns [U,C,d] in x.dtype: the swiglu
    (or tanh-gelu) FFN in float32 for rows below counts[u], exact zeros for
    the other rows and for slots with counts[u] == 0."""
    w = {"gate": wg, "up": wu, "down": wd}
    return _ffn_plain(x, counts, expert_ids, activation,
                      lambda name, rows: w[name][rows].float())


def _h_scratch(route: str, u: int, c: int, f: int, device):
    """The gate/up pass's output h of both fused kernels: float32 [U,C,F]
    on the CUDA cores; on wgmma, h at float32 precision as the two bf16
    planes hi = bf16(h) and lo = bf16(h - hi) (the down product's
    tensor-core operands), [2,U,C,F], the same bytes."""
    if route == "wgmma":
        return torch.empty((2, u, c, f), dtype=torch.bfloat16, device=device)
    return torch.empty((u, c, f), dtype=torch.float32, device=device)


def fused_route(dtype: torch.dtype, d: int, f: int) -> str:
    """`moe_gmm_fused`'s route for a dtype and widths d and F, as the C
    launcher chooses it: bf16 on wgmma fed by TMA where d and F are
    multiples of 8 (TMA needs 16-byte row pitches), with token tiles of 8
    rows (C <= 8), 16 (C <= 16) or 128, at every C (it beat the CUDA cores
    at every span shape measured: PERF.md); float32, and bf16 at other
    widths, on the CUDA cores. Never U or expert_ids: a slot computes the
    same bits in the dense and the packed layouts."""
    if dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0:
        return "wgmma"
    return "simt"


_FARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
              + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])


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
    u, c, d, e, f = _check_args(_NAME, x, wg, wu, wd, counts, expert_ids,
                                swiglu, 2)
    weights = (wg, wu, wd) if swiglu else (wu, wd)
    if any(w.dtype != x.dtype for w in weights):
        raise ValueError(f"{_NAME}: x and weights must share float32 or "
                         f"bfloat16, got {x.dtype} and "
                         f"{[w.dtype for w in weights]}")
    route = fused_route(x.dtype, d, f)
    h = _h_scratch(route, u, c, f, x.device)
    y = torch.empty_like(x)
    taken = ctypes.c_int(-1)
    err = _lib.function(_NAME, "moe_gmm_fused", _FARGTYPES)(
        x.data_ptr(), wg.data_ptr() if swiglu else None, wu.data_ptr(),
        wd.data_ptr(), counts.data_ptr(),
        None if expert_ids is None else expert_ids.data_ptr(), h.data_ptr(),
        y.data_ptr(), u, c, d, f, e, int(swiglu), _lib.DTYPE_CODES[x.dtype],
        _lib.stream_ptr(x), ctypes.byref(taken))
    _lib.check(_NAME, err)
    _lib.count_route(moe_gmm_fused, _NAME, taken.value, route)
    return y


moe_gmm_fused.launches = 0
moe_gmm_fused.launches_by_route = {"wgmma": 0, "simt": 0}


def moe_gmm_fused_quant_plain(x, wg, wu, wd, s_gate, s_up, s_down, counts, *,
                              activation: str = "swiglu", expert_ids=None):
    """`moe_gmm_fused_plain` over int8 weights: wg, wu: int8 [E,d,F]; wd:
    int8 [E,F,d]; s_gate, s_up, s_down: float32 [E] per-expert scales,
    indexed by expert like the weights (wg and s_gate are unused for
    gelu). The live slots' weights are dequantized to float32 (q8 * scale)
    and the FFN runs in float32 for rows below counts[u]; other rows and
    dead slots are exact zeros. Returns [U,C,d] in x.dtype."""
    w = {"gate": (wg, s_gate), "up": (wu, s_up), "down": (wd, s_down)}

    def weight(name, rows):
        q, scale = w[name]
        return dequantize_int8(q[rows], scale[rows])

    return _ffn_plain(x, counts, expert_ids, activation, weight)


def quant_route(dtype: torch.dtype, d: int, f: int, c: int) -> str:
    """`moe_gmm_fused_quant`'s route for a dtype, widths d and F and C rows
    a slot, as the C launcher chooses it: bf16 (d and F multiples of 16,
    as the wrapper requires on the card) with C > 1 on wgmma, the int8
    weight tiles fed by TMA and dequantized into the A fragments, with
    token tiles of 8, 16, 32 or 128 rows by C; float32, and bf16 at C = 1
    (a one-token pass: its two live experts give too few CTAs to keep the
    TMA ring fed, and the CUDA cores were faster there: PERF.md), on the
    CUDA cores. Never U or expert_ids: a slot computes the same bits in the
    dense and the packed layouts."""
    if dtype == torch.bfloat16 and d % 16 == 0 and f % 16 == 0 and c > 1:
        return "wgmma"
    return "simt"


_QARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
              + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])


def moe_gmm_fused_quant(x, wg, wu, wd, s_gate, s_up, s_down, counts, *,
                        activation: str = "swiglu", expert_ids=None):
    """Fused expert FFN over int8 weights; see `moe_gmm_fused_quant_plain`
    for the contract. On the card d and F must be multiples of 16."""
    if x.device.type == "cpu":
        return moe_gmm_fused_quant_plain(
            x, wg, wu, wd, s_gate, s_up, s_down, counts,
            activation=activation, expert_ids=expert_ids)
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    swiglu = activation == "swiglu"
    u, c, d, e, f = _check_args(_QNAME, x, wg, wu, wd, counts, expert_ids,
                                swiglu, 16)
    weights = (wg, wu, wd) if swiglu else (wu, wd)
    scales = (s_gate, s_up, s_down) if swiglu else (s_up, s_down)
    if any(w.dtype != torch.int8 for w in weights):
        raise ValueError(f"{_QNAME}: weights must be int8, got "
                         f"{[w.dtype for w in weights]}")
    if any(s.device != x.device or s.dtype != torch.float32
           or tuple(s.shape) != (e,) or not s.is_contiguous()
           for s in scales):
        raise ValueError(f"{_QNAME}: scales must be contiguous float32 "
                         f"[E={e}] on {x.device}")
    route = quant_route(x.dtype, d, f, c)
    h = _h_scratch(route, u, c, f, x.device)
    y = torch.empty_like(x)
    taken = ctypes.c_int(-1)
    err = _lib.function(_QNAME, "moe_gmm_fused_quant", _QARGTYPES)(
        x.data_ptr(), wg.data_ptr() if swiglu else None, wu.data_ptr(),
        wd.data_ptr(), s_gate.data_ptr() if swiglu else None,
        s_up.data_ptr(), s_down.data_ptr(), counts.data_ptr(),
        None if expert_ids is None else expert_ids.data_ptr(), h.data_ptr(),
        y.data_ptr(), u, c, d, f, e, int(swiglu), _lib.DTYPE_CODES[x.dtype],
        _lib.stream_ptr(x), ctypes.byref(taken))
    _lib.check(_QNAME, err)
    _lib.count_route(moe_gmm_fused_quant, _QNAME, taken.value, route)
    return y


moe_gmm_fused_quant.launches = 0
moe_gmm_fused_quant.launches_by_route = {"wgmma": 0, "simt": 0}


def moe_gmm_plain(x, w, counts, *, transpose_w: bool = False):
    """x: [E,C,d]; w: [E,d,F], or [E,F,d] read transposed when
    transpose_w; counts: [E] int32 live rows per expert. Returns
    y[e] = x[e] @ w[e] (x[e] @ w[e]^T) as [E,C,F] in x.dtype, summed in
    float32 (float64 kept), with rows c >= counts[e] exactly zero."""
    acc = torch.promote_types(x.dtype, torch.float32)
    wf = w.to(acc)
    y = torch.bmm(x.to(acc), wf.transpose(1, 2) if transpose_w else wf)
    keep = (torch.arange(x.shape[1], device=x.device)[None, :]
            < counts[:, None])
    return torch.where(keep[..., None], y, 0.0).to(x.dtype)


def route(dtype: torch.dtype, d: int, f: int) -> str:
    """`moe_gmm`'s route for a dtype and inner and output widths d and F,
    as the C launcher chooses it: float32 on the CUDA cores; bf16 on wgmma
    fed by TMA where d and F are multiples of 8 (TMA needs 16-byte row
    pitches), else on WMMA."""
    if dtype != torch.bfloat16:
        return "simt"
    return "wgmma" if d % 8 == 0 and f % 8 == 0 else "wmma"


_GARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
              + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])


def moe_gmm(x, w, counts, *, transpose_w: bool = False):
    """Grouped expert matmul over the dense capacity dispatch; see
    `moe_gmm_plain` for the contract. Any C, d and F."""
    if x.device.type == "cpu":
        return moe_gmm_plain(x, w, counts, transpose_w=transpose_w)
    _lib.require_cuda(_GNAME, x, w, counts)
    if x.dtype not in _lib.DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"{_GNAME}: x and w must share float32 or "
                         f"bfloat16, got {x.dtype} and {w.dtype}")
    if counts.dtype != torch.int32:
        raise ValueError(f"{_GNAME}: counts must be int32, got "
                         f"{counts.dtype}")
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"{_GNAME}: x [E,C,d] and w [E,d,F] expected, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    e, c, d = x.shape
    f = w.shape[1] if transpose_w else w.shape[2]
    if w.shape[0] != e or w.shape[2 if transpose_w else 1] != d or (
            tuple(counts.shape) != (e,)):
        raise ValueError(f"{_GNAME}: x {tuple(x.shape)}, w {tuple(w.shape)}"
                         f" (transpose_w={transpose_w}) and counts "
                         f"{tuple(counts.shape)} do not match")
    y = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    taken = ctypes.c_int(-1)
    err = _lib.function(_GNAME, "moe_gmm_grouped", _GARGTYPES)(
        x.data_ptr(), w.data_ptr(), counts.data_ptr(), y.data_ptr(), e, c,
        d, f, int(transpose_w), _lib.DTYPE_CODES[x.dtype],
        _lib.stream_ptr(x), ctypes.byref(taken))
    _lib.check(_GNAME, err)
    _lib.count_route(moe_gmm, _GNAME, taken.value, route(x.dtype, d, f))
    return y


moe_gmm.launches = 0
moe_gmm.launches_by_route = {"wgmma": 0, "wmma": 0, "simt": 0}


class MoeGmm(torch.autograd.Function):
    """`moe_gmm` with gradients, for the training path:
    y = moe_gmm(x, w, counts); dx = moe_gmm(dy, w, counts,
    transpose_w=True), the same kernel; dw = `grouped_weight_grad`, by
    `torch.bmm` over dy with rows at or past counts[e] zeroed (the
    forward's mask). `MoeGmm.apply(x, w, counts)`."""

    @staticmethod
    def forward(ctx, x, w, counts):
        ctx.save_for_backward(x, w, counts)
        return moe_gmm(x, w, counts)

    @staticmethod
    def backward(ctx, dy):
        x, w, counts = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = moe_gmm(dy, w, counts, transpose_w=True)
        if ctx.needs_input_grad[1]:
            dw = grouped_weight_grad(x, dy, counts)
        return dx, dw, None


def grouped_weight_grad(x, dy, counts):
    """dw[e] = x[e]^T @ dy[e] over the rows below counts[e]: `torch.bmm`,
    a library product (the JAX package differentiates its einsums outside
    any Pallas kernel; a hand-written one is queued in ROADMAP queue 2)."""
    keep = (torch.arange(dy.shape[1], device=dy.device)[None, :]
            < counts[:, None])
    return torch.bmm(x.transpose(1, 2), torch.where(keep[..., None], dy, 0.0))
