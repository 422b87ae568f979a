"""Explicit expert-parallel (EP) MoE dispatch over torch.distributed: the
Switch/GShard pattern, one all-to-all each way, forward and backward.

Layout (the ranks form a data x model grid; `shard_moe_params` cuts a
layer's params to one rank's slice, `shard_params` a whole model's):
    tokens  x2d [T, d]        T split over the data ranks
    experts                   E split over the data ranks
    expert weights [E, d, F]  E over data, F over model
    shared experts [d, F_s]   F_s over model
    router [d, E]             replicated

On each rank:
    1. route locally (top-k over all E experts);
    2. pack a send buffer [n_data, E_local, C_src, d] (slot by arrival
       rank; a per-source quota C_src bounds the worst-case skew);
    3. all-to-all over the data group -> the same shape received;
    4. the local experts' FFN over [E_local, n_data * C_src, d]: without
       a gradient the fused expert kernel K1 (`kernels.moe_gmm_fused`),
       with one the dense training branch's three grouped products
       (`models.moe._grouped_ffn`: K5 forward and input gradient); F split
       over the model group, the partial down products summed there;
    5. all-to-all back, then the routing-weighted combine.

Collective volume per layer: 2 x T*k*cf*d elements spread over the data
group, the same again in the backward.

Gradients. The collectives are `torch.autograd.Function`s: an all-to-all
with equal splits is its own transpose, so its backward sends the
gradient back the same way; over the model group an input that every
model rank holds whole (the receive buffer, the tokens before the shared
experts) meets a weight cut in F through `_ModelCopy` (identity forward,
the gradient summed backward), and the partial products are summed by
`_ModelSum` (summed forward, identity backward). Each rank differentiates
its own share of the loss; `reduce_gradients` then sums over the data
group the gradients of the leaves the data ranks all hold (everything but
the routed experts, whose gradients are complete on their rank)."""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels import moe_gmm_fused
from repro_torch.kernels.moe_gmm.quant import dequantize_int8
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import apply_mlp

_EXPERT_KEYS = ("w_gate", "w_up", "w_down")


# --------------------------------------------------------------------- #
# Collectives that carry gradients
# --------------------------------------------------------------------- #

class _AllToAll(torch.autograd.Function):
    """`all_to_all_single` over `group`, equal splits along dim 0. The
    exchange is its own transpose: the backward applies it to the
    gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x, group):
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _ModelCopy(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group backward:
    where an input every model rank holds whole meets a weight cut in F,
    each rank's gradient is one F slice's part."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ModelSum(torch.autograd.Function):
    """The partial products of the F slices summed over the model group
    forward; identity backward: every model rank then holds the same
    output and the same gradient of it."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


# --------------------------------------------------------------------- #
# The dispatch
# --------------------------------------------------------------------- #

def _local_pack(cfg, x_loc, idx, n_data: int, c_src: int):
    """Build the send buffer on one rank.

    x_loc: [T_loc, d]; idx: [T_loc, k] routed expert ids.
    Returns (send, (dst, e_within, slot_c, keep)) where
      send     [n_data, e_loc, c_src, d]: token inputs slotted by
               (destination rank, local expert, arrival rank), spilled
               entries dropped, empty slots zero;
      dst      [T_loc*k] destination rank of each (token, choice);
      e_within [T_loc*k] expert index within its rank;
      slot_c   [T_loc*k] capacity-clamped slot (== c_src for spilled);
      keep     [T_loc*k] bool, False where the (token, choice) overflowed
               its per-source quota and was dropped from the send buffer.
    The combine gathers with (dst, e_within, slot_c) and zeroes dropped
    choices by `keep`; the routing weights are applied there."""
    t_loc, d = x_loc.shape
    k, e = cfg.experts_per_token, cfg.num_experts
    e_loc = e // n_data
    dev = x_loc.device

    flat_e = idx.reshape(-1).long()                 # [T_loc*k]
    dst = flat_e // e_loc
    e_within = flat_e % e_loc
    onehot = torch.zeros((flat_e.numel(), e), dtype=torch.int32, device=dev)
    onehot.scatter_(1, flat_e[:, None], 1)
    slot = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    keep = slot < c_src
    slot_c = torch.where(keep, slot, c_src)         # spill row

    x_rep = torch.repeat_interleave(x_loc, k, dim=0)
    send = torch.zeros((n_data, e_loc, c_src + 1, d), dtype=x_loc.dtype,
                       device=dev)
    send[dst, e_within, slot_c] = x_rep
    return send[:, :, :c_src].contiguous(), (dst, e_within, slot_c, keep)


def _expert_ffn(cfg, p, xs):
    """xs: [e_loc, C, d], the receive buffer grouped by local expert; p:
    this rank's expert weights (F already cut over the model group).
    Returns [e_loc, C, d]. An empty slot is a zero row: its output and its
    share of a weight gradient are zero.

    Every live expert runs at its full C rows, an expert whose rows are
    all zero at count 0 (its weights are not read): each source block of
    the buffer is live only at its head, so no shorter count covers it.
    Without a gradient the rows go through K1 (`moe_gmm_fused`), with one
    through `models.moe._grouped_ffn` (K5 forward and input gradient).
    Int8 experts are dequantized to a view of xs's type first."""
    e_loc, c, _ = xs.shape
    if "w_up_q8" in p:
        p = {n: dequantize_int8(p[n + "_q8"], p[n + "_s"]).to(xs.dtype)
             for n in _EXPERT_KEYS if n + "_q8" in p}
    swiglu = "w_gate" in p and cfg.activation == "swiglu"
    grad = torch.is_grad_enabled() and (
        xs.requires_grad or any(p[n].requires_grad for n in _EXPERT_KEYS
                                if n in p))
    live = xs.ne(0).flatten(1).any(1)
    counts = torch.where(live, c, 0).to(torch.int32)
    if grad:
        return moe_mod._grouped_ffn(p, xs, counts, swiglu)
    return moe_gmm_fused(xs, p["w_gate"] if swiglu else None, p["w_up"],
                         p["w_down"], counts,
                         activation="swiglu" if swiglu else "gelu")


def _gather(t, group, n: int, dim: int = 0):
    """The `n` ranks of `group`'s `t`s concatenated along `dim`, in rank
    order."""
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _ExpertParallelMoe:
    """apply(p, x_loc) -> (y_loc, aux) with the semantics of
    `models.moe.apply_moe` (but for tokens dropped at a quota boundary).
    Each rank of `data_group` passes the same number of its own tokens
    x_loc [T_loc, d] and its slice `p` of the layer's params
    (`shard_moe_params`); `model_group` (None: one rank) holds the ranks
    that split F for the same experts and tokens. aux: `lb_loss` the mean
    of the data ranks' local losses (detached: a reported value);
    `lb_loss_local` this rank's own, which carries the gradient;
    `unique_experts` and `dropped` per source rank [n_data]; `expert_idx`
    the gathered global routing [n_data * T_loc, k]. Differentiable: see
    the module's docstring."""

    def __init__(self, cfg, data_group, model_group=None, *,
                 capacity_factor: float = 2.0):
        self.cfg, self.capacity_factor = cfg, capacity_factor
        self.data_group, self.model_group = data_group, model_group
        self.n_data = dist.get_world_size(data_group)
        self.data_rank = dist.get_rank(data_group)
        self.n_model = (1 if model_group is None
                        else dist.get_world_size(model_group))
        self.model_rank = 0 if model_group is None else dist.get_rank(
            model_group)
        if cfg.num_experts % self.n_data:
            raise ValueError(f"{cfg.num_experts} experts do not divide over "
                             f"{self.n_data} data ranks")

    @property
    def ranks(self) -> tuple:
        """(data_rank, n_data, model_rank, n_model), as `shard_params`
        takes them."""
        return self.data_rank, self.n_data, self.model_rank, self.n_model

    def __call__(self, p, x_loc):
        cfg, n_data = self.cfg, self.n_data
        mg = self.model_group if self.n_model > 1 else None
        t_loc, d = x_loc.shape
        k, e = cfg.experts_per_token, cfg.num_experts
        e_loc = e // n_data
        c_src = max(int(t_loc * k * self.capacity_factor) // e + 1, 1)

        weights, idx, probs = moe_mod.route(cfg, p, x_loc)
        send, (dst, e_within, slot_c, keep) = _local_pack(
            cfg, x_loc, idx, n_data, c_src)

        # one all-to-all each way over the data group
        recv = _AllToAll.apply(send, self.data_group)
        # recv: [n_src, e_loc, c_src, d] -> grouped per local expert
        xs = recv.transpose(0, 1).reshape(e_loc, n_data * c_src, d)
        if mg is not None:
            xs = _ModelCopy.apply(xs, mg)
        out = _expert_ffn(cfg, p, xs)                   # [e_loc, C, d]
        if mg is not None:
            out = _ModelSum.apply(out, mg)              # F-split down product

        back = out.reshape(e_loc, n_data, c_src, d).transpose(0, 1)
        ret = _AllToAll.apply(back, self.data_group)
        # ret: [n_dst, e_loc, c_src, d], the layout of `send`
        pad = torch.zeros((n_data, e_loc, 1, d), dtype=ret.dtype,
                          device=ret.device)
        ret = torch.cat([ret, pad], dim=2)
        y_rep = ret[dst, e_within, slot_c]              # [T_loc*k, d]
        w_flat = (weights.reshape(-1) * keep).to(y_rep.dtype)
        y = (y_rep * w_flat[:, None]).reshape(t_loc, k, d).sum(1)

        if cfg.num_shared_experts:
            # the shared experts' F is split over the model group
            x_sh = x_loc if mg is None else _ModelCopy.apply(x_loc, mg)
            sh = apply_mlp(cfg, p["shared"], x_sh)
            y = y + (sh if mg is None else _ModelSum.apply(sh, mg))

        lb_local = moe_mod.load_balance_loss(cfg, probs, idx)
        lb = lb_local.detach().reshape(1).clone()
        dist.all_reduce(lb, group=self.data_group)
        src = torch.stack([moe_mod.unique_expert_count(cfg, idx),
                           (~keep).sum().to(torch.int32)])
        src = _gather(src[None], self.data_group, n_data)  # [n_data, 2]
        aux = {"lb_loss": lb[0] / n_data,
               "lb_loss_local": lb_local,
               "unique_experts": src[:, 0],
               "dropped": src[:, 1],
               "expert_idx": _gather(idx, self.data_group, n_data)}
        return y, aux


def make_expert_parallel_moe(cfg, data_group, model_group=None, *,
                             capacity_factor: float = 2.0
                             ) -> _ExpertParallelMoe:
    """The dispatch of one configuration over these groups, for
    `models.moe.apply_moe(ep=)` and the model's entry points
    (`train_forward(ep=)`, `prefill(ep=)`, `training.make_train_step(ep=)`):
    a callable (p, x_loc) -> (y_loc, aux), see `_ExpertParallelMoe`."""
    return _ExpertParallelMoe(cfg, data_group, model_group,
                              capacity_factor=capacity_factor)


# --------------------------------------------------------------------- #
# Params cut per rank
# --------------------------------------------------------------------- #

def _routed_cuts(key: str) -> tuple:
    """(dim from the end, axis) pairs along which the ranks cut a leaf of
    a layer's (or a stack's) MoE dict: the routed experts' E over the
    data ranks and F over the model ranks, their int8 scales' E; () for
    the router."""
    if key.endswith("_s"):
        return ((-1, "data"),)
    if key.startswith("w_"):
        return ((-3, "data"), (-2 if key.startswith("w_down") else -1,
                               "model"))
    return ()


def _moe_map(fn, p) -> dict:
    """fn(leaf, cuts) over a MoE dict's leaves; the shared experts' F is
    cut over the model ranks."""
    out = {}
    for key, v in p.items():
        if key == "shared":
            out[key] = {n: fn(w, ((-2 if n == "w_down" else -1, "model"),))
                        for n, w in v.items()}
        else:
            out[key] = fn(v, _routed_cuts(key))
    return out


def _tree_map_cuts(fn, tree):
    """fn(leaf, cuts) over a whole params tree: every dict under a "moe"
    key (a stack's [L, ...] leaves or one layer's) through `_moe_map`,
    every other leaf whole (cuts ())."""
    if isinstance(tree, dict):
        return {k: (_moe_map(fn, v) if k == "moe" else _tree_map_cuts(fn, v))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map_cuts(fn, v) for v in tree)
    return fn(tree, ())


def _slicer(cfg, data_rank, n_data, model_rank, n_model):
    """cut(leaf, cuts): one rank's slice of a leaf along its cuts."""
    e, f = cfg.num_experts, cfg.moe_d_ff
    if e % n_data or f % n_model:
        raise ValueError(f"{e} experts over {n_data} data ranks or F={f} "
                         f"over {n_model} model ranks does not divide")
    ranks = {"data": (data_rank, n_data), "model": (model_rank, n_model)}

    def cut(t, cuts):
        for dim, axis in cuts:
            rank, n = ranks[axis]
            if t.shape[dim] % n:
                raise ValueError(f"a dim of {t.shape[dim]} does not divide "
                                 f"over {n} {axis} ranks")
            step = t.shape[dim] // n
            t = t.narrow(dim, rank * step, step)
        return t.contiguous()
    return cut


def shard_moe_params(cfg, p, data_rank: int, n_data: int,
                     model_rank: int = 0, n_model: int = 1) -> dict:
    """One rank's slice of a layer's MoE params `p`: the routed experts cut
    over the data ranks (E), their F axis and the shared experts' cut over
    the model ranks, the router whole. Int8 experts keep their
    per-expert scales beside their rows."""
    return _moe_map(_slicer(cfg, data_rank, n_data, model_rank, n_model), p)


def shard_params(cfg, params, data_rank: int, n_data: int,
                 model_rank: int = 0, n_model: int = 1):
    """One rank's slice of a whole model's params: every MoE dict (the
    stacked [L, E, ...] experts, or a pattern stack's per-layer ones) cut
    as `shard_moe_params` cuts a layer's; every other leaf whole, the same
    tensor."""
    cut = _slicer(cfg, data_rank, n_data, model_rank, n_model)
    return _tree_map_cuts(lambda t, cuts: cut(t, cuts) if cuts else t,
                          params)


def gather_params(tree, ep: _ExpertParallelMoe):
    """The inverse of `shard_params` (say, of a gradient tree after
    `reduce_gradients`): each cut leaf all-gathered over its ranks and
    concatenated in rank order, on every rank; whole leaves as they are."""
    groups = {"data": (ep.data_group, ep.n_data),
              "model": (ep.model_group, ep.n_model)}

    def gather(t, cuts):
        for dim, axis in cuts:
            group, n = groups[axis]
            if n > 1:
                t = _gather(t, group, n, dim)
        return t
    return _tree_map_cuts(gather, tree)


def param_cuts(params, ep: _ExpertParallelMoe):
    """For each leaf of a rank's params tree, {dim: process group} of the
    dims that ranks of that group hold slices of (groups of more than one
    rank only; {} for a leaf every rank holds whole): what a reduction over
    the whole leaf (the clip's norm, Adafactor's statistics) must also sum
    over."""
    groups = {"data": ep.data_group if ep.n_data > 1 else None,
              "model": ep.model_group if ep.n_model > 1 else None}
    return _tree_map_cuts(
        lambda t, cuts: {t.dim() + dim: groups[axis] for dim, axis in cuts
                         if groups[axis] is not None}, params)


def reduce_gradients(grads, ep: _ExpertParallelMoe):
    """Sum over the data group, in place, the gradient of every leaf the
    data ranks all hold (everything but the routed experts): each data
    rank's gradient is that of its own share of the loss. The model ranks
    of one data row differentiate the same share, so nothing is summed
    over them. Returns `grads`."""
    if ep.n_data > 1:
        def reduce(g, cuts):
            if not any(axis == "data" for _, axis in cuts):
                dist.all_reduce(g, group=ep.data_group)
            return g
        _tree_map_cuts(reduce, grads)
    return grads
