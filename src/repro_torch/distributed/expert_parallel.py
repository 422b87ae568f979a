"""Explicit expert-parallel (EP) MoE dispatch over torch.distributed: the
Switch/GShard pattern, one all-to-all each way.

Layout (the ranks form a data x model grid; `shard_moe_params` cuts a
layer's params to one rank's slice):
    tokens  x2d [T, d]        T split over the data ranks
    experts                   E split over the data ranks
    expert weights [E, d, F]  E over data, F over model
    router [d, E]             replicated

On each rank:
    1. route locally (top-k over all E experts);
    2. pack a send buffer [n_data, E_local, C_src, d] (slot by arrival
       rank; a per-source quota C_src bounds the worst-case skew);
    3. all-to-all over the data group -> the same shape received;
    4. the local experts' FFN over [E_local, n_data * C_src, d]: the fused
       expert kernel K1 (`kernels.moe_gmm_fused`) on the card, its plain
       version on the CPU; F split over the model group, the partial
       down products summed by an all-reduce there;
    5. all-to-all back, then the routing-weighted combine.

Collective volume per layer: 2 x T*k*cf*d elements spread over the data
group. Forward only: the collectives carry no gradient, so a call that
would need one raises."""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels import moe_gmm_fused
from repro_torch.kernels.moe_gmm.quant import dequantize_int8
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import apply_mlp

_EXPERT_KEYS = ("w_gate", "w_up", "w_down")


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
    Returns [e_loc, C, d] from K1 (`moe_gmm_fused`), every slot at its
    full C rows: an empty slot is a zero row, whose output is zero. An
    expert whose rows are all zero gets count 0, so its weights are not
    read. Int8 experts are dequantized to a view of xs's type first."""
    e_loc, c, _ = xs.shape
    if "w_up_q8" in p:
        p = {n: dequantize_int8(p[n + "_q8"], p[n + "_s"]).to(xs.dtype)
             for n in _EXPERT_KEYS if n + "_q8" in p}
    swiglu = "w_gate" in p and cfg.activation == "swiglu"
    live = xs.ne(0).flatten(1).any(1)
    counts = torch.where(live, c, 0).to(torch.int32)
    return moe_gmm_fused(xs, p["w_gate"] if swiglu else None, p["w_up"],
                         p["w_down"], counts,
                         activation="swiglu" if swiglu else "gelu")


def _gather_rows(t, group, n: int):
    """The data group's `t`s concatenated along dim 0, in rank order."""
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def _needs_grad(p, x) -> bool:
    if not torch.is_grad_enabled():
        return False
    leaves = [x] + [v for v in p.values() if torch.is_tensor(v)]
    return any(t.requires_grad for t in leaves)


def shard_moe_params(cfg, p, data_rank: int, n_data: int,
                     model_rank: int = 0, n_model: int = 1) -> dict:
    """One rank's slice of a layer's MoE params `p`: the routed experts cut
    over the data ranks (E), their F axis and the shared experts' cut over
    the model ranks, the router whole. Int8 experts keep their
    per-expert scales beside their rows."""
    e, f = cfg.num_experts, cfg.moe_d_ff
    if e % n_data or f % n_model:
        raise ValueError(f"{e} experts over {n_data} data ranks or F={f} "
                         f"over {n_model} model ranks does not divide")
    e_loc, f_loc = e // n_data, f // n_model
    es = slice(data_rank * e_loc, (data_rank + 1) * e_loc)
    fs = slice(model_rank * f_loc, (model_rank + 1) * f_loc)
    out = {"router": p["router"]}
    for n in _EXPERT_KEYS:
        for key in (n, n + "_q8"):
            if key in p:
                w = p[key][es]
                out[key] = (w[:, fs] if n == "w_down" else w[:, :, fs])
        if n + "_s" in p:
            out[n + "_s"] = p[n + "_s"][es]
    if "shared" in p:
        sf = p["shared"]["w_down"].shape[0] // n_model
        ss = slice(model_rank * sf, (model_rank + 1) * sf)
        out["shared"] = {n: (w[ss] if n == "w_down" else w[:, ss])
                         for n, w in p["shared"].items()}
    return {k: v.contiguous() if torch.is_tensor(v) else v
            for k, v in out.items()}


def make_expert_parallel_moe(cfg, data_group, model_group=None, *,
                             capacity_factor: float = 2.0):
    """Returns apply(p, x_loc) -> (y_loc, aux) with the semantics of
    `models.moe.apply_moe` (but for tokens dropped at a quota boundary).
    Each rank of `data_group` passes the same number of its own tokens
    x_loc [T_loc, d] and its slice `p` of the layer's params
    (`shard_moe_params`); `model_group` (None: one rank) holds the ranks
    that split F for the same experts and tokens. aux: `lb_loss` the mean
    of the data ranks' local losses; `unique_experts` and `dropped`
    per source rank [n_data]; `expert_idx` the gathered global routing
    [n_data * T_loc, k]. Forward only: a call that would need a gradient
    raises NotImplementedError."""
    n_data = dist.get_world_size(data_group)
    n_model = 1 if model_group is None else dist.get_world_size(model_group)
    if cfg.num_experts % n_data:
        raise ValueError(f"{cfg.num_experts} experts do not divide over "
                         f"{n_data} data ranks")
    e_loc = cfg.num_experts // n_data

    def apply(p, x_loc):
        if _needs_grad(p, x_loc):
            raise NotImplementedError(
                "the expert-parallel dispatch is forward only: its "
                "collectives carry no gradient (training through it is "
                "ROADMAP queue 1, item 11)")
        t_loc, d = x_loc.shape
        k, e = cfg.experts_per_token, cfg.num_experts
        c_src = max(int(t_loc * k * capacity_factor) // e + 1, 1)

        weights, idx, probs = moe_mod.route(cfg, p, x_loc)
        send, (dst, e_within, slot_c, keep) = _local_pack(
            cfg, x_loc, idx, n_data, c_src)

        # one all-to-all each way over the data group
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=data_group)
        # recv: [n_src, e_loc, c_src, d] -> grouped per local expert
        xs = recv.transpose(0, 1).reshape(e_loc, n_data * c_src, d)
        out = _expert_ffn(cfg, p, xs)                   # [e_loc, C, d]
        if n_model > 1:
            dist.all_reduce(out, group=model_group)     # F-split down product

        back = out.reshape(e_loc, n_data, c_src, d).transpose(0, 1)
        ret = torch.empty_like(send)
        dist.all_to_all_single(ret, back.contiguous(), group=data_group)
        # ret: [n_dst, e_loc, c_src, d], the layout of `send`
        pad = torch.zeros((n_data, e_loc, 1, d), dtype=ret.dtype,
                          device=ret.device)
        ret = torch.cat([ret, pad], dim=2)
        y_rep = ret[dst, e_within, slot_c]              # [T_loc*k, d]
        w_flat = (weights.reshape(-1) * keep).to(y_rep.dtype)
        y = (y_rep * w_flat[:, None]).reshape(t_loc, k, d).sum(1)

        if cfg.num_shared_experts:
            # the shared experts' F is split over the model group
            sh = apply_mlp(cfg, p["shared"], x_loc)
            if n_model > 1:
                dist.all_reduce(sh, group=model_group)
            y = y + sh

        lb = moe_mod.load_balance_loss(cfg, probs, idx).reshape(1)
        dist.all_reduce(lb, group=data_group)
        src = torch.stack([moe_mod.unique_expert_count(cfg, idx),
                           (~keep).sum().to(torch.int32)])
        src = _gather_rows(src[None], data_group, n_data)   # [n_data, 2]
        aux = {"lb_loss": lb[0] / n_data,
               "unique_experts": src[:, 0],
               "dropped": src[:, 1],
               "expert_idx": _gather_rows(idx, data_group, n_data)}
        return y, aux

    return apply
