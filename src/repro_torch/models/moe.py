"""Mixture-of-Experts layer: top-k router (+optional shared experts) and a
capacity-based scatter/gather expert dispatch.

Both dispatch branches run the expert FFN through `kernels.moe_gmm_fused`
(or, for int8 expert storage, `kernels.moe_gmm_fused_quant`): the dense
branch over all E experts' stacks with `counts = min(hits, C)`, so experts
no token routed to stream no weights, and the packed branch over the union
of routed experts, whose slots name their expert through `expert_ids`
instead of gathering its weights. Neither branch dequantizes int8 experts
up front: the kernel reads them at one byte per weight. The routed indices
are also returned so the serving engine can feed *unique activated expert
counts* to Cascade's cost model, the paper's central quantity.

Verification and prefill use exact capacity C=T, so no token is dropped
(drops would corrupt rejection sampling). Training (capacity policy
"train", factor 1.25, drops allowed) runs the dense branch's three expert
products through `kernels.MoeGmm` instead (the grouped matmul `moe_gmm`,
forward and input gradient), so gradients reach the experts, the dispatch
and, through the combine weights and the load-balance loss, the router."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import MoeGmm, moe_gmm_fused, moe_gmm_fused_quant

from .layers import _dense_init, apply_mlp, init_mlp


def init_moe(cfg, gen, dtype, device):
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {
        "router": _dense_init(gen, (d, e), dtype, device, scale=0.02),
        # fan-in is shape[0] = E for the stacked experts, as in the JAX init
        "w_gate": _dense_init(gen, (e, d, f), dtype, device),
        "w_up": _dense_init(gen, (e, d, f), dtype, device),
        "w_down": _dense_init(gen, (e, f, d), dtype, device),
    }
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(cfg, gen, d, f * cfg.num_shared_experts, dtype,
                               device)
    return p


def _top_k(scores, k: int):
    """Top-k along the last dim with ties to the lower index, as
    `jax.lax.top_k` does (`torch.topk` promises no order on ties)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg, p, x2d):
    """x2d: [T,d] -> (weights [T,k], idx [T,k], probs [T,E])."""
    logits = x2d.float() @ p["router"].float()
    if cfg.router_score == "sigmoid":
        scores = torch.sigmoid(logits)
        top, idx = _top_k(scores, cfg.experts_per_token)
        weights = top / (top.sum(-1, keepdim=True) + 1e-20)
        probs = scores / (scores.sum(-1, keepdim=True) + 1e-20)
    else:
        probs = torch.softmax(logits, dim=-1)
        top, idx = _top_k(probs, cfg.experts_per_token)
        weights = top / (top.sum(-1, keepdim=True) + 1e-20)
    return weights, idx, probs


def _hits(idx, e: int):
    """Routed (token, choice) pairs per expert: [E] int32. (`bincount` and
    `one_hot` would wait for the card to read the largest index; a scatter
    lets the host run ahead.)"""
    flat = idx.reshape(-1)
    return torch.zeros(e, dtype=torch.int32, device=idx.device).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))


def load_balance_loss(cfg, probs, idx):
    """Switch-Transformer auxiliary loss: E * sum_e f_e * P_e."""
    e = cfg.num_experts
    frac_tokens = _hits(idx, e).float() / idx.shape[0]       # [E]
    frac_probs = probs.mean(0)                               # [E]
    return e * (frac_tokens * frac_probs).sum() / cfg.experts_per_token


def unique_expert_count(cfg, idx):
    """Number of distinct experts activated by this batch of tokens — the
    paper's data-movement driver (§2.4). idx: [T,k] -> scalar int."""
    return (_hits(idx, cfg.num_experts) > 0).sum().to(torch.int32)


def masked_expert_idx(cfg, idx_btk, token_mask=None):
    """idx_btk [B,T,k] with the choices of padding tokens (token_mask
    False) moved to a sentinel expert id E that no count reads."""
    if token_mask is None:
        return idx_btk
    return torch.where(token_mask[:, :, None], idx_btk, cfg.num_experts)


def unique_expert_stats(cfg, idx_btk, token_mask=None):
    """Per-request AND batch-union distinct-expert counts: the union drives
    the shared verification bytes, per-row counts the marginal split.

    idx_btk: [B,T,k] routed expert ids; token_mask: [B,T] bool marking the
    real (non-padding) tokens of ragged [1+K_i] spans, or None for all
    valid. Returns (union scalar, per_row [B])."""
    b, t, k = idx_btk.shape
    e = cfg.num_experts
    flat = masked_expert_idx(cfg, idx_btk, token_mask).reshape(b, t * k)
    hits = torch.zeros((b, e + 1), dtype=torch.int32,
                       device=idx_btk.device).scatter_add_(
        1, flat, torch.ones_like(flat, dtype=torch.int32))
    per_row = (hits[:, :e] > 0).sum(-1).to(torch.int32)
    union = (hits[:, :e].sum(0) > 0).sum().to(torch.int32)
    return union, per_row


def shard_expert_stats(cfg, idx_btk, shard_of, token_mask=None,
                       n_shards=None):
    """Per-EP-shard distinct-expert counts: the batch union restricted to
    each shard's experts [S] and the per-row restriction [B,S], the
    gating-shard quantities the sharded cost model prices (the pass
    completes only when the hottest shard has streamed its local activated
    experts; see core/cost_model.ExpertPlacement).

    idx_btk: [B,T,k] routed expert ids; shard_of: length-E expert -> shard
    map, a Python sequence or an int tensor (the engine's replica routes);
    `n_shards` gives the shard count, else it is max(shard_of) + 1;
    token_mask: [B,T] bool marking real tokens (None = all valid). Every
    expert is counted on exactly one shard, so the per-shard counts
    partition `unique_expert_stats`' union and the per-row counts its
    per_row. Returns (per_shard [S], per_row_shard [B,S]), int32."""
    b, t, k = idx_btk.shape
    e = cfg.num_experts
    dev = idx_btk.device
    sid = torch.as_tensor(shard_of, device=dev).long()
    s_n = int(n_shards) if n_shards is not None else int(sid.max()) + 1
    flat = masked_expert_idx(cfg, idx_btk, token_mask).reshape(b, t * k)
    hits = torch.zeros((b, e + 1), dtype=torch.int32,
                       device=dev).scatter_add_(
        1, flat, torch.ones_like(flat, dtype=torch.int32))
    active = (hits[:, :e] > 0).to(torch.int32)                 # [B,E]
    per_row_shard = torch.zeros((b, s_n), dtype=torch.int32,
                                device=dev).index_add_(1, sid, active)
    union_active = (hits[:, :e].sum(0) > 0).to(torch.int32)    # [E]
    per_shard = torch.zeros((s_n,), dtype=torch.int32,
                            device=dev).index_add_(0, sid, union_active)
    return per_shard, per_row_shard


CAPACITY_FACTORS = {"train": 1.25, "serve": 2.0}


def _capacity(cfg, n_tokens: int, policy: str) -> int:
    """Tokens-per-expert buffer size.

    "exact":  C = T — no drop is possible (top-k experts are distinct per
              token); required for exact speculative verification.
    "train":  GShard capacity factor 1.25 (drops allowed).
    "serve":  factor 2.0."""
    if policy == "exact":
        return n_tokens
    cf = CAPACITY_FACTORS[policy]
    cap = int(n_tokens * cfg.experts_per_token * cf) // cfg.num_experts + 1
    return max(min(n_tokens, cap), min(n_tokens, cfg.experts_per_token))


def packed_expert_cap(cfg, n_tokens: int) -> int:
    """Static slot count U_pad of the packed verification layout: a T-token
    pass routes at most min(T*k, E) distinct experts, pow-2 bucketed."""
    from .transformer import bucket_length
    u = min(n_tokens * cfg.experts_per_token, cfg.num_experts)
    return min(bucket_length(u), cfg.num_experts)


def moe_pass_counters(cfg, n_tokens: int, *, capacity_policy: str = "exact",
                      packed: bool = False, precision=None) -> dict:
    """Dry-run counters for one MoE layer's FFN pass: the expert-weight
    bytes the dispatch path streams and the FLOPs its slot products
    execute. They mirror `apply_moe`: the dense branch runs every one of
    the E expert slots, the packed branch only the U_pad =
    `packed_expert_cap` slots, each at capacity C. Bytes price at the
    precision spec's expert class (`core.cost_model.Precision`, default
    bf16): int8 expert storage streams 1 byte/param."""
    from repro_torch.core.cost_model import Precision
    weight_bytes = (precision if precision is not None
                    else Precision.DEFAULT).expert
    c = _capacity(cfg, n_tokens, capacity_policy)
    streamed = (packed_expert_cap(cfg, n_tokens) if packed
                else cfg.num_experts)
    mult = 3 if cfg.activation == "swiglu" else 2
    d, f = cfg.d_model, cfg.moe_d_ff
    return {
        "experts_streamed": streamed,
        "capacity": c,
        "expert_weight_bytes": streamed * mult * d * f * weight_bytes,
        "ffn_flops": 2.0 * streamed * c * d * f * mult,
    }

def quantize_transformer_experts(params, mode: str = "int8",
                                 quantile: float = 1.0) -> dict:
    """Quantize the routed-expert stacks of a whole transformer params tree
    (blocks/moe/w_* with a leading [L, E, ...] axis), returning a new tree.
    Scales are per (layer, expert): `w_up_q8` [L,E,d,F] slices to [E,d,F]
    and `w_up_s` [L,E] to [E] per layer, the storage `apply_moe` detects.
    Router, shared and dense weights keep their type. Modes as in
    `kernels.moe_gmm.quant.quantize_moe_experts`."""
    from repro_torch.kernels.moe_gmm.quant import quantize_moe_experts
    moe = params.get("blocks", {}).get("moe")
    if not isinstance(moe, dict):
        raise ValueError("params tree has no stacked blocks/moe dict "
                         "(per-layer trees: quantize each layer's dict "
                         "with kernels.moe_gmm.quant.quantize_moe_experts)")
    names = [k for k in ("w_gate", "w_up", "w_down") if k in moe]
    if not names:
        raise ValueError("blocks/moe holds no routed expert tensors")
    # one [L*E, ...] stack per weight: a scale per (layer, expert)
    lead = tuple(moe[names[0]].shape[:2])
    flat = quantize_moe_experts({k: moe[k].flatten(0, 1) for k in names},
                                mode, quantile)
    new = {k: v for k, v in moe.items() if k not in names}
    new.update({k: v.reshape(lead + tuple(v.shape[1:]))
                for k, v in flat.items()})
    out = dict(params)
    out["blocks"] = dict(params["blocks"])
    out["blocks"]["moe"] = new
    return out


def _grouped_ffn(p, disp, counts, swiglu: bool):
    """The dense branch's expert FFN under the "train" policy: three grouped
    products through `MoeGmm` (gate, up, down), the activation between
    them, as the JAX package's three einsums."""
    up = MoeGmm.apply(disp, p["w_up"], counts)
    if swiglu:
        h = F.silu(MoeGmm.apply(disp, p["w_gate"], counts)) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return MoeGmm.apply(h, p["w_down"], counts)


def apply_moe(cfg, p, x2d, *, capacity_policy: str = "train",
              packed: bool = False, ep=None):
    """x2d: [T,d] -> (y [T,d], aux dict with routing telemetry).

    packed=True compacts the activated experts into the leading
    `packed_expert_cap(cfg, T)` slots (active experts first, ascending id),
    so the dispatch buffer and the FFN scale with the union U rather than
    E. Both branches give the same outputs up to the order of float sums
    (on the card, bit for bit: the kernels compute a slot's bits
    independently of the layout).

    Int8 expert storage (`w_up_q8` + per-expert `w_up_s`, from
    `quantize_transformer_experts` or `quant.quantize_moe_experts`) runs
    `moe_gmm_fused_quant` on the [E,...] int8 stacks in both branches; fp8
    fake-quant keeps the bf16 keys and runs `moe_gmm_fused`. The dense
    branch under capacity_policy="train" runs `_grouped_ffn`, which carries
    gradients. The output keeps x2d's type.

    `ep` (a callable from `distributed.make_expert_parallel_moe`, applied
    to this rank's slice of the params and its own tokens) runs the
    layer expert-parallel over torch.distributed when the capacity policy
    is not "exact": the union is recomputed from the gathered global
    routing, the per-source counts stay under `unique_experts_src`,
    `dropped` is their sum, and `lb_loss_local` (this rank's load-balance
    loss, beside the reported mean `lb_loss`) carries the gradient."""
    if ep is not None and capacity_policy != "exact":
        y, aux = ep(p, x2d)
        # summing the per-source counts would double-count experts that
        # several token shards route to
        return y, dict(aux,
                       unique_experts=unique_expert_count(
                           cfg, aux["expert_idx"]),
                       unique_experts_src=aux["unique_experts"],
                       dropped=aux["dropped"].sum())
    t, d = x2d.shape
    k, e = cfg.experts_per_token, cfg.num_experts
    c = _capacity(cfg, t, capacity_policy)
    dev = x2d.device

    weights, idx, probs = route(cfg, p, x2d)

    # --- slot assignment: position of each (token, choice) inside its expert
    flat_e = idx.reshape(-1)                                  # [T*k]
    onehot = torch.zeros((flat_e.numel(), e), dtype=torch.int32, device=dev)
    onehot.scatter_(1, flat_e[:, None], 1)
    pos = torch.cumsum(onehot, dim=0) * onehot                # rank in expert
    flat_p = pos.sum(-1) - 1                                  # 0-based
    keep = flat_p < c
    # overflow rows scatter to a spill slot c, which is dropped below
    flat_p = torch.where(keep, flat_p, c)
    hits = _hits(idx, e)                                      # [E]

    x_rep = torch.repeat_interleave(x2d, k, dim=0)            # [T*k,d]
    quant = "w_up_q8" in p
    swiglu = ("w_gate_q8" if quant else "w_gate") in p and \
        cfg.activation == "swiglu"
    activation = "swiglu" if swiglu else "gelu"
    if packed:
        u_cap = packed_expert_cap(cfg, t)
        active = (hits > 0).to(torch.int32)
        perm = torch.argsort(1 - active, stable=True)         # [E]
        expert_ids = perm[:u_cap].to(torch.int32)             # [U_pad]
        slot_of = torch.full((e,), u_cap, dtype=torch.long, device=dev)
        slot_of[expert_ids.long()] = torch.arange(u_cap, device=dev)
        rows = slot_of[flat_e]                                # [T*k] < U_pad
        n_slots = u_cap
        counts = hits[expert_ids.long()].clamp(max=c)
    else:
        expert_ids = None
        rows = flat_e
        n_slots = e
        counts = hits.clamp(max=c)
    # --- dispatch: scatter tokens into [slots, C(+spill), d]
    disp = torch.zeros((n_slots, c + 1, d), dtype=x2d.dtype, device=dev)
    disp[rows, flat_p] = x_rep
    disp = disp[:, :c].contiguous()                           # drop spill slot
    if quant:
        out = moe_gmm_fused_quant(
            disp, p["w_gate_q8"] if swiglu else None, p["w_up_q8"],
            p["w_down_q8"], p["w_gate_s"] if swiglu else None, p["w_up_s"],
            p["w_down_s"], counts, activation=activation,
            expert_ids=expert_ids)
    elif capacity_policy == "train" and not packed:
        out = _grouped_ffn(p, disp, counts, swiglu)
    else:
        out = moe_gmm_fused(disp, p["w_gate"] if swiglu else None,
                            p["w_up"], p["w_down"], counts,
                            activation=activation, expert_ids=expert_ids)

    # --- combine: gather each slot's output back to its token
    pad = torch.zeros((n_slots, 1, d), dtype=out.dtype, device=dev)
    out = torch.cat([out, pad], dim=1)                        # spill reads 0
    y_rep = out[rows, torch.where(keep, flat_p, c)]           # [T*k,d]
    w_flat = (weights.reshape(-1) * keep).to(out.dtype)
    y = (y_rep * w_flat[:, None]).reshape(t, k, d).sum(1)

    if cfg.num_shared_experts:
        y = y + apply_mlp(cfg, p["shared"], x2d)

    aux = {
        "lb_loss": load_balance_loss(cfg, probs, idx),
        "expert_idx": idx,
        "unique_experts": unique_expert_count(cfg, idx),
        "dropped": (~keep).sum(),
    }
    return y, aux
