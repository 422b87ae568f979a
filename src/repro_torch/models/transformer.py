"""Model assembly for uniform stacks of attention+MoE/FFN ("A") blocks or
RWKV-6 ("W") blocks, and for RecurrentGemma's pattern stacks of RG-LRU
("R") and local-attention ("A") blocks, with four entry points:

    train_forward(cfg, params, tokens)         -> logits, aux
    prefill(cfg, params, tokens, cache)        -> logits, cache, aux
    decode_step(cfg, params, cache, tokens)    -> logits, cache, aux, staged
    prefill_chunk(cfg, params, cache, tokens)  -> logits, cache, aux, staged

Per-layer params are stacked with a leading L dim (`params["blocks"]`), as
in the JAX package, and a Python loop runs the layers. A pattern stack's
layers differ in kind, so its params are a tuple of per-layer trees
(`params["blocks_list"]`), as in the JAX package.

KV caches are ring buffers: ring size = full length for full attention, or
window + 2*SPEC_PAD for sliding-window variants. Speculative rollback is a
metadata operation for attention caches and a select of the staged state
for recurrent ones (`rollback_cache`): a "W" stack's `decode_step` stages
the WKV state and the two token-shift states before and after every token
of the pass, a pattern stack's the RG-LRU state `h` and the conv history
`conv`. A per-row cache
(`init_cache(per_row=True)`) keeps a `lengths` [B] vector, so the rows of
a continuous batch sit at their own lengths (`write_cache_row`,
`clear_cache_row`, per-row rollback). Unlike the JAX package's functional
caches, `prefill` and `decode_step` write the new K/V rows into the cache's
buffers in place (a copy of the whole cache per pass would cost more than
the pass itself); the returned cache shares those buffers with the one
passed in, which is replaced by it. A pass leaves the recurrent leaves
of the cache it was given as they were: its new states are new tensors.

`train_forward` runs "A" stacks only (no backward kernel exists for the
WKV or the RG-LRU recurrence): attention through
`kernels.FlashAttention` and the MoE layers under the "train" capacity
policy, both differentiable. The JAX package rematerializes each layer in
training (`jax.checkpoint`); that changes no value, and the port keeps the
activations instead: a whole OLMoE-1B-7B step over 2048 tokens, Adafactor
update included, peaks at 45.5 GB on an 80 GB H100 (`chip_smoke.py`)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import (FlashAttention, decode_attention,
                                 flash_attention)

from . import attention as attn_mod
from . import layers as L
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import rwkv as rwkv_mod

SPEC_PAD = 16  # ring-buffer slack so speculative writes never clobber window
#: a "W" stack's per-layer recurrent cache leaves
RWKV_LEAVES = ("wkv", "sx_att", "sx_ffn")
#: a pattern stack's per-"R"-layer recurrent cache leaves
RGLRU_LEAVES = ("h", "conv")


# ===================================================================== #
# Parameter init
# ===================================================================== #

def _stack_kind(cfg) -> str:
    """The block kind of a stack the port runs: "A" (uniform attention,
    no MLA, no encoder), "W" (uniform RWKV-6) or "P" (a pattern of RG-LRU
    "R" and dense local-attention "A" layers, RecurrentGemma's). Raises
    for the rest."""
    kinds = set(cfg.layer_kinds())
    if kinds == {"W"}:
        return "W"
    if (cfg.layer_pattern and kinds == {"R", "A"} and not cfg.is_moe
            and not cfg.use_mla and not cfg.is_encoder_decoder):
        return "P"
    if kinds != {"A"} or cfg.use_mla or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the port runs uniform attention or RWKV-6 stacks "
            f"and RG-LRU/dense-attention pattern stacks (kinds "
            f"{sorted(kinds)}, moe={cfg.is_moe}, mla={cfg.use_mla}) only "
            f"so far")
    return "A"


def _init_block(cfg, gen, dtype, device, kind=None):
    """One layer's params; `kind` defaults to the uniform stack's."""
    kind = kind or _stack_kind(cfg)
    if kind == "W":
        return {"ln1": L.init_norm(cfg, cfg.d_model, dtype, device),
                "tmix": rwkv_mod.init_time_mix(cfg, gen, dtype, device),
                "ln2": L.init_norm(cfg, cfg.d_model, dtype, device),
                "cmix": rwkv_mod.init_channel_mix(cfg, gen, dtype, device)}
    if kind == "R":
        return {"ln1": L.init_norm(cfg, cfg.d_model, dtype, device),
                "rec": rglru_mod.init_rglru_block(cfg, gen, dtype, device),
                "ln2": L.init_norm(cfg, cfg.d_model, dtype, device),
                "ffn": L.init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, dtype,
                                  device)}
    p = {"ln1": L.init_norm(cfg, cfg.d_model, dtype, device),
         "attn": attn_mod.init_attention(cfg, gen, dtype, device),
         "ln2": L.init_norm(cfg, cfg.d_model, dtype, device)}
    if cfg.is_moe:
        p["moe"] = moe_mod.init_moe(cfg, gen, dtype, device)
    else:
        p["ffn"] = L.init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def _stack_into(dst, src, layer, n_layers):
    """Copy one layer's tree `src` into slot `layer` of the stacked tree
    `dst`, allocating each [L, ...] leaf on first use."""
    for name, leaf in src.items():
        if isinstance(leaf, dict):
            _stack_into(dst.setdefault(name, {}), leaf, layer, n_layers)
            continue
        if name not in dst:
            dst[name] = torch.empty((n_layers,) + tuple(leaf.shape),
                                    dtype=leaf.dtype, device=leaf.device)
        dst[name][layer].copy_(leaf)


def init_params(cfg, generator: torch.Generator, *, device=None):
    """Random params in `cfg.dtype` on `device` (the card by default), drawn
    from `generator`, which must live on the same device. Same tree and
    shapes as the JAX package's `init_params`; the numbers differ. Built
    one layer at a time, so the peak is the model plus one layer."""
    kind = _stack_kind(cfg)
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    dtype = getattr(torch, cfg.dtype)
    params: Dict[str, Any] = {"embed": L.init_embed(cfg, generator, dtype,
                                                    dev)}
    if kind == "P":
        params["blocks_list"] = tuple(
            _init_block(cfg, generator, dtype, dev, k)
            for k in cfg.layer_kinds())
    else:
        blocks: Dict[str, Any] = {}
        for layer in range(cfg.num_layers):
            _stack_into(blocks, _init_block(cfg, generator, dtype, dev, kind),
                        layer, cfg.num_layers)
        params["blocks"] = blocks
    params["final_norm"] = L.init_norm(cfg, cfg.d_model, dtype, dev)
    return params


# ===================================================================== #
# Cache
# ===================================================================== #

def ring_size(cfg, max_len: int, window: int) -> int:
    """Ring slots for a sliding-window cache: `window + SPEC_PAD` live slots
    (modulus) plus SPEC_PAD spill slots; full attention keeps max_len."""
    if window and window > 0:
        return min(max_len, window + 2 * SPEC_PAD)
    return max_len


def init_cache(cfg, batch: int, max_len: int, *, window: int = 0,
               dtype=None, device=None, per_row: bool = False):
    """Allocate an empty cache for `batch` sequences of up to `max_len`
    tokens on `device` (the card by default). `window` (0 = full) selects
    sliding-window attention and sizes the ring accordingly.

    `per_row=True` adds a `lengths` [B] vector so every row keeps its own
    sequence length: the continuous-batching layout where rows join, draft
    different K_i and roll back independently. The scalar `length` is kept
    alongside as the row maximum.

    A "W" stack's cache holds no positions and no K/V: the WKV state `wkv`
    [L,B,H,N,N] in float32 and the token-shift states `sx_att`, `sx_ffn`
    [L,B,d] in the model dtype, all zero. A pattern stack's holds K/V for
    its "A" layers only, and for its "R" layers the RG-LRU state `h`
    [n_rec,B,d_rnn] in float32 and the conv history `conv`
    [n_rec,B,cw-1,d_rnn] in the model dtype, all zero."""
    kind = _stack_kind(cfg)
    dev = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    n_layers = cfg.num_layers
    cache = {"length": torch.zeros((), dtype=torch.int32, device=dev)}
    if per_row:
        cache["lengths"] = torch.zeros((batch,), dtype=torch.int32,
                                       device=dev)
    if kind == "W":
        h, n = cfg.rwkv_num_heads, cfg.rwkv_head_size
        cache["wkv"] = torch.zeros((n_layers, batch, h, n, n),
                                   dtype=torch.float32, device=dev)
        for name in ("sx_att", "sx_ffn"):
            cache[name] = torch.zeros((n_layers, batch, cfg.d_model),
                                      dtype=dtype, device=dev)
        return cache
    if kind == "P":
        kinds = cfg.layer_kinds()
        n_layers = kinds.count("A")            # the K/V below: "A" only
        n_rec = kinds.count("R")
        cache["h"] = torch.zeros((n_rec, batch, cfg.d_rnn),
                                 dtype=torch.float32, device=dev)
        cache["conv"] = torch.zeros(
            (n_rec, batch, cfg.conv1d_width - 1, cfg.d_rnn), dtype=dtype,
            device=dev)
    w_eff = window if window else (cfg.window or 0)
    r = ring_size(cfg, max_len, w_eff)
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    cache.update({
        "pos": torch.full((batch, r), -1, dtype=torch.int32, device=dev),
        "k": torch.zeros((n_layers, batch, r, hkv, hd), dtype=dtype,
                         device=dev),
        "v": torch.zeros((n_layers, batch, r, hkv, hd), dtype=dtype,
                         device=dev),
    })
    return cache


def bucket_length(t: int, minimum: int = 1) -> int:
    """Round a span length up to the next power of two."""
    t = max(int(t), int(minimum), 1)
    return 1 << (t - 1).bit_length()


def cache_slots(cache, positions_1d):
    """Map absolute positions [T] to ring slots [T]."""
    r = cache["pos"].shape[1]
    return positions_1d % r


def rollback_cache(cfg, cache, staged, n_accept, length_before):
    """Rewind the cache to `length_before + n_accept` after verification.

    Attention caches: invalidate the positions of rejected slots (metadata
    only). Recurrent caches: select the staged state after `n_accept`
    tokens (`staged[name]` is [L,T+1,B,...], slot j the state after j
    tokens of the pass), copied out so the staged buffers can be freed.

    Scalar `n_accept`/`length_before` rewind every row uniformly (the
    single-request path). [B]-shaped ones rewind each row to its own
    accepted length in one vectorised truncation and a per-row gather."""
    dev = cache["length"].device
    n_accept = torch.as_tensor(n_accept, dtype=torch.int32, device=dev)
    new_len = (torch.as_tensor(length_before, dtype=torch.int32, device=dev)
               + n_accept)
    cache = dict(cache)
    if new_len.dim() == 0:
        cache["length"] = new_len
        if "lengths" in cache:
            cache["lengths"] = new_len.expand(
                cache["lengths"].shape).clone()
        row_len = new_len
    else:
        cache["lengths"] = new_len
        cache["length"] = new_len.max()
        row_len = new_len[:, None]
    if "pos" in cache:
        cache["pos"] = torch.where(cache["pos"] >= row_len, -1,
                                   cache["pos"])
    for name, st in (staged or {}).items():
        idx = n_accept.to(st.device).long()
        if idx.dim() == 0:
            sel = st.index_select(1, idx[None])[:, 0]
        else:
            # row b keeps the state after its own n_accept[b] tokens
            sel = st[:, idx, torch.arange(idx.shape[0], device=st.device)]
        cache[name] = sel.to(cache[name].dtype)
    return cache


def write_cache_row(cache, slot: int, row_cache):
    """Copy a batch-1 cache (a freshly prefilled request) into row `slot`
    of a per-row batched cache: the join half of continuous batching. The
    K/V rows, or the recurrent states, are copied into the batched buffers
    in place; positions and lengths come back in new tensors. Both caches
    must share ring size and layer layout."""
    out = dict(cache)
    for name, buf in cache.items():
        if name in ("length", "lengths"):
            continue
        src = row_cache[name]
        if name == "pos":                       # [B,R] <- [1,R]
            out[name] = buf.clone()
            out[name][slot] = src[0]
        else:                                   # [L,B,...] <- [L,1,...]
            buf[:, slot].copy_(src[:, 0])
    row_len = (row_cache["lengths"][0] if "lengths" in row_cache
               else row_cache["length"])
    if "lengths" in cache:
        lengths = cache["lengths"].clone()
        lengths[slot] = row_len
        out["lengths"] = lengths
        out["length"] = lengths.max()
    else:
        out["length"] = torch.maximum(cache["length"], row_len)
    return out


def clear_cache_row(cache, slot: int):
    """Retire row `slot`: zero its length and invalidate its ring positions
    (stale K/V content is masked out by pos == -1, no data wipe needed).

    A recurrent cache's row (`wkv`, `sx_att`, `sx_ffn`, or `h`, `conv`) is
    zeroed in place, so a request admitted by chunks into the row starts
    from the zero state as in a fresh cache. The JAX package's
    `clear_cache_row` leaves these leaves as they were, so there a
    chunk-admitted request that joins a recycled row starts from the state
    of the request that left it."""
    out = dict(cache)
    if "pos" in cache:
        pos = cache["pos"].clone()
        pos[slot] = -1
        out["pos"] = pos
    for name in RWKV_LEAVES + RGLRU_LEAVES:
        if name in cache:
            cache[name][:, slot].zero_()
    if "lengths" in cache:
        lengths = cache["lengths"].clone()
        lengths[slot] = 0
        out["lengths"] = lengths
        out["length"] = lengths.max()
    return out


# ===================================================================== #
# Block application
# ===================================================================== #

def _write_ring(buf_l, vals, slots):
    """Write T new entries into a cache buffer [B,R,...] in place, at ring
    `slots` [T] shared by every row, or at per-row slots [B,T] (continuous
    batching: rows sit at different lengths)."""
    vals = vals.to(buf_l.dtype)
    if slots.dim() == 2:
        rows = torch.arange(slots.shape[0], device=slots.device)[:, None]
        buf_l[rows, slots] = vals
    else:
        buf_l[:, slots] = vals
    return buf_l


def _attn_block(cfg, p, x, lc, ctx):
    """Attention + MoE/FFN block. lc: this layer's {"k","v"} cache views
    (None in training). Returns (x, aux)."""
    mode = ctx["mode"]
    window = ctx["window"]
    seq_pos = ctx["seq_pos"]
    h = L.apply_norm(cfg, p["ln1"], x)
    q, k, v = attn_mod.qkv(cfg, p["attn"], h, seq_pos)
    if mode == "train":
        out = FlashAttention.apply(q, k, v, window)
    elif mode == "decode":
        kb = _write_ring(lc["k"], k, ctx["slots"])
        vb = _write_ring(lc["v"], v, ctx["slots"])
        out = decode_attention(q, kb.to(q.dtype), vb.to(q.dtype),
                               ctx["cache_pos"], seq_pos, window=window)
    else:
        out = flash_attention(q, k, v, window=window)
        t_w = ctx["t_w"]
        _write_ring(lc["k"], k[:, -t_w:], ctx["slots"])
        _write_ring(lc["v"], v[:, -t_w:], ctx["slots"])
    b, t = out.shape[:2]
    x = x + out.reshape(b, t, -1) @ p["attn"]["wo"]

    h2 = L.apply_norm(cfg, p["ln2"], x)
    aux = {}
    if cfg.is_moe:
        b, t, d = h2.shape
        y2d, moe_aux = moe_mod.apply_moe(cfg, p["moe"], h2.reshape(b * t, d),
                                         capacity_policy=ctx["moe_policy"],
                                         packed=ctx["moe_packed"])
        x = x + y2d.reshape(b, t, d)
        aux["lb_loss"] = moe_aux["lb_loss"]
        aux["unique_experts"] = moe_aux["unique_experts"]
        if mode == "decode":
            # per-row counts always; the union replaces the all-token count
            # when a padding mask marks ragged [1+K_i] spans (padding must
            # not inflate the union the cost model prices)
            mask = ctx["token_mask"]
            idx_btk = moe_aux["expert_idx"].reshape(b, t, -1)
            union, aux["unique_experts_row"] = moe_mod.unique_expert_stats(
                cfg, idx_btk, mask)
            if mask is not None:
                aux["unique_experts"] = union
            # padding routes to the sentinel bucket E, dropped here
            flat = moe_mod.masked_expert_idx(cfg, idx_btk, mask)
            aux["experts_active"] = moe_mod._hits(
                flat, cfg.num_experts + 1)[:cfg.num_experts] > 0
    else:
        x = x + L.apply_mlp(cfg, p["ffn"], h2)
        dev = x.device
        aux["lb_loss"] = torch.zeros((), dtype=torch.float32, device=dev)
        aux["unique_experts"] = torch.zeros((), dtype=torch.int32, device=dev)
        if mode == "decode":
            aux["unique_experts_row"] = torch.zeros(
                (x.shape[0],), dtype=torch.int32, device=dev)
            aux["experts_active"] = torch.zeros(
                (cfg.num_experts,), dtype=torch.bool, device=dev)
    return x, aux


def _rwkv_block(cfg, p, x, lc, states=None):
    """Time-mix + channel-mix block. lc: this layer's {"wkv", "sx_att",
    "sx_ffn"} cache views. With `states` ([T+1,B,H,N,N] float32, a
    verification pass) the WKV recurrence stages its states there, and the
    token-shift states are staged as well: slot j holds the state after j
    tokens (slot 0 the previous token, slot j the j-th token's normed
    input). Returns (x, new layer cache, staged token-shift states or
    None)."""
    h = L.apply_norm(cfg, p["ln1"], x)
    sx_att = lc["sx_att"].to(h.dtype)
    out, last_x, s_last = rwkv_mod.time_mix(cfg, p["tmix"], h, sx_att,
                                            lc["wkv"], states=states)
    x = x + out
    h2 = L.apply_norm(cfg, p["ln2"], x)
    sx_ffn = lc["sx_ffn"].to(h2.dtype)
    out2, last_x2 = rwkv_mod.channel_mix(cfg, p["cmix"], h2, sx_ffn)
    x = x + out2
    new_lc = {"wkv": s_last, "sx_att": last_x, "sx_ffn": last_x2}
    staged = None
    if states is not None:
        staged = {"sx_att": torch.cat([sx_att[None], h.movedim(1, 0)]),
                  "sx_ffn": torch.cat([sx_ffn[None], h2.movedim(1, 0)])}
    return x, new_lc, staged


def _rec_block(cfg, p, x, lc, want_states):
    """RG-LRU recurrent block + FFN. lc: this layer's {"h", "conv"} cache
    views. Returns (x, new layer state, staged {"h", "conv"} or None)."""
    h = L.apply_norm(cfg, p["ln1"], x)
    out, new_state, staged = rglru_mod.apply_rglru_block(
        cfg, p["rec"], h, lc, want_states=want_states)
    x = x + out
    h2 = L.apply_norm(cfg, p["ln2"], x)
    x = x + L.apply_mlp(cfg, p["ffn"], h2)
    return x, new_state, staged


# ===================================================================== #
# Forward passes
# ===================================================================== #

def _layers(tree, n_layers):
    """The stacked [L, ...] tree as L per-layer trees of views. One
    `unbind` per leaf: under autograd its backward stacks the L layers'
    gradients once, where indexing layer by layer would build a full-size
    [L, ...] gradient for every layer."""
    out = [{} for _ in range(n_layers)]
    for name, v in tree.items():
        parts = (_layers(v, n_layers) if isinstance(v, dict)
                 else v.unbind(0))
        for layer in range(n_layers):
            out[layer][name] = parts[layer]
    return out


def _run_uniform(cfg, params, x, cache, ctx):
    """Python loop over the stacked homogeneous layers."""
    auxs = []
    blocks = _layers(params["blocks"], cfg.num_layers)
    for layer in range(cfg.num_layers):
        lc = (None if cache is None
              else {"k": cache["k"][layer], "v": cache["v"][layer]})
        x, aux = _attn_block(cfg, blocks[layer], x, lc, ctx)
        auxs.append(aux)
    return x, {n: torch.stack([a[n] for a in auxs]) for n in auxs[0]}


def _ring_positions(cfg, cache, x, ctx, per_row):
    """Ring slots of this pass's tokens, from the top-level `ctx["window"]`:
    puts `slots`, `t_w` and the updated positions `cache_pos` into ctx and
    returns the new positions."""
    seq_pos, window = ctx["seq_pos"], ctx["window"]
    t = x.shape[1]
    r = cache["pos"].shape[1]
    # effective ring modulus: ring caches (window + SPEC_PAD slots) wrap at
    # `window + SPEC_PAD` so a write of <= SPEC_PAD entries never splits
    is_ring = window and r == ring_size(cfg, 1 << 62, window)
    m_eff = (r - SPEC_PAD) if is_ring else r
    t_w = min(t, m_eff)
    # per-row layout: rows sit at independent lengths, so ring slots (and
    # pos updates) are computed per row rather than shared across the batch
    new_pos = cache["pos"].clone()
    if per_row:
        slots = (seq_pos[:, -t_w:] % m_eff).long()           # [B,t_w]
        new_pos.scatter_(1, slots, seq_pos[:, -t_w:])
    else:
        slots = (seq_pos[0, -t_w:] % m_eff).long()           # [t_w]
        new_pos[:, slots] = seq_pos[:, -t_w:]
    ctx.update(cache_pos=new_pos, slots=slots, t_w=t_w)
    return new_pos


def _run_attention(cfg, params, x, cache, ctx, per_row):
    """An "A" stack's pass over its ring cache: writes K/V in place and
    returns (x, aux, the new positions)."""
    new_pos = _ring_positions(cfg, cache, x, ctx, per_row)
    x, ys = _run_uniform(cfg, params, x, cache, ctx)
    aux = {"lb_loss": ys["lb_loss"].mean(),
           "unique_experts": ys["unique_experts"]}              # [L]
    if ctx["mode"] == "decode":
        aux["unique_experts_row"] = ys["unique_experts_row"]    # [L,B]
        aux["experts_active"] = ys["experts_active"]            # [L,E]
    return x, aux, new_pos


def _run_rwkv(cfg, params, x, cache, mode):
    """Python loop over a stacked "W" stack. Returns (x, the new recurrent
    cache leaves, staged states or None). A decode pass stages every
    layer's WKV states straight into one [L,T+1,B,H,N,N] buffer (2.8 GB on
    RWKV-6-3B at B=4, T=32: no stacked copy of it is ever made)."""
    n_layers = cfg.num_layers
    blocks = _layers(params["blocks"], n_layers)
    states = None
    if mode == "decode":
        shape = (n_layers, x.shape[1] + 1) + tuple(cache["wkv"].shape[1:])
        states = torch.empty(shape, dtype=torch.float32, device=x.device)
    new = {n: [] for n in RWKV_LEAVES}
    staged = {"sx_att": [], "sx_ffn": []}
    for layer in range(n_layers):
        lc = {n: cache[n][layer] for n in RWKV_LEAVES}
        x, new_lc, st = _rwkv_block(
            cfg, blocks[layer], x, lc,
            None if states is None else states[layer])
        for n in RWKV_LEAVES:
            new[n].append(new_lc[n])
        if st is not None:
            for n in staged:
                staged[n].append(st[n])
    new = {n: torch.stack(v) for n, v in new.items()}
    if states is None:
        return x, new, None
    return x, new, {"wkv": states,
                    **{n: torch.stack(v) for n, v in staged.items()}}


def _run_pattern(cfg, params, x, cache, ctx, per_row):
    """Python loop over a pattern stack's layers (RecurrentGemma). The "A"
    layers attend with `cfg.local_window` over the ring the top-level
    window sized (a full cache when it is 0), as the JAX package's
    `_run_pattern` does; the "R" layers carry `h` and `conv`. Returns (x,
    the new recurrent leaves, the new positions, staged states or None):
    a decode pass stages `h` [n_rec,T+1,B,d_rnn] and `conv`
    [n_rec,T+1,B,cw-1,d_rnn]."""
    new_pos = _ring_positions(cfg, cache, x, ctx, per_row)
    want = ctx["mode"] == "decode"
    lctx = dict(ctx, window=cfg.local_window)
    new = {n: [] for n in RGLRU_LEAVES}
    staged = {n: [] for n in RGLRU_LEAVES}
    i_rec = i_attn = 0
    for kind, p in zip(cfg.layer_kinds(), params["blocks_list"]):
        if kind == "R":
            lc = {n: cache[n][i_rec] for n in RGLRU_LEAVES}
            x, st, stg = _rec_block(cfg, p, x, lc, want)
            for n in RGLRU_LEAVES:
                new[n].append(st[n])
                if want:
                    staged[n].append(stg[n])
            i_rec += 1
        else:
            lc = {"k": cache["k"][i_attn], "v": cache["v"][i_attn]}
            x, _ = _attn_block(cfg, p, x, lc, lctx)
            i_attn += 1
    new = {n: torch.stack(v) for n, v in new.items()}
    if not want:
        return x, new, new_pos, None
    return x, new, new_pos, {n: torch.stack(v) for n, v in staged.items()}


def _forward(cfg, params, tokens, *, cache, mode, seq_pos, window,
             moe_exact=True, moe_packed=False, token_mask=None):
    """Returns (logits, new_cache, aux, staged)."""
    kind = _stack_kind(cfg)
    if kind == "W" and cache is None:
        raise NotImplementedError(
            f"{cfg.name}: training an RWKV-6 stack is not ported (no "
            "backward kernel for the WKV recurrence)")
    if kind == "P" and cache is None:
        raise NotImplementedError(
            f"{cfg.name}: training a RecurrentGemma pattern stack is not "
            "ported (no backward kernel for the RG-LRU recurrence)")
    x = L.embed_tokens(params["embed"], tokens)
    # the JAX package's choice: training capacity unless exact routing is
    # asked for; its "serve" capacity is a TPU sharding option not ported
    ctx = {"mode": mode, "seq_pos": seq_pos, "window": window,
           "moe_policy": "exact" if moe_exact else "train",
           "moe_packed": moe_packed, "token_mask": token_mask}
    if cache is None:
        x, ys = _run_uniform(cfg, params, x, None, ctx)
        x = L.apply_norm(cfg, params["final_norm"], x)
        aux = {"lb_loss": ys["lb_loss"].mean(),
               "unique_experts": ys["unique_experts"]}          # [L]
        return L.unembed(cfg, params["embed"], x), None, aux, None
    per_row = "lengths" in cache
    new_cache = dict(cache)
    if kind == "W":
        # no positions, no routing: the recurrent leaves are the cache
        x, new, staged = _run_rwkv(cfg, params, x, cache, mode)
        new_cache.update(new)
        aux = {}
    elif kind == "P":
        # no routing: the aux is empty, as the JAX package's
        x, new, new_cache["pos"], staged = _run_pattern(cfg, params, x,
                                                        cache, ctx, per_row)
        new_cache.update(new)
        aux = {}
    else:
        x, aux, new_cache["pos"] = _run_attention(cfg, params, x, cache,
                                                  ctx, per_row)
        staged = None
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.unembed(cfg, params["embed"], x)
    if per_row:
        new_cache["lengths"] = seq_pos[:, -1] + 1
        new_cache["length"] = new_cache["lengths"].max()
    else:
        new_cache["length"] = seq_pos[0, -1] + 1
    return logits, new_cache, aux, staged


# --------------------------------------------------------------------- #
# Public entry points
# --------------------------------------------------------------------- #

def train_forward(cfg, params, tokens, *, window: int = 0):
    """The training pass over `tokens` [B,T] from position 0, without a
    cache: differentiable, with the MoE layers under the "train" capacity
    policy. Returns (logits [B,T,V], aux) with aux["lb_loss"] the mean
    load-balance loss over the layers and aux["unique_experts"] [L].
    An RWKV-6 ("W") or a pattern ("P") stack raises NotImplementedError."""
    b, t = tokens.shape[:2]
    seq_pos = torch.arange(t, dtype=torch.int32,
                           device=tokens.device).expand(b, t).contiguous()
    window = window or cfg.window
    logits, _, aux, _ = _forward(cfg, params, tokens, cache=None,
                                 mode="train", seq_pos=seq_pos,
                                 window=window, moe_exact=False)
    return logits, aux


def prefill(cfg, params, tokens, cache, *, window: int = 0):
    """Run the prompt `tokens` [B,T] from position 0 and fill the cache.
    Returns (logits [B,T,V], new_cache, aux)."""
    b, t = tokens.shape[:2]
    seq_pos = torch.arange(t, dtype=torch.int32,
                           device=tokens.device).expand(b, t).contiguous()
    window = window or cfg.window
    logits, cache, aux, _ = _forward(cfg, params, tokens, cache=cache,
                                     mode="prefill", seq_pos=seq_pos,
                                     window=window)
    return logits, cache, aux


def decode_step(cfg, params, cache, tokens, *, window: int = 0,
                moe_packed: bool = False, token_mask=None):
    """Verify/decode T tokens per row. Single-request caches start every
    row at the scalar cache['length']; per-row caches
    (init_cache(per_row=True)) start row b at cache['lengths'][b], which is
    how a continuous batch verifies ragged [1+K_i] spans padded to a common
    T in one pass. `token_mask` [B,T] bool marks the real tokens of each
    span: padding tokens still flow through the network (their writes are
    rolled back) but are left out of the expert-union accounting.
    `moe_packed=True` runs the MoE layers on the union-packed path.
    Returns (logits [B,T,V], new_cache, aux, staged); attention stacks
    stage nothing, so staged is None; an RWKV-6 stack's staged holds
    "wkv" [L,T+1,B,H,N,N] and "sx_att", "sx_ffn" [L,T+1,B,d], a pattern
    stack's "h" [n_rec,T+1,B,d_rnn] and "conv" [n_rec,T+1,B,cw-1,d_rnn],
    slot j the state after j tokens of the pass (`rollback_cache` selects
    from them); neither has routing, so their aux is empty."""
    b, t = tokens.shape[:2]
    offs = torch.arange(t, dtype=torch.int32, device=tokens.device)
    if "lengths" in cache:
        seq_pos = cache["lengths"][:, None] + offs[None, :]
    else:
        seq_pos = (cache["length"] + offs).expand(b, t).contiguous()
    window = window or cfg.window
    return _forward(cfg, params, tokens, cache=cache, mode="decode",
                    seq_pos=seq_pos, window=window, moe_packed=moe_packed,
                    token_mask=token_mask)


def prefill_chunk(cfg, params, cache, tokens, *, token_mask=None,
                  window: int = 0):
    """Advance cache rows by their masked prompt-chunk tokens: the chunked
    half of non-blocking admission. Row b's chunk enters at positions
    lengths[b]..lengths[b]+T-1, attends causally to its cached context and
    the in-chunk prefix, and writes its KV exactly like a decode span; so
    it is the decode pass with `token_mask` doing the ragged-chunk
    bookkeeping, and a serving engine can pack prefill chunks and [1+K_i]
    decode spans into one padded pass. Callers roll each row back to its
    real chunk length, like rejected drafts. Returns (logits [B,T,V],
    new_cache, aux, staged); a row's last real position holds the
    next-token distribution once its prompt is done."""
    return decode_step(cfg, params, cache, tokens, window=window,
                       token_mask=token_mask)
