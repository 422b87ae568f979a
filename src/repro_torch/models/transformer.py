"""Model assembly for uniform stacks of attention+MoE/FFN ("A") blocks,
grouped-query or Multi-head Latent Attention (MLA), of Whisper's decoder
blocks (self-attention, cross-attention to encoder states, FFN: "X") or
of RWKV-6 ("W") blocks, and for RecurrentGemma's pattern stacks of RG-LRU
("R") and local-attention ("A") blocks, with four entry points:

    train_forward(cfg, params, tokens, ...)    -> logits, aux
    prefill(cfg, params, tokens, cache, ...)   -> logits, cache, aux
    decode_step(cfg, params, cache, tokens)    -> logits, cache, aux, staged
    prefill_chunk(cfg, params, cache, tokens)  -> logits, cache, aux, staged

`embeds=` [B,T,d] replaces the token embeddings (Qwen2-VL's precomputed
patch embeddings; `tokens` may then be None), `rope_pos=` the positions
that RoPE rotates by ([3,B,T] for M-RoPE; the cache and the ring keep
using the sequence positions), and `enc_out=` [B,S_enc,d_enc] gives an
"X" stack's encoder states: prefill writes each layer's cross-attention
K/V of them into the cache (`enc_k`, `enc_v`), which decode reads.

Per-layer params are stacked with a leading L dim (`params["blocks"]`), as
in the JAX package, and a Python loop runs the layers. A pattern stack's
layers differ in kind, so its params are a tuple of per-layer trees
(`params["blocks_list"]`), as in the JAX package.

KV caches are ring buffers: ring size = full length for full attention, or
window + 2*SPEC_PAD for sliding-window variants. An MLA stack's ring holds
the compressed latent `ckv` and the shared RoPE key `krope` in place of
`k`/`v`. Speculative rollback is a metadata operation for attention caches
and a select of the staged state for recurrent ones (`rollback_cache`): a
"W" stack's `decode_step` stages
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

`train_forward` trains every stack kind the port serves, each layer from
zero recurrent states as in the JAX package: self-attention through
`kernels.FlashAttention` (MLA's with v zero-padded to the key width; a
pattern stack's "A" layers windowed by `cfg.local_window`), an "X"
stack's cross-attention through `attention.CrossAttention`, the RWKV-6
recurrence through `kernels.RwkvScan` and the RG-LRU's through
`kernels.LinearScan`, and the MoE layers under the "train" capacity
policy, all differentiable. `ep=` (the dispatch
`distributed.make_expert_parallel_moe` returns; `train_forward` and
`prefill(moe_exact=False)`) runs every MoE layer through the expert-parallel
dispatch over torch.distributed, each rank on its own rows of the batch and
its slice of the params (`distributed.shard_params`): the JAX package's
global "ep-a2a" option and context mesh turned into an argument. The JAX
package rematerializes each layer in training (`jax.checkpoint`); that
changes no value, and the port keeps the activations instead: a whole
OLMoE-1B-7B step over 2048 tokens, Adafactor update included, peaks at 45.5
GB on an 80 GB H100 (`chip_smoke.py`)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import (FlashAttention, decode_attention,
                                 flash_attention)

from . import attention as attn_mod
from . import layers as L
from . import mla as mla_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import rwkv as rwkv_mod

SPEC_PAD = 16  # ring-buffer slack so speculative writes never clobber window
#: a "W" stack's per-layer recurrent cache leaves
RWKV_LEAVES = ("wkv", "sx_att", "sx_ffn")
#: a pattern stack's per-"R"-layer recurrent cache leaves
RGLRU_LEAVES = ("h", "conv")
#: an "X" stack's per-layer cross-attention K/V of the encoder output
ENC_LEAVES = ("enc_k", "enc_v")


# ===================================================================== #
# Parameter init
# ===================================================================== #

def _stack_kind(cfg) -> str:
    """The block kind of a stack the port runs: "A" (uniform attention,
    grouped-query or MLA, no encoder), "X" (uniform grouped-query
    attention with cross-attention to an encoder, Whisper's decoder), "W"
    (uniform RWKV-6) or "P" (a pattern of RG-LRU "R" and local-attention
    "A" layers, RecurrentGemma's; an "A" layer holds a MoE in place of its
    FFN when `cfg.is_moe`). Raises for the rest, which the JAX package
    cannot run either: its pattern loop reads `k`/`v` caches for every
    "A" layer (no MLA latents) and has no encoder."""
    kinds = set(cfg.layer_kinds())
    if kinds == {"W"}:
        return "W"
    if kinds == {"X"} and not cfg.use_mla:
        return "X"
    if (cfg.layer_pattern and kinds == {"R", "A"} and not cfg.use_mla
            and not cfg.is_encoder_decoder):
        return "P"
    if kinds != {"A"} or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the port runs uniform attention or RWKV-6 stacks "
            f"and RG-LRU/attention pattern stacks without MLA or an "
            f"encoder (kinds {sorted(kinds)}, moe={cfg.is_moe}, "
            f"mla={cfg.use_mla})")
    return "A"


def kv_leaves(cfg) -> tuple:
    """An attention stack's per-layer cache leaves: the compressed latent
    and the shared RoPE key under MLA, else K and V; an encoder-decoder
    stack's also the cross-attention K/V of the encoder output."""
    if cfg.use_mla:
        return ("ckv", "krope")
    return ("k", "v") + (ENC_LEAVES if cfg.is_encoder_decoder else ())


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
    attn = mla_mod.init_mla if cfg.use_mla else attn_mod.init_attention
    p = {"ln1": L.init_norm(cfg, cfg.d_model, dtype, device),
         "attn": attn(cfg, gen, dtype, device)}
    if kind == "X":
        p["lnx"] = L.init_norm(cfg, cfg.d_model, dtype, device)
        p["xattn"] = attn_mod.init_cross_attention(cfg, gen, dtype, device)
    p["ln2"] = L.init_norm(cfg, cfg.d_model, dtype, device)
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
    [n_rec,B,cw-1,d_rnn] in the model dtype, all zero. An MLA stack's
    holds the latent `ckv` [L,B,R,kv_lora_rank] and the RoPE key `krope`
    [L,B,R,qk_rope_dim] in place of `k`/`v` [L,B,R,Hkv,D]. An "X" stack's
    also holds `enc_k`, `enc_v` [L,B,encoder_len,H,D], zero until a
    prefill writes the encoder's K/V there."""
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
    if cfg.use_mla:
        widths = {"ckv": (cfg.kv_lora_rank,), "krope": (cfg.qk_rope_dim,)}
    else:
        widths = dict.fromkeys(("k", "v"), (cfg.num_kv_heads, cfg.head_dim))
    cache["pos"] = torch.full((batch, r), -1, dtype=torch.int32, device=dev)
    for name, w in widths.items():
        cache[name] = torch.zeros((n_layers, batch, r) + w, dtype=dtype,
                                  device=dev)
    if kind == "X":
        for name in ENC_LEAVES:
            cache[name] = torch.zeros(
                (n_layers, batch, cfg.encoder_len, cfg.num_heads,
                 cfg.head_dim), dtype=dtype, device=dev)
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
    only; an "X" stack's encoder K/V stay as they are). Recurrent caches: select the staged state after `n_accept`
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
    K/V rows (an "X" stack's encoder K/V too), or the recurrent states,
    are copied into the batched buffers in place; positions and lengths come back in new tensors. Both caches
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
    (stale K/V content is masked out by pos == -1, no data wipe needed;
    an "X" stack's encoder K/V stay until the next prefill of the row
    overwrites them, as in the JAX package).

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


def _mla(cfg, p, h, lc, ctx):
    """MLA's half of `_attn_block`, as the JAX package's: decode writes the
    new latents into the ring and attends in latent space over it
    (`mla_absorbed`); prefill runs the expanded form and writes its last
    t_w latents; training runs the expanded form and writes nothing.
    Returns the attention output [B,T,d]."""
    seq_pos = ctx["seq_pos"]
    if ctx["mode"] == "decode":
        ckv_new, krope_new = mla_mod.latent_kv(cfg, p, h, seq_pos)
        ckv = _write_ring(lc["ckv"], ckv_new, ctx["slots"])
        krope = _write_ring(lc["krope"], krope_new, ctx["slots"])
        return mla_mod.mla_absorbed(cfg, p, h, seq_pos, ckv, krope,
                                    ctx["cache_pos"], window=ctx["window"])
    out, (ckv_new, krope_new) = mla_mod.mla_full(cfg, p, h, seq_pos)
    if ctx["mode"] == "prefill":
        t_w = ctx["t_w"]
        _write_ring(lc["ckv"], ckv_new[:, -t_w:], ctx["slots"])
        _write_ring(lc["krope"], krope_new[:, -t_w:], ctx["slots"])
    return out


def _cross(cfg, p, x, lc, ctx):
    """The cross-attention half of an "X" block: prefill encodes the
    encoder output into this layer's `enc_k`/`enc_v` cache views, decode
    reads them, training encodes without a cache. Returns the output
    [B,T,d] to add to the residual."""
    hx = L.apply_norm(cfg, p["lnx"], x)
    if ctx["mode"] == "decode":
        enc_k, enc_v = lc["enc_k"], lc["enc_v"]
    else:
        enc_k, enc_v = attn_mod.encode_cross_kv(cfg, p["xattn"],
                                                ctx["enc_out"])
        if ctx["mode"] == "prefill":
            lc["enc_k"].copy_(enc_k)
            lc["enc_v"].copy_(enc_v)
    return attn_mod.cross_attention(cfg, p["xattn"], hx, enc_k.to(hx.dtype),
                                    enc_v.to(hx.dtype))


def _attn_block(cfg, p, x, lc, ctx, moe_h=None):
    """Attention (+ cross-attention) + MoE/FFN block. lc: this layer's
    {"k","v"} (MLA: {"ckv","krope"}; "X": also {"enc_k","enc_v"}) cache
    views (None in training). `moe_h` ([B,T,d], this layer's slot of the
    decode pass's `aux["moe_h"]` buffer) receives the MoE input, the
    post-ln2 hidden state feeding the router. Returns (x, aux)."""
    mode = ctx["mode"]
    window = ctx["window"]
    seq_pos = ctx["seq_pos"]
    h = L.apply_norm(cfg, p["ln1"], x)
    if cfg.use_mla:
        x = x + _mla(cfg, p["attn"], h, lc, ctx)
    else:
        q, k, v = attn_mod.qkv(cfg, p["attn"], h, ctx["rope_pos"])
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
    if "xattn" in p:
        x = x + _cross(cfg, p, x, lc, ctx)

    h2 = L.apply_norm(cfg, p["ln2"], x)
    aux = {}
    if cfg.is_moe:
        b, t, d = h2.shape
        y2d, moe_aux = moe_mod.apply_moe(cfg, p["moe"], h2.reshape(b * t, d),
                                         capacity_policy=ctx["moe_policy"],
                                         packed=ctx["moe_packed"],
                                         ep=ctx["ep"])
        x = x + y2d.reshape(b, t, d)
        aux["lb_loss"] = moe_aux["lb_loss"]
        aux["unique_experts"] = moe_aux["unique_experts"]
        if "lb_loss_local" in moe_aux:
            # the dispatch's `lb_loss` is reported; this rank's carries
            # the gradient of its share of the loss
            aux["lb_loss_local"] = moe_aux["lb_loss_local"]
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
            if moe_h is not None:
                moe_h.copy_(h2)
            sid = ctx.get("ep_shard_ids")
            if sid is not None:
                # EP-shard accounting: the hottest shard's local activated
                # experts gate a sharded pass
                (aux["unique_experts_shard"],
                 aux["unique_experts_row_shard"]) = \
                    moe_mod.shard_expert_stats(cfg, idx_btk, sid, mask,
                                               n_shards=ctx["ep_n_shards"])
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
            if ctx.get("ep_shard_ids") is not None:
                s_n = ctx["ep_n_shards"]
                aux["unique_experts_shard"] = torch.zeros(
                    (s_n,), dtype=torch.int32, device=dev)
                aux["unique_experts_row_shard"] = torch.zeros(
                    (x.shape[0], s_n), dtype=torch.int32, device=dev)
    return x, aux


def _rwkv_block(cfg, p, x, lc, states=None):
    """Time-mix + channel-mix block. lc: this layer's {"wkv", "sx_att",
    "sx_ffn"} cache views, or None in training: zero token-shift states in
    x's dtype and a zero float32 WKV state, as the JAX package's training
    pass starts each layer. With `states` ([T+1,B,H,N,N] float32, a
    verification pass) the WKV recurrence stages its states there, and the
    token-shift states are staged as well: slot j holds the state after j
    tokens (slot 0 the previous token, slot j the j-th token's normed
    input). Returns (x, new layer cache, staged token-shift states or
    None)."""
    if lc is None:
        b, d = x.shape[0], cfg.d_model
        h_, n = cfg.rwkv_num_heads, cfg.rwkv_head_size
        lc = {"sx_att": x.new_zeros((b, d)), "sx_ffn": x.new_zeros((b, d)),
              "wkv": torch.zeros((b, h_, n, n), dtype=torch.float32,
                                 device=x.device)}
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
    views, or None in training: a zero float32 `h` and a zero `conv` in
    x's dtype, as the JAX package's training pass starts each layer.
    Returns (x, new layer state, staged {"h", "conv"} or None)."""
    if lc is None:
        b = x.shape[0]
        lc = {"h": torch.zeros((b, cfg.d_rnn), dtype=torch.float32,
                               device=x.device),
              "conv": x.new_zeros((b, cfg.conv1d_width - 1, cfg.d_rnn))}
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


def _run_uniform(cfg, params, x, cache, ctx, moe_h=None):
    """Python loop over the stacked homogeneous layers; layer l writes its
    MoE input into `moe_h[l]` when a buffer is given."""
    auxs = []
    blocks = _layers(params["blocks"], cfg.num_layers)
    names = kv_leaves(cfg)
    for layer in range(cfg.num_layers):
        lc = (None if cache is None
              else {n: cache[n][layer] for n in names})
        x, aux = _attn_block(cfg, blocks[layer], x, lc, ctx,
                             None if moe_h is None else moe_h[layer])
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


def _run_attention(cfg, params, x, cache, ctx, per_row, want_moe_h=False):
    """An "A" stack's pass over its ring cache: writes K/V in place and
    returns (x, aux, the new positions). A decode pass of an MoE stack
    with `want_moe_h` gathers every layer's MoE input into one [L,B,T,d]
    buffer allocated up front (no stack of per-layer tensors, so nothing
    else of a layer is kept alive through it)."""
    new_pos = _ring_positions(cfg, cache, x, ctx, per_row)
    decode = ctx["mode"] == "decode"
    moe_h = None
    if want_moe_h and decode and cfg.is_moe:
        moe_h = torch.empty((cfg.num_layers,) + tuple(x.shape),
                            dtype=x.dtype, device=x.device)
    x, ys = _run_uniform(cfg, params, x, cache, ctx, moe_h)
    aux = {"lb_loss": ys["lb_loss"].mean(),
           "unique_experts": ys["unique_experts"]}              # [L]
    if decode:
        aux["unique_experts_row"] = ys["unique_experts_row"]    # [L,B]
        aux["experts_active"] = ys["experts_active"]            # [L,E]
        if "unique_experts_shard" in ys:
            aux["unique_experts_shard"] = ys["unique_experts_shard"]  # [L,S]
            aux["unique_experts_row_shard"] = \
                ys["unique_experts_row_shard"]                  # [L,B,S]
    if moe_h is not None:
        aux["moe_h"] = moe_h                                    # [L,B,T,d]
    return x, aux, new_pos


def _run_rwkv(cfg, params, x, cache, mode):
    """Python loop over a stacked "W" stack. Returns (x, the new recurrent
    cache leaves, staged states or None); in training (no cache) each
    layer starts from zero states and (x, None, None) comes back. A decode
    pass stages every layer's WKV states straight into one [L,T+1,B,H,N,N]
    buffer (2.8 GB on RWKV-6-3B at B=4, T=32: no stacked copy of it is
    ever made)."""
    n_layers = cfg.num_layers
    blocks = _layers(params["blocks"], n_layers)
    states = None
    if mode == "decode":
        shape = (n_layers, x.shape[1] + 1) + tuple(cache["wkv"].shape[1:])
        states = torch.empty(shape, dtype=torch.float32, device=x.device)
    new = {n: [] for n in RWKV_LEAVES}
    staged = {"sx_att": [], "sx_ffn": []}
    for layer in range(n_layers):
        if cache is None:
            x, _, _ = _rwkv_block(cfg, blocks[layer], x, None)
            continue
        lc = {n: cache[n][layer] for n in RWKV_LEAVES}
        x, new_lc, st = _rwkv_block(
            cfg, blocks[layer], x, lc,
            None if states is None else states[layer])
        for n in RWKV_LEAVES:
            new[n].append(new_lc[n])
        if st is not None:
            for n in staged:
                staged[n].append(st[n])
    if cache is None:
        return x, None, None
    new = {n: torch.stack(v) for n, v in new.items()}
    if states is None:
        return x, new, None
    return x, new, {"wkv": states,
                    **{n: torch.stack(v) for n, v in staged.items()}}


def _run_pattern(cfg, params, x, cache, ctx, per_row):
    """Python loop over a pattern stack's layers (RecurrentGemma). The "A"
    layers attend with `cfg.local_window` over the ring the top-level
    window sized (a full cache when it is 0), as the JAX package's
    `_run_pattern` does, and run their MoE (if the config has one) under
    the pass's capacity policy; like the JAX package's, the loop drops
    the "A" layers' aux, so a MoE pattern stack reports no `lb_loss` and
    no routing. The "R" layers carry `h` and `conv`. Returns (x,
    the new recurrent leaves, the new positions, staged states or None):
    a decode pass stages `h` [n_rec,T+1,B,d_rnn] and `conv`
    [n_rec,T+1,B,cw-1,d_rnn]. In training (no cache) the "R" layers start
    from zero states, the "A" layers run `FlashAttention` windowed by
    `cfg.local_window`, and (x, None, None, None) comes back."""
    train = cache is None
    new_pos = None if train else _ring_positions(cfg, cache, x, ctx,
                                                 per_row)
    want = ctx["mode"] == "decode"
    lctx = dict(ctx, window=cfg.local_window)
    new = {n: [] for n in RGLRU_LEAVES}
    staged = {n: [] for n in RGLRU_LEAVES}
    i_rec = i_attn = 0
    for kind, p in zip(cfg.layer_kinds(), params["blocks_list"]):
        if train:
            x = (_rec_block(cfg, p, x, None, False)[0] if kind == "R"
                 else _attn_block(cfg, p, x, None, lctx)[0])
            continue
        if kind == "R":
            lc = {n: cache[n][i_rec] for n in RGLRU_LEAVES}
            x, st, stg = _rec_block(cfg, p, x, lc, want)
            for n in RGLRU_LEAVES:
                new[n].append(st[n])
                if want:
                    staged[n].append(stg[n])
            i_rec += 1
        else:
            lc = {n: cache[n][i_attn] for n in kv_leaves(cfg)}
            x, _ = _attn_block(cfg, p, x, lc, lctx)
            i_attn += 1
    if train:
        return x, None, None, None
    new = {n: torch.stack(v) for n, v in new.items()}
    if not want:
        return x, new, new_pos, None
    return x, new, new_pos, {n: torch.stack(v) for n, v in staged.items()}


def _sinusoid(positions, dim):
    """[B,T] -> [B,T,dim] float32 sinusoidal embedding (Whisper's decoder
    positions): sines of the first dim/2 frequencies, then their cosines."""
    half = dim // 2
    log_base = torch.log(torch.tensor(10000.0, dtype=torch.float32,
                                      device=positions.device))
    freq = torch.exp(-log_base * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _embed_inputs(cfg, params, tokens, embeds, seq_pos):
    """The first layer's input: `embeds` if given, else the tokens'
    embeddings; an encoder-decoder stack adds the sinusoid of the sequence
    positions."""
    if embeds is None:
        embeds = L.embed_tokens(params["embed"], tokens)
    if cfg.is_encoder_decoder:
        embeds = embeds + _sinusoid(seq_pos, cfg.d_model).to(embeds.dtype)
    return embeds


def _batch_len(tokens, embeds) -> tuple:
    """(B, T, device) of a pass from its tokens, or from `embeds` without
    them."""
    lead = tokens if tokens is not None else embeds
    return lead.shape[0], lead.shape[1], lead.device


def _forward(cfg, params, tokens, *, cache, mode, seq_pos, window,
             embeds=None, rope_pos=None, enc_out=None, moe_exact=True,
             moe_packed=False, token_mask=None, want_moe_h=False,
             ep_shard_ids=None, ep_n_shards=None, ep=None):
    """Returns (logits, new_cache, aux, staged)."""
    kind = _stack_kind(cfg)
    if kind == "X" and mode != "decode" and enc_out is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder stack's "
                         f"{mode} needs the encoder output (enc_out=)")
    x = _embed_inputs(cfg, params, tokens, embeds, seq_pos)
    # the JAX package's choice: training capacity unless exact routing is
    # asked for; its "serve" capacity is a TPU sharding option not ported
    ctx = {"mode": mode, "seq_pos": seq_pos, "window": window,
           "rope_pos": seq_pos if rope_pos is None else rope_pos,
           "enc_out": enc_out,
           "moe_policy": "exact" if moe_exact else "train",
           "moe_packed": moe_packed, "token_mask": token_mask, "ep": ep}
    if ep_shard_ids is not None:
        # one device copy of the shard map for every layer of the pass
        sid = torch.as_tensor(ep_shard_ids, device=x.device).long()
        ctx["ep_shard_ids"] = sid
        ctx["ep_n_shards"] = (int(ep_n_shards) if ep_n_shards
                              else int(sid.max()) + 1)
    if cache is None:
        # training: the recurrent stacks have no routing, and a MoE pattern
        # stack's loop drops it, so their aux is empty, as the JAX
        # package's
        aux = {}
        if kind == "W":
            x = _run_rwkv(cfg, params, x, None, mode)[0]
        elif kind == "P":
            x = _run_pattern(cfg, params, x, None, ctx, False)[0]
        else:
            x, ys = _run_uniform(cfg, params, x, None, ctx)
            aux = {"lb_loss": ys["lb_loss"].mean(),
                   "unique_experts": ys["unique_experts"]}      # [L]
            if "lb_loss_local" in ys:
                aux["lb_loss_local"] = ys["lb_loss_local"].mean()
        x = L.apply_norm(cfg, params["final_norm"], x)
        return L.unembed(cfg, params["embed"], x), None, aux, None
    per_row = "lengths" in cache
    new_cache = dict(cache)
    if kind == "W":
        # no positions, no routing: the recurrent leaves are the cache
        x, new, staged = _run_rwkv(cfg, params, x, cache, mode)
        new_cache.update(new)
        aux = {}
    elif kind == "P":
        # the loop drops the routing: the aux is empty, as the JAX package's
        x, new, new_cache["pos"], staged = _run_pattern(cfg, params, x,
                                                        cache, ctx, per_row)
        new_cache.update(new)
        aux = {}
    else:
        x, aux, new_cache["pos"] = _run_attention(cfg, params, x, cache,
                                                  ctx, per_row, want_moe_h)
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

def _arange_pos(b, t, device):
    return torch.arange(t, dtype=torch.int32,
                        device=device).expand(b, t).contiguous()


def train_forward(cfg, params, tokens, *, embeds=None, rope_pos=None,
                  enc_out=None, window: int = 0, ep=None):
    """The training pass over `tokens` [B,T] (or `embeds` [B,T,d]) from
    position 0, without a cache: differentiable, with the MoE layers under
    the "train" capacity policy. Returns (logits
    [B,T,V], aux) with aux["lb_loss"] the mean load-balance loss over the
    layers and aux["unique_experts"] [L] (an RWKV-6 "W" or a pattern "P"
    stack has no routing: its aux is empty). An "X" stack needs `enc_out`
    [B,S_enc,d_enc] and raises ValueError without it. With `ep` (the dispatch
    `distributed.make_expert_parallel_moe` returns; `params` this rank's
    slice, `tokens` its rows) the MoE layers run expert-parallel:
    aux["lb_loss"] is then the mean of the data ranks' losses, a reported
    value, and aux["lb_loss_local"] this rank's, which carries the
    gradient."""
    b, t, dev = _batch_len(tokens, embeds)
    window = window or cfg.window
    logits, _, aux, _ = _forward(cfg, params, tokens, cache=None,
                                 mode="train", seq_pos=_arange_pos(b, t, dev),
                                 window=window, embeds=embeds,
                                 rope_pos=rope_pos, enc_out=enc_out,
                                 moe_exact=False, ep=ep)
    return logits, aux


def prefill(cfg, params, tokens, cache, *, embeds=None, rope_pos=None,
            enc_out=None, window: int = 0, moe_exact: bool = True, ep=None):
    """Run the prompt `tokens` [B,T] (or `embeds` [B,T,d], with `tokens`
    None) from position 0 and fill the cache; `rope_pos` ([B,T], or
    [3,B,T] for M-RoPE) replaces the positions RoPE rotates by, `enc_out`
    [B,S_enc,d_enc] is an "X" stack's encoder output. `moe_exact=False`
    runs the MoE layers under the "train" capacity policy (drops allowed),
    and then `ep` (as in `train_forward`; each rank its rows and a cache of
    as many) dispatches them expert-parallel; under exact routing they keep
    the dense path, as in the JAX package. Returns (logits [B,T,V],
    new_cache, aux)."""
    b, t, dev = _batch_len(tokens, embeds)
    window = window or cfg.window
    logits, cache, aux, _ = _forward(
        cfg, params, tokens, cache=cache, mode="prefill",
        seq_pos=_arange_pos(b, t, dev), window=window,
        embeds=embeds, rope_pos=rope_pos, enc_out=enc_out,
        moe_exact=moe_exact, ep=ep)
    return logits, cache, aux


def decode_step(cfg, params, cache, tokens, *, embeds=None, rope_pos=None,
                window: int = 0, moe_packed: bool = False, token_mask=None,
                want_moe_h: bool = False, ep_shard_ids=None,
                ep_n_shards=None):
    """Verify/decode T tokens per row. Single-request caches start every
    row at the scalar cache['length']; per-row caches
    (init_cache(per_row=True)) start row b at cache['lengths'][b], which is
    how a continuous batch verifies ragged [1+K_i] spans padded to a common
    T in one pass. `token_mask` [B,T] bool marks the real tokens of each
    span: padding tokens still flow through the network (their writes are
    rolled back) but are left out of the expert-union accounting.
    `moe_packed=True` runs the MoE layers on the union-packed path.
    `want_moe_h=True` also returns `aux["moe_h"]` [L,B,T,d], every MoE
    layer's input (the post-ln2 hidden state its router reads), the
    layered prefetcher's probe basis; without it nothing is gathered.
    `ep_shard_ids` (length-E expert -> EP shard map, a sequence or an int
    tensor; see core/cost_model.ExpertPlacement) also returns per-shard
    and per-row-per-shard distinct-expert counts, aux
    `unique_experts_shard` [L,S] and `unique_experts_row_shard` [L,B,S]
    (zeros on dense layers), the hottest-shard telemetry an EP-sharded
    deployment prices its passes with; `ep_n_shards` gives the shard
    count (default max(ep_shard_ids) + 1).
    `embeds` and `rope_pos` as in `prefill`; RoPE rotates by the sequence
    positions unless `rope_pos` is given (the JAX package's default, after
    a multimodal prefill too). An "X" stack attends to the encoder K/V
    its prefill wrote into the cache.
    Returns (logits [B,T,V], new_cache, aux, staged); attention stacks
    stage nothing, so staged is None; an RWKV-6 stack's staged holds
    "wkv" [L,T+1,B,H,N,N] and "sx_att", "sx_ffn" [L,T+1,B,d], a pattern
    stack's "h" [n_rec,T+1,B,d_rnn] and "conv" [n_rec,T+1,B,cw-1,d_rnn],
    slot j the state after j tokens of the pass (`rollback_cache` selects
    from them); neither has routing, so their aux is empty."""
    b, t, dev = _batch_len(tokens, embeds)
    offs = torch.arange(t, dtype=torch.int32, device=dev)
    if "lengths" in cache:
        seq_pos = cache["lengths"][:, None] + offs[None, :]
    else:
        seq_pos = (cache["length"] + offs).expand(b, t).contiguous()
    window = window or cfg.window
    return _forward(cfg, params, tokens, cache=cache, mode="decode",
                    seq_pos=seq_pos, window=window, embeds=embeds,
                    rope_pos=rope_pos, moe_packed=moe_packed,
                    token_mask=token_mask, want_moe_h=want_moe_h,
                    ep_shard_ids=ep_shard_ids, ep_n_shards=ep_n_shards)


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
