"""Model assembly for uniform attention+MoE ("A") stacks, with two entry
points:

    prefill(cfg, params, tokens, cache)      -> logits, cache, aux
    decode_step(cfg, params, cache, tokens)  -> logits, cache, aux, staged

Per-layer params are stacked with a leading L dim (`params["blocks"]`), as
in the JAX package, and a Python loop runs the layers.

KV caches are ring buffers: ring size = full length for full attention, or
window + 2*SPEC_PAD for sliding-window variants. Speculative rollback is a
metadata operation (`rollback_cache`). Unlike the JAX package's functional
caches, `prefill` and `decode_step` write the new K/V rows into the cache's
buffers in place (a copy of the whole cache per pass would cost more than
the pass itself); the returned cache shares those buffers with the one
passed in, which is replaced by it."""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import decode_attention, flash_attention

from . import attention as attn_mod
from . import layers as L
from . import moe as moe_mod

SPEC_PAD = 16  # ring-buffer slack so speculative writes never clobber window


# ===================================================================== #
# Parameter init
# ===================================================================== #

def _check_uniform_attention(cfg):
    kinds = set(cfg.layer_kinds())
    if kinds != {"A"} or cfg.use_mla or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the port runs uniform attention stacks (kinds "
            f"{sorted(kinds)}, mla={cfg.use_mla}) only so far")


def _init_block(cfg, gen, dtype, device):
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
    shapes as the JAX package's `init_params`; the numbers differ."""
    _check_uniform_attention(cfg)
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    dtype = getattr(torch, cfg.dtype)
    params: Dict[str, Any] = {"embed": L.init_embed(cfg, generator, dtype,
                                                    dev)}
    blocks: Dict[str, Any] = {}
    for layer in range(cfg.num_layers):
        # one layer at a time, so the peak is the model plus one layer
        _stack_into(blocks, _init_block(cfg, generator, dtype, dev), layer,
                    cfg.num_layers)
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
               dtype=None, device=None):
    """Allocate an empty cache for `batch` sequences of up to `max_len`
    tokens on `device` (the card by default). `window` (0 = full) selects
    sliding-window attention and sizes the ring accordingly."""
    _check_uniform_attention(cfg)
    dev = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    w_eff = window if window else (cfg.window or 0)
    r = ring_size(cfg, max_len, w_eff)
    n_attn = cfg.num_layers
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "length": torch.zeros((), dtype=torch.int32, device=dev),
        "pos": torch.full((batch, r), -1, dtype=torch.int32, device=dev),
        "k": torch.zeros((n_attn, batch, r, hkv, hd), dtype=dtype, device=dev),
        "v": torch.zeros((n_attn, batch, r, hkv, hd), dtype=dtype, device=dev),
    }


def bucket_length(t: int, minimum: int = 1) -> int:
    """Round a span length up to the next power of two."""
    t = max(int(t), int(minimum), 1)
    return 1 << (t - 1).bit_length()


def cache_slots(cache, positions_1d):
    """Map absolute positions [T] to ring slots [T]."""
    r = cache["pos"].shape[1]
    return positions_1d % r


def rollback_cache(cfg, cache, staged, n_accept, length_before):
    """Rewind the cache to `length_before + n_accept` after verification:
    invalidate the positions of rejected slots (metadata only). Attention
    stacks stage no recurrent state, so `staged` must be empty."""
    if staged:
        raise ValueError("staged recurrent states are not ported")
    new_len = torch.as_tensor(length_before, dtype=torch.int32,
                              device=cache["pos"].device) + int(n_accept)
    cache = dict(cache)
    cache["length"] = new_len
    cache["pos"] = torch.where(cache["pos"] >= new_len, -1, cache["pos"])
    return cache


# ===================================================================== #
# Block application
# ===================================================================== #

def _write_ring(buf_l, vals, slots):
    """Write T new entries into a cache buffer [B,R,...] at ring `slots`
    [T], in place."""
    buf_l[:, slots] = vals.to(buf_l.dtype)
    return buf_l


def _attn_block(cfg, p, x, lc, ctx):
    """Attention + MoE/FFN block. lc: this layer's {"k","v"} cache views.
    Returns (x, aux)."""
    mode = ctx["mode"]
    window = ctx["window"]
    seq_pos = ctx["seq_pos"]
    h = L.apply_norm(cfg, p["ln1"], x)
    q, k, v = attn_mod.qkv(cfg, p["attn"], h, seq_pos)
    if mode == "decode":
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
                                         capacity_policy="exact",
                                         packed=ctx["moe_packed"])
        x = x + y2d.reshape(b, t, d)
        aux["lb_loss"] = moe_aux["lb_loss"]
        aux["unique_experts"] = moe_aux["unique_experts"]
        if mode == "decode":
            idx_btk = moe_aux["expert_idx"].reshape(b, t, -1)
            _, aux["unique_experts_row"] = moe_mod.unique_expert_stats(
                cfg, idx_btk)
            aux["experts_active"] = moe_mod._hits(idx_btk,
                                                  cfg.num_experts) > 0
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


# ===================================================================== #
# Forward passes
# ===================================================================== #

def _layer(tree, layer):
    """Slice layer `layer` out of the stacked [L, ...] tree (views)."""
    return {n: (_layer(v, layer) if isinstance(v, dict) else v[layer])
            for n, v in tree.items()}


def _run_uniform(cfg, params, x, cache, ctx):
    """Python loop over the stacked homogeneous layers."""
    auxs = []
    for layer in range(cfg.num_layers):
        lc = {"k": cache["k"][layer], "v": cache["v"][layer]}
        x, aux = _attn_block(cfg, _layer(params["blocks"], layer), x, lc, ctx)
        auxs.append(aux)
    return x, {n: torch.stack([a[n] for a in auxs]) for n in auxs[0]}


def _forward(cfg, params, tokens, *, cache, mode, seq_pos, window,
             moe_packed=False):
    _check_uniform_attention(cfg)
    x = L.embed_tokens(params["embed"], tokens)
    t = x.shape[1]
    r = cache["pos"].shape[1]
    # effective ring modulus: ring caches (window + SPEC_PAD slots) wrap at
    # `window + SPEC_PAD` so a write of <= SPEC_PAD entries never splits
    is_ring = window and r == ring_size(cfg, 1 << 62, window)
    m_eff = (r - SPEC_PAD) if is_ring else r
    t_w = min(t, m_eff)
    slots = (seq_pos[0, -t_w:] % m_eff).long()
    new_pos = cache["pos"].clone()
    new_pos[:, slots] = seq_pos[:, -t_w:]
    ctx = {"mode": mode, "seq_pos": seq_pos, "window": window,
           "cache_pos": new_pos, "slots": slots, "t_w": t_w,
           "moe_packed": moe_packed}
    x, ys = _run_uniform(cfg, params, x, cache, ctx)
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.unembed(cfg, params["embed"], x)

    aux = {"lb_loss": ys["lb_loss"].mean(),
           "unique_experts": ys["unique_experts"]}              # [L]
    if mode == "decode":
        aux["unique_experts_row"] = ys["unique_experts_row"]    # [L,B]
        aux["experts_active"] = ys["experts_active"]            # [L,E]
    new_cache = dict(cache)
    new_cache["pos"] = new_pos
    new_cache["length"] = seq_pos[0, -1] + 1
    return logits, new_cache, aux


# --------------------------------------------------------------------- #
# Public entry points
# --------------------------------------------------------------------- #

def prefill(cfg, params, tokens, cache, *, window: int = 0):
    """Run the prompt `tokens` [B,T] from position 0 and fill the cache.
    Returns (logits [B,T,V], new_cache, aux)."""
    b, t = tokens.shape[:2]
    seq_pos = torch.arange(t, dtype=torch.int32,
                           device=tokens.device).expand(b, t).contiguous()
    window = window or cfg.window
    return _forward(cfg, params, tokens, cache=cache, mode="prefill",
                    seq_pos=seq_pos, window=window)


def decode_step(cfg, params, cache, tokens, *, window: int = 0,
                moe_packed: bool = False):
    """Verify/decode T tokens per row, starting every row at the scalar
    cache['length']. `moe_packed=True` runs the MoE layers on the
    union-packed path. Returns (logits [B,T,V], new_cache, aux, staged);
    attention stacks stage nothing, so staged is None."""
    b, t = tokens.shape[:2]
    offs = torch.arange(t, dtype=torch.int32, device=tokens.device)
    seq_pos = (cache["length"] + offs).expand(b, t).contiguous()
    window = window or cfg.window
    logits, cache, aux = _forward(cfg, params, tokens, cache=cache,
                                  mode="decode", seq_pos=seq_pos,
                                  window=window, moe_packed=moe_packed)
    return logits, cache, aux, None
