"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

The KV cache stores only the compressed latent c_kv (kv_lora_rank dims)
plus a single shared RoPE key (qk_rope_dim dims) per position. Prefill and
training use the expanded form (`mla_full`): the latent is expanded into
per-head keys of qk_nope_dim + qk_rope_dim and values of v_head_dim, and
causal attention runs through `kernels.flash_attention` (training:
`kernels.FlashAttention`) with v zero-padded to the key width (the scale
is 1/sqrt of the key width, so the padded columns change nothing and are
dropped). Decode and verification use the absorbed form
(`mla_absorbed`): W_UK is folded into the query and W_UV into the output,
so a pass reads only the latent cache, in float32 as the JAX package's
does. The absorbed form is plain PyTorch: in the JAX package it is einsums
outside any Pallas kernel."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import FlashAttention, flash_attention

from .attention import NEG_INF
from .layers import _dense_init
from .rope import apply_rope


def init_mla(cfg, gen, dtype, device):
    """One layer's MLA params, with the JAX package's leaf names and
    shapes."""
    d, h = cfg.d_model, cfg.num_heads
    nope, rope, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    p = {
        "w_kva": _dense_init(gen, (d, r), dtype, device),
        "kv_norm": torch.ones(r, dtype=dtype, device=device),
        "w_kr": _dense_init(gen, (d, rope), dtype, device),
        "w_uk": _dense_init(gen, (r, h, nope), dtype, device),
        "w_uv": _dense_init(gen, (r, h, vdim), dtype, device),
        "wo": _dense_init(gen, (h * vdim, d), dtype, device),
    }
    if cfg.q_lora_rank:
        p["w_qa"] = _dense_init(gen, (d, cfg.q_lora_rank), dtype, device)
        p["q_norm"] = torch.ones(cfg.q_lora_rank, dtype=dtype, device=device)
        p["w_qb"] = _dense_init(gen, (cfg.q_lora_rank, h, nope + rope),
                                dtype, device)
    else:
        p["w_q"] = _dense_init(gen, (d, h, nope + rope), dtype, device)
    return p


def _rms(x, scale, eps=1e-6):
    xf = x.float()
    out = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (out * scale.float()).to(x.dtype)


def _heads(x, w):
    """x [B,T,L] @ w [L,H,D] -> [B,T,H,D]."""
    b, t, _ = x.shape
    return (x @ w.reshape(w.shape[0], -1)).reshape(b, t, *w.shape[1:])


def _queries(cfg, p, x, pos2d):
    """-> q_nope [B,T,H,nope], q_rope [B,T,H,rope] (roped)."""
    nope = cfg.qk_nope_dim
    if cfg.q_lora_rank:
        q = _heads(_rms(x @ p["w_qa"], p["q_norm"]), p["w_qb"])
    else:
        q = _heads(x, p["w_q"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    return q_nope, apply_rope(q_rope, pos2d, cfg.rope_theta)


def latent_kv(cfg, p, x, pos2d):
    """Compress x -> (c_kv [B,T,R], k_rope [B,T,rope]): what is cached."""
    c_kv = _rms(x @ p["w_kva"], p["kv_norm"])
    k_rope = apply_rope((x @ p["w_kr"])[:, :, None, :], pos2d,
                        cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def attend_padded(q, k, v):
    """Causal attention over positions 0..S-1 with values narrower than the
    keys: v [B,S,H,dv] is zero-padded to q's width D, so that
    `kernels.flash_attention` runs at head_dim D (scaled by 1/sqrt(D), as
    the JAX package's `attend` scales by the query width), and the D - dv
    padded output columns, which are zeros, are dropped. Where a gradient
    is needed it runs through `kernels.FlashAttention` (the kernel writing
    each row's lse, then the plain backward, which takes any head_dim);
    the gradient flows back through the pad. Returns [B,S,H,dv]."""
    dv = v.shape[-1]
    v = F.pad(v, (0, q.shape[-1] - dv))
    if torch.is_grad_enabled() and any(z.requires_grad for z in (q, k, v)):
        return FlashAttention.apply(q, k, v, 0)[..., :dv]
    return flash_attention(q, k, v)[..., :dv]


def mla_full(cfg, p, x, pos2d):
    """Prefill and training: expand the latent into per-head K/V and run
    causal MHA over positions 0..T-1 (`pos2d` is the arange). Returns
    (out [B,T,d], (c_kv, k_rope)) for caching (training writes no
    cache)."""
    b, t, _ = x.shape
    h = cfg.num_heads
    q_nope, q_rope = _queries(cfg, p, x, pos2d)
    c_kv, k_rope = latent_kv(cfg, p, x, pos2d)
    k_nope = _heads(c_kv, p["w_uk"])
    v = _heads(c_kv, p["w_uv"])
    k_rope_b = k_rope[:, :, None, :].expand(b, t, h, cfg.qk_rope_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_b], dim=-1)
    out = attend_padded(q, k, v)
    return out.reshape(b, t, -1) @ p["wo"], (c_kv, k_rope)


def mla_absorbed(cfg, p, x, pos2d, ckv_cache, krope_cache, cache_pos, *,
                 window: int = 0):
    """Decode/verify: attention in latent space over the compressed cache,
    in float32.

    ckv_cache: [B,R,kv_lora] (new entries already written)
    krope_cache: [B,R,rope]
    cache_pos: [B,R] absolute positions, -1 = empty.
    A query with no valid key gives zeros."""
    b, t, _ = x.shape
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope, q_rope = _queries(cfg, p, x, pos2d)
    ckv = ckv_cache.float()
    # absorb W_UK into the query: q_lat [B,T,H,R]
    q_lat = torch.einsum("bthd,lhd->bthl", q_nope.float(), p["w_uk"].float())
    scores = (torch.einsum("bthl,bsl->bhts", q_lat, ckv)
              + torch.einsum("bthr,bsr->bhts", q_rope.float(),
                             krope_cache.float())) * scale
    valid = ((cache_pos[:, None, :] >= 0)
             & (cache_pos[:, None, :] <= pos2d[:, :, None]))    # [B,T,S]
    if window:
        valid = valid & (cache_pos[:, None, :] > pos2d[:, :, None] - window)
    mask = valid[:, None]                                       # [B,1,T,S]
    probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    probs = torch.where(mask.any(-1, keepdim=True), probs, 0.0)
    out_lat = torch.einsum("bhts,bsl->bthl", probs, ckv)
    out = torch.einsum("bthl,lhd->bthd", out_lat, p["w_uv"].float())
    return (out.reshape(b, t, -1) @ p["wo"].float()).to(x.dtype)
