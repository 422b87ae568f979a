"""Grouped-query self-attention of the attention-bearing stacks:
projections with RoPE (`qkv`) and the masked attention core (`attend`);
and Whisper's cross-attention to encoder states (`encode_cross_kv`,
`cross_attention`). `attend` is the plain PyTorch version that the
kernels' plain versions use on the CPU; on the card the transformer calls
`kernels.flash_attention` (prefill) and `kernels.decode_attention` (decode
and verification) instead, and `cross_attention` calls
`kernels.decode_attention` on both."""

from __future__ import annotations

import math

import torch

from . import rope as rope_mod
from .layers import _dense_init

NEG_INF = -1e30


def init_attention(cfg, gen, dtype, device):
    d, h, hk, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": _dense_init(gen, (d, h * hd), dtype, device),
        "wk": _dense_init(gen, (d, hk * hd), dtype, device),
        "wv": _dense_init(gen, (d, hk * hd), dtype, device),
        "wo": _dense_init(gen, (h * hd, d), dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=dtype, device=device)
        p["k_norm"] = torch.ones(hd, dtype=dtype, device=device)
    return p


def init_cross_attention(cfg, gen, dtype, device):
    """Cross-attention (Whisper's decoder): queries from the decoder's
    states, keys and values from the encoder's."""
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    de = cfg.encoder_d_model
    return {"wq": _dense_init(gen, (d, h * hd), dtype, device),
            "wk": _dense_init(gen, (de, h * hd), dtype, device),
            "wv": _dense_init(gen, (de, h * hd), dtype, device),
            "wo": _dense_init(gen, (h * hd, d), dtype, device)}


def _split_heads(x, n_heads, head_dim):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim)


def attend(q, k, v, q_pos, kv_pos, *, window: int = 0, causal: bool = True):
    """Masked GQA attention core.

    q: [B,T,H,D]; k,v: [B,S,Hkv,D]
    q_pos: [B,T] absolute positions of queries
    kv_pos: [B,S] absolute positions of keys (-1 marks empty cache slots)
    window: if >0, keys at or before q_pos - window are masked
    A query with no valid key gives zeros. Computes in float32 (float64
    inputs stay float64)."""
    b, t, h, d = q.shape
    hkv = k.shape[2]
    dv = v.shape[3]
    if h % hkv:
        raise ValueError(f"{h} query heads over {hkv} KV heads")
    group = h // hkv

    acc = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(acc) / math.sqrt(d)
    kf = k.to(acc)
    vf = v.to(acc)
    qg = qf.reshape(b, t, hkv, group, d)
    scores = torch.einsum("bthgd,bshd->bhgts", qg, kf)   # [B,Hkv,G,T,S]

    valid = kv_pos[:, None, :] >= 0                      # [B,1,S]
    if causal:
        valid = valid & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if window and window > 0:
        valid = valid & (kv_pos[:, None, :] > q_pos[:, :, None] - window)
    mask = valid[:, None, None, :, :]                    # [B,1,1,T,S]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(mask.any(-1, keepdim=True), probs, 0.0)
    out = torch.einsum("bhgts,bshd->bthgd", probs, vf)
    return out.reshape(b, t, h, dv).to(q.dtype)


def _rms(x, eps=1e-6):
    xf = x.float()
    return (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)).to(x.dtype)


def qkv(cfg, p, x, positions):
    """Project + rope. Returns q [B,T,H,D], k/v [B,T,Hkv,D]."""
    h, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(x @ p["wq"], h, hd)
    k = _split_heads(x @ p["wk"], hk, hd)
    v = _split_heads(x @ p["wv"], hk, hd)
    if "q_norm" in p:
        q = _rms(q) * p["q_norm"]
        k = _rms(k) * p["k_norm"]
    q = rope_mod.apply_positional(cfg, q, positions)
    k = rope_mod.apply_positional(cfg, k, positions)
    return q, k, v


def encode_cross_kv(cfg, p, enc_out):
    """One decoder layer's K and V [B,S_enc,H,D] of the encoder output
    `enc_out` [B,S_enc,d_enc], in the promoted type of the two (the JAX
    package's matmul promotes a float32 `enc_out` against bf16 weights)."""
    h, hd = cfg.num_heads, cfg.head_dim
    acc = torch.promote_types(enc_out.dtype, p["wk"].dtype)
    e = enc_out.to(acc)
    k = _split_heads(e @ p["wk"].to(acc), h, hd)
    v = _split_heads(e @ p["wv"].to(acc), h, hd)
    return k, v


class CrossAttention(torch.autograd.Function):
    """Cross-attention, serving and training: every query sees every key.
    The forward is `kernels.decode_attention` with every key and query at
    position 0 (K2 on the card, as serving runs it), which writes no lse;
    the backward is `kernels.flash_attention_bwd` with no mask, which
    recomputes the softmax from the saved q, k, v and output (plain
    PyTorch on the card too, as K3's backward: the JAX package
    differentiates its attention outside any Pallas kernel).
    `CrossAttention.apply(q, k, v)` with q [B,T,H,D], k, v [B,S_enc,H,D]
    -> [B,T,H,D]."""

    @staticmethod
    def forward(ctx, q, k, v):
        # imported here: the kernels' plain versions import this module
        from repro_torch.kernels import decode_attention

        b, t = q.shape[:2]
        kv_pos = torch.zeros((b, k.shape[1]), dtype=torch.int32,
                             device=q.device)
        q_pos = torch.zeros((b, t), dtype=torch.int32, device=q.device)
        out = decode_attention(q, k, v, kv_pos, q_pos)
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.kernels import flash_attention_bwd

        q, k, v, out = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, out, None, dout, causal=False)


def cross_attention(cfg, p, x, enc_k, enc_v):
    """x [B,T,d] attends to every encoder position of enc_k, enc_v
    [B,S_enc,H,D]; returns [B,T,d]. The JAX package computes this with a
    non-causal `attend` at zero positions. Here it is `CrossAttention`:
    the span decode attention with every key and query at position 0,
    whose causal mask then keeps every key (`kernels.decode_attention` on
    the card, its plain version on the CPU), differentiable."""
    h, hd = cfg.num_heads, cfg.head_dim
    q = _split_heads(x @ p["wq"], h, hd)
    b, t = q.shape[:2]
    out = CrossAttention.apply(q, enc_k.to(q.dtype).contiguous(),
                               enc_v.to(q.dtype).contiguous())
    return out.reshape(b, t, -1) @ p["wo"]
