"""Shared primitive layers: norms, MLPs, embeddings. Params are plain dicts
of tensors; every layer has an init_* and a matching apply function, with
the JAX package's layouts (`x @ W`, `W [d_in, d_out]`)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _dense_init(gen, shape, dtype, device, scale=None):
    """Normal(0, scale) in float32, cast to `dtype`; scale defaults to
    1/sqrt(shape[0]) as in the JAX package."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


# --------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------- #

def init_norm(cfg, dim, dtype, device):
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(dim, dtype=dtype, device=device),
                "bias": torch.zeros(dim, dtype=dtype, device=device)}
    return {"scale": torch.ones(dim, dtype=dtype, device=device)}


def apply_norm(cfg, p, x, eps=1e-6):
    xf = x.float()
    if "bias" in p:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# Feed-forward
# --------------------------------------------------------------------- #

def init_mlp(cfg, gen, d_model, d_ff, dtype, device):
    if cfg.activation == "swiglu":
        return {
            "w_gate": _dense_init(gen, (d_model, d_ff), dtype, device),
            "w_up": _dense_init(gen, (d_model, d_ff), dtype, device),
            "w_down": _dense_init(gen, (d_ff, d_model), dtype, device),
        }
    return {
        "w_up": _dense_init(gen, (d_model, d_ff), dtype, device),
        "w_down": _dense_init(gen, (d_ff, d_model), dtype, device),
    }


def apply_mlp(cfg, p, x):
    if "w_gate" in p:
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]


# --------------------------------------------------------------------- #
# Embeddings / logits
# --------------------------------------------------------------------- #

def init_embed(cfg, gen, dtype, device):
    p = {"embedding": _dense_init(gen, (cfg.vocab_size, cfg.d_model), dtype,
                                  device, scale=0.02)}
    if not cfg.tie_embeddings:
        p["unembed"] = _dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype,
                                   device)
    return p


def embed_tokens(p, tokens):
    return p["embedding"][tokens.long()]


def unembed(cfg, p, x):
    if cfg.tie_embeddings:
        return x @ p["embedding"].T
    return x @ p["unembed"]
