"""Rotary position embeddings (the standard variant). Tensors are shaped
[B, S, H, D] with explicit integer positions [B, S], so the same code
serves prefill (positions 0..S-1) and speculative spans (L..L+K)."""

from __future__ import annotations

import torch


def _rotate_half_pairs(x):
    """Rotate interleaved pairs (x0,x1) -> (-x1,x0) on the last dim."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def rope_angles(positions, dim: int, theta: float):
    """positions [...,S] -> angles [...,S,dim//2]."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                            device=positions.device), exps)
    return positions[..., None].float() * inv_freq


def apply_rope(x, positions, theta: float = 10000.0):
    """Standard RoPE over the full head_dim. x: [B,S,H,D], positions: [B,S]."""
    d = x.shape[-1]
    ang = rope_angles(positions, d, theta)                  # [B,S,d/2]
    cos = torch.repeat_interleave(torch.cos(ang), 2, dim=-1)[:, :, None, :]
    sin = torch.repeat_interleave(torch.sin(ang), 2, dim=-1)[:, :, None, :]
    xf = x.float()
    return (xf * cos + _rotate_half_pairs(xf) * sin).to(x.dtype)


def apply_positional(cfg, x, positions):
    """Dispatch on cfg.rope_variant; the port has "standard" and "none"."""
    if cfg.rope_variant == "none":
        return x
    if cfg.rope_variant != "standard":
        raise NotImplementedError(
            f"rope variant {cfg.rope_variant!r} is not ported yet")
    return apply_rope(x, positions, cfg.rope_theta)
