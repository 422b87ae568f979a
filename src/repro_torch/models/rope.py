"""Rotary position embeddings: standard, ChatGLM's 2-D and Qwen2-VL's
M-RoPE. Tensors are shaped [B, S, H, D] with explicit integer positions
[B, S] (M-RoPE: [3, B, S]), so the same code serves prefill (positions
0..S-1) and speculative spans (L..L+K). Plain differentiable tensor
operations, in float32, cast back to the input's dtype."""

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
    return _rotate(x, rope_angles(positions, x.shape[-1], theta))


def _rotate(x, ang):
    """x [B,S,H,D] rotated by angles [B,S,D/2] (one per interleaved pair)."""
    cos = torch.repeat_interleave(torch.cos(ang), 2, dim=-1)[:, :, None, :]
    sin = torch.repeat_interleave(torch.sin(ang), 2, dim=-1)[:, :, None, :]
    xf = x.float()
    return (xf * cos + _rotate_half_pairs(xf) * sin).to(x.dtype)


def apply_rope_2d(x, positions, theta: float = 10000.0):
    """ChatGLM's 2-D RoPE: the first half of head_dim rotated as standard
    RoPE over that half, the second half passed through."""
    half = x.shape[-1] // 2
    rot = _rotate(x[..., :half], rope_angles(positions, half, theta))
    return torch.cat([rot, x[..., half:]], dim=-1)


def apply_mrope(x, positions_3d, sections, theta: float = 10000.0):
    """Qwen2-VL's multimodal RoPE. positions_3d: [3,B,S] (t, h, w ids);
    `sections` splits the head_dim/2 frequency slots among t, h and w in
    that order: slot i takes its angle from the positions of the section
    it falls in."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim/2 = {d // 2}")
    ang = rope_angles(positions_3d, d, theta)               # [3,B,S,d/2]
    sel = torch.cat([torch.full((s,), i, dtype=torch.long,
                                device=x.device)
                     for i, s in enumerate(sections)])       # [d/2]
    idx = sel.expand(ang.shape[1:])[None]                   # [1,B,S,d/2]
    return _rotate(x, torch.gather(ang, 0, idx)[0])


def apply_positional(cfg, x, positions):
    """Dispatch on cfg.rope_variant. `positions` is [B,S] int32, or [3,B,S]
    for M-RoPE; M-RoPE given [B,S] (text only) uses the same id for t, h
    and w."""
    if cfg.rope_variant == "none":
        return x
    if cfg.rope_variant == "2d":
        return apply_rope_2d(x, positions, cfg.rope_theta)
    if cfg.rope_variant == "mrope":
        if positions.dim() == 2:
            positions = positions[None].expand((3,) + tuple(positions.shape))
        return apply_mrope(x, positions, cfg.mrope_sections, cfg.rope_theta)
    if cfg.rope_variant != "standard":
        raise ValueError(f"unknown rope variant {cfg.rope_variant!r}")
    return apply_rope(x, positions, cfg.rope_theta)
