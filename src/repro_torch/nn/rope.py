"""Rotary position embeddings: standard, partial (GLM-style 2d), or none.

Port of ``nn/rope.py``.
"""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, base: float = 10_000.0,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for the rotated sub-dimension (even count)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (base ** exps)


def apply_rope(
    x: torch.Tensor,             # (..., seq, heads, head_dim)
    positions: torch.Tensor,     # (..., seq)
    *,
    base: float = 10_000.0,
    rotary_fraction: float = 1.0,
) -> torch.Tensor:
    """Rotate the first ``rotary_fraction`` of head_dim; pass the rest."""
    head_dim = x.shape[-1]
    rot_dim = int(head_dim * rotary_fraction)
    rot_dim -= rot_dim % 2
    if rot_dim == 0:
        return x
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    inv_freq = rope_frequencies(rot_dim, base, device=x.device)
    angles = positions[..., None].to(torch.float32) * inv_freq
    angles = angles[..., None, :]                       # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x_rot.to(torch.float32), 2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)


def rope_for(kind: str):
    """kind in {"full", "glm2d", "none"} -> (fraction, base) or None."""
    if kind == "none":
        return None
    if kind == "glm2d":
        return (0.5, 10_000.0)
    if kind == "full":
        return (1.0, 10_000.0)
    raise ValueError(f"unknown rope kind {kind!r}")
