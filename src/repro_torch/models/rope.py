"""Rotary position embeddings (``repro/models/rope.py``).

Frequencies and angles in float32. A bf16 ``x`` times the float32 cos and sin
promotes to float32 here as in JAX; the result is cast back to ``x.dtype``
once, at the end, as JAX casts it.
"""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, Dh]; positions: [B, S] or [S]. Rotate-half convention."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)  # [Dh/2]
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs  # [B, S, Dh/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2 :]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)
