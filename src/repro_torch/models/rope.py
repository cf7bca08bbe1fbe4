"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE.

Split-halves rotation computed in fp32 and cast back, as in the reference.
"""
from __future__ import annotations

import torch

# fraction of the rotary half-dim given to (t, h, w) sections
MROPE_SECTIONS = (0.25, 0.375, 0.375)


def rope_freqs(head_dim: int, theta: float, device="cpu"):
    half = head_dim // 2
    expo = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** expo)


def _rotate(x, ang):
    """x [B, S, N, H]; ang [B, S, half] fp32."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float = 10_000.0):
    """x [B, S, N, H], positions [B, S] (or [S]) -> rotated x."""
    if positions.ndim == 1:
        positions = positions[None, :]
    inv = rope_freqs(x.shape[-1], theta, device=x.device)
    return _rotate(x, positions[..., None].float() * inv)


def mrope_angles(positions3, head_dim: int, theta: float):
    """positions3 [3, B, S] (t, h, w) -> angles [B, S, half] with sections."""
    half = head_dim // 2
    n_t = int(half * MROPE_SECTIONS[0])
    n_h = int(half * MROPE_SECTIONS[1])
    inv = rope_freqs(head_dim, theta, device=positions3.device)
    ang_all = positions3[..., None].float() * inv          # [3, B, S, half]
    return torch.cat([ang_all[0, ..., :n_t], ang_all[1, ..., n_t:n_t + n_h],
                      ang_all[2, ..., n_t + n_h:]], dim=-1)


def apply_mrope(x, positions3, theta: float = 1_000_000.0):
    """x [B, S, N, H], positions3 [3, B, S]."""
    return _rotate(x, mrope_angles(positions3, x.shape[-1], theta))


def apply_positional(x, positions, kind: str, theta: float):
    """Dispatch: kind in {rope, mrope, none}.  For mrope, ``positions`` may
    be [B, S] (text-only: three equal components) or [3, B, S]."""
    if kind == "none":
        return x
    if kind == "mrope":
        if positions.ndim != 3:
            if positions.ndim == 1:
                positions = positions[None, :]
            positions = positions[None].expand((3,) + tuple(positions.shape))
        return apply_mrope(x, positions, theta)
    return apply_rope(x, positions, theta)
