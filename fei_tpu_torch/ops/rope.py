"""Rotary position embeddings (counterpart of fei_tpu/ops/rope.py).

Split-half convention (Llama/Mixtral): the head dim is split into two
halves rotated against each other. Tables are indexed by absolute
position, so one function serves prefill and decode.
"""

from __future__ import annotations

import torch


def compute_rope_freqs(
    head_dim: int, max_seq_len: int, theta: float = 500000.0,
    device: torch.device | str = "cpu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (cos, sin) tables of shape [max_seq_len, head_dim // 2], fp32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)  # [S, D/2]
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(
    x: torch.Tensor,  # [B, T, H, D]
    cos: torch.Tensor,  # [max_seq, D/2]
    sin: torch.Tensor,
    positions: torch.Tensor,  # [B, T] absolute positions (int)
) -> torch.Tensor:
    """Rotate q or k by position-dependent phases. Shape-preserving."""
    d2 = x.shape[-1] // 2
    c = cos[positions][:, :, None, :]  # [B, T, 1, D/2]
    s = sin[positions][:, :, None, :]
    xf1, xf2 = x[..., :d2].float(), x[..., d2:].float()
    out1 = xf1 * c - xf2 * s
    out2 = xf2 * c + xf1 * s
    return torch.cat([out1, out2], dim=-1).to(x.dtype)
