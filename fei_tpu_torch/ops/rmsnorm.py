"""RMSNorm (counterpart of fei_tpu/ops/rmsnorm.py)."""

from __future__ import annotations

import torch


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
    offset: bool = False,
) -> torch.Tensor:
    """y = x / rms(x) * weight, computed in fp32 for stability, cast back.

    ``offset=True`` multiplies by (1 + weight) instead — the Gemma-family
    convention, whose checkpoints store norm weights zero-centered."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    w = weight.float()
    if offset:
        w = 1.0 + w
    return (y * w).to(x.dtype)

