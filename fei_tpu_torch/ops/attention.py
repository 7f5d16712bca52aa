"""Grouped-query attention over a static KV cache (counterpart of
fei_tpu/ops/attention.py).

The plain PyTorch path: one batched einsum per contraction, in fp32, with
the causal, cache-length and sliding-window masks folded into the softmax.
It is the oracle the flash kernel is held against, the CPU path, and the
decode (T = 1) path of the engine.

Shapes (B=batch, T=query len, S=cache len, H=q heads, K=kv heads, D=head dim):
  q: [B, T, H, D]   k,v: [B, S, K, D]   out: [B, T, H, D]
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def visible_mask(
    q_positions: torch.Tensor,  # [B, T]
    kv_length: torch.Tensor | int,  # [B] or scalar
    S: int,
    window: int = 0,
) -> torch.Tensor:
    """[B, T, S] bool: key s is visible to the query at absolute position p
    iff s <= p and s < kv_length (and, with a window, s > p - window)."""
    s_pos = torch.arange(S, device=q_positions.device)[None, None, :]
    p = q_positions[:, :, None]
    mask = s_pos <= p
    if window:
        mask &= s_pos > p - window
    if isinstance(kv_length, int):
        return mask & (s_pos < kv_length)
    return mask & (s_pos < kv_length.to(q_positions.device)[:, None, None])


def acc(x: torch.Tensor) -> torch.Tensor:
    """The accumulation type of the plain paths: fp32, or fp64 for fp64
    inputs (a gradient check in double precision)."""
    return x if x.dtype == torch.float64 else x.float()


def attention_scores(
    q: torch.Tensor,
    k: torch.Tensor,
    q_positions: torch.Tensor,  # [B, T]
    kv_length: torch.Tensor | int,
    scale: float | None = None,
    window: int = 0,
) -> torch.Tensor:
    """[B, T, K, G, S] fp32 scaled scores of each query head (head
    h = k*G + g) against the cache, NEG_INF where a key is not visible."""
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    if scale is None:
        scale = D ** -0.5
    qg = acc(q.reshape(B, T, K, H // K, D))
    scores = torch.einsum("btkgd,bskd->btkgs", qg, acc(k)) * scale
    mask = visible_mask(q_positions, kv_length, S, window)[:, :, None, None, :]
    return torch.where(mask, scores, torch.full_like(scores, NEG_INF))


def attention_probs(
    q: torch.Tensor,
    k: torch.Tensor,
    q_positions: torch.Tensor,  # [B, T]
    kv_length: torch.Tensor | int,
    scale: float | None = None,
    window: int = 0,
) -> torch.Tensor:
    """[B, T, K, G, S] fp32 softmax weights of each query head over the
    cache, with the masks applied."""
    scores = attention_scores(q, k, q_positions, kv_length, scale, window)
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return probs / probs.sum(dim=-1, keepdim=True)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,  # [B, T] absolute position of each query token
    kv_length: torch.Tensor | int,  # [B] or scalar: valid prefix of the cache
    scale: float | None = None,
    window: int = 0,  # sliding window: 0 = full causal; w = last w positions
) -> torch.Tensor:
    B, T, H, D = q.shape
    probs = attention_probs(q, k, q_positions, kv_length, scale, window)
    out = torch.einsum("btkgs,bskd->btkgd", probs, acc(v))
    return out.reshape(B, T, H, D).to(q.dtype)
